"""Smoke run of the renderer's main paths on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the parallel/ paths only

One card, reference defaults (Features(): 32 candidates, K=2, 5 neighbours,
radius 10, 2 spatial passes, M-clamp 20), generated scenes:

1. ReSTIR stream: ``romis.cli`` renders the Cornell Nightclub at 1920x1080,
   8 temporally reused frames (render/animation.py's scan).
2. R-MIS (balance) and R-OMIS (progressive, 5 iterations, D=5): one 1080p
   frame each through render/pipeline.render_frame.
3. ReSTIR gradient: 3 optimiser steps at 1080p (surrogate gradients,
   coherent offsets) recovering the nightclub's light colours.
4. Large scene: one 1080p ReSTIR frame on the 5x5 blob field (24,002
   triangles) through the BVH traversal.
5. GPU against CPU: the same 256x256 nightclub frame with the same keys on
   both backends of this process.
6. Kernel check: the trace kernel (ops/trace_kernel.py) against the XLA
   block scan at 1080p, and the whole frame with and without it.

Each phase prints one line: compile seconds, wall ms (block_until_ready),
the process's peak device bytes so far, and a finiteness / non-black check.
These are smoke readings, not benchmark numbers. Any failed check raises;
the last stdout line is the JSON verdict. Without a GPU the script exits
non-zero before running anything.
"""

import argparse
import functools
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np

H, W = 1080, 1920
NIGHTCLUB_CAM = dict(look_at=(2.57, 1.23, -1.35),
                     rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                     fov_deg=30.0)


def _log(msg):
    print(msg, flush=True)


def _peak(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)


def _check_image(name, img):
    img = np.asarray(img, np.float64)
    finite = bool(np.isfinite(img).all())
    mean = float(img.mean()) if finite else float("nan")
    if not finite or not mean > 0.0:
        raise RuntimeError(f"{name}: image not finite or black "
                           f"(finite={finite}, mean={mean})")
    return f"finite=True mean={mean:.6g}"


def _run(name, fn, args, dev, check):
    """Compile ``fn`` for ``args``, run it twice, time the second run."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    wall_ms = 1000 * (time.perf_counter() - t0)
    _log(f"[{name}] compile_s={compile_s:.2f} wall_ms={wall_ms:.2f} "
         f"peak_bytes={_peak(dev)} {check(out)}")
    return out, wall_ms


def _camera(h, w, **kw):
    from romis.core.camera import make_camera

    return make_camera(resolution=(h, w), **(kw or NIGHTCLUB_CAM))


def phase_stream(dev, out_dir):
    """1: the CLI's 8-frame ReSTIR stream at 1080p: a cold call writing
    the last frame as .npy (checked), then a warm call writing the PNG."""
    from romis import cli

    argv = ["--scene", "cornell_nightclub", "--size", str(W), str(H),
            "--mode", "restir", "--frames", "8", "--out", out_dir]
    times = []
    for fmt in ("npy", "png"):
        t0 = time.perf_counter()
        if cli.main(argv + ["--format", fmt]) != 0:
            raise RuntimeError("cli.main failed")
        times.append(time.perf_counter() - t0)
    files = sorted(os.listdir(out_dir))
    check = _check_image("stream", np.load(os.path.join(
        out_dir, [f for f in files if f.endswith(".npy")][-1])))
    png = [f for f in files if f.endswith(".png")][-1]
    with open(os.path.join(out_dir, png), "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise RuntimeError(f"{png} is not a PNG")
    _log(f"[stream cli 8 frames 1080p] compile_s={times[0] - times[1]:.2f} "
         f"wall_ms={1000 * times[1]:.2f} (warm call: 8 frames and the PNG "
         f"write) peak_bytes={_peak(dev)} {check}, wrote {png}")


def phase_mis(dev, scene):
    """2: R-MIS balance and R-OMIS progressive at 1080p."""
    import jax

    from romis.core.features import Features, MISWeight, RayTraceMode
    from romis.render.pipeline import render_frame

    cam = _camera(H, W)
    key = jax.random.PRNGKey(2)
    for name, feats in (
            ("rmis balance", Features(ray_trace_mode=RayTraceMode.RMIS,
                                      mis_weight_rmis=MISWeight.BALANCE)),
            ("romis progressive", Features(ray_trace_mode=RayTraceMode.ROMIS,
                                           use_progressive_romis=True))):
        _run(f"{name} 1080p",
             lambda k, c: render_frame(k, c, scene, H, W, feats)[0],
             (key, cam), dev, lambda img: _check_image(name, img))


def phase_grad(dev, scene):
    """3: three gradient steps on the light colours at 1080p."""
    import jax
    import jax.numpy as jnp

    from romis.core.features import Features
    from romis.diff.grad import extract_params, make_grad_fn
    from romis.render.restir import initial_temporal_state, render_restir_frame

    feats = Features(enable_tone_mapping=False,
                     surrogate_resampling_grad=True)
    cam = _camera(H, W)
    prev = initial_temporal_state(H, W, feats.num_samples_in_reservoir, cam)
    target, _ = jax.jit(
        lambda k: render_restir_frame(
            k, cam, scene.geometry, scene.lights, scene.num_lights, H, W,
            feats, prev))(jax.random.PRNGKey(7))
    true = extract_params(scene.geometry, scene.lights)
    params = true.replace(light_c0=0.5 * true.light_c0,
                          light_c1=0.5 * true.light_c1,
                          light_c2=0.5 * true.light_c2,
                          light_c3=0.5 * true.light_c3)
    vg = make_grad_fn(scene.geometry, scene.lights, scene.num_lights, H, W,
                      feats)
    colours = ("light_c0", "light_c1", "light_c2", "light_c3")

    def step(params, key):
        loss, grads = vg(params, target, key, cam, prev)
        upd = {c: getattr(params, c) - 0.05 * jnp.sign(getattr(grads, c))
               for c in colours}
        return params.replace(**upd), loss, grads

    def check(out):
        _, loss, grads = out
        g = np.concatenate([np.asarray(getattr(grads, c)).ravel()
                            for c in colours])
        if not (np.isfinite(float(loss)) and np.isfinite(g).all()
                and np.abs(g).max() > 0):
            raise RuntimeError(f"grad: loss={float(loss)} "
                               f"finite={np.isfinite(g).all()} "
                               f"max|g|={np.abs(g).max()}")
        return (f"loss={float(loss):.6g} finite=True "
                f"max|dL/dcolour|={np.abs(g).max():.3g}")

    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(params, jax.random.PRNGKey(0)).compile()
    compile_s = time.perf_counter() - t0
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        params, loss, grads = jax.block_until_ready(
            compiled(params, jax.random.PRNGKey(100 + i)))
        wall = 1000 * (time.perf_counter() - t0)
        _log(f"[grad step {i + 1} 1080p] compile_s={compile_s:.2f} "
             f"wall_ms={wall:.2f} peak_bytes={_peak(dev)} "
             f"{check((params, loss, grads))}")
        losses.append(float(loss))
    err = [float(np.abs(np.asarray(getattr(params, c))
                        - np.asarray(getattr(true, c))).mean())
           for c in colours]
    _log(f"[grad] losses={losses} mean|colour - true| after 3 steps="
         f"{np.mean(err):.4g} (start {0.5 * float(np.abs(true.light_c0).mean()):.4g})")


def phase_large(dev):
    """4: one 1080p ReSTIR frame on the 24k-triangle blob field."""
    import jax

    from romis.core.features import Features
    from romis.ops.bvh import builder_name, with_bvh
    from romis.render.restir import initial_temporal_state, render_restir_frame
    from romis.scene.scene import load_blob_field

    t0 = time.perf_counter()
    scene = load_blob_field(5)
    scene.geometry = with_bvh(scene.geometry)
    _log(f"[large scene] {int(np.asarray(scene.geometry.active).sum())} "
         f"triangles, BVH built by {builder_name()} in "
         f"{time.perf_counter() - t0:.1f} s")
    feats = Features()
    cam = _camera(H, W, look_at=(0, 0, 0), rotation_deg=(25, 30, 0),
                  distance=11.0, fov_deg=50)
    prev = initial_temporal_state(H, W, feats.num_samples_in_reservoir, cam)
    _run("large scene frame 1080p",
         lambda k, p: render_restir_frame(
             k, cam, scene.geometry, scene.lights, scene.num_lights, H, W,
             feats, p)[0],
         (jax.random.PRNGKey(4), prev), dev,
         lambda img: _check_image("large", img))


def phase_gpu_vs_cpu(scene):
    """5: the same 256x256 frame on the GPU and on the CPU."""
    import jax

    from romis.core.features import Features
    from romis.render.restir import initial_temporal_state, render_restir_frame

    h = w = 256
    feats = Features()
    cam = _camera(h, w)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    args = (jax.random.PRNGKey(5), cam, scene.geometry, scene.lights, prev)

    def frame(k, c, g, li, p):
        return render_restir_frame(k, c, g, li, scene.num_lights, h, w,
                                   feats, p)[0]

    imgs = []
    with jax.default_matmul_precision("highest"):
        for dev in (jax.devices()[0], jax.devices("cpu")[0]):
            on_dev = jax.device_put(args, dev)
            img = jax.jit(frame)(*on_dev)
            if img.devices() != {dev}:
                raise RuntimeError(f"frame ran on {img.devices()}, not {dev}")
            imgs.append(np.asarray(img, np.float64))
    gpu, cpu = imgs
    _check_image("gpu", gpu)
    _check_image("cpu", cpu)
    mad = float(np.abs(gpu - cpu).mean())
    mean = float(cpu.mean())
    agree = float((np.abs(gpu - cpu).max(-1) <= 1e-3).mean())
    _log(f"[gpu vs cpu 256x256] mean|diff|={mad:.3g} "
         f"= {mad / mean:.3g} x mean intensity (limit 1e-3); pixels within "
         f"1e-3: {100 * agree:.3f}% (limit 99.5%)")
    if not (mad <= 1e-3 * mean and agree >= 0.995):
        raise RuntimeError("GPU and CPU frames disagree")


def _time(fn, args, reps=5):
    import jax

    fn = jax.jit(fn)
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(1000 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_kernel(dev, scene):
    """6: trace kernel vs the XLA block scan at 1080p, and the frame."""
    import jax
    import jax.numpy as jnp

    from romis.core.camera import generate_rays
    from romis.core.features import Features
    from romis.ops import intersect
    from romis.ops.trace_kernel import any_hit_kernel, closest_hit_kernel
    from romis.render.restir import (
        initial_temporal_state, render_restir_frame, trace_primary,
    )
    from romis.ops.wrs import SHADOW_RAY_EPSILON, gen_canonical_samples

    geo = scene.geometry
    feats = Features()
    cam = _camera(H, W)
    rays = jax.jit(lambda c: generate_rays(c, H, W))(cam)

    # Primary rays.
    ref = jax.jit(intersect.intersect_closest)(rays, geo)
    got = jax.jit(closest_hit_kernel)(rays, geo)
    t_r, i_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_k, i_k = np.asarray(got[0]), np.asarray(got[1])
    same = i_r == i_k
    hit = same & (i_r >= 0)
    rel = np.abs(t_k[hit] - t_r[hit]) / np.maximum(np.abs(t_r[hit]), 1e-30)
    ms_x = _time(intersect.intersect_closest, (rays, geo))
    ms_k = _time(closest_hit_kernel, (rays, geo))
    _log(f"[kernel closest 1080p] index equal {100 * same.mean():.4f}% "
         f"(limit 99.99%), max rel|dt| {rel.max():.3g} (limit 1e-5); "
         f"xla_ms={ms_x:.3f} kernel_ms={ms_k:.3f}")
    if same.mean() < 0.9999 or rel.max() > 1e-5:
        raise RuntimeError("trace kernel closest hit disagrees with XLA")

    # The final shade's K shadow rays per pixel.
    _, ctx = jax.jit(lambda r: trace_primary(r, geo, feats))(rays)
    res = jax.jit(lambda k, c: gen_canonical_samples(
        k, c, scene.lights, scene.num_lights, geo, feats))(
        jax.random.PRNGKey(6), ctx)

    @jax.jit
    def shadow_rays(pos, p):
        to = p - pos
        dist = jnp.sqrt(jnp.sum(to * to, axis=-3))
        d = to / jnp.maximum(dist, 1e-20)[..., None, :, :]
        o = pos + SHADOW_RAY_EPSILON * d
        return o, d, jnp.sqrt(jnp.sum((p - o) ** 2, axis=-3))

    o, d, tm = shadow_rays(ctx.position, res.pos)
    occ_r = np.asarray(jax.jit(intersect.intersect_any)(o, d, tm, geo))
    occ_k = np.asarray(jax.jit(any_hit_kernel)(o, d, tm, geo))
    eq = float((occ_r == occ_k).mean())
    ms_x = _time(intersect.intersect_any, (o, d, tm, geo))
    ms_k = _time(any_hit_kernel, (o, d, tm, geo))
    _log(f"[kernel any-hit 1080p x K={feats.num_samples_in_reservoir}] "
         f"equal {100 * eq:.4f}% (limit 99.99%); xla_ms={ms_x:.3f} "
         f"kernel_ms={ms_k:.3f}")
    if eq < 0.9999:
        raise RuntimeError("trace kernel any hit disagrees with XLA")

    # The whole frame, with the kernel and with the XLA scan only.
    prev = initial_temporal_state(H, W, feats.num_samples_in_reservoir, cam)

    def frame(k, p):
        return render_restir_frame(k, cam, geo, scene.lights,
                                   scene.num_lights, H, W, feats, p)[0]

    args = (jax.random.PRNGKey(8), prev)
    ms = {}
    for order in ("kernel", "xla", "xla", "kernel"):
        if order == "xla":
            with mock.patch.object(intersect, "kernel_fits",
                                   lambda *args: False):
                ms.setdefault(order, []).append(
                    _time(lambda k, p: frame(k, p) + 0.0, args))
        else:
            ms.setdefault(order, []).append(_time(frame, args))
    _log(f"[kernel frame 1080p] kernel_ms={ms['kernel']} xla_ms={ms['xla']}")


def run_one(dev):
    from romis.scene.scene import load_prebuilt

    scene = load_prebuilt("cornell_nightclub")
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        phase_stream(dev, tmp)
    phase_mis(dev, scene)
    phase_grad(dev, scene)
    phase_large(dev)
    phase_gpu_vs_cpu(scene)
    phase_kernel(dev, scene)


def _agree(name, a, b):
    """Phase-5 agreement of two images (or arrays) a and b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mad = float(np.abs(a - b).mean())
    mean = float(np.abs(b).mean())
    within = float((np.abs(a - b).reshape(a.shape[0], -1).max(-1) <= 1e-3)
                   .mean()) if a.ndim > 1 else float(mad <= 1e-3)
    ok = mad <= 1e-3 * mean and within >= 0.995
    _log(f"[four {name}] mean|4-card - 1-card|={mad:.3g} "
         f"({mad / max(mean, 1e-30):.3g} x mean), rows within 1e-3: "
         f"{100 * within:.3f}% -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: 4-card result disagrees with 1 card")


def run_four():
    """The parallel/ paths on 4 cards, each against 1 card."""
    import jax
    import jax.numpy as jnp

    from romis.core.features import Features, MISWeight, RayTraceMode
    from romis.diff.grad import extract_params
    from romis.ops.wrs import gen_canonical_samples
    from romis.parallel.halo import render_frame_halo, spatial_reuse_halo
    from romis.parallel.mesh import make_mesh
    from romis.parallel.mis import render_rmis_sharded, render_romis_sharded
    from romis.parallel.shard import make_sharded_train_step, render_frame_sharded
    from romis.render.restir import initial_temporal_state, trace_primary
    from romis.core.camera import generate_rays
    from romis.scene.scene import load_prebuilt

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    meshes = {n: make_mesh(n) for n in (1, 4)}
    scene = load_prebuilt("cornell_nightclub")
    geo, li, nl = scene.geometry, scene.lights, scene.num_lights
    feats = Features()
    cam = _camera(H, W)
    prev = initial_temporal_state(H, W, feats.num_samples_in_reservoir, cam)
    key = jax.random.PRNGKey(11)

    def both(name, fn, *args):
        """fn(mesh, *args) on the 1-card and the 4-card mesh."""
        outs = {}
        for n, mesh in meshes.items():
            with mesh:
                f = jax.jit(functools.partial(fn, mesh))
                out = jax.block_until_ready(f(*args))
                t0 = time.perf_counter()
                out = jax.block_until_ready(f(*args))
                ms = 1000 * (time.perf_counter() - t0)
            shards = out.addressable_shards
            devices = {sh.device for sh in shards}
            _log(f"[four {name}] {n} card(s): wall_ms={ms:.2f} output "
                 f"shards {[tuple(sh.data.shape) for sh in shards]} on "
                 f"{len(devices)} device(s), fully replicated="
                 f"{out.sharding.is_fully_replicated}; peak_bytes per device "
                 f"{[_peak(d) for d in devs[:n]]}")
            if len(devices) != n:
                raise RuntimeError(f"{name}: output not spread over {n}")
            outs[n] = out
        return outs

    o = both("render_frame_sharded",
             lambda m, g, p: render_frame_sharded(
                 key, cam, g, li, nl, H, W, feats, p, m)[0], geo, prev)
    _agree("render_frame_sharded", o[4], o[1])

    # The halo path folds the device index into its neighbour draws, so
    # whole frames on 1 and 4 cards are different samples: compare their
    # means, and the spatial reuse itself on injected offsets and noise.
    o = both("render_frame_halo",
             lambda m, g, p: render_frame_halo(
                 key, cam, g, li, nl, H, W, feats, p, m)[0], geo, prev)
    m4, m1 = float(jnp.mean(o[4])), float(jnp.mean(o[1]))
    _log(f"[four render_frame_halo] mean 4-card {m4:.6g} vs 1-card "
         f"{m1:.6g} (rel {abs(m4 - m1) / m1:.3g}, limit 1e-2)")
    if abs(m4 - m1) > 1e-2 * m1:
        raise RuntimeError("render_frame_halo means disagree")
    rays = generate_rays(cam, H, W)
    _, ctx = jax.jit(lambda r: trace_primary(r, geo, feats))(rays)
    res = jax.jit(lambda c: gen_canonical_samples(
        key, c, li, nl, geo, feats))(ctx)
    rng = np.random.default_rng(7)
    r, k_n = feats.spatial_resample_radius, feats.num_neighbours_to_sample
    k = feats.num_samples_in_reservoir
    inject = [(jnp.asarray(rng.integers(-r, r + 1, (2, k_n, H, W)),
                           jnp.int32),
               jnp.asarray(rng.gumbel(size=(k_n + 1, k, H, W)), jnp.float32))
              for _ in range(feats.spatial_resampling_passes)]
    o = both("spatial_reuse_halo (injected)",
             lambda m, c, rs, inj: spatial_reuse_halo(
                 key, c, rs, H, W, geo, feats, m, inject=inj).big_w,
             ctx, res, inject)
    _agree("spatial_reuse_halo big_w", o[4], o[1])

    train_feats = feats.replace(enable_tone_mapping=False,
                                surrogate_resampling_grad=True)
    params = extract_params(geo, li)
    target = jnp.zeros((H, W, 3))
    losses = {}
    for n, mesh in meshes.items():
        with mesh:
            step = make_sharded_train_step(geo, li, nl, H, W, train_feats,
                                           mesh)
            new, loss, _ = jax.block_until_ready(
                step(params, target, key, cam, prev))
        losses[n] = (float(loss), np.asarray(new.light_c0))
        _log(f"[four train step] {n} card(s): loss={float(loss):.8g}")
    d_loss = abs(losses[4][0] - losses[1][0])
    _log(f"[four train step] |dloss|={d_loss:.3g} (limit 1e-3 x loss)")
    if not d_loss <= 1e-3 * abs(losses[1][0]):
        raise RuntimeError("train step losses disagree")
    _agree("train step updated light_c0", losses[4][1], losses[1][1])

    # The sharded MIS paths draw per-band reservoirs, so both sides get the
    # same injected neighbourhoods and reservoirs.
    mis = feats.replace(max_iterations_mis=5)
    rows = jnp.arange(H, dtype=jnp.int32)[:, None]
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    offs = jax.random.randint(jax.random.fold_in(key, 1),
                              (2, mis.num_neighbours_to_sample, H, W), -r,
                              r + 1)
    ny = jnp.concatenate([jnp.broadcast_to(rows, (1, H, W)),
                          jnp.clip(rows[None] + offs[0], 0, H - 1)])
    nx = jnp.concatenate([jnp.broadcast_to(cols, (1, H, W)),
                          jnp.clip(cols[None] + offs[1], 0, W - 1)])
    res_list = [jax.jit(lambda c, i=i: gen_canonical_samples(
        jax.random.fold_in(key, 10 + i), c, li, nl, geo, mis))(ctx)
        for i in range(mis.max_iterations_mis)]
    inj = (ny, nx, res_list)
    rmis = mis.replace(ray_trace_mode=RayTraceMode.RMIS,
                       mis_weight_rmis=MISWeight.BALANCE)
    o = both("render_rmis_sharded",
             lambda m, g, i: render_rmis_sharded(
                 key, cam, g, li, nl, H, W, rmis, m, inject=i), geo, inj)
    _agree("render_rmis_sharded", o[4], o[1])
    romis = mis.replace(ray_trace_mode=RayTraceMode.ROMIS)
    o = both("render_romis_sharded",
             lambda m, g, i: render_romis_sharded(
                 key, cam, g, li, nl, H, W, romis, m, inject=i), geo, inj)
    _agree("render_romis_sharded", o[4], o[1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card parallel/ paths")
    args = p.parse_args(argv)

    import jax

    from romis.utils.runtime import card_info, require_gpu, setup_compile_cache

    cache = setup_compile_cache()
    dev = require_gpu()
    _log(f"card: {card_info()} | device_kind={dev.device_kind} | "
         f"jax={jax.__version__} | compile cache={cache}")
    if args.four:
        run_four()
    else:
        run_one(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
