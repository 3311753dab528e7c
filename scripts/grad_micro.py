"""Micro-profile the gradient-path primitives at 1080p on a GPU: which
part of the spatial/RIS backward costs the most.

Run: python scripts/grad_micro.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def timed(name, fn, *args, reps=4):
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(*args))
    comp = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"{name:>34}: {best * 1e3:8.1f} ms (compile {comp:.0f}s)",
          flush=True)
    return best


def main():
    h, w, k, d, r = 1080, 1920, 2, 5, 10
    c = 10 * k + 18
    key = jax.random.PRNGKey(0)
    planes = jax.random.uniform(key, (c, h, w))
    dy = jax.random.randint(jax.random.fold_in(key, 1), (d, h, w), -r, r + 1)
    dx = jax.random.randint(jax.random.fold_in(key, 2), (d, h, w), -r, r + 1)
    rows = jnp.arange(h, dtype=jnp.int32)[:, None]
    cols = jnp.arange(w, dtype=jnp.int32)[None, :]
    dy = jnp.clip(rows[None] + dy, 0, h - 1) - rows[None]
    dx = jnp.clip(cols[None] + dx, 0, w - 1) - cols[None]

    from romis.ops.gather import halo_offset_gather

    def g_fwd(p):
        return jnp.sum(halo_offset_gather(p, dy, dx))

    timed("halo_offset_gather fwd", lambda p: halo_offset_gather(
        p, dy, dx), planes)
    timed("halo_offset_gather grad", jax.grad(g_fwd), planes)

    # The raw scatter in the VJP, isolated.
    ct = jax.random.uniform(jax.random.fold_in(key, 3), (d, c, h, w))

    def scat(ct):
        flat_idx = ((rows[None] + dy) * w + (cols[None] + dx)).ravel()
        ct_flat = jnp.moveaxis(ct, 1, -1).reshape(-1, c)
        return jax.ops.segment_sum(ct_flat, flat_idx, num_segments=h * w)

    timed("segment_sum scatter [10M,38]", scat, ct)

    # combine_biased grad alone (R = d+1 streams, K lanes).
    from romis.core.features import Features
    from romis.core.types import Reservoirs, ShadeCtx
    from romis.ops.wrs import combine_biased

    feats = Features()
    rr = d + 1

    def mk(shape):
        return jax.random.uniform(jax.random.fold_in(key, hash(shape) % 97),
                                  shape)

    res = Reservoirs(
        pos=mk((rr, k, 3, h, w)), color=mk((rr, k, 3, h, w)),
        w_sum=mk((rr, k, h, w)), m=mk((rr, k, h, w)),
        big_w=mk((rr, k, h, w)), chosen_w=mk((rr, k, h, w)))
    ctx = ShadeCtx(
        valid=jnp.ones((h, w), bool), position=mk((3, h, w)),
        normal=mk((3, h, w)), view_origin=mk((3, h, w)), kd=mk((3, h, w)),
        ks=mk((3, h, w)), shininess=jnp.full((h, w), 32.0),
        geom_id=jnp.zeros((h, w), jnp.int32), depth_t=mk((h, w)))
    mask = jnp.ones((rr, h, w), bool)

    def comb(res, ctx):
        out = combine_biased(key, ctx, res, mask, feats)
        return jnp.sum(out.big_w) + jnp.sum(out.pos) + jnp.sum(out.w_sum)

    timed("combine_biased fwd", comb, res, ctx)

    def comb_diff(res, cin):
        ctx2 = ctx.replace(position=cin[0:3], normal=cin[3:6],
                           kd=cin[6:9], ks=cin[9:12])
        return comb(res, ctx2)

    cin = jnp.concatenate([ctx.position, ctx.normal, ctx.kd, ctx.ks], 0)
    timed("combine_biased grad", jax.grad(comb_diff, argnums=(0, 1)), res, cin)

    # RIS slot-scan primitives: light-table gather + scatter VJP.
    from romis.scene.lights import sample_lights_planes
    from romis.scene.scene import load_prebuilt
    import __graft_entry__ as ge

    scene = ge._flagship_scene()
    lights = scene.lights
    nl = scene.num_lights
    idx = jax.random.randint(jax.random.fold_in(key, 9), (k, h, w), 0, nl)
    u1 = mk((k, h, w))
    u2 = mk((k, h, w))

    def light_fetch(rows_tab):
        li = lights.replace(rows=rows_tab)
        comps = sample_lights_planes(li, idx, u1, u2)
        return sum(jnp.sum(cc) for cc in comps)

    timed("sample_lights_planes fwd", light_fetch, lights.rows)
    timed("sample_lights_planes grad", jax.grad(light_fetch), lights.rows)


if __name__ == "__main__":
    main()
