"""Profile the 1080p gradient step phase by phase on a GPU.

Measures value_and_grad of L2-style losses truncated after successive
pipeline phases on the flagship nightclub workload (bench.py config 5's
gradient pass): trace-only, +RIS, +temporal, +spatial, full frame. The
deltas attribute backward-pass cost to phases, steering the custom-vjp
work (VERDICT round-1 item #2).

Protocol: min-of-3 wall clocks on one jitted call returning one scalar
(fetching the scalar waits for the device).

Run: python scripts/grad_bench.py [stage ...]   (default: all stages)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def main():
    if os.environ.get("GRAD_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
    import __graft_entry__ as ge
    from romis.core.features import Features
    from romis.diff.grad import apply_params, extract_params
    from romis.render.restir import (
        PH_CANDIDATES, PH_SPATIAL, PH_TEMPORAL, final_shade,
        initial_temporal_state, render_restir_frame, spatial_reuse,
        temporal_reuse, trace_primary,
    )
    from romis.core.camera import generate_rays
    from romis.ops.wrs import gen_canonical_samples

    h, w = (int(x) for x in os.environ.get("GRAD_RES", "1080x1920").split("x"))
    scene = ge._flagship_scene()
    cam = ge._flagship_camera(h, w)
    geometry, lights, nl = scene.geometry, scene.lights, scene.num_lights
    features = Features(enable_tone_mapping=False)
    # Mirror diff/grad.render_with_params' gradient-path feature set.
    features = features.replace(coherent_spatial_offsets=True)
    if os.environ.get("GRAD_SURR", "1") == "1":
        features = features.replace(surrogate_resampling_grad=True)
    prev = initial_temporal_state(h, w, features.num_samples_in_reservoir,
                                  cam)
    params0 = extract_params(geometry, lights)
    key = jax.random.PRNGKey(3)

    # Mirror render_restir_frame's replay-records gating so the per-stage
    # deltas decompose the SAME backward the full step runs.
    use_records = (features.surrogate_resampling_grad
                   and not features.unbiased_combination)

    def upto(params, stage):
        from romis.ops.wrs import gen_canonical_with_records

        geo, li = apply_params(geometry, lights, params)
        rays = generate_rays(cam, h, w)
        _, ctx = trace_primary(rays, geo, features)
        if stage == "trace":
            return jnp.mean(ctx.position ** 2) + jnp.mean(ctx.kd ** 2)
        if use_records:
            res, rec = jax.checkpoint(
                lambda k_, c_, li_, ge_: gen_canonical_with_records(
                    k_, c_, li_, nl, ge_, features))(
                jax.random.fold_in(key, PH_CANDIDATES), ctx, li, geo)
        else:
            rec = None
            res = jax.checkpoint(
                lambda k_, c_, li_, ge_: gen_canonical_samples(
                    k_, c_, li_, nl, ge_, features))(
                jax.random.fold_in(key, PH_CANDIDATES), ctx, li, geo)
        if stage == "ris":
            return jnp.mean(res.big_w ** 2) + jnp.mean(res.color ** 2)
        if stage != "ris_notemporal":
            if use_records:
                res, rec = jax.checkpoint(
                    lambda k_, c_, r_, rc_, p_, li_: temporal_reuse(
                        k_, c_, r_, p_, h, w, features, records=rc_,
                        lights=li_))(
                    jax.random.fold_in(key, PH_TEMPORAL), ctx, res, rec,
                    prev, li)
            else:
                res = jax.checkpoint(lambda k_, c_, r_, p_: temporal_reuse(
                    k_, c_, r_, p_, h, w, features))(
                    jax.random.fold_in(key, PH_TEMPORAL), ctx, res, prev)
            if stage == "temporal":
                return jnp.mean(res.big_w ** 2) + jnp.mean(res.color ** 2)
        if use_records:
            res, _ = spatial_reuse(
                jax.random.fold_in(key, PH_SPATIAL), ctx, res, h, w, geo,
                features, records=rec, lights=li)
        else:
            sp = lambda k_, c_, r_, ge_: spatial_reuse(  # noqa: E731
                k_, c_, r_, h, w, ge_, features)
            if (not features.surrogate_resampling_grad
                    or features.unbiased_combination):
                sp = jax.checkpoint(sp)  # mirrors render_restir_frame
            res = sp(jax.random.fold_in(key, PH_SPATIAL), ctx, res, geo)
        if stage in ("spatial", "ris_notemporal"):
            return jnp.mean(res.big_w ** 2) + jnp.mean(res.color ** 2)
        color = final_shade(ctx, res, geo, features)
        return jnp.mean(color ** 2)

    def full(params):
        geo, li = apply_params(geometry, lights, params)
        img, _ = render_restir_frame(key, cam, geo, li, nl, h, w, features,
                                     prev)
        return jnp.mean(img ** 2)

    def consume(vg):
        """value+grad -> one scalar touching every grad leaf (defeats DCE)."""

        def f(p):
            v, g = vg(p)
            return v + jax.tree.reduce(
                lambda a, b: a + jnp.sum(jnp.abs(b)), g, jnp.float32(0.0))

        return f

    stages = sys.argv[1:] or ["trace", "ris", "temporal", "spatial", "shade",
                              "full", "fwd"]
    print(f"backend={jax.default_backend()} res={h}x{w} "
          f"surrogate={features.surrogate_resampling_grad}", flush=True)
    last = None
    for stage in stages:
        if stage == "fwd":
            f = jax.jit(full)
        elif stage == "full":
            f = jax.jit(consume(jax.value_and_grad(full)))
        else:
            f = jax.jit(consume(
                jax.value_and_grad(lambda p, s=stage: upto(p, s))))
        t0 = time.perf_counter()
        v = float(f(params0))
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(f(params0))
            best = min(best, time.perf_counter() - t0)
        delta = "" if last is None or stage in ("fwd", "full") else (
            f"  (+{(best - last) * 1e3:7.0f} ms)")
        print(f"{stage:>14}: {best * 1e3:8.0f} ms  "
              f"(compile {compile_s:.0f}s, value {v:.3e}){delta}", flush=True)
        if stage not in ("fwd", "full"):
            last = best


if __name__ == "__main__":
    main()
