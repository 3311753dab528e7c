"""Per-phase timing of the ReSTIR frame on a GPU.

Each phase runs `reps` times inside one jitted lax.scan (one dispatch per
measurement; fetching the scalar result waits for the device), fed
realistic inputs produced by the preceding phases. Run:
    python scripts/phase_bench.py [HxW reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np
import jax.numpy as jnp


def main():
    hw = sys.argv[1] if len(sys.argv) > 1 else "1080x1920"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    h, w = (int(x) for x in hw.split("x"))

    from romis.core.features import Features
    from romis.ops.wrs import gen_canonical_samples
    from romis.render.restir import (
        final_shade, generate_rays, initial_temporal_state, spatial_reuse,
        temporal_reuse, trace_primary,
    )
    import __graft_entry__ as ge

    scene = ge._flagship_scene()
    features = Features()
    cam = ge._flagship_camera(h, w)
    geometry, lights, n_lights = (scene.geometry, scene.lights,
                                  scene.num_lights)
    k = features.num_samples_in_reservoir
    prev = initial_temporal_state(h, w, k, cam)

    key = jax.random.PRNGKey(0)

    # Build realistic phase inputs once (jitted, untimed).
    @jax.jit
    def setup(key):
        rays = generate_rays(cam, h, w)
        _, ctx = trace_primary(rays, geometry, features)
        res = gen_canonical_samples(key, ctx, lights, n_lights, geometry,
                                    features)
        return rays, ctx, res

    rays, ctx, res = setup(key)
    jax.block_until_ready(res)

    # PHASES=substr1,substr2 runs only matching rows.
    only = os.environ.get("PHASES")
    only = [s.strip() for s in only.split(",")] if only else None

    def timed(name, body):
        if only is not None and not any(s in name for s in only):
            return
        # ctx/res are jit ARGUMENTS (not closure constants): closure arrays
        # get baked into the program as constants.
        def run(key, ctx, res):
            def f(carry, kk):
                return carry, jnp.sum(body(kk, ctx, res))
            keys = jax.random.split(key, reps)
            _, sums = jax.lax.scan(f, 0.0, keys)
            return jnp.sum(sums)

        fn = jax.jit(run)
        t0 = time.perf_counter()
        float(fn(jax.random.PRNGKey(1), ctx, res))
        t1 = time.perf_counter()
        # Best of 3 calls.
        best = np.inf
        for i in range(2, 5):
            ta = time.perf_counter()
            float(fn(jax.random.PRNGKey(i), ctx, res))
            best = min(best, time.perf_counter() - ta)
        print(f"{name:28s} compile {t1 - t0 - best:6.1f}s  "
              f"{1000 * best / reps:8.2f} ms/rep", flush=True)

    timed("trace_primary",
          lambda kk, ctx, res: trace_primary(generate_rays(cam, h, w),
                                             geometry, features)[1].depth_t)

    def trace_full_ctx(kk, ctx, res):
        _, c2 = trace_primary(generate_rays(cam, h, w), geometry, features)
        return (jnp.sum(c2.position) + jnp.sum(c2.normal) + jnp.sum(c2.kd)
                + jnp.sum(c2.ks) + jnp.sum(c2.shininess)
                + jnp.sum(c2.depth_t) + jnp.sum(c2.view_origin))

    timed("trace+full ctx", trace_full_ctx)

    def trace_ris(kk, ctx, res):
        _, c2 = trace_primary(generate_rays(cam, h, w), geometry, features)
        r2 = gen_canonical_samples(kk, c2, lights, n_lights, geometry,
                                   features)
        return (jnp.sum(r2.w_sum) + jnp.sum(r2.pos) + jnp.sum(r2.color)
                + jnp.sum(r2.big_w) + jnp.sum(r2.m))

    timed("trace+ctx+RIS", trace_ris)
    timed("gen_canonical (RIS)",
          lambda kk, ctx, res: gen_canonical_samples(
              kk, ctx, lights, n_lights, geometry, features).w_sum)
    timed("temporal_reuse",
          lambda kk, ctx, res: temporal_reuse(kk, ctx, res, prev, h, w,
                                              features).w_sum)
    timed("spatial_reuse (2 passes)",
          lambda kk, ctx, res: spatial_reuse(kk, ctx, res, h, w, geometry,
                                             features).w_sum)
    timed("final_shade",
          lambda kk, ctx, res: final_shade(ctx, res, geometry, features))

    def final_shade_kkdep(kk, ctx, res):
        # Perturb the sample positions with the scanned key so XLA cannot
        # hoist the (otherwise loop-invariant) shadow trace out of the
        # timing scan — this row is the TRUE per-rep cost.
        jitter = 1e-6 * jax.random.normal(kk, res.pos.shape)
        res = res.replace(pos=res.pos + jitter)
        return final_shade(ctx, res, geometry, features)

    timed("final_shade kkdep", final_shade_kkdep)

    def trace_kkdep(kk, ctx, res):
        rays = generate_rays(cam, h, w)
        rays = rays.replace(
            origin=rays.origin + 1e-7 * jax.random.normal(kk, (3, 1, 1)))
        return trace_primary(rays, geometry, features)[1].depth_t

    timed("trace kkdep", trace_kkdep)

    from romis.render.restir import render_restir_frame

    def full_frame(kk, ctx, res, feats):
        img, _ = render_restir_frame(kk, cam, geometry, lights, n_lights,
                                     h, w, feats, prev)
        return jnp.mean(img)

    timed("full frame", lambda kk, ctx, res: full_frame(kk, ctx, res,
                                                        features))
    timed("frame no spatial",
          lambda kk, ctx, res: full_frame(
              kk, ctx, res, features.replace(spatial_reuse=False)))
    timed("frame no temporal",
          lambda kk, ctx, res: full_frame(
              kk, ctx, res, features.replace(temporal_reuse=False)))
    timed("frame RIS+shade only",
          lambda kk, ctx, res: full_frame(
              kk, ctx, res, features.replace(spatial_reuse=False,
                                             temporal_reuse=False)))


if __name__ == "__main__":
    main()
