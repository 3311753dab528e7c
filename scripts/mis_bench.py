"""End-to-end R-MIS / R-OMIS frame timing on a GPU (nightclub scene, or
RMIS_SCENE=blob5 for the 5x5 blob field through the BVH traversal).

Protocol: `reps` frames inside one jitted lax.scan, min of 3 calls.

Run: python scripts/mis_bench.py [--res 1080x1920] [--modes ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def timed(fn, *args, reps):
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    float(jfn(*args))
    comp = time.perf_counter() - t0
    best = min(
        (lambda t: (float(jfn(*args)), time.perf_counter() - t)[1])(
            time.perf_counter())
        for _ in range(3))
    return best / reps, comp


def main():
    import __graft_entry__ as ge
    from romis.core.features import Features, MISWeight, RayTraceMode
    from romis.render.pipeline import render_frame

    res_s = os.environ.get("RMIS_RES", "1080x1920")
    h, w = (int(x) for x in res_s.split("x"))
    reps = int(os.environ.get("RMIS_REPS", "4"))
    if os.environ.get("RMIS_SCENE", "").startswith("blob"):
        # Large-scene MIS: blob_field NxN through the BVH traversal.
        from romis.core.camera import make_camera
        from romis.ops.bvh import with_bvh
        from romis.scene.scene import load_blob_field

        n = int(os.environ.get("RMIS_SCENE", "blob5")[4:] or 5)
        scene = load_blob_field(n)
        scene.geometry = with_bvh(scene.geometry)
        cam = make_camera(look_at=(0, 0, 0), rotation_deg=(25, 30, 0),
                          distance=11.0, fov_deg=50, resolution=(h, w))
    else:
        scene = ge._flagship_scene()
        cam = ge._flagship_camera(h, w)

    modes = {
        "rmis_equal": Features(ray_trace_mode=RayTraceMode.RMIS),
        "rmis_balance": Features(ray_trace_mode=RayTraceMode.RMIS,
                                 mis_weight_rmis=MISWeight.BALANCE),
        "romis_direct": Features(ray_trace_mode=RayTraceMode.ROMIS),
        "romis_progressive": Features(ray_trace_mode=RayTraceMode.ROMIS,
                                      use_progressive_romis=True),
    }
    sel = os.environ.get("RMIS_MODES")
    out = {}
    for name, feats in modes.items():
        if sel and name not in sel.split(","):
            continue

        def frames(key, feats=feats):
            def body(acc, k):
                img, _ = render_frame(k, cam, scene, h, w, feats)
                return acc + jnp.mean(img), None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0),
                                  jax.random.split(key, reps))
            return acc

        dt, comp = timed(frames, jax.random.PRNGKey(0), reps=reps)
        out[name] = round(dt * 1e3, 1)
        print(f"{name:>18}: {dt * 1e3:8.1f} ms/frame (compile {comp:.0f}s)",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
