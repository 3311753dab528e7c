"""1080p R-MIS / R-OMIS gradient-step timing on a GPU.

value_and_grad of the MIS L2 loss (diff/grad.py mis_l2_image_loss) w.r.t.
every scene parameter on the flagship nightclub workload. The MIS gradient
path runs with per-iteration jax.checkpoint.

Run: python scripts/mis_grad_bench.py [--res 1080x1920]
Env: MIS_GRAD_MODES=rmis_equal,romis_direct  MIS_GRAD_ITERS=5
     MIS_GRAD_SURR=1 — winner-replay surrogate for the per-iteration
     canonical RIS (Features.surrogate_resampling_grad, statistically
     validated in tests/test_grad_surrogate.py; the MIS gradient wrappers
     pass the flag through).
     MIS_GRAD_BANDS=N — band-sequential backward (diff/banded.py): the
     frame runs as a scan over N row bands with a checkpointed band body,
     dividing reverse-mode residual memory by N.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def main():
    import __graft_entry__ as ge
    from romis.core.features import Features, MISWeight, RayTraceMode
    from romis.diff.banded import mis_banded_l2_loss
    from romis.diff.grad import extract_params, mis_l2_image_loss

    res_s = os.environ.get("RMIS_RES", "1080x1920")
    h, w = (int(x) for x in res_s.split("x"))
    iters = int(os.environ.get("MIS_GRAD_ITERS", "5"))
    surr = os.environ.get("MIS_GRAD_SURR", "0") == "1"
    n_bands = int(os.environ.get("MIS_GRAD_BANDS", "0"))
    scene = ge._flagship_scene()
    cam = ge._flagship_camera(h, w)
    params = extract_params(scene.geometry, scene.lights)
    target = jnp.zeros((h, w, 3))
    key = jax.random.PRNGKey(3)

    modes = {
        "rmis_equal": Features(ray_trace_mode=RayTraceMode.RMIS,
                               max_iterations_mis=iters),
        "rmis_balance": Features(ray_trace_mode=RayTraceMode.RMIS,
                                 mis_weight_rmis=MISWeight.BALANCE,
                                 max_iterations_mis=iters),
        "romis_direct": Features(ray_trace_mode=RayTraceMode.ROMIS,
                                 max_iterations_mis=iters),
        "romis_progressive": Features(ray_trace_mode=RayTraceMode.ROMIS,
                                      use_progressive_romis=True,
                                      max_iterations_mis=iters),
    }
    sel = os.environ.get("MIS_GRAD_MODES")
    out = {}
    for name, feats in modes.items():
        if sel and name not in sel.split(","):
            continue
        if surr:
            feats = feats.replace(surrogate_resampling_grad=True)

        def step(params, feats=feats):
            if n_bands:
                loss, g = jax.value_and_grad(mis_banded_l2_loss)(
                    params, target, key, cam, scene.geometry, scene.lights,
                    scene.num_lights, h, w, feats, n_bands)
            else:
                loss, g = jax.value_and_grad(mis_l2_image_loss)(
                    params, target, key, cam, scene.geometry, scene.lights,
                    scene.num_lights, h, w, feats)
            # one scalar touching every grad leaf (defeats DCE)
            return loss + sum(jnp.sum(jnp.abs(x))
                              for x in jax.tree.leaves(g))

        jfn = jax.jit(step)
        t0 = time.perf_counter()
        float(jfn(params))
        comp = time.perf_counter() - t0
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            float(jfn(params))
            best = min(best, time.perf_counter() - t0)
        out[name] = round(best * 1e3, 1)
        print(f"{name:>18}: {best * 1e3:8.1f} ms/grad-step "
              f"(compile {comp:.0f}s)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
