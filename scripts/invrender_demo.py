"""Inverse-rendering demo: recover light emission by gradient descent.

Renders a target image of the Cornell box with its parallelogram light at a
"ground truth" color, perturbs the light's corner colors, and runs Adam-ish
SGD on the full SceneParams through the differentiable ReSTIR pipeline
until the render matches the target — the end-to-end proof of the
gradient path (SURVEY north star: image + gradients; BASELINE config 5's
"gradient pass").

Run: python scripts/invrender_demo.py  (GPU, or CPU with JAX_PLATFORMS=cpu)
     INVRENDER_MODE=romis python scripts/invrender_demo.py  (through the
     R-OMIS estimator's gradient path instead — rmis also accepted)
Writes renders/invrender_{target,initial,final}.png and prints the loss
curve.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from romis.utils.runtime import setup_compile_cache

    setup_compile_cache()
    from romis.core.camera import make_camera
    from romis.core.features import Features
    from romis.diff.grad import (
        extract_params, render_with_params,
    )
    from romis.io.image import write_image
    from romis.render.restir import initial_temporal_state
    from romis.scene.scene import load_prebuilt

    h, w = 128, 160
    scene = load_prebuilt("cornell_box_parallelogram_light")
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(h, w))
    g, lights, nl = scene.geometry, scene.lights, scene.num_lights
    # Fixed sampling key: the target and the optimized render share the
    # noise realization, so the loss measures parameters, not variance.
    feats = Features(enable_tone_mapping=False, temporal_reuse=False)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    key = jax.random.PRNGKey(7)

    mode = os.environ.get("INVRENDER_MODE", "restir")
    true_params = extract_params(g, lights)
    if mode in ("rmis", "romis"):
        # Same demo through the MIS estimators' gradient path
        # (diff/grad.render_mis_with_params, VERDICT r4 capability).
        from romis.core.features import RayTraceMode
        from romis.diff.grad import render_mis_with_params

        feats = feats.replace(
            ray_trace_mode=RayTraceMode(mode), max_iterations_mis=3,
            num_neighbours_to_sample=3, spatial_resample_radius=4)
        raw_render = lambda p: render_mis_with_params(  # noqa: E731
            p, key, cam, g, lights, nl, h, w, feats)
    else:
        raw_render = lambda p: render_with_params(  # noqa: E731
            p, key, cam, g, lights, nl, h, w, feats, prev)[0]
    render = jax.jit(raw_render)
    target = render(true_params)

    # log1p L2 — the standard HDR inverse-rendering loss: ReSTIR/MIS W
    # weights are unbiased but heavy-tailed (reference reservoir.cpp:64 has
    # the same math, no clamping), and a single firefly sample otherwise
    # dominates a linear L2 and its gradients.
    def loss_fn(p, t):
        return jnp.mean(
            (jnp.log1p(raw_render(p)) - jnp.log1p(t)) ** 2)

    # Perturb the light: dim it to 20% and tint it.
    tint = jnp.asarray([0.2, 0.05, 0.3])
    params = true_params.replace(
        light_c0=true_params.light_c0 * tint,
        light_c1=true_params.light_c1 * tint,
        light_c2=true_params.light_c2 * tint,
        light_c3=true_params.light_c3 * tint,
    )
    initial = render(params)

    loss_grad = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, target)))

    # Optimize the light corner colors only (geometry/material grads are
    # exercised by tests/test_grad.py; one learning rate does not fit
    # parameters of wildly different scales in a demo).
    color_fields = ("light_c0", "light_c1", "light_c2", "light_c3")
    lr = 2.0  # plain SGD; the light-color loss surface is near-quadratic
    losses = []
    for it in range(80):
        loss, grads = loss_grad(params)
        losses.append(float(loss))
        # ReSTIR's W weights are unbiased but heavy-tailed (reference
        # reservoir.cpp:64 has the same math, no clamping): a rare firefly
        # sample produces a step-destroying gradient spike. Value-clipping
        # is the standard inverse-rendering treatment.
        params = params.replace(**{
            f: getattr(params, f)
            - lr * jnp.clip(getattr(grads, f), -10.0, 10.0)
            for f in color_fields
        })
    final_loss, _ = loss_grad(params)
    losses.append(float(final_loss))

    final = render(params)
    err0 = [float(jnp.abs(a - b).max()) for a, b in (
        (params.light_c0, true_params.light_c0),)][0]
    print("loss curve:", " ".join(f"{v:.3e}" for v in losses[::10]))
    print(f"final loss {losses[-1]:.3e} (start {losses[0]:.3e}), "
          f"max |light_c0 - truth| = {err0:.4f}")

    os.makedirs("renders", exist_ok=True)
    for name, img in (("target", target), ("initial", initial),
                      ("final", final)):
        write_image(f"renders/invrender_{name}.png",
                    np.clip(np.asarray(img), 0, 1))
    # The floor is set by partial identifiability: WRS winner selection is
    # (correctly) stop-grad and changes discretely with the parameters, so
    # the fixed-key loss plateaus near — not at — zero. 30x down in a few
    # dozen SGD steps is the demo's success bar; visually the renders match.
    assert losses[-1] < losses[0] / 30.0, "optimization failed to converge"
    print("converged OK")


if __name__ == "__main__":
    main()
