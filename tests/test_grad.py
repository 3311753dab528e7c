"""Differentiable-rendering tests: gradient flow, NaN-freedom, and
finite-difference validation on tiny scenes (SURVEY §7.3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera
from romis.core.features import Features
from romis.diff.grad import (
    SceneParams, apply_params, extract_params, l2_image_loss,
    render_with_params,
)
from romis.render.restir import initial_temporal_state
from romis.scene.scene import load_prebuilt

HW = (12, 12)


@pytest.fixture(scope="module")
def cornell():
    return load_prebuilt("cornell_box_parallelogram_light")


def _setup(cornell, feats):
    h, w = HW
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=HW)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    params = extract_params(cornell.geometry, cornell.lights)
    args = (jax.random.PRNGKey(0), cam, cornell.geometry, cornell.lights,
            cornell.num_lights, h, w, feats, prev)
    return params, args


@pytest.mark.parametrize("feats", [
    Features(spatial_reuse=False, temporal_reuse=False,
             enable_tone_mapping=False, initial_light_samples=4),
    Features(spatial_resample_radius=2, initial_light_samples=4,
             enable_tone_mapping=False, temporal_reprojection=True),
    Features(spatial_resample_radius=2, initial_light_samples=4,
             enable_tone_mapping=False, unbiased_combination=True),
], ids=["ris", "full", "unbiased"])
def test_gradients_finite_and_nonzero(cornell, feats):
    params, args = _setup(cornell, feats)
    target = jnp.zeros(HW + (3,))
    loss, grads = jax.value_and_grad(l2_image_loss)(params, target, *args)
    assert np.isfinite(float(loss)) and float(loss) > 0
    for name in vars(grads):
        g = getattr(grads, name)
        assert np.isfinite(np.asarray(g)).all(), f"NaN/inf grad in {name}"
    # Gradients reach every parameter family.
    for name in ("light_c0", "light_v0", "mat_kd", "tri_v0"):
        assert float(jnp.abs(getattr(grads, name)).max()) > 0, name


def test_light_color_grad_matches_finite_difference(cornell):
    """Light emission gradients are estimator-exact (color enters linearly
    except through the target PDF): central differences must match."""
    feats = Features(spatial_reuse=False, temporal_reuse=False,
                     enable_tone_mapping=False, initial_light_samples=4)
    params, args = _setup(cornell, feats)
    target = jnp.zeros(HW + (3,))

    loss_fn = lambda p: l2_image_loss(p, target, *args)
    g = jax.grad(loss_fn)(params)

    eps = 1e-3
    rng = np.random.default_rng(0)
    # Probe a few random coordinates of the light corner colors.
    for _ in range(3):
        ch = rng.integers(0, 3)
        base = np.asarray(params.light_c0)
        d = np.zeros_like(base)
        d[0, ch] = eps
        lp = params.replace(light_c0=jnp.asarray(base + d))
        lm = params.replace(light_c0=jnp.asarray(base - d))
        fd = (float(loss_fn(lp)) - float(loss_fn(lm))) / (2 * eps)
        ad = float(np.asarray(g.light_c0)[0, ch])
        assert abs(fd - ad) <= 2e-2 * max(abs(fd), abs(ad), 1e-3), (fd, ad)


def test_kd_grad_matches_finite_difference(cornell):
    feats = Features(spatial_reuse=False, temporal_reuse=False,
                     enable_tone_mapping=False, initial_light_samples=4)
    params, args = _setup(cornell, feats)
    target = jnp.zeros(HW + (3,))
    loss_fn = lambda p: l2_image_loss(p, target, *args)
    g = jax.grad(loss_fn)(params)

    eps = 1e-3
    gk = np.asarray(g.mat_kd)
    # Pick the material with the largest gradient for a strong signal.
    mi, ch = np.unravel_index(np.abs(gk).argmax(), gk.shape)
    base = np.asarray(params.mat_kd)
    d = np.zeros_like(base)
    d[mi, ch] = eps
    fd = (float(loss_fn(params.replace(mat_kd=jnp.asarray(base + d))))
          - float(loss_fn(params.replace(mat_kd=jnp.asarray(base - d))))) \
        / (2 * eps)
    ad = float(gk[mi, ch])
    # kd enters the target PDF (nonlinear resampling weights) — tolerate a
    # few percent of secondary effect.
    assert abs(fd - ad) <= 5e-2 * max(abs(fd), abs(ad), 1e-3), (fd, ad)


def test_light_position_grad_matches_finite_difference(cornell):
    """Light placement gradients (v0) vs central differences of the energy.
    (The *sign* of d(energy)/dy is not physically determined here — pixels
    adjacent to the light dominate via 1/d² — so compare against FD.)"""
    feats = Features(spatial_reuse=False, temporal_reuse=False,
                     enable_tone_mapping=False, initial_light_samples=8)
    params, args = _setup(cornell, feats)

    def energy(p):
        img, _ = render_with_params(p, *args)
        return jnp.sum(img)

    g = jax.grad(energy)(params)
    gy = float(np.asarray(g.light_v0)[0, 1])
    eps = 1e-4
    base = np.asarray(params.light_v0)
    d = np.zeros_like(base)
    d[0, 1] = eps
    fd = (float(energy(params.replace(light_v0=jnp.asarray(base + d))))
          - float(energy(params.replace(light_v0=jnp.asarray(base - d))))) \
        / (2 * eps)
    assert abs(fd - gy) <= 5e-2 * max(abs(fd), abs(gy), 1e-3), (fd, gy)


def test_vertex_grad_finite_difference_on_energy(cornell):
    """Vertex gradients flow through the Möller–Trumbore hit maths; compare
    against finite differences of the energy for one coordinate. Selection
    flips (hit/miss changes) are avoided by a small epsilon."""
    feats = Features(spatial_reuse=False, temporal_reuse=False,
                     enable_tone_mapping=False, initial_light_samples=4)
    params, args = _setup(cornell, feats)

    def energy(p):
        img, _ = render_with_params(p, *args)
        return jnp.sum(img)

    g = jax.grad(energy)(params)
    gv = np.asarray(g.tri_v0)
    ti, ch = np.unravel_index(np.abs(gv).argmax(), gv.shape)
    eps = 2e-4
    base = np.asarray(params.tri_v0)
    d = np.zeros_like(base)
    d[ti, ch] = eps
    fp = float(energy(params.replace(tri_v0=jnp.asarray(base + d))))
    fm = float(energy(params.replace(tri_v0=jnp.asarray(base - d))))
    fd = (fp - fm) / (2 * eps)
    ad = float(gv[ti, ch])
    # Geometry gradients include discontinuous silhouette terms that autodiff
    # cannot see; accept agreement within 25% on the smooth component.
    assert np.sign(fd) == np.sign(ad) or abs(fd - ad) < 0.25 * abs(ad), (
        fd, ad)


def test_apply_params_drops_stale_host_specialisations(cornell):
    """The packed row tables are built from the host arrays at scene build
    time; apply_params must repack them from the traced params, so no
    stale build-time value survives in the tables the renderer reads."""
    params = extract_params(cornell.geometry, cornell.lights)
    params = params.replace(mat_shininess=params.mat_shininess + 7.0,
                            light_c0=params.light_c0 * 2.0)
    geometry, lights = apply_params(cornell.geometry, cornell.lights, params)
    np.testing.assert_allclose(
        np.asarray(geometry.mat_shininess),
        np.asarray(cornell.geometry.mat_shininess) + 7.0)
    np.testing.assert_allclose(np.asarray(geometry.mat_rows[:, 6]),
                               np.asarray(geometry.mat_shininess))
    np.testing.assert_allclose(np.asarray(lights.rows[:, 9:12]),
                               np.asarray(cornell.lights.c0) * 2.0)
