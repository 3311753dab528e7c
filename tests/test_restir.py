"""End-to-end ReSTIR pipeline tests: determinism, NaN-freedom, and
statistical agreement with a brute-force Monte Carlo ground truth."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera, generate_rays
from romis.core.features import Features
from romis.core.vec import e
from romis.ops.shading import phong_shade
from romis.ops.wrs import visibility
from romis.render.restir import (
    initial_temporal_state, render_restir_frame, trace_primary,
)
from romis.scene.lights import sample_lights
from romis.scene.scene import load_prebuilt


HW = (24, 24)


@pytest.fixture(scope="module")
def cornell():
    return load_prebuilt("cornell_box_parallelogram_light")


@pytest.fixture(scope="module")
def cam():
    return make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                       distance=2.5, fov_deg=50, resolution=HW)


def _render(scene, cam, feats, key, n_frames=1):
    h, w = HW
    state = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    img = None
    for f in range(n_frames):
        img, state = fn(jax.random.fold_in(key, f), cam, scene.geometry,
                        scene.lights, scene.num_lights, h, w, feats, state)
    return np.asarray(img), state


@pytest.mark.parametrize("feats", [
    Features(spatial_reuse=False, temporal_reuse=False),
    Features(temporal_reuse=False),
    Features(),
    Features(unbiased_combination=True),
    Features(unbiased_combination=True, spatial_reuse_visibility_check=True),
    Features(initial_samples_visibility_check=True),
    Features(temporal_reuse=True, temporal_reprojection=True),
], ids=["ris", "spatial", "full", "unbiased", "unbiased_vis", "init_vis",
        "reproject"])
def test_frame_finite_and_deterministic(cornell, cam, feats):
    img1, _ = _render(cornell, cam, feats, jax.random.PRNGKey(0), n_frames=2)
    img2, _ = _render(cornell, cam, feats, jax.random.PRNGKey(0), n_frames=2)
    assert np.isfinite(img1).all()
    assert img1.min() >= 0.0 and img1.max() <= 1.0  # tone-mapped
    np.testing.assert_array_equal(img1, img2)  # keyed RNG → bit-identical
    img3, _ = _render(cornell, cam, feats, jax.random.PRNGKey(9), n_frames=2)
    assert not np.array_equal(img1, img3)  # different key → different noise


def _ground_truth(scene, cam, feats, n_samples=4096, seed=123):
    """Brute-force direct lighting: uniform light + uniform point samples,
    f·vis / pdf averaged — the estimator the RIS pipeline must match in
    expectation."""
    h, w = HW
    rays = generate_rays(cam, h, w)
    _, ctx = trace_primary(rays, scene.geometry, feats)
    key = jax.random.PRNGKey(seed)
    total = jnp.zeros((3, h, w))
    chunk = 64
    for s in range(0, n_samples, chunk):
        k = jax.random.fold_in(key, s)
        k1, k2 = jax.random.split(k)
        idx = jax.random.randint(k1, (chunk, h, w), 0, scene.num_lights)
        uv = jax.random.uniform(k2, (2, chunk, h, w))
        pos, color = sample_lights(scene.lights, idx, uv[0], uv[1])
        f = phong_shade(ctx, pos, color, feats)  # [chunk, 3, h, w]
        vis = visibility(ctx.position, pos, scene.geometry)  # [chunk, h, w]
        contrib = jnp.where(e(vis), f, 0.0) * scene.num_lights
        total = total + contrib.sum(axis=0)
    img = np.asarray(total / n_samples)  # [3, h, w]
    return np.moveaxis(img, 0, -1)


def test_ris_estimator_matches_ground_truth(cornell, cam):
    """RIS-only render (no reuse, no tone map) averaged over many frames must
    converge to the brute-force MC estimate."""
    feats = Features(spatial_reuse=False, temporal_reuse=False,
                     enable_tone_mapping=False, initial_light_samples=8)
    truth = _ground_truth(cornell, cam, feats)

    h, w = HW
    state = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    acc = np.zeros((h, w, 3))
    n_frames = 150
    for f in range(n_frames):
        img, _ = fn(jax.random.PRNGKey(f), cam, cornell.geometry,
                    cornell.lights, cornell.num_lights, h, w, feats, state)
        acc += np.asarray(img)
    mean_img = acc / n_frames

    # Compare mean pixel intensity and per-pixel agreement on lit pixels.
    lit = truth.mean(axis=-1) > 0.01
    assert lit.sum() > 50
    rel = abs(mean_img.mean() - truth.mean()) / truth.mean()
    assert rel < 0.05, (mean_img.mean(), truth.mean())
    per_pix = np.abs(mean_img[lit] - truth[lit]).mean() / truth[lit].mean()
    assert per_pix < 0.15, per_pix


def test_unbiased_spatial_reuse_matches_ground_truth(cornell, cam):
    """The UNBIASED spatial combine (Alg. 6 Z-count) must stay unbiased —
    the mean over frames converges to brute-force MC. Regression for the
    reference's totalSampleNums over-normalization (reservoir.cpp:92),
    which dimmed the estimator ~K-fold per pass at K=2."""
    feats = Features(temporal_reuse=False, unbiased_combination=True,
                     enable_tone_mapping=False, initial_light_samples=8,
                     spatial_resample_radius=2)
    truth = _ground_truth(cornell, cam, feats)

    h, w = HW
    state = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    acc = np.zeros((h, w, 3))
    n_frames = 150
    for f in range(n_frames):
        img, _ = fn(jax.random.PRNGKey(f), cam, cornell.geometry,
                    cornell.lights, cornell.num_lights, h, w, feats, state)
        acc += np.asarray(img)
    mean_img = acc / n_frames

    lit = truth.mean(axis=-1) > 0.01
    assert lit.sum() > 50
    rel = abs(mean_img.mean() - truth.mean()) / truth.mean()
    assert rel < 0.08, (mean_img.mean(), truth.mean())


def test_spatial_reuse_reduces_variance(cornell, cam):
    """Spatial reuse must cut pixel variance vs RIS-only at equal candidate
    counts (the point of ReSTIR)."""
    # Radius 2: at 24×24 the default radius (10) spans half the image, so
    # neighbours land on other surfaces and the similarity gates reject them.
    base = Features(spatial_reuse=False, temporal_reuse=False,
                    enable_tone_mapping=False, initial_light_samples=4)
    spat = base.replace(spatial_reuse=True, spatial_resample_radius=2)

    def frames(feats, n=48):
        h, w = HW
        state = initial_temporal_state(h, w, feats.num_samples_in_reservoir,
                                       cam)
        fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
        return np.stack([
            np.asarray(fn(jax.random.PRNGKey(f), cam, cornell.geometry,
                          cornell.lights, cornell.num_lights, h, w, feats,
                          state)[0])
            for f in range(n)
        ])

    # Median per-pixel variance ratio over lit pixels — robust to the few
    # huge-variance pixels adjacent to the light that dominate the mean.
    f_base, f_spat = frames(base), frames(spat)
    lit = f_base.mean(axis=0).mean(axis=-1) > 0.01
    v_base = f_base.var(axis=0).mean(axis=-1)[lit]
    v_spat = f_spat.var(axis=0).mean(axis=-1)[lit]
    ratio = np.median(v_spat / np.maximum(v_base, 1e-12))
    assert ratio < 0.7, (ratio, v_base.mean(), v_spat.mean())


def test_temporal_reuse_converges(cornell, cam):
    """Running frames with temporal reuse must reduce frame-to-frame noise
    relative to independent frames."""
    feats = Features(spatial_reuse=False, temporal_reuse=True,
                     enable_tone_mapping=False, initial_light_samples=4)
    h, w = HW
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    state = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    imgs = []
    for f in range(12):
        img, state = fn(jax.random.PRNGKey(f), cam, cornell.geometry,
                        cornell.lights, cornell.num_lights, h, w, feats,
                        state)
        imgs.append(np.asarray(img))
    late_diff = np.abs(imgs[-1] - imgs[-2]).mean()
    early_diff = np.abs(imgs[1] - imgs[0]).mean()
    assert late_diff < early_diff


def test_reprojection_bounded_reuse_and_reject(cornell):
    """Bounded temporal reprojection (Features.reprojection_radius): motion
    within the band carries history forward (total M grows past the
    canonical count); motion beyond it reuse-rejects (M stays canonical)."""
    h, w = HW
    cam1 = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                       distance=2.5, fov_deg=50, resolution=HW)
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))

    def second_frame_m(radius):
        """Median total M over VALID pixels after a frame-2 camera pan that
        moves every valid pixel by 3-4 px (look_at shift 0.3 at distance
        2.5, measured)."""
        feats = Features(temporal_reuse=True, temporal_reprojection=True,
                         spatial_reuse=False, reprojection_radius=radius)
        cam2 = make_camera(look_at=(0.3, 0, 0), rotation_deg=(0, 0, 0),
                           distance=2.5, fov_deg=50, resolution=HW)
        state = initial_temporal_state(
            h, w, feats.num_samples_in_reservoir, cam1)
        _, state = fn(jax.random.PRNGKey(0), cam1, cornell.geometry,
                      cornell.lights, cornell.num_lights, h, w, feats, state)
        _, state = fn(jax.random.PRNGKey(1), cam2, cornell.geometry,
                      cornell.lights, cornell.num_lights, h, w, feats, state)
        valid = np.asarray(state.ctx.valid)
        return np.median(np.asarray(state.reservoirs.total_m())[valid])

    canonical = Features().initial_light_samples
    # 3-4 px of motion inside an 8 px band: history must carry.
    assert second_frame_m(radius=8) > canonical * 1.5
    # The same motion outside a 2 px band: reuse-reject, M stays canonical.
    assert second_frame_m(radius=2) == canonical
