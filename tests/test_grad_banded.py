"""Band-sequential MIS gradients (diff/banded.py — VERDICT r4 item 1).

The banded scan must be the SAME estimator as the single-pass renderers:
with injected neighbour coords + reservoirs the forward is the identical
computation re-read through band slices (exact parity), and its gradients
match the whole-frame backward. Without injection, the per-band RNG streams
differ (same caveat as parallel/mis.py) but the banded loss is still
FD-consistent with its own gradient.

Reference semantics: renderRMIS (src/rendering/render.cpp:64-119),
renderROMIS (render.cpp:121-265).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera
from romis.core.features import Features, MISWeight, RayTraceMode
from romis.diff.banded import mis_banded_l2_loss, render_mis_banded
from romis.diff.grad import apply_params, extract_params
from romis.ops.wrs import gen_canonical_samples
from romis.render.neighbours import select_neighbour_indices
from romis.render.restir import trace_primary
from romis.render.rmis import PH_NEIGHBOURS, render_rmis
from romis.render.romis import render_romis
from romis.scene.scene import load_prebuilt

HW = (12, 12)
N_BANDS = 3


@pytest.fixture(scope="module")
def cornell():
    return load_prebuilt("cornell_box_parallelogram_light")


def _cam():
    return make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                       distance=2.5, fov_deg=50, resolution=HW)


def _mis_feats(**kw):
    base = dict(
        enable_tone_mapping=False, initial_light_samples=4,
        max_iterations_mis=2, spatial_resample_radius=2,
        num_neighbours_to_sample=2,
    )
    base.update(kw)
    return Features(**base)


MIS_CONFIGS = [
    ("rmis_equal", _mis_feats(ray_trace_mode=RayTraceMode.RMIS,
                              mis_weight_rmis=MISWeight.EQUAL)),
    ("rmis_balance", _mis_feats(ray_trace_mode=RayTraceMode.RMIS,
                                mis_weight_rmis=MISWeight.BALANCE)),
    ("romis_direct", _mis_feats(ray_trace_mode=RayTraceMode.ROMIS,
                                use_progressive_romis=False)),
    ("romis_progressive", _mis_feats(ray_trace_mode=RayTraceMode.ROMIS,
                                     use_progressive_romis=True,
                                     max_iterations_mis=3)),
]


def _make_inject(scene, feats, key=0):
    """Explicit neighbour coords + per-iteration canonical reservoirs, shared
    verbatim by the single-pass and banded renderers."""
    h, w = HW
    from romis.core.camera import generate_rays

    rays = generate_rays(_cam(), h, w)
    _, ctx = trace_primary(rays, scene.geometry, feats)
    k = jax.random.PRNGKey(key)
    ny, nx = select_neighbour_indices(
        jax.random.fold_in(k, PH_NEIGHBOURS), ctx, h, w, feats)
    res = [
        gen_canonical_samples(jax.random.fold_in(k, 100 + it), ctx,
                              scene.lights, scene.num_lights,
                              scene.geometry, feats)
        for it in range(feats.max_iterations_mis)
    ]
    return ny, nx, res


@pytest.mark.parametrize(
    "feats", [f for _, f in MIS_CONFIGS], ids=[n for n, _ in MIS_CONFIGS])
def test_banded_forward_matches_single_pass_with_injection(cornell, feats):
    h, w = HW
    inj = _make_inject(cornell, feats)
    args = (jax.random.PRNGKey(0), _cam(), cornell.geometry, cornell.lights,
            cornell.num_lights, h, w, feats)
    if feats.ray_trace_mode == RayTraceMode.RMIS:
        ref = render_rmis(*args, inject=inj)
    else:
        ref = render_romis(*args, inject=inj)
    banded = render_mis_banded(*args, n_bands=N_BANDS, inject=inj)
    # atol covers f32 reassociation (scan carry vs Python-loop adds fuse
    # differently) amplified through near-singular pixels' α solves; the
    # progressive estimator feeds mid-stream α forward and adds 1/sum_frac
    # amplification (same bands as tests/test_parallel_mis.py). The float64
    # test below pins the same two programs at 1e-10.
    atol = 1e-2 if feats.use_progressive_romis else 4e-4
    np.testing.assert_allclose(np.asarray(banded), np.asarray(ref),
                               rtol=2e-5, atol=atol)


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["direct", "progressive"])
def test_banded_forward_parity_float64(cornell, progressive):
    """Decisive band-slicing correctness check: in float64 the α-solve
    amplification vanishes and banded ≡ single-pass to ~1e-10 (measured
    1.3e-13). An indexing/halo bug is dtype-independent and would fail
    this hard."""
    h, w = HW
    feats = _mis_feats(ray_trace_mode=RayTraceMode.ROMIS,
                       use_progressive_romis=progressive,
                       max_iterations_mis=3)
    inj = _make_inject(cornell, feats)

    with jax.enable_x64():
        def to64(x):
            return jax.tree.map(
                lambda a: a.astype(np.float64)
                if hasattr(a, "dtype") and a.dtype == np.float32 else a, x)

        geo, li = to64(cornell.geometry), to64(cornell.lights)
        cam, inj64 = to64(_cam()), to64(inj)
        args = (jax.random.PRNGKey(0), cam, geo, li, cornell.num_lights,
                h, w, feats)
        ref = np.asarray(jax.jit(
            lambda k, c, g, l_, i_: render_romis(
                k, c, g, l_, cornell.num_lights, h, w, feats, inject=i_))(
            jax.random.PRNGKey(0), cam, geo, li, inj64))
        banded = np.asarray(jax.jit(
            lambda k, c, g, l_, i_: render_mis_banded(
                k, c, g, l_, cornell.num_lights, h, w, feats,
                n_bands=N_BANDS, inject=i_))(
            jax.random.PRNGKey(0), cam, geo, li, inj64))
    np.testing.assert_allclose(banded, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize(
    "feats",
    [f for n, f in MIS_CONFIGS if n in ("rmis_balance", "romis_direct")],
    ids=["rmis_balance", "romis_direct"])
def test_banded_grad_matches_single_pass_with_injection(cornell, feats):
    """Same injected computation ⇒ the banded backward must reproduce the
    whole-frame backward (the injected reservoirs are constants; gradients
    flow through ctx, gathers, colvec/MIS weights and shading)."""
    h, w = HW
    inj = _make_inject(cornell, feats)
    params = extract_params(cornell.geometry, cornell.lights)
    target = jnp.zeros(HW + (3,))

    def loss(p, banded):
        geometry, lights = apply_params(cornell.geometry, cornell.lights, p)
        args = (jax.random.PRNGKey(0), _cam(), geometry, lights,
                cornell.num_lights, h, w, feats)
        if banded:
            img = render_mis_banded(*args, n_bands=N_BANDS, inject=inj)
        elif feats.ray_trace_mode == RayTraceMode.RMIS:
            img = render_rmis(*args, inject=inj)
        else:
            img = render_romis(*args, inject=inj)
        return jnp.mean((img - target) ** 2)

    g_ref = jax.grad(lambda p: loss(p, False))(params)
    g_band = jax.grad(lambda p: loss(p, True))(params)
    for name in vars(g_ref):
        a, b = np.asarray(getattr(g_ref, name)), \
            np.asarray(getattr(g_band, name))
        assert np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=2e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize(
    "feats", [f for _, f in MIS_CONFIGS], ids=[n for n, _ in MIS_CONFIGS])
def test_banded_light_color_grad_matches_finite_difference(cornell, feats):
    """No injection: band-local RNG. The banded loss must be FD-consistent
    with its own AD gradient (the 1080p production configuration)."""
    h, w = HW
    params = extract_params(cornell.geometry, cornell.lights)
    target = jnp.zeros(HW + (3,))
    args = (target, jax.random.PRNGKey(0), _cam(), cornell.geometry,
            cornell.lights, cornell.num_lights, h, w, feats, N_BANDS)
    loss_fn = jax.jit(lambda p: mis_banded_l2_loss(p, *args))
    g = jax.jit(jax.grad(loss_fn))(params)
    for name in vars(g):
        assert np.isfinite(np.asarray(getattr(g, name))).all(), name

    eps = 3e-3 if feats.use_progressive_romis else 1e-3
    base = np.asarray(params.light_c0)
    d = np.zeros_like(base)
    d[0, 1] = eps
    fd = (float(loss_fn(params.replace(light_c0=jnp.asarray(base + d))))
          - float(loss_fn(params.replace(light_c0=jnp.asarray(base - d))))
          ) / (2 * eps)
    ad = float(np.asarray(g.light_c0)[0, 1])
    assert abs(fd - ad) <= 3e-2 * max(abs(fd), abs(ad), 1e-3), (fd, ad)
