"""Phong shading / target PDF / tone mapping vs the NumPy oracle."""

import numpy as np
import jax.numpy as jnp

from romis.core.features import Features
from romis.ops.shading import (
    exposure_tone_mapping, phong_shade, target_pdf,
)

from helpers import make_ctx, pack_vec, unpack_vec, unpack_scalar, pack_scalar
from oracle import phong as oracle_phong


def _ctx(n, rng):
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return make_ctx(
        position=pos,
        normal=nrm,
        view_origin=rng.uniform(-3, 3, (n, 3)).astype(np.float32),
        kd=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        ks=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        shininess=rng.uniform(1, 30, (n,)).astype(np.float32),
    )


def test_phong_matches_oracle():
    rng = np.random.default_rng(0)
    n = 64
    ctx = _ctx(n, rng)
    lp = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    lc = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    feats = Features()
    got = unpack_vec(phong_shade(ctx, pack_vec(lp), pack_vec(lc), feats))
    pos = unpack_vec(ctx.position)
    nrm = unpack_vec(ctx.normal)
    vo = unpack_vec(ctx.view_origin)
    kd = unpack_vec(ctx.kd)
    ks = unpack_vec(ctx.ks)
    sh = unpack_scalar(ctx.shininess)
    for i in range(n):
        want = oracle_phong(lp[i], lc[i], vo[i], pos[i], nrm[i], kd[i],
                            ks[i], float(sh[i]))
        np.testing.assert_allclose(got[i], want, rtol=2e-3, atol=1e-5)


def test_phong_light_behind_is_zero():
    feats = Features()
    ctx = make_ctx(position=[[0, 0, 0]], normal=[[0, 0, 1]],
                   view_origin=[[0, 0, 2]], kd=[[1, 1, 1]], ks=[[1, 1, 1]],
                   shininess=[1.0])
    out = phong_shade(ctx, pack_vec([[0.0, 0.0, -1.0]]),
                      pack_vec([[1, 1, 1]]), feats)
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-7)


def test_phong_coincident_light_distance_clamp():
    """Distance < ZERO_EPSILON → treated as 1 (shading.cpp:31-33)."""
    feats = Features()
    ctx = make_ctx(position=[[0, 0, 0]], normal=[[0, 0, 1]],
                   view_origin=[[0, 0, 2]], kd=[[1, 1, 1]], ks=[[0, 0, 0]],
                   shininess=[1.0])
    out = np.asarray(phong_shade(ctx, pack_vec([[0, 0, 0]]),
                                 pack_vec([[1, 1, 1]]), feats))
    assert np.all(np.isfinite(out))


def test_invalid_pixels_shade_zero():
    rng = np.random.default_rng(1)
    ctx = _ctx(4, rng)
    ctx = ctx.replace(valid=jnp.zeros_like(ctx.valid))
    out = phong_shade(ctx, pack_vec(np.ones((4, 3))),
                      pack_vec(np.ones((4, 3))), Features())
    np.testing.assert_allclose(np.asarray(out), 0.0)
    p = target_pdf(ctx, pack_vec(np.ones((4, 3))),
                   pack_vec(np.ones((4, 3))), Features())
    np.testing.assert_allclose(np.asarray(p), 0.0)


def test_disable_shading_returns_kd():
    rng = np.random.default_rng(2)
    ctx = _ctx(4, rng)
    feats = Features(enable_shading=False)
    out = phong_shade(ctx, pack_vec(np.ones((4, 3))),
                      pack_vec(np.ones((4, 3))), feats)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ctx.kd), rtol=1e-6)


def test_target_pdf_is_norm():
    rng = np.random.default_rng(3)
    ctx = _ctx(8, rng)
    lp = pack_vec(rng.uniform(-2, 2, (8, 3)).astype(np.float32))
    lc = pack_vec(np.ones((8, 3), np.float32))
    feats = Features()
    shade = np.asarray(phong_shade(ctx, lp, lc, feats))
    p = np.asarray(target_pdf(ctx, lp, lc, feats))
    np.testing.assert_allclose(p, np.linalg.norm(shade, axis=0), rtol=1e-5)


def test_shading_broadcasts_leading_sample_axes():
    """Samples [S, 3, H, W] against ctx [3, H, W]."""
    rng = np.random.default_rng(4)
    n, s = 6, 4
    ctx = _ctx(n, rng)
    lp = rng.uniform(-2, 2, (s, n, 3)).astype(np.float32)
    lp_packed = jnp.asarray(lp.transpose(0, 2, 1)[:, :, None, :])  # [S,3,1,N]
    lc = jnp.ones((s, 3, 1, n))
    out = np.asarray(phong_shade(ctx, lp_packed, lc, Features()))
    assert out.shape == (s, 3, 1, n)
    for i in range(s):
        one = np.asarray(phong_shade(ctx, lp_packed[i], lc[i], Features()))
        np.testing.assert_allclose(out[i], one, rtol=1e-6)


def test_tone_mapping():
    """1 - exp(-exposure*c), then pow(c, 1/gamma) (tone_mapping.cpp:8-11)."""
    feats = Features(exposure=1.5, gamma=2.0)
    c = jnp.asarray([[0.0, 0.5, 10.0]])
    out = np.asarray(exposure_tone_mapping(c, feats))
    want = (1.0 - np.exp(-1.5 * np.array([0.0, 0.5, 10.0]))) ** 0.5
    np.testing.assert_allclose(out[0], want, rtol=1e-5)


def test_planes_forms_match_vector_forms():
    """target_pdf_planes / sample_lights_planes (the scan-friendly scalar
    component forms used by the gradient path) must match the vector-axis
    originals."""
    import jax
    import jax.numpy as jnp
    from romis.core.features import Features
    from romis.ops.shading import target_pdf, target_pdf_planes
    from romis.scene.lights import (
        LightListBuilder, sample_lights, sample_lights_planes,
    )
    from helpers import random_reservoirs_and_ctx

    rng = np.random.default_rng(11)
    h, w, k = 24, 130, 2
    _, ctx = random_reservoirs_and_ctx(rng, h, w, k)

    b = LightListBuilder()
    b.add_parallelogram((0.3, 2.0, 0.1), (0.4, 0, 0), (0, 0, 0.4),
                        (1.0, 0.9, 0.8), (0.5, 0.5, 0.5),
                        (0.2, 0.4, 0.6), (0.1, 0.1, 0.1))
    b.add_point((1.0, 1.5, -0.5), (2.0, 2.0, 2.0))
    b.add_segment((0, 1, 0), (1, 1, 0), (1, 0, 0), (0, 0, 1))
    lights = b.build()

    idx = jnp.asarray(rng.integers(0, len(b), (k, h, w)).astype(np.int32))
    u = jnp.asarray(rng.uniform(size=(k, h, w)).astype(np.float32))
    v = jnp.asarray(rng.uniform(size=(k, h, w)).astype(np.float32))

    pos, color = sample_lights(lights, idx, u, v)
    px, py, pz, cr, cg, cb = sample_lights_planes(lights, idx, u, v)
    np.testing.assert_allclose(np.asarray(pos),
                               np.stack([px, py, pz], axis=1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(color),
                               np.stack([cr, cg, cb], axis=1), rtol=1e-6)

    for feats in (Features(), Features(enable_shading=False)):
        a = np.asarray(target_pdf(ctx, pos, color, feats))
        bb = np.asarray(target_pdf_planes(ctx, px, py, pz, cr, cg, cb,
                                          feats))
        np.testing.assert_allclose(bb, a, rtol=2e-5, atol=1e-7)
