"""Weighted-reservoir-sampling core: selection law, bookkeeping, estimator
unbiasedness, and combine semantics. Image-minor layout: test pixels live on
a [1, N] grid; reservoir fields are [K, ..., 1, N], stacked inputs
[R, K, ..., 1, N]."""

import numpy as np
import jax
import jax.numpy as jnp

from romis.core.features import Features
from romis.core.types import Reservoirs
from romis.ops.shading import target_pdf
from romis.ops.wrs import (
    clamp_temporal_m, combine_biased, combine_unbiased, gen_canonical_samples,
    _lane_layout,
)
from romis.scene.lights import LightListBuilder
from romis.scene.scene import build_geometry
from romis.scene.objloader import SubMesh, Material

from helpers import make_ctx


def _flat_ctx(n, seed=5):
    """Surface points on z=0 plane facing +z, white diffuse."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate(
        [rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    return make_ctx(
        position=pos,
        normal=np.tile([[0.0, 0.0, 1.0]], (n, 1)),
        view_origin=np.tile([[0.0, 0.0, 3.0]], (n, 1)),
        kd=np.ones((n, 3)),
        ks=np.zeros((n, 3)),
        shininess=np.ones((n,)),
        depth_t=np.full((n,), 3.0),
    )


def _empty_geometry():
    sm = SubMesh(
        positions=np.zeros((3, 3), np.float32),
        normals=np.tile(np.array([0, 0, 1], np.float32), (3, 1)),
        texcoords=np.zeros((3, 2), np.float32),
        triangles=np.array([[0, 1, 2]], np.int32),
        material=Material(),
    )
    # Degenerate triangle → nothing ever occludes.
    return build_geometry([sm])


def _point_lights(positions, colors):
    b = LightListBuilder()
    for p, c in zip(positions, colors):
        b.add_point(p, c)
    return b.build(), len(b)


def test_lane_layout():
    sk, counts, real = _lane_layout(32, 2)
    assert sk == 16 and list(counts) == [16.0, 16.0] and real.all()
    sk, counts, real = _lane_layout(5, 2)
    assert sk == 3
    assert list(counts) == [3.0, 2.0]  # lane 0: j=0,2,4; lane 1: j=1,3


def test_ris_bookkeeping():
    """wSum = sum of candidate weights, M = candidates per lane, and
    W = wSum / (p_hat * M) — exact identities, not statistics."""
    n = 16
    ctx = _flat_ctx(n)
    lights, nl = _point_lights(
        [(0, 0, 2), (1, 1, 1), (-1, 0, 1.5)],
        [(1, 1, 1), (2, 0.5, 0.1), (0.3, 0.9, 0.2)],
    )
    feats = Features(initial_light_samples=8, num_samples_in_reservoir=2)
    geometry = _empty_geometry()
    res = gen_canonical_samples(jax.random.PRNGKey(0), ctx, lights, nl,
                                geometry, feats)
    m = np.asarray(res.m)  # [K, 1, N]
    np.testing.assert_allclose(m, 4.0)  # 8 candidates / 2 lanes
    np.testing.assert_allclose(np.asarray(res.total_m()), 8.0)

    # W identity where p_hat of the winner > 0.
    p_hat = np.asarray(target_pdf(ctx, res.pos, res.color, feats))
    w = np.asarray(res.big_w)
    ws = np.asarray(res.w_sum)
    nzero = p_hat > 0
    np.testing.assert_allclose(
        w[nzero], (ws / (np.maximum(p_hat, 1e-37) * m))[nzero], rtol=1e-4)


def test_wrs_selection_distribution():
    """The Gumbel-max lane winner is distributed ∝ candidate weight."""
    # One pixel at the origin, lights straight above at distances 1 and 2 →
    # p_hat ∝ dotNL/d² gives light 0 exactly 4x light 1's weight.
    ctx = _flat_ctx(1)
    ctx = ctx.replace(position=jnp.zeros((3, 1, 1)))
    lights, nl = _point_lights([(0, 0, 1), (0, 0, 2)], [(1, 1, 1), (1, 1, 1)])
    geometry = _empty_geometry()

    def picks_for(feats, trials, seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), trials)
        res = jax.vmap(
            lambda k: gen_canonical_samples(k, ctx, lights, nl, geometry,
                                            feats)
        )(keys)
        return np.asarray(res.pos)[:, 0, 2, 0, 0]  # z of lane-0 winner

    # With 1 candidate the pick is just the uniform light choice (50/50).
    feats = Features(initial_light_samples=1, num_samples_in_reservoir=1)
    picks = picks_for(feats, 4000, 0)
    assert 0.45 < (picks == 1.0).mean() < 0.55

    # With many candidates, RIS resamples toward the 4x-weight light:
    # P(pick light 0) → 4/(4+1) = 0.8.
    feats = Features(initial_light_samples=32, num_samples_in_reservoir=1)
    picks = picks_for(feats, 4000, 1)
    frac_near = (picks == 1.0).mean()
    assert 0.77 < frac_near < 0.83, frac_near


def test_ris_estimator_unbiased():
    """E[p_hat(y) * W] over the RIS draw equals sum over lights of p_hat —
    the defining property of the W weight (RIS / ReSTIR Eq. 6)."""
    n = 512  # many pixels = many independent replicates
    base = _flat_ctx(1)
    ctx = jax.tree.map(
        lambda a: jnp.repeat(a, n, axis=-1), base)
    lights, nl = _point_lights(
        [(0, 0, 1), (0.5, 0.5, 2), (-0.5, 0, 1.2)],
        [(1, 1, 1), (1, 0.2, 0.1), (0.1, 0.5, 1.0)],
    )
    feats = Features(initial_light_samples=4, num_samples_in_reservoir=2)
    geometry = _empty_geometry()

    # Integrand f = p_hat itself → estimate should equal Σ_lights p_hat.
    truth = 0.0
    for li in range(nl):
        lp = jnp.asarray(np.asarray(lights.v0)[li]).reshape(3, 1, 1)
        lc = jnp.asarray(np.asarray(lights.c0)[li]).reshape(3, 1, 1)
        truth += float(np.asarray(target_pdf(base, lp, lc, feats))[0, 0])

    est = []
    for t in range(30):
        res = gen_canonical_samples(jax.random.PRNGKey(t), ctx, lights, nl,
                                    geometry, feats)
        p_hat = target_pdf(ctx, res.pos, res.color, feats)
        est.append(np.asarray(jnp.sum(p_hat * res.big_w, axis=0) / res.k))
    est = np.concatenate([x.ravel() for x in est])
    rel_err = abs(est.mean() - truth) / truth
    assert rel_err < 0.02, (est.mean(), truth)


def _mk_res(pos, color, w_sum, m, big_w):
    """Build [R, K, ..., 1, N]-shaped stacked reservoirs from [N, R, K, ...]
    numpy arrays (test-friendly order)."""
    def tov(a):  # [N, R, K, 3] → [R, K, 3, 1, N]
        return jnp.asarray(np.transpose(a, (1, 2, 3, 0))[:, :, :, None, :])

    def tos(a):  # [N, R, K] → [R, K, 1, N]
        return jnp.asarray(np.transpose(a, (1, 2, 0))[:, :, None, :])

    return Reservoirs(
        pos=tov(np.asarray(pos, np.float32)),
        color=tov(np.asarray(color, np.float32)),
        w_sum=tos(np.asarray(w_sum, np.float32)),
        m=tos(np.asarray(m, np.float32)),
        big_w=tos(np.asarray(big_w, np.float32)),
        chosen_w=tos(np.zeros_like(np.asarray(w_sum, np.float32))),
    )


def test_combine_biased_bookkeeping():
    """M_out = Σ masked input M per lane; W = wSum/(p_hat·M) identity;
    masked-out inputs contribute nothing (reservoir.cpp:40-66)."""
    n, r, k = 8, 3, 2
    rng = np.random.default_rng(11)
    ctx = _flat_ctx(n)
    pos = rng.uniform(-1, 1, (n, r, k, 3)).astype(np.float32)
    pos[..., 2] = np.abs(pos[..., 2]) + 0.5  # in front of the plane
    color = rng.uniform(0.2, 1, (n, r, k, 3)).astype(np.float32)
    w_sum = rng.uniform(0, 5, (n, r, k)).astype(np.float32)
    m = rng.integers(1, 20, (n, r, k)).astype(np.float32)
    big_w = rng.uniform(0, 2, (n, r, k)).astype(np.float32)
    inputs = _mk_res(pos, color, w_sum, m, big_w)
    mask = rng.uniform(size=(n, r)) > 0.3
    mask[:, 0] = True
    mask_j = jnp.asarray(mask.T[:, None, :])  # [R, 1, N]
    feats = Features()

    out = combine_biased(jax.random.PRNGKey(0), ctx, inputs, mask_j, feats)
    want_m = (m * mask[..., None]).sum(axis=1)  # [N, K]
    got_m = np.asarray(out.m)[:, 0, :].T  # [N, K]
    np.testing.assert_allclose(got_m, want_m, rtol=1e-6)

    p_hat_in = np.asarray(target_pdf(ctx, inputs.pos, inputs.color, feats))
    # [R, K, 1, N] → [N, R, K]
    p_hat_in = np.transpose(p_hat_in[:, :, 0, :], (2, 0, 1))
    w_in = p_hat_in * big_w * m * mask[..., None]
    got_wsum = np.asarray(out.w_sum)[:, 0, :].T
    np.testing.assert_allclose(got_wsum, w_in.sum(axis=1), rtol=1e-4)

    p_hat_out = np.asarray(target_pdf(ctx, out.pos, out.color, feats))
    p_hat_out = p_hat_out[:, 0, :].T  # [N, K]
    w = np.asarray(out.big_w)[:, 0, :].T
    ok = p_hat_out > 0
    np.testing.assert_allclose(
        w[ok],
        (got_wsum / np.maximum(p_hat_out * want_m, 1e-37))[ok],
        rtol=1e-4)

    # The winner must be one of the *unmasked* input samples.
    sel = np.transpose(np.asarray(out.pos)[:, :, 0, :], (2, 0, 1))  # [N,K,3]
    for i in range(n):
        for lane in range(k):
            cands = pos[i, mask[i], lane]
            d = np.linalg.norm(cands - sel[i, lane], axis=-1)
            zero_w = w_in[i, :, lane][mask[i]].sum() == 0
            assert zero_w or d.min() < 1e-6


def test_combine_unbiased_z_count():
    """Z counts the per-lane M of inputs whose own p_hat at the winner is
    > 0 (fixing the reference's totalSampleNums over-normalization,
    reservoir.cpp:92 — see combine_unbiased docstring); with all inputs
    valid everywhere the unbiased and biased combines agree for any K."""
    rng = np.random.default_rng(3)
    geometry = _empty_geometry()
    feats = Features()
    key = jax.random.PRNGKey(0)

    def run(n, r, k):
        ctx = _flat_ctx(n)
        pos = rng.uniform(-1, 1, (n, r, k, 3)).astype(np.float32)
        pos[..., 2] = np.abs(pos[..., 2]) + 0.5
        color = rng.uniform(0.2, 1, (n, r, k, 3)).astype(np.float32)
        w_sum = rng.uniform(0.1, 5, (n, r, k)).astype(np.float32)
        m = rng.integers(1, 9, (n, r, k)).astype(np.float32)
        big_w = rng.uniform(0.1, 2, (n, r, k)).astype(np.float32)
        inputs = _mk_res(pos, color, w_sum, m, big_w)
        mask = jnp.ones((r, 1, n), bool)
        # Input ctxs: every input reservoir's own geometry = the same flat
        # plane points → p_hat > 0 at any sample in front of it.
        input_ctxs = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (r,) + a.shape), ctx)
        out_u = combine_unbiased(key, ctx, inputs, mask, input_ctxs,
                                 geometry, feats)
        out_b = combine_biased(key, ctx, inputs, mask, feats)
        return out_u, out_b, m

    out_u, out_b, _ = run(4, 2, 1)
    np.testing.assert_allclose(np.asarray(out_u.big_w),
                               np.asarray(out_b.big_w), rtol=1e-5)

    # K = 2: all inputs valid → Z equals the lane's own M → identical W.
    out_u, out_b, m = run(4, 2, 2)
    np.testing.assert_allclose(np.asarray(out_u.big_w),
                               np.asarray(out_b.big_w), rtol=1e-4)


def test_temporal_m_clamp():
    """render_utils.cpp:151-163 contract (float math)."""
    n, k = 2, 2
    prev = Reservoirs(
        pos=jnp.zeros((k, 3, 1, n)), color=jnp.zeros((k, 3, 1, n)),
        w_sum=jnp.asarray([[10.0, 1.0], [20.0, 1.0]]).reshape(k, 1, n),
        m=jnp.asarray([[100.0, 2.0], [300.0, 2.0]]).reshape(k, 1, n),
        big_w=jnp.zeros((k, 1, n)), chosen_w=jnp.zeros((k, 1, n)),
    )
    current_total = jnp.asarray([[2.0, 2.0]])  # bound = 20*2+1 = 41
    out = clamp_temporal_m(prev, current_total, 20.0)
    m = np.asarray(out.m)[:, 0, :]  # [K, N]
    ws = np.asarray(out.w_sum)[:, 0, :]
    # Pixel 0: total 400 > 41 → each lane clamped to 41, wSum scaled by 41/M.
    np.testing.assert_allclose(m[:, 0], [41.0, 41.0])
    np.testing.assert_allclose(ws[:, 0], [10.0 * 41 / 100, 20.0 * 41 / 300],
                               rtol=1e-6)
    # Pixel 1: total 4 ≤ 41 → untouched.
    np.testing.assert_allclose(m[:, 1], [2.0, 2.0])
    np.testing.assert_allclose(ws[:, 1], [1.0, 1.0])
