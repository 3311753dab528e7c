"""Exact per-pixel float64 golden oracles for R-MIS and R-OMIS iterations.

The statistical tests (test_rmis_romis.py) validate the estimator within a
12% band — a subtle scale/indexing bug could pass them. Here the canonical reservoirs and neighbour
coordinates enter as INJECTED shared data and everything downstream — the
per-sample MIS weights (equal and generalised balance), the R-OMIS colvec
(arbitraryUnbiasedContributionWeightReciprocal), scale/ŵ, the A/b
accumulation, the Tikhonov α solve, and the progressive estimator update —
is recomputed independently in float64 NumPy loops and compared per pixel.

Reference semantics: renderRMIS (src/rendering/render.cpp:64-119,
generalisedBalanceHeuristic render_utils.cpp:179-187), renderROMIS
(render.cpp:121-265, arbitraryUnbiasedContributionWeightReciprocal
render_utils.cpp:245-257).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from test_golden_frame import _Res, _oracle_p_hat, _oracle_visible
from romis.core.camera import make_camera, generate_rays
from romis.core.features import Features, MISWeight, RayTraceMode
from romis.ops.wrs import gen_canonical_samples
from romis.render.restir import trace_primary
from romis.render.rmis import FLT_MIN, render_rmis
from romis.render.romis import render_romis
from romis.scene.scene import load_prebuilt

H = W = 6
D = 2          # neighbours; D1 = 3 techniques
K = 2          # reservoir lanes
RADIUS = 2
ITERS = 2


@pytest.fixture(scope="module")
def setup():
    scene = load_prebuilt("cornell_box_parallelogram_light")
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(H, W))
    feats = Features(initial_light_samples=8, num_samples_in_reservoir=K,
                     num_neighbours_to_sample=D,
                     spatial_resample_radius=RADIUS,
                     max_iterations_mis=ITERS)
    key = jax.random.PRNGKey(7)

    rays = generate_rays(cam, H, W)
    _, ctx = trace_primary(rays, scene.geometry, feats)

    # Injected neighbour coordinates: self at d=0 (the reference's fixed
    # convention, neighbour_selection.cpp:38/75), random in-box otherwise.
    rows = jnp.arange(H, dtype=jnp.int32)[:, None]
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    offs = jax.random.randint(jax.random.fold_in(key, 1),
                              (2, D, H, W), -RADIUS, RADIUS + 1)
    ny = jnp.concatenate([jnp.broadcast_to(rows, (1, H, W)),
                          jnp.clip(rows[None] + offs[0], 0, H - 1)], axis=0)
    nx = jnp.concatenate([jnp.broadcast_to(cols, (1, H, W)),
                          jnp.clip(cols[None] + offs[1], 0, W - 1)], axis=0)

    # Injected canonical reservoirs: one independent draw per iteration
    # (their own generation is oracle-tested in test_wrs.py — shared data
    # here, exactly like the golden ReSTIR frame's canonical injection).
    res_list = [
        gen_canonical_samples(jax.random.fold_in(key, 10 + i), ctx,
                              scene.lights, scene.num_lights,
                              scene.geometry, feats)
        for i in range(max(ITERS, 3))
    ]

    octx = dict(
        pos=np.asarray(ctx.position, np.float64),
        normal=np.asarray(ctx.normal, np.float64),
        view=np.asarray(ctx.view_origin, np.float64),
        kd=np.asarray(ctx.kd, np.float64),
        ks=np.asarray(ctx.ks, np.float64),
        shin=np.asarray(ctx.shininess, np.float64),
        depth=np.asarray(ctx.depth_t, np.float64),
        valid=np.asarray(ctx.valid),
    )
    g = scene.geometry
    act = np.asarray(g.active)
    tris = [(np.asarray(g.v0[i], np.float64),
             np.asarray(g.e1[i], np.float64),
             np.asarray(g.e2[i], np.float64))
            for i in range(act.shape[0]) if act[i]]
    return dict(scene=scene, cam=cam, feats=feats, key=key, ctx=ctx,
                ny=np.asarray(ny), nx=np.asarray(nx),
                ny_j=ny, nx_j=nx, res_list=res_list,
                octx=octx, tris=tris,
                ores=[_Res(r) for r in res_list])


def _sample_fields(ores, d_coord, lane):
    """(pos, color, W, w_sum, chosen_w, m) of reservoir ``ores`` at
    neighbour coord ``d_coord`` = (yd, xd), lane ``lane``."""
    yd, xd = d_coord
    return (ores.pos[lane, :, yd, xd], ores.color[lane, :, yd, xd],
            ores.big_w[lane, yd, xd], ores.w_sum[lane, yd, xd],
            ores.chosen_w[lane, yd, xd], ores.m[lane, yd, xd])


def _shade_vis(s, octx, tris, y, x, pos, color):
    """vis × valid-gated Phong at the receiver (render.cpp:187-189)."""
    if not octx["valid"][y, x]:
        return np.zeros(3)
    if not _oracle_visible(tris, octx["pos"][:, y, x], pos):
        return np.zeros(3)
    return oracle.phong(pos, color, octx["view"][:, y, x],
                        octx["pos"][:, y, x], octx["normal"][:, y, x],
                        octx["kd"][:, y, x], octx["ks"][:, y, x],
                        octx["shin"][y, x])


def _tone(c, feats):
    return np.maximum(1.0 - np.exp(-feats.exposure * c), 0.0) \
        ** (1.0 / feats.gamma)


@pytest.mark.parametrize("weight", [MISWeight.EQUAL, MISWeight.BALANCE],
                         ids=["equal", "balance"])
def test_golden_rmis_iterations(setup, weight):
    s = setup
    feats = s["feats"].replace(ray_trace_mode=RayTraceMode.RMIS,
                               mis_weight_rmis=weight)
    img = np.asarray(render_rmis(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["scene"].num_lights, H, W, feats,
        inject=(s["ny_j"], s["nx_j"], s["res_list"][:ITERS])))

    d1 = D + 1
    ny, nx, octx, tris = s["ny"], s["nx"], s["octx"], s["tris"]
    oimg = np.zeros((H, W, 3))
    for y in range(H):
        for x in range(W):
            coords = [(ny[j, y, x], nx[j, y, x]) for j in range(d1)]
            acc = np.zeros(3)
            for it in range(ITERS):
                ores = s["ores"][it]
                for d in range(d1):
                    for lane in range(K):
                        pos, color, big_w, _, _, _ = _sample_fields(
                            ores, coords[d], lane)
                        f = _shade_vis(s, octx, tris, y, x, pos, color)
                        if weight == MISWeight.EQUAL:
                            mis_w = 1.0 / d1
                        else:
                            # generalisedBalanceHeuristic: p̂ at the
                            # receiver over Σ_j p̂ at each technique's own
                            # geometry (render_utils.cpp:179-187).
                            p_recv = _oracle_p_hat(octx, y, x, pos, color)
                            denom = FLT_MIN + sum(
                                _oracle_p_hat(octx, yj, xj, pos, color)
                                for yj, xj in coords)
                            mis_w = p_recv / denom
                        acc += mis_w * big_w * f / K
            oimg[y, x] = _tone(acc / ITERS, feats)

    np.testing.assert_allclose(img, oimg, rtol=1e-5, atol=1e-6)


def _oracle_romis(s, feats, iters):
    """Shared R-OMIS oracle: returns (alphas [3, D1, H, W], image [H, W, 3],
    cond [H, W] — condition number of the final regularised A) for
    direct/progressive per ``feats``."""
    d1 = D + 1
    ny, nx, octx, tris = s["ny"], s["nx"], s["octx"], s["tris"]
    L = float(s["scene"].num_lights)
    progressive = feats.use_progressive_romis
    frac = float(K) / float(d1)
    total_samples = float(d1 * K)

    def solve(a, b):
        # solve_alpha semantics: Tikhonov λ = 1e-6·tr/D1 + 1e-20, non-finite
        # α zeroed (render/romis.py solve_alpha).
        lam = 1e-6 * np.trace(a) / d1 + 1e-20
        try:
            al = np.linalg.solve(a + lam * np.eye(d1), b.T).T  # [3, D1]
        except np.linalg.LinAlgError:
            return np.zeros((3, d1))
        return np.where(np.isfinite(al), al, 0.0)

    alphas_out = np.zeros((3, d1, H, W))
    oimg = np.zeros((H, W, 3))
    cond = np.zeros((H, W))
    for y in range(H):
        for x in range(W):
            coords = [(ny[j, y, x], nx[j, y, x]) for j in range(d1)]
            a_mat = np.zeros((d1, d1))
            b_vec = np.zeros((3, d1))
            final = np.zeros(3)
            alphas = np.zeros((3, d1))
            for it in range(iters):
                if (progressive and it >= 1
                        and it % feats.progressive_update_mod == 0):
                    alphas = solve(a_mat, b_vec)
                if progressive:
                    final += alphas.sum(axis=1)
                ores = s["ores"][it]
                for d in range(d1):
                    for lane in range(K):
                        pos, color, _, _, _, _ = _sample_fields(
                            ores, coords[d], lane)
                        colvec = np.zeros(d1)
                        for j in range(d1):
                            yj, xj = coords[j]
                            p_hat = _oracle_p_hat(octx, yj, xj, pos, color)
                            _, _, _, w_sum_j, chosen_j, m_j = \
                                _sample_fields(ores, coords[j], lane)
                            w_prime = ((1.0 / max(p_hat, 1e-37))
                                       * (1.0 / max(m_j, 1e-37))
                                       * (w_sum_j - chosen_j + p_hat * L))
                            if p_hat > 0.0 and abs(w_prime) > 1e-37:
                                colvec[j] = 1.0 / w_prime
                        scale = 1.0 / (FLT_MIN + K * colvec.sum())
                        w_hat = scale * colvec
                        f = _shade_vis(s, octx, tris, y, x, pos, color)
                        a_mat += np.outer(w_hat, w_hat)
                        for c in range(3):
                            b_vec[c] += scale * w_hat * f[c]
                        if progressive:
                            sum_alpha_prod = alphas @ colvec  # [3]
                            sum_frac = FLT_MIN + frac * colvec.sum()
                            final += ((f - sum_alpha_prod) / sum_frac
                                      / total_samples)
            if progressive:
                color = final / iters
                alphas_out[:, :, y, x] = alphas
            else:
                al = solve(a_mat, b_vec)
                alphas_out[:, :, y, x] = al
                color = al.sum(axis=1)
            lam = 1e-6 * np.trace(a_mat) / d1 + 1e-20
            cond[y, x] = np.linalg.cond(a_mat + lam * np.eye(d1))
            oimg[y, x] = _tone(color, feats)
    return alphas_out, oimg, cond


def test_golden_romis_direct(setup):
    s = setup
    feats = s["feats"].replace(ray_trace_mode=RayTraceMode.ROMIS)
    img, alphas = render_romis(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["scene"].num_lights, H, W, feats, return_alphas=True,
        inject=(s["ny_j"], s["nx_j"], s["res_list"][:ITERS]))
    img = np.asarray(img)
    # alphas returned as [D1, H, W, 3] — reorder to the oracle's layout.
    al_pipe = np.transpose(np.asarray(alphas), (3, 0, 1, 2))  # [3,D1,H,W]

    o_alphas, oimg, cond = _oracle_romis(s, feats, ITERS)

    # The pixel estimate Σ_d α_d (= the image) must be EXACT: it is what the
    # estimator outputs, and it stays stable even when A is near-singular.
    np.testing.assert_allclose(img, oimg, rtol=1e-5, atol=1e-6)
    # Individual α components are solver-degenerate where A is
    # ill-conditioned (similar neighbourhoods make the colvecs nearly
    # collinear — A is dominantly rank-1 there, which is exactly why the
    # solve is Tikhonov-regularised; any solver returns noise in the null
    # directions, the reference's Eigen COD included). Compare per component
    # on the well-conditioned pixels; a quarter of this frame qualifies,
    # enough to keep the assertion meaningful.
    ok = cond < 1e4
    assert ok.mean() > 0.25, f"too few well-conditioned pixels: {ok.mean()}"
    np.testing.assert_allclose(al_pipe[:, :, ok], o_alphas[:, :, ok],
                               rtol=2e-3, atol=2e-4)


def test_golden_romis_progressive(setup):
    s = setup
    iters = 3
    feats = s["feats"].replace(ray_trace_mode=RayTraceMode.ROMIS,
                               use_progressive_romis=True,
                               max_iterations_mis=iters,
                               progressive_update_mod=1)
    img = np.asarray(render_romis(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["scene"].num_lights, H, W, feats,
        inject=(s["ny_j"], s["nx_j"], s["res_list"][:iters])))

    _, oimg, _ = _oracle_romis(s, feats, iters)
    np.testing.assert_allclose(img, oimg, rtol=1e-4, atol=1e-5)
