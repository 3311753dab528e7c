"""R-OMIS: reservoir-based optimal multiple importance sampling.

Reference: renderROMIS (src/rendering/render.cpp:121-265). Per pixel, a
(D+1)×(D+1) technique matrix A and one contribution vector b per color
channel accumulate over iterations; the optimal per-technique weights α solve
A α = b (minimum-norm least squares — the reference uses Eigen's
completeOrthogonalDecomposition, render_utils.h:52; we use a
Tikhonov-regularised unrolled plane Cholesky, see solve_alpha). The final pixel value is the sum of α components (direct
estimator, render.cpp:234-264) or a running progressive estimate
(render.cpp:159-204).

Per-sample math (render.cpp:168-219):
- colVecW[j] = 1 / W'_j  where W'_j is the *mock* unbiased contribution
  weight of the sample under technique j
  (arbitraryUnbiasedContributionWeightReciprocal, render_utils.cpp:245-257):
  W'_j = (1/p̂_j) (1/M_j[k]) (wSum_j[k] − chosenW_j[k] + p̂_j·|lights|)
- scale = 1 / (FLT_MIN + Σ_j K·colVecW[j]);  ŵ = scale·colVecW
- A += ŵ ŵᵀ;  b_c += scale·ŵ·f_c   (yes, scale enters b twice — faithful to
  render.cpp:205-218)

Bug fixed vs reference: ``fractionOfTotalSamples`` is integer division
K/(D+1) = 0 in C++ (render.cpp:139), which makes the progressive estimator
divide by FLT_MIN; we use the float ratio.

Layout: image-minor throughout — A stays [D1, D1, H, W] even through the
solve (no hw-major transposes; see solve_alpha's docstring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features
from ..core.vec import e
from ..ops.shading import exposure_tone_mapping
from ..ops.wrs import gen_canonical_samples, visibility
from .neighbours import select_neighbour_indices
from .restir import trace_primary
from .rmis import FLT_MIN, PH_ITER, PH_NEIGHBOURS, _gather_neighbourhood


def _colvec_for_samples(nb, nbhd_ctx, num_lights, features):
    """colVecW for every (distribution d, lane k) sample evaluated under
    every technique j. Returns colvec [J, D1, K, H, W]. Unrolled over
    (j, d) on scalar component planes (ops/shading.target_pdf_planes):
    the vector-axis broadcast form materialised [J, K, 3, H, W]
    Phong temporaries per d — the dominant cost of an R-OMIS iteration.
    ``nbhd_ctx``: pre-gathered fields [D1, ..., H, W] or a callable
    j → ShadeCtx (streamed gathers, see rmis.balance_heuristic_weights)."""
    from ..ops.shading import target_pdf_planes, target_pdf_planes_analytic
    from .rmis import ctx_j_getter

    tp = (target_pdf_planes_analytic if features.analytic_phong_vjp
          else target_pdf_planes)
    d1 = nb.pos.shape[0]
    get_j = ctx_j_getter(nbhd_ctx)

    # The technique axis j runs as a lax.scan with a checkpointed step: the
    # scan's SEQUENTIAL backward bounds reverse-mode memory to one j's
    # Phong residuals (a Python loop over j lets XLA schedule all six
    # rematerialised row-backwards concurrently — tens of GB at 1080p;
    # see render_romis's gradient-path notes).
    p_, c_ = nb.pos, nb.color
    comps = (p_[:, :, 0], p_[:, :, 1], p_[:, :, 2],
             c_[:, :, 0], c_[:, :, 1], c_[:, :, 2])  # each [D1, K, H, W]

    def row_step(_, j):
        ctx_j = get_j(j)
        w_sum_j = jax.lax.dynamic_index_in_dim(nb.w_sum, j, 0, False)
        chosen_j = jax.lax.dynamic_index_in_dim(nb.chosen_w, j, 0, False)
        m_j = jax.lax.dynamic_index_in_dim(nb.m, j, 0, False)
        px, py, pz, cr, cg, cb = comps
        outs = []
        for d in range(d1):
            p_hat = tp(
                ctx_j, px[d], py[d], pz[d], cr[d], cg[d], cb[d],
                features)  # [K, H, W]
            mock_w = p_hat * float(num_lights)
            # Grad-safe p̂ gate: colvec ≈ p̂·M/(wSum−chosen) → 0 as p̂ → 0,
            # so gating at 1e-18 instead of 0 changes nothing measurable —
            # but 1/max(p̂, 1e-37) has backward −1/p̂² = inf for p̂ ~1e-30,
            # and the masked inf NaN-poisoned progressive vertex grads.
            ok_p = p_hat > 1e-18
            inv_p = jnp.where(ok_p, 1.0 / jnp.where(ok_p, p_hat, 1.0), 0.0)
            w_prime = (
                inv_p
                * (1.0 / jnp.maximum(m_j, 1e-37))
                * (w_sum_j - chosen_j + mock_w)
            )
            ok_w = ok_p & (jnp.abs(w_prime) > 1e-37)
            outs.append(jnp.where(
                ok_w, 1.0 / jnp.where(ok_w, w_prime, 1.0), 0.0,
            ))  # [K, H, W]
        return 0.0, jnp.stack(outs)  # [D1, K, H, W]

    _, rows = jax.lax.scan(jax.checkpoint(row_step), 0.0,
                           jnp.arange(d1))
    return rows  # [J, D1, K, H, W]


def _colvec_rows(nb, nbhd_ctx, num_lights, features):
    """List-mode colvec for the BAND-SEQUENTIAL backward (diff/banded.py):
    Python loop over j with a per-j checkpointed term → a LIST over j of
    [D1, K, h, w] rows, same math as _colvec_for_samples.

    Why a second formulation exists: the lax.scan form's stacked
    [J, D1, K, H, W] output is sliced per (j, d, k) by the A/b consumer,
    and each slice's transpose is a pad-add into a [J, D1·K, H, W]
    cotangent buffer (569 MB per instance at 1080p — the round-4 OOM
    driver). At band shapes (H/8 rows) the per-j rows fit concurrently, the
    stacking (and its pads) disappears, and the A/b accumulation can run as
    axis-reductions whose transpose is a broadcast
    (scripts/mis_grad_micro.py: ab 47 ms → see perf_artifacts). Full-frame
    paths must keep the scan form (its sequential backward is what bounds
    whole-frame memory)."""
    from ..ops.shading import target_pdf_planes, target_pdf_planes_analytic
    from .rmis import ctx_j_getter

    tp = (target_pdf_planes_analytic if features.analytic_phong_vjp
          else target_pdf_planes)
    d1 = nb.pos.shape[0]
    get_j = ctx_j_getter(nbhd_ctx)
    p_, c_ = nb.pos, nb.color
    comps = (p_[:, :, 0], p_[:, :, 1], p_[:, :, 2],
             c_[:, :, 0], c_[:, :, 1], c_[:, :, 2])  # each [D1, K, h, w]

    @jax.checkpoint
    def term(ctx_j, w_sum_j, chosen_j, m_j, px, py, pz, cr, cg, cb):
        outs = []
        for d in range(d1):
            p_hat = tp(
                ctx_j, px[d], py[d], pz[d], cr[d], cg[d], cb[d],
                features)  # [K, h, w]
            mock_w = p_hat * float(num_lights)
            # Same grad-safe gates as _colvec_for_samples (see its notes).
            ok_p = p_hat > 1e-18
            inv_p = jnp.where(ok_p, 1.0 / jnp.where(ok_p, p_hat, 1.0), 0.0)
            w_prime = (
                inv_p
                * (1.0 / jnp.maximum(m_j, 1e-37))
                * (w_sum_j - chosen_j + mock_w)
            )
            ok_w = ok_p & (jnp.abs(w_prime) > 1e-37)
            outs.append(jnp.where(
                ok_w, 1.0 / jnp.where(ok_w, w_prime, 1.0), 0.0))
        return jnp.stack(outs)  # [D1, K, h, w]

    return [
        term(get_j(j), nb.w_sum[j], nb.chosen_w[j], nb.m[j], *comps)
        for j in range(d1)
    ]


def solve_alpha(a_mat, b_vec):
    """Batched least-squares α per channel via a Tikhonov-regularised
    Cholesky solve: α = (A + λI)⁻¹ b with λ = 1e-6·tr(A)/D1.

    A = Σ ŵŵᵀ is symmetric PSD and b = Σ(scale·f)ŵ lies in range(A) by
    construction, so the ridge solution converges to the min-norm
    least-squares α as λ→0 — the same target as the reference's Eigen
    completeOrthogonalDecomposition (render_utils.h:52).

    The (D1)³-unrolled Cholesky runs directly on the image-minor
    [.., H, W] planes: pure elementwise ops, no transposes, no linalg
    custom calls (pinv lowers to a batched SVD — an iterative,
    data-dependent while_loop — and jnp.linalg.solve to an hw-major
    transpose plus a batched LU)."""
    d1_n = a_mat.shape[0]
    tr = sum(a_mat[i, i] for i in range(d1_n))  # [H, W]
    lam = 1e-6 * tr / d1_n + 1e-20
    a = [[a_mat[i, j] + jnp.where(jnp.int32(i == j), lam, 0.0)
          for j in range(d1_n)] for i in range(d1_n)]

    # Cholesky A = L Lᵀ, unrolled. In exact arithmetic every pivot of
    # A + λI satisfies L[j][j]² ≥ λ_min ≥ λ, so flooring the pivot at
    # λ (not at machine tiny) bounds inv_diag by 1/√λ — cancellation
    # on near-singular pixels otherwise produced ~1e19 pivots whose
    # back-substitution overflowed to inf−inf = NaN.
    low = [[None] * d1_n for _ in range(d1_n)]
    inv_diag = [None] * d1_n
    for j in range(d1_n):
        s = a[j][j] - sum((low[j][k] * low[j][k] for k in range(j)),
                          start=jnp.zeros_like(lam))
        diag = jnp.sqrt(jnp.maximum(s, lam))
        low[j][j] = diag
        inv_diag[j] = 1.0 / diag
        for i in range(j + 1, d1_n):
            s = a[i][j] - sum(
                (low[i][k] * low[j][k] for k in range(j)),
                start=jnp.zeros_like(lam))
            low[i][j] = s * inv_diag[j]

    def solve_one(rhs):  # rhs: list of D1 [H, W] planes
        y = [None] * d1_n
        for i in range(d1_n):
            y[i] = (rhs[i] - sum(
                (low[i][k] * y[k] for k in range(i)),
                start=jnp.zeros_like(lam))) * inv_diag[i]
        x = [None] * d1_n
        for i in reversed(range(d1_n)):
            x[i] = (y[i] - sum(
                (low[k][i] * x[k] for k in range(i + 1, d1_n)),
                start=jnp.zeros_like(lam))) * inv_diag[i]
        return x

    alpha = jnp.stack([
        jnp.stack(solve_one([b_vec[c, i] for i in range(d1_n)]))
        for c in range(3)
    ])  # [3, D1, H, W]
    # Degenerate pixels (numerically rank-0 neighbourhoods) yield
    # meaningless α in ANY solver — the reference's Eigen COD returns
    # noise there too; zero is the defensible estimate.
    return jnp.where(jnp.isfinite(alpha), alpha, 0.0)


def romis_iteration_terms(ctx, nbhd_ctx, nb, alphas, num_lights, geometry,
                          features: Features):
    """One R-OMIS iteration's (ΔA [D1, D1, H, W], Δb [3, D1, H, W],
    progressive contribution [3, H, W]) from pre-gathered neighbourhood
    reservoirs ``nb`` (fields [D1, K, ..., H, W]) — render.cpp:168-219.
    ``alphas`` [3, D1, H, W] is only read in progressive mode. Shared by
    render_romis and the sharded row-band path (parallel/mis.py)."""
    colvec = _colvec_for_samples(nb, nbhd_ctx, num_lights, features)
    # colvec: [J, D1(d), K, H, W]
    return romis_ab_from_colvec(ctx, nb, colvec, alphas, geometry, features)


def romis_ab_from_colvec(ctx, nb, colvec, alphas, geometry,
                         features: Features):
    """The post-colvec half of an R-OMIS iteration: receiver shading f,
    scale/ŵ, ΔA/Δb accumulation and the progressive per-sample estimate
    (render.cpp:187-219). Split from romis_iteration_terms so the gradient
    path can checkpoint the colvec sweep and this stage as SIBLINGS with
    only colvec crossing the boundary (render_romis.iteration_update).

    ``colvec`` may be the stacked [J, D1, K, H, W] array
    (_colvec_for_samples) or the banded path's per-j LIST
    (_colvec_rows) — the list form computes A/b as axis-reductions over
    [D1, K, h, w] blocks (transpose = broadcast) instead of per-plane
    sums (transpose = 72 pad-adds into a [J, D1·K, H, W] buffer)."""
    if isinstance(colvec, (list, tuple)):
        return _romis_ab_rows(ctx, nb, colvec, alphas, geometry, features)
    d1 = nb.pos.shape[0]
    k_lanes = nb.pos.shape[1]
    height, width = nb.pos.shape[-2:]
    total_samples = float(d1 * k_lanes)
    frac = float(k_lanes) / float(d1)  # float fix of render.cpp:139

    # Shading of each (d, k) sample at the receiver (render.cpp:187-189)
    # via the planes-form phong (no [.., 3, H, W] temporaries).
    from ..ops.shading import phong_shade_planes, phong_shade_planes_analytic

    phong = (phong_shade_planes_analytic if features.analytic_phong_vjp
             else phong_shade_planes)
    p_, c_ = nb.pos, nb.color
    rgb = phong(
        ctx, p_[:, :, 0], p_[:, :, 1], p_[:, :, 2],
        c_[:, :, 0], c_[:, :, 1], c_[:, :, 2], features)
    shade = jnp.stack(rgb, axis=2)  # [D1, K, 3, H, W]
    vis = visibility(ctx.position, nb.pos, geometry)  # [D1, K, H, W]
    f = jnp.where(e(vis), shade, 0.0)  # [D1, K, 3, H, W]

    # scale = 1/(FLT_MIN + Σ_j K * colvec_j) (render.cpp:207-210),
    # grad-safe: the bare reciprocal's backward is −1/(...)² = inf when
    # Σcolvec ~1e-37 (see _colvec_for_samples' p̂ gate note). Forward is
    # EXACT for Σcolvec ≥ 1e-30.
    s_cv = jnp.sum(colvec, axis=0)  # [D1, K, H, W]
    ok_s = s_cv >= 1e-30
    scale = jnp.where(
        ok_s,
        1.0 / jnp.where(ok_s, FLT_MIN + float(k_lanes) * s_cv, 1.0),
        1.0 / FLT_MIN)  # [D1, K, H, W]
    w_hat = colvec * scale[None]  # [J, D1, K, H, W]

    # A += Σ_{d,k} ŵ ŵᵀ, b_c += Σ_{d,k} scale·ŵ·f_c
    # (render.cpp:212-218). UNROLLED plane sums, not einsums: XLA
    # lowers the (h, w)-batched dots with hw-major layouts whose {J, J}
    # minor dims pad to the (8,128) vreg tile — a 28x memory expansion
    # that OOMs at 1080p (and converts through bf16).
    wf = w_hat.reshape(d1, d1 * k_lanes, height, width)
    ws = (w_hat * scale[None]).reshape(d1, d1 * k_lanes, height, width)
    ff = f.reshape(d1 * k_lanes, 3, height, width)
    s_n = d1 * k_lanes
    a_upd = [[None] * d1 for _ in range(d1)]
    for i in range(d1):
        for j in range(i, d1):
            v = sum(wf[i, s] * wf[j, s] for s in range(s_n))
            a_upd[i][j] = v
            a_upd[j][i] = v
    a_delta = jnp.stack([jnp.stack(row) for row in a_upd])
    b_delta = jnp.stack([
        jnp.stack([sum(ws[j, s] * ff[s, c] for s in range(s_n))
                   for j in range(d1)])
        for c in range(3)])

    # ===== progressive per-sample estimate (render.cpp:191-204) =====
    prog = jnp.zeros((3, height, width))
    if features.use_progressive_romis:
        # sum_alpha_prod[d,k,c] = Σ_j α[c,j]·colvec[j,d,k], unrolled
        # over j for the same layout reason as A/b above.
        sum_alpha_prod = jnp.stack([
            sum(alphas[c, j][None, None] * colvec[j] for j in range(d1))
            for c in range(3)
        ], axis=2)  # [D1, K, 3, H, W]
        sum_frac = FLT_MIN + frac * jnp.sum(colvec, axis=0)  # [D1,K,H,W]
        # Grad-safe reciprocal: the FLT_MIN-only denominator is faithful to
        # render.cpp:197, but its backward computes 1/sum_frac² = inf in
        # f32, and 0·inf = NaN poisons vertex/position gradients. The
        # double-where keeps the forward EXACT for sum_frac ≥ 1e-30 (the
        # golden-oracle regime); below that the pixel is a >1e30 firefly
        # whose gradient is zeroed.
        ok = sum_frac >= 1e-30
        inv_sf = jnp.where(ok, 1.0 / jnp.where(ok, sum_frac, 1.0),
                           1.0 / FLT_MIN)[:, :, None]
        num = f - sum_alpha_prod
        # Degenerate samples (Σcolvec ≈ 0) keep their faithful ~1e38-scaled
        # VALUE but are detached: the huge multiplier otherwise overflows
        # every upstream cotangent (phong/shininess partials → inf → NaN).
        contrib = jnp.where(
            ok[:, :, None], num * inv_sf,
            jax.lax.stop_gradient(num * inv_sf))
        prog = jnp.sum(contrib, axis=(0, 1)) / total_samples
    return a_delta, b_delta, prog


def _romis_ab_rows(ctx, nb, rows, alphas, geometry, features: Features):
    """List-mode post-colvec half (see romis_ab_from_colvec docstring):
    identical estimator math on per-j [D1, K, h, w] blocks with
    axis-reductions. Shading stays as three separate channel planes (no
    [.., 3, h, w] stacking)."""
    d1 = nb.pos.shape[0]
    k_lanes = nb.pos.shape[1]
    height, width = nb.pos.shape[-2:]
    total_samples = float(d1 * k_lanes)
    frac = float(k_lanes) / float(d1)

    from ..ops.shading import phong_shade_planes, phong_shade_planes_analytic

    phong = (phong_shade_planes_analytic if features.analytic_phong_vjp
             else phong_shade_planes)
    p_, c_ = nb.pos, nb.color
    rgb = phong(
        ctx, p_[:, :, 0], p_[:, :, 1], p_[:, :, 2],
        c_[:, :, 0], c_[:, :, 1], c_[:, :, 2], features)
    vis = visibility(ctx.position, nb.pos, geometry)  # [D1, K, h, w]
    f_c = [jnp.where(vis, ch, 0.0) for ch in rgb]  # 3 x [D1, K, h, w]

    s_cv = sum(rows[1:], start=rows[0])  # [D1, K, h, w]
    ok_s = s_cv >= 1e-30
    scale = jnp.where(
        ok_s,
        1.0 / jnp.where(ok_s, FLT_MIN + float(k_lanes) * s_cv, 1.0),
        1.0 / FLT_MIN)
    w_hat = [r * scale for r in rows]  # per j

    a_upd = [[None] * d1 for _ in range(d1)]
    for i in range(d1):
        for j in range(i, d1):
            v = jnp.sum(w_hat[i] * w_hat[j], axis=(0, 1))  # [h, w]
            a_upd[i][j] = v
            a_upd[j][i] = v
    a_delta = jnp.stack([jnp.stack(row) for row in a_upd])
    b_delta = jnp.stack([
        jnp.stack([jnp.sum(w_hat[j] * scale * f_c[c], axis=(0, 1))
                   for j in range(d1)])
        for c in range(3)])

    prog = jnp.zeros((3, height, width))
    if features.use_progressive_romis:
        sum_frac = FLT_MIN + frac * s_cv  # [D1, K, h, w]
        ok = sum_frac >= 1e-30
        inv_sf = jnp.where(ok, 1.0 / jnp.where(ok, sum_frac, 1.0),
                           1.0 / FLT_MIN)
        chans = []
        for c in range(3):
            sap = sum((alphas[c, j][None, None] * rows[j]
                       for j in range(1, d1)),
                      start=alphas[c, 0][None, None] * rows[0])
            num = f_c[c] - sap
            contrib = jnp.where(ok, num * inv_sf,
                                jax.lax.stop_gradient(num * inv_sf))
            chans.append(jnp.sum(contrib, axis=(0, 1)) / total_samples)
        prog = jnp.stack(chans)
    return a_delta, b_delta, prog


def render_romis(
    key,
    cam: CameraParams,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
    return_alphas: bool = False,
    inject=None,  # (ny, nx, [Reservoirs per iteration]) — golden tests
):
    """Full R-OMIS render → tone-mapped image [H, W, 3] (and optionally the
    per-technique α images [D1, H, W, 3] — the reference's visualiseAlphas
    data, render_utils.cpp:189-243).

    ``inject`` feeds explicit neighbour coordinates and per-iteration
    canonical reservoirs (tests/test_golden_mis.py float64 oracle); it
    forces the XLA formulation."""
    d1 = features.num_neighbours_to_sample + 1
    k_lanes = features.num_samples_in_reservoir

    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features)
    if inject is not None:
        ny, nx = inject[0], inject[1]
    else:
        ny, nx = select_neighbour_indices(
            jax.random.fold_in(key, PH_NEIGHBOURS), ctx, height, width,
            features)

    a_mat = jnp.zeros((d1, d1, height, width))
    b_vec = jnp.zeros((3, d1, height, width))

    # ===== progressive-only state (render.cpp:144-151) =====
    final_colors = jnp.zeros((3, height, width))
    alphas = jnp.zeros((3, d1, height, width))

    solve = solve_alpha

    it_keys = jax.random.split(jax.random.fold_in(key, PH_ITER),
                               features.max_iterations_mis)

    # ===== gradient-path memory layout (diff/grad.py) =====
    # Iterations run as a lax.scan with a jax.checkpoint'ed body (same
    # shape as render_rmis): the scan's backward is inherently SEQUENTIAL,
    # so one iteration's rematerialised intermediates are live at a time.
    # Three measured failure modes shaped this:
    # - a Python accumulation loop (a_mat += ΔA) gives every iteration's
    #   backward an immediately-available cotangent, and XLA schedules all
    #   five rematerialised iteration-backwards CONCURRENTLY (~70 GB);
    # - nesting per-row checkpoints under an iteration checkpoint makes
    #   remat instantiate per-row tangent copies of the sample planes;
    # - [D1, K, 3, H, W] arrays crossing checkpoint/scan boundaries pick
    #   the (2,3)-minor 42.7x-padded layout. Component planes only.
    from types import SimpleNamespace

    def res_comp_planes(res):
        return dict(
            px=res.pos[:, 0], py=res.pos[:, 1], pz=res.pos[:, 2],
            cr=res.color[:, 0], cg=res.color[:, 1], cb=res.color[:, 2],
            w_sum=res.w_sum, chosen=res.chosen_w, m=res.m)  # [K, H, W] each

    def rebuild_nb(g):  # g: gathered comps, [D1, K, H, W] each
        return SimpleNamespace(
            pos=jnp.stack([g["px"], g["py"], g["pz"]], axis=2),
            color=jnp.stack([g["cr"], g["cg"], g["cb"]], axis=2),
            w_sum=g["w_sum"], chosen_w=g["chosen"], m=g["m"])

    use_rec = features.surrogate_resampling_grad and inject is None

    def iteration_update(it_key, ctx_, lights_, geometry_,
                         alphas_, res=None):
        """One iteration's (ΔA, Δb, progressive contribution)."""
        rec = None
        if res is None:
            if use_rec:
                from ..ops.wrs import gen_canonical_with_records

                res, rec = gen_canonical_with_records(
                    it_key, ctx_, lights_, num_lights, geometry_, features)
            else:
                res = gen_canonical_samples(it_key, ctx_, lights_,
                                            num_lights, geometry_, features)
        if rec is not None:
            # Replay-records gather (rmis.gather_nb_records): only
            # w_sum/chosen ride the differentiable gather; pos/color are
            # re-derived at the receiver, m is data.
            from .rmis import gather_nb_records

            gfn = lambda tr: _gather_neighbourhood(tr, ny, nx)  # noqa: E731
            pos, color, g_dif, g_det = gather_nb_records(
                gfn, rec, lights_,
                diff=dict(w_sum=res.w_sum, chosen=res.chosen_w),
                det=dict(m=res.m))
            nb = SimpleNamespace(pos=pos, color=color,
                                 w_sum=g_dif["w_sum"],
                                 chosen_w=g_dif["chosen"], m=g_det["m"])
        else:
            rc = res_comp_planes(res)
            nb = rebuild_nb(_gather_neighbourhood(rc, ny, nx))
        # Streamed slim per-j ctx gathers (rmis.slim_ctx_stream; j may be
        # a tracer inside the colvec sweep's scan — it slices dynamically).
        from .rmis import slim_ctx_stream

        nbhd_ctx_ = slim_ctx_stream(ctx_, ny, nx)
        return romis_iteration_terms(ctx_, nbhd_ctx_, nb, alphas_,
                                     num_lights, geometry_, features)

    progressive = features.use_progressive_romis

    if inject is not None:
        for iteration in range(features.max_iterations_mis):
            if (progressive and iteration >= 1
                    and iteration % features.progressive_update_mod == 0):
                alphas = solve(a_mat, b_vec)
            if progressive:
                final_colors = final_colors + jnp.sum(alphas, axis=1)
            a_delta, b_delta, prog = iteration_update(
                it_keys[iteration], ctx, lights, geometry, alphas,
                res=inject[2][iteration])
            a_mat = a_mat + a_delta
            b_vec = b_vec + b_delta
            if progressive:
                final_colors = final_colors + prog
    else:
        def body(carry, inp):
            a_mat, b_vec, final_colors, alphas = carry
            it_key, it_i = inp
            if progressive:
                # Refresh α on the reference's schedule (render.cpp:161-165)
                # as a traced select — the scan body is iteration-uniform.
                # The solve runs EVERY iteration (where-selected), so feed
                # it a well-conditioned matrix on unselected iterations:
                # iteration 0's all-zero A gives λ=1e-20 pivots whose
                # backward overflows to inf, and the where's zero cotangent
                # times inf NaN-poisons vertex/position gradients. When
                # ``do`` holds, a_safe == a_mat exactly.
                do = ((it_i >= 1)
                      & (it_i % features.progressive_update_mod == 0))
                bump = (1.0 - do.astype(jnp.float32))
                a_safe = a_mat + bump * jnp.eye(d1)[:, :, None, None]
                alphas = jnp.where(do, solve(a_safe, b_vec), alphas)
                final_colors = final_colors + jnp.sum(alphas, axis=1)
            a_d, b_d, prog = iteration_update(it_key, ctx, lights,
                                              geometry, alphas)
            if progressive:
                final_colors = final_colors + prog
            return (a_mat + a_d, b_vec + b_d, final_colors, alphas), None

        (a_mat, b_vec, final_colors, alphas), _ = jax.lax.scan(
            jax.checkpoint(body),
            (a_mat, b_vec, final_colors, alphas),
            (it_keys, jnp.arange(features.max_iterations_mis)))

    if progressive:
        color = final_colors / features.max_iterations_mis  # combineToScreen
        alpha_out = alphas
    else:
        alpha_out = solve(a_mat, b_vec)  # [3, D1, H, W]
        color = jnp.sum(alpha_out, axis=1)  # [3, H, W]

    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = jnp.moveaxis(color, 0, -1)
    if return_alphas:
        return image, jnp.moveaxis(alpha_out, 0, -1)  # [D1, H, W, 3]
    return image
