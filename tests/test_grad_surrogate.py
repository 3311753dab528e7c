"""Winner-replay surrogate RIS gradient (Features.surrogate_resampling_grad):
values must be BIT-IDENTICAL to the exact path, and the gradient estimator
must be unbiased for the exact autodiff gradient (paired statistical test —
the surrogate shares the exact path's candidates and primary winner, so the
difference is purely the second-race w_sum term)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import generate_rays, make_camera
from romis.core.features import Features
from romis.ops.wrs import gen_canonical_samples
from romis.render.restir import trace_primary
from romis.scene.lights import LightListBuilder
from romis.scene.scene import load_prebuilt

HW = (12, 12)


def _setup():
    scene = load_prebuilt("cornell_box_parallelogram_light")
    # Several distinct lights so the light-pick index actually varies.
    b = LightListBuilder()
    b.add_parallelogram((-0.3, 0.55, -0.3), (0.25, 0, 0), (0, 0, 0.25),
                        (4, 3, 2), (3, 4, 2), (2, 3, 4), (4, 2, 3))
    b.add_parallelogram((0.1, 0.55, 0.0), (0.2, 0, 0), (0, 0, 0.2),
                        (1, 5, 1), (1, 5, 1), (5, 1, 1), (1, 1, 5))
    b.add_point((0.0, 0.3, 0.0), (2, 2, 2))
    b.add_segment((-0.5, 0.1, -0.5), (0.5, 0.1, -0.5), (1, 2, 3), (3, 2, 1))
    lights = b.build()
    nl = len(b)

    h, w = HW
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=HW)
    feats = Features(initial_light_samples=8, spatial_reuse=False,
                     temporal_reuse=False, enable_tone_mapping=False)
    rays = generate_rays(cam, h, w)
    _, ctx = trace_primary(rays, scene.geometry, feats)
    return ctx, lights, nl, scene.geometry, feats


def _loss_fn(feats, ctx, lights, nl, geometry, proj):
    def loss(rows, kd, key):
        li = lights.replace(rows=rows)
        cx = ctx.replace(kd=kd)
        res = gen_canonical_samples(key, cx, li, nl, geometry, feats)
        return (jnp.sum(res.big_w * proj[0])
                + jnp.sum(res.pos * proj[1])
                + jnp.sum(res.color * proj[2])
                + jnp.sum(res.chosen_w * proj[3]))

    return loss


def test_surrogate_values_identical():
    """Same candidates, same primary winner, same reservoir values — up to
    XLA fusion-level float reassociation (~1 ulp) in the recomputed
    winner attributes."""
    ctx, lights, nl, geometry, feats = _setup()
    key = jax.random.PRNGKey(3)
    exact = gen_canonical_samples(key, ctx, lights, nl, geometry, feats)
    surr = gen_canonical_samples(
        key, ctx, lights, nl, geometry,
        feats.replace(surrogate_resampling_grad=True))
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(exact, f)), np.asarray(getattr(surr, f)),
            rtol=1e-6, atol=1e-7, err_msg=f)


def test_replay_kernel_surrogate_tail_interpret():
    """The surrogate tail, fed a fixed replay (every candidate is light 0
    at its (0,0) corner), reconstructs the closed-form reservoir, and
    gradients flow through the tail into the light table."""
    from romis.ops.shading import target_pdf
    from romis.ops.wrs import _lane_layout, _surrogate_tail

    import sys
    sys.path.insert(0, "tests")
    from helpers import random_reservoirs_and_ctx

    h, w, k = 40, 150, 2
    feats = Features()
    _, ctx = random_reservoirs_and_ctx(np.random.default_rng(4), h, w, k)
    b = LightListBuilder()
    b.add_parallelogram((0.3, 2.0, 0.1), (0.4, 0, 0), (0, 0, 0.4),
                        (1.0, 0.9, 0.8), (0.5, 0.5, 0.5),
                        (0.2, 0.4, 0.6), (0.1, 0.1, 0.1))
    b.add_point((1.0, 1.5, -0.5), (2.0, 2.0, 2.0))
    lights = b.build()
    nl = len(b)
    _, lane_counts, _ = _lane_layout(feats.initial_light_samples, k)

    pos0 = np.asarray(lights.rows[0, 0:3])
    col0 = np.asarray(lights.rows[0, 9:12])
    pos = jnp.broadcast_to(jnp.asarray(pos0)[:, None, None], (3, h, w))
    col = jnp.broadcast_to(jnp.asarray(col0)[:, None, None], (3, h, w))
    p_hat = np.asarray(target_pdf(ctx, pos, col, feats))
    w_cand = p_hat * nl
    w_sum = jnp.asarray(np.asarray(lane_counts)[:, None, None] * w_cand)
    zero = jnp.zeros((k, h, w))
    r1 = r2 = (zero, zero, zero)  # (light index, u1, u2) of the winner

    def tail_loss(rows):
        li = lights.replace(rows=rows)
        res = _surrogate_tail(ctx, li, nl, None, feats, lane_counts,
                              w_sum, r1, r2)
        return jnp.sum(res.big_w), res

    (_, res), g = jax.value_and_grad(tail_loss, has_aux=True)(lights.rows)

    for lane in range(k):
        cnt = float(lane_counts[lane])
        np.testing.assert_allclose(np.asarray(w_sum[lane]), cnt * w_cand,
                                   rtol=2e-4, atol=1e-5)
        sel = (w_cand > 0)[None]
        np.testing.assert_allclose(
            np.asarray(res.pos[lane]) * sel, np.asarray(pos) * sel,
            rtol=1e-5, atol=1e-6)
        cond = p_hat > 0
        expect_bw = np.where(cond, cnt * w_cand
                             / np.where(cond, p_hat * cnt, 1.0), 0.0)
        np.testing.assert_allclose(np.asarray(res.big_w[lane]), expect_bw,
                                   rtol=2e-3, atol=1e-4)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g[0]).max() > 0  # light 0 receives gradient
    assert np.abs(g[1:]).max() == 0  # never sampled → no gradient


def test_surrogate_gradient_unbiased():
    ctx, lights, nl, geometry, feats = _setup()
    h, w = HW
    k = feats.num_samples_in_reservoir
    pk = jax.random.split(jax.random.PRNGKey(11), 4)
    proj = (jax.random.normal(pk[0], (k, h, w)),
            jax.random.normal(pk[1], (k, 3, h, w)),
            jax.random.normal(pk[2], (k, 3, h, w)),
            jax.random.normal(pk[3], (k, h, w)))

    loss_e = _loss_fn(feats, ctx, lights, nl, geometry, proj)
    loss_s = _loss_fn(feats.replace(surrogate_resampling_grad=True),
                      ctx, lights, nl, geometry, proj)
    grad_e = jax.jit(jax.grad(loss_e, argnums=(0, 1)))
    grad_s = jax.jit(jax.grad(loss_s, argnums=(0, 1)))

    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    ge_rows, ge_kd = jax.vmap(lambda kk: grad_e(lights.rows, ctx.kd, kk))(keys)
    gs_rows, gs_kd = jax.vmap(lambda kk: grad_s(lights.rows, ctx.kd, kk))(keys)

    for name, de, ds in (("rows", ge_rows, gs_rows), ("kd", ge_kd, gs_kd)):
        diff = np.asarray(ds - de).reshape(len(keys), -1)
        mean = diff.mean(axis=0)
        stderr = diff.std(axis=0) / np.sqrt(len(keys))
        scale = np.abs(np.asarray(de).reshape(len(keys), -1)).mean() + 1e-6
        # Paired mean difference compatible with zero: within 5 stderr plus
        # a small absolute slack relative to typical gradient magnitude.
        bad = np.abs(mean) > 5.0 * stderr + 1e-3 * scale
        assert not bad.any(), (
            name, int(bad.sum()), float(np.abs(mean).max()),
            float(stderr.max()))


# ---------------------------------------------------------------------------
# Spatial-race winner-replay surrogate (ops/wrs.combine_biased_surrogate)
# ---------------------------------------------------------------------------

def _combine_setup(rng_seed=8, r=4):
    import sys
    sys.path.insert(0, "tests")
    from helpers import random_reservoirs_and_ctx

    h, w = HW
    feats = Features(enable_tone_mapping=False)
    k = feats.num_samples_in_reservoir
    rng = np.random.default_rng(rng_seed)
    _, recv = random_reservoirs_and_ctx(rng, h, w, k)
    stacks = [random_reservoirs_and_ctx(rng, h, w, k)[0] for _ in range(r)]
    inputs = jax.tree.map(lambda *a: jnp.stack(a, axis=0), *stacks)
    in_mask = jnp.asarray(rng.uniform(size=(r, h, w)) < 0.8)
    return feats, recv, inputs, in_mask


def test_spatial_surrogate_values_identical():
    """combine_biased_surrogate shares the exact path's primary gumbel, so
    every output value matches combine_biased bit-for-bit (up to fusion
    reassociation in the re-evaluated winner attributes)."""
    from romis.ops.wrs import combine_biased, combine_biased_surrogate

    feats, recv, inputs, in_mask = _combine_setup()
    key = jax.random.PRNGKey(5)
    exact = combine_biased(key, recv, inputs, in_mask, feats)
    surr = combine_biased_surrogate(key, recv, inputs, in_mask, feats)
    for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(exact, f)), np.asarray(getattr(surr, f)),
            rtol=1e-5, atol=1e-6, err_msg=f)


def test_spatial_surrogate_gradient_unbiased_exact():
    """EXACT unbiasedness identity (no statistics): forcing the second race
    to input j (gumbel2 injection) and weighting each cell's surrogate
    gradient by P(J'=j) = w_j / w_sum must reproduce the exact autodiff
    gradient componentwise —

        sum_j P_j * grad_surrogate(win2=j)  ==  grad_exact

    because E_J'[(w_sum/w_J') dw_J'] telescopes to sum_j dw_j. Input-array
    gradients decompose per (lane, pixel) cell, so the per-cell P_j
    weighting applies directly to the gradient components. Cells whose
    w_sum is 0 get no correction from any j (ratio = 0): the leftover
    (1 - sum_j P_j) weight goes to any forced j (they all agree there)."""
    from romis.ops.wrs import (
        _stream_weights, combine_biased, combine_biased_surrogate,
    )

    feats, recv, inputs, in_mask = _combine_setup()
    h, w = HW
    k = feats.num_samples_in_reservoir
    r = int(inputs.m.shape[0])
    pk = jax.random.split(jax.random.PRNGKey(12), 3)
    proj = (jax.random.normal(pk[0], (k, h, w)),
            jax.random.normal(pk[1], (k, 3, h, w)),
            jax.random.normal(pk[2], (k, h, w)))
    key = jax.random.PRNGKey(5)

    def loss_with(combine, **kw):
        def loss(in_pos, in_color, in_big_w):
            ins = inputs.replace(pos=in_pos, color=in_color, big_w=in_big_w)
            res = combine(key, recv, ins, in_mask, feats, **kw)
            return (jnp.sum(res.big_w * proj[0])
                    + jnp.sum(res.pos * proj[1])
                    + jnp.sum(res.w_sum * proj[2]))
        return loss

    args = (inputs.pos, inputs.color, inputs.big_w)
    ge = jax.grad(loss_with(combine_biased), argnums=(0, 1, 2))(*args)

    w_d, _ = _stream_weights(recv, inputs, in_mask, feats)
    w_sum = jnp.sum(w_d, axis=0)
    p = np.asarray(w_d / jnp.maximum(w_sum, 1e-37))  # [R, K, H, W]
    p = np.where(np.asarray(w_sum)[None] > 0, p, 0.0)
    leftover = 1.0 - p.sum(axis=0)  # 1 at all-zero cells, else 0

    acc = None
    for j in range(r):
        # Force win2 = j wherever w_j > 0 (finite score beats -1e30).
        g2 = jnp.where(jnp.arange(r)[:, None, None, None] == j, 0.0, -1e30)
        g2 = jnp.broadcast_to(g2, w_d.shape)
        gs = jax.grad(loss_with(combine_biased_surrogate, gumbel2=g2),
                      argnums=(0, 1, 2))(*args)
        wt = p[j] + (leftover if j == 0 else 0.0)  # [K, H, W]
        term = tuple(
            np.asarray(g) * (wt[:, None] if g.ndim == 5 else wt)[None]
            for g in gs)
        acc = term if acc is None else tuple(
            a + t for a, t in zip(acc, term))

    for name, de, ds in zip(("pos", "color", "big_w"), ge, acc):
        de = np.asarray(de)
        scale = np.abs(de).max() + 1e-6
        np.testing.assert_allclose(ds, de, rtol=2e-4, atol=2e-6 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Replay-records mode (round 5): records-mode combine must reproduce the
# chain-mode surrogate gradient exactly (winner pos/color are the SAME
# function of the light table either way — re-derived at the combine vs
# chained through the select graph).
# ---------------------------------------------------------------------------

def test_records_combine_matches_chain_gradients():
    from romis.ops.wrs import (
        combine_biased_surrogate, gen_canonical_with_records,
    )

    ctx, lights, nl, geometry, feats = _setup()
    feats = feats.replace(surrogate_resampling_grad=True)
    h, w = HW
    k = feats.num_samples_in_reservoir
    r = 3
    key = jax.random.PRNGKey(21)
    ckeys = jax.random.split(jax.random.fold_in(key, 1), r)
    pk = jax.random.split(jax.random.PRNGKey(31), 3)
    proj = (jax.random.normal(pk[0], (k, h, w)),
            jax.random.normal(pk[1], (k, 3, h, w)),
            jax.random.normal(pk[2], (k, h, w)))
    in_mask = jnp.ones((r, h, w), bool)

    def loss(rows, kd, use_records):
        li = lights.replace(rows=rows)
        cx = ctx.replace(kd=kd)
        outs = [gen_canonical_with_records(ckeys[i], cx, li, nl, geometry,
                                           feats) for i in range(r)]
        inputs = jax.tree.map(lambda *a: jnp.stack(a, axis=0),
                              *[o[0] for o in outs])
        recs = jnp.stack([o[1] for o in outs], axis=0)
        if use_records:
            res, _ = combine_biased_surrogate(
                key, cx, inputs, in_mask, feats, records=recs, lights=li)
        else:
            res = combine_biased_surrogate(key, cx, inputs, in_mask, feats)
        return (jnp.sum(res.big_w * proj[0]) + jnp.sum(res.pos * proj[1])
                + jnp.sum(res.w_sum * proj[2]))

    gc = jax.jit(jax.grad(lambda a, b: loss(a, b, False),
                          argnums=(0, 1)))(lights.rows, ctx.kd)
    gr = jax.jit(jax.grad(lambda a, b: loss(a, b, True),
                          argnums=(0, 1)))(lights.rows, ctx.kd)
    for name, a, b in zip(("rows", "kd"), gc, gr):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=3e-6 * scale,
                                   err_msg=name)


def test_records_pipeline_values_match_exact():
    """Full production-gradient-config frame (surrogate + records engaged in
    render_restir_frame) must render the same image as the exact XLA path."""
    from romis.core.camera import make_camera
    from romis.render.restir import (
        initial_temporal_state, render_restir_frame,
    )

    scene = load_prebuilt("cornell_box_parallelogram_light")
    h, w = HW
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=HW)
    base = Features(enable_tone_mapping=False,
                    initial_light_samples=8)
    key = jax.random.PRNGKey(4)

    def frame(feats):
        state = initial_temporal_state(h, w, feats.num_samples_in_reservoir,
                                       cam)
        img1, state = render_restir_frame(key, cam, scene.geometry,
                                          scene.lights, scene.num_lights,
                                          h, w, feats, state)
        img2, _ = render_restir_frame(jax.random.fold_in(key, 9), cam,
                                      scene.geometry, scene.lights,
                                      scene.num_lights, h, w, feats, state)
        return np.asarray(img2)

    exact = frame(base)
    rec = frame(base.replace(surrogate_resampling_grad=True))
    np.testing.assert_allclose(rec, exact, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("est", ["rmis", "romis"])
def test_mis_records_gather_matches_plain_and_grads(est):
    """MIS replay-records neighbourhood gather (rmis.gather_nb_records,
    round 5): BITWISE value parity with the plain differentiable gather —
    the re-derived pos/color are sample_lights_planes(lights, record), the
    same expression the surrogate tail stored, and winnerless lanes are
    zeros on both sides — and gradient parity w.r.t. light params (the
    composition is identical; only where the chain is evaluated differs).
    Covers the R-MIS contribution chain and the R-OMIS A/b chain."""
    import numpy as np
    from types import SimpleNamespace

    from romis.core.camera import generate_rays, make_camera
    from romis.core.features import Features, RayTraceMode
    from romis.ops.wrs import gen_canonical_with_records
    from romis.render.neighbours import select_neighbour_indices
    from romis.render.restir import trace_primary
    from romis.render.rmis import (
        PH_NEIGHBOURS, _gather_neighbourhood, gather_nb_records,
        rmis_sample_contrib, slim_ctx_stream,
    )
    from romis.render.romis import romis_iteration_terms
    from romis.scene.scene import load_prebuilt

    h, w = 14, 18
    scene = load_prebuilt("cornell_box_parallelogram_light")
    rtm = RayTraceMode.RMIS if est == "rmis" else RayTraceMode.ROMIS
    feats = Features(ray_trace_mode=rtm,
                     initial_light_samples=4, max_iterations_mis=1,
                     spatial_resample_radius=2, num_neighbours_to_sample=2,
                     surrogate_resampling_grad=True,
                     enable_tone_mapping=False)
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(h, w))
    rays = generate_rays(cam, h, w)
    _, ctx = trace_primary(rays, scene.geometry, feats)
    key = jax.random.PRNGKey(2)
    ny, nx = select_neighbour_indices(
        jax.random.fold_in(key, PH_NEIGHBOURS), ctx, h, w, feats)
    gfn = lambda tr: _gather_neighbourhood(tr, ny, nx)
    d1 = feats.num_neighbours_to_sample + 1
    alphas = jnp.zeros((3, d1, h, w))

    def nb_for(rows, mode):
        lights = scene.lights.replace(rows=rows)
        res, rec = gen_canonical_with_records(
            jax.random.fold_in(key, 9), ctx, lights, scene.num_lights,
            scene.geometry, feats)
        if est == "rmis":
            if mode == "records":
                pos, color, g_dif, _ = gather_nb_records(
                    gfn, rec, lights, diff=dict(big_w=res.big_w))
                return SimpleNamespace(pos=pos, color=color,
                                       big_w=g_dif["big_w"]), lights
            return SimpleNamespace(**gfn(dict(
                pos=res.pos, color=res.color, big_w=res.big_w))), lights
        if mode == "records":
            pos, color, g_dif, g_det = gather_nb_records(
                gfn, rec, lights,
                diff=dict(w_sum=res.w_sum, chosen=res.chosen_w),
                det=dict(m=res.m))
            return SimpleNamespace(
                pos=pos, color=color, w_sum=g_dif["w_sum"],
                chosen_w=g_dif["chosen"], m=g_det["m"]), lights
        g = gfn(dict(px=res.pos[:, 0], py=res.pos[:, 1], pz=res.pos[:, 2],
                     cr=res.color[:, 0], cg=res.color[:, 1],
                     cb=res.color[:, 2], w_sum=res.w_sum,
                     chosen=res.chosen_w, m=res.m))
        return SimpleNamespace(
            pos=jnp.stack([g["px"], g["py"], g["pz"]], 2),
            color=jnp.stack([g["cr"], g["cg"], g["cb"]], 2),
            w_sum=g["w_sum"], chosen_w=g["chosen"], m=g["m"]), lights

    def loss(rows, mode):
        nb, lights = nb_for(rows, mode)
        if est == "rmis":
            return jnp.sum(rmis_sample_contrib(
                ctx, None, nb, scene.geometry, feats) ** 2)
        nbhd = slim_ctx_stream(ctx, ny, nx)
        a_d, b_d, _ = romis_iteration_terms(
            ctx, nbhd, nb, alphas, scene.num_lights, scene.geometry, feats)
        return jnp.sum(a_d ** 2) + jnp.sum(b_d ** 2)

    nb_r, _ = nb_for(scene.lights.rows, "records")
    nb_p, _ = nb_for(scene.lights.rows, "plain")
    np.testing.assert_array_equal(np.asarray(nb_r.pos), np.asarray(nb_p.pos))
    np.testing.assert_array_equal(np.asarray(nb_r.color),
                                  np.asarray(nb_p.color))

    v_r = float(loss(scene.lights.rows, "records"))
    v_p = float(loss(scene.lights.rows, "plain"))
    assert v_r == v_p
    g_rec = jax.grad(lambda r: loss(r, "records"))(scene.lights.rows)
    g_pln = jax.grad(lambda r: loss(r, "plain"))(scene.lights.rows)
    np.testing.assert_allclose(np.asarray(g_rec), np.asarray(g_pln),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["rmis_equal", "romis_direct"])
def test_banded_surrogate_records_fd(mode):
    """Banded MIS gradients with the surrogate + records gather engaged:
    light-color gradient matches finite differences (the production
    MIS_GRAD_SURR=1 configuration end-to-end)."""
    import numpy as np

    from romis.core.camera import make_camera
    from romis.core.features import Features, RayTraceMode
    from romis.diff.banded import mis_banded_l2_loss
    from romis.diff.grad import extract_params
    from romis.scene.scene import load_prebuilt

    h, w = 12, 12
    scene = load_prebuilt("cornell_box_parallelogram_light")
    rtm = (RayTraceMode.RMIS if mode.startswith("rmis")
           else RayTraceMode.ROMIS)
    feats = Features(ray_trace_mode=rtm, initial_light_samples=4,
                     max_iterations_mis=2, spatial_resample_radius=2,
                     num_neighbours_to_sample=2,
                     surrogate_resampling_grad=True,
                     enable_tone_mapping=False)
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(h, w))
    params = extract_params(scene.geometry, scene.lights)
    target = jnp.zeros((h, w, 3))
    key = jax.random.PRNGKey(0)

    def loss(p):
        return mis_banded_l2_loss(p, target, key, cam, scene.geometry,
                                  scene.lights, scene.num_lights, h, w,
                                  feats, n_bands=3)

    val, g = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    gc = np.asarray(g.light_c0)
    assert np.isfinite(gc).all()
    eps = 1e-2
    basis = jnp.zeros_like(params.light_c0).at[0].set(1.0)
    lp = float(loss(params.replace(light_c0=params.light_c0 + eps * basis)))
    lm = float(loss(params.replace(light_c0=params.light_c0 - eps * basis)))
    fd = (lp - lm) / (2 * eps)
    ad = float(jnp.sum(g.light_c0 * basis))
    # The surrogate's w_sum gradient is a single-sample second-race
    # ESTIMATE (wrs._surrogate_tail) — for romis the chosen/colvec chains
    # amplify its variance, so FD agreement is a sanity band here; the
    # tight check is the records-vs-plain AD parity test above (the
    # records gather itself is gradient-identical).
    rtol = 0.15 if mode.startswith("rmis") else 0.45
    assert np.sign(ad) == np.sign(fd)
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=1e-4)
