"""Exact end-to-end golden test of the ReSTIR reuse + shading pipeline.

One tiny frame — temporal M-clamp + 2-way biased combine, two spatial-reuse
passes (similarity gates + biased combine), final shading, tone map — is fed
pre-drawn race noise and neighbour offsets (the same injection hooks the
bitwise halo-parity test plumbs) and compared PER PIXEL against an
independent float64 NumPy oracle at 1e-5 — a failing combine/W/M formula can
no longer hide inside the statistical test bands (VERDICT r2 missing #4;
SURVEY §4 test plan).

The canonical reservoirs enter as shared DATA (their generation has its own
lane-level oracle tests in test_wrs.py); everything downstream is computed
twice, independently.
"""

import numpy as np
import jax
import jax.numpy as jnp

import oracle
from romis.core.camera import make_camera, generate_rays
from romis.core.features import Features
from romis.ops.shading import exposure_tone_mapping
from romis.ops.wrs import (
    SHADOW_RAY_EPSILON,
    clamp_temporal_m,
    combine_biased,
    gen_canonical_samples,
)
from romis.render.restir import (
    SPATIAL_DEPTH_FRAC,
    SPATIAL_NORMAL_COS,
    final_shade,
    spatial_reuse,
    trace_primary,
)
from romis.scene.scene import load_prebuilt

H = W = 8
FEATS = Features(initial_light_samples=8, num_neighbours_to_sample=3,
                 spatial_resample_radius=2, temporal_clamp_m=2)


def _np_tree(x):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), x)


class _Res:
    """Mutable per-pixel-array reservoir mirror (numpy, float64)."""

    def __init__(self, res):
        self.pos = np.asarray(res.pos, np.float64)      # [K, 3, H, W]
        self.color = np.asarray(res.color, np.float64)
        self.w_sum = np.asarray(res.w_sum, np.float64)  # [K, H, W]
        self.m = np.asarray(res.m, np.float64)
        self.big_w = np.asarray(res.big_w, np.float64)
        self.chosen_w = np.asarray(res.chosen_w, np.float64)


def _oracle_p_hat(ctx, y, x, pos, color):
    return oracle.target_pdf(
        pos, color, ctx["view"][:, y, x], ctx["pos"][:, y, x],
        ctx["normal"][:, y, x], ctx["kd"][:, y, x], ctx["ks"][:, y, x],
        ctx["shin"][y, x], valid=bool(ctx["valid"][y, x]))


def _oracle_combine_biased(ctx, inputs, masks, gumbel, k, y, x):
    """Reservoir::combineBiased / ops/wrs.combine_biased per pixel: inputs =
    list of _Res, masks = list of bools, gumbel [R, K]. Returns per-lane
    dicts."""
    out = []
    for lane in range(k):
        ws, phs = [], []
        for r, (res, mk) in enumerate(zip(inputs, masks)):
            ph = _oracle_p_hat(ctx, y, x, res.pos[lane, :, y, x],
                               res.color[lane, :, y, x])
            w = ph * res.big_w[lane, y, x] * res.m[lane, y, x]
            ws.append(w if mk else 0.0)
            phs.append(ph)
        win = oracle.wrs_lane_select(ws, gumbel[:, lane])
        w_sum = float(np.sum(ws))
        m_out = float(sum(res.m[lane, y, x] for res, mk in zip(inputs, masks)
                          if mk))
        sel = inputs[win]
        sel_ph = phs[win]
        big_w = (w_sum / (sel_ph * m_out)
                 if (sel_ph > 0.0 and m_out > 0.0) else 0.0)
        out.append(dict(pos=sel.pos[lane, :, y, x],
                        color=sel.color[lane, :, y, x],
                        w_sum=w_sum, m=m_out, big_w=big_w,
                        chosen_w=ws[win]))
    return out


def _oracle_visible(tris, frm, to):
    """ops/wrs.visibility semantics (reference utils.cpp:41-56)."""
    d = np.asarray(to, np.float64) - frm
    dist = np.linalg.norm(d)
    if dist <= SHADOW_RAY_EPSILON:
        return True
    d = d / max(dist, 1e-20)
    origin = frm + SHADOW_RAY_EPSILON * d
    t_max = np.linalg.norm(to - origin)
    for v0, e1, e2 in tris:
        r = oracle.moller_trumbore(origin, d, v0, e1, e2)
        if r is not None and r[0] < t_max:
            return False
    return True


def test_golden_restir_frame():
    scene = load_prebuilt("cornell_box_parallelogram_light")
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(H, W))
    feats = FEATS
    k = feats.num_samples_in_reservoir
    k_n = feats.num_neighbours_to_sample
    radius = feats.spatial_resample_radius
    key = jax.random.PRNGKey(42)

    rays = generate_rays(cam, H, W)
    _, ctx = trace_primary(rays, scene.geometry, feats)

    # Shared data: canonical reservoirs + a fabricated previous frame whose
    # history EXCEEDS the clamp bound (M-clamping must actually fire).
    res = gen_canonical_samples(jax.random.fold_in(key, 1), ctx,
                                scene.lights, scene.num_lights,
                                scene.geometry, feats)
    prev_raw = gen_canonical_samples(jax.random.fold_in(key, 2), ctx,
                                     scene.lights, scene.num_lights,
                                     scene.geometry, feats)
    prev = prev_raw.replace(m=prev_raw.m * 25.0, w_sum=prev_raw.w_sum * 25.0)

    # Pre-drawn noise shared by both sides.
    g_t = jax.random.gumbel(jax.random.fold_in(key, 3), (2, k, H, W))
    inject = []
    for p in range(feats.spatial_resampling_passes):
        kp = jax.random.fold_in(key, 10 + p)
        offs = jax.random.randint(kp, (2, k_n, H, W), -radius, radius + 1)
        gum = jax.random.gumbel(jax.random.fold_in(kp, 1), (k_n + 1, k, H, W))
        inject.append((offs, gum))

    # ===== pipeline side =====
    pred = clamp_temporal_m(prev, res.total_m(),
                            float(feats.temporal_clamp_m))
    inputs = jax.tree.map(lambda a, b: jnp.stack([a, b]), res, pred)
    mask = jnp.ones((2, H, W), bool)
    res_t = combine_biased(jax.random.fold_in(key, 4), ctx, inputs, mask,
                           feats, gumbel=g_t)
    res_s = spatial_reuse(jax.random.fold_in(key, 5), ctx, res_t, H, W,
                          scene.geometry, feats, inject=inject)
    color = final_shade(ctx, res_s, scene.geometry, feats)
    img = np.asarray(jnp.moveaxis(
        exposure_tone_mapping(color, feats), 0, -1))

    # ===== oracle side (float64 numpy, fully independent formulas) =====
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
    tris = [(np.asarray(g.v0[i], np.float64), np.asarray(g.e1[i], np.float64),
             np.asarray(g.e2[i], np.float64))
            for i in range(act.shape[0]) if act[i]]

    ores = _Res(res)
    oprev = _Res(prev)

    # temporal M-clamp (render_utils.cpp:151-163 contract, float math)
    cur_total = ores.m.sum(axis=0)
    bound = feats.temporal_clamp_m * cur_total + 1.0
    needs = oprev.m.sum(axis=0) > bound
    for lane in range(k):
        nz = oprev.m[lane] > 0.0
        sc = np.where(nz, bound / np.maximum(oprev.m[lane], 1e-37), 1.0)
        app = needs & nz
        oprev.w_sum[lane] = np.where(app, oprev.w_sum[lane] * sc,
                                     oprev.w_sum[lane])
        oprev.m[lane] = np.where(app, bound, oprev.m[lane])

    g_t_np = np.asarray(g_t, np.float64)

    def combine_grid(inputs, masks_grid, gum):
        """masks_grid: list of [H, W] bool; gum [R, K, H, W] →
        new _Res-like arrays."""
        out = _Res(res)  # shape template; every field overwritten
        for y in range(H):
            for x in range(W):
                lanes = _oracle_combine_biased(
                    octx, inputs, [mg[y, x] for mg in masks_grid],
                    gum[:, :, y, x], k, y, x)
                for lane, lr in enumerate(lanes):
                    out.pos[lane, :, y, x] = lr["pos"]
                    out.color[lane, :, y, x] = lr["color"]
                    out.w_sum[lane, y, x] = lr["w_sum"]
                    out.m[lane, y, x] = lr["m"]
                    out.big_w[lane, y, x] = lr["big_w"]
                    out.chosen_w[lane, y, x] = lr["chosen_w"]
        return out

    ones = np.ones((H, W), bool)
    ores_t = combine_grid([ores, oprev], [ones, ones], g_t_np)

    # two spatial passes: gather at clipped coords, similarity gates,
    # combine {neighbours..., self} (render_utils.cpp:87-140)
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    state = ores_t
    for offs, gum in inject:
        offs = np.asarray(offs)
        gum = np.asarray(gum, np.float64)
        ny = np.clip(rows[None] + offs[0], 0, H - 1)  # [R, H, W]
        nx = np.clip(cols[None] + offs[1], 0, W - 1)
        nbrs, masks = [], []
        for r in range(k_n):
            nb = _Res(res)
            for f in ("pos", "color", "w_sum", "m", "big_w", "chosen_w"):
                getattr(nb, f)[:] = getattr(state, f)[..., ny[r], nx[r]]
            nbrs.append(nb)
            nd = octx["depth"][ny[r], nx[r]]
            depth_ok = np.abs(1.0 - nd / np.maximum(octx["depth"], 1e-20)) \
                <= SPATIAL_DEPTH_FRAC
            ndot = (octx["normal"][:, ny[r], nx[r]]
                    * octx["normal"]).sum(axis=0)
            normal_ok = ndot >= SPATIAL_NORMAL_COS
            masks.append(depth_ok & normal_ok & octx["valid"]
                         & octx["valid"][ny[r], nx[r]])
        state = combine_grid(nbrs + [state], masks + [ones], gum)

    # final shading (render_utils.cpp:54-65) + tone map
    oimg = np.zeros((H, W, 3))
    for y in range(H):
        for x in range(W):
            acc = np.zeros(3)
            for lane in range(k):
                sp = state.pos[lane, :, y, x]
                vis = _oracle_visible(tris, octx["pos"][:, y, x], sp)
                if not (vis and octx["valid"][y, x]):
                    continue
                shade = oracle.phong(
                    sp, state.color[lane, :, y, x], octx["view"][:, y, x],
                    octx["pos"][:, y, x], octx["normal"][:, y, x],
                    octx["kd"][:, y, x], octx["ks"][:, y, x],
                    octx["shin"][y, x])
                acc += shade * state.big_w[lane, y, x]
            c = acc / k
            oimg[y, x] = np.maximum(1.0 - np.exp(-feats.exposure * c), 0.0) \
                ** (1.0 / feats.gamma)

    np.testing.assert_allclose(img, oimg, rtol=1e-5, atol=1e-6)
