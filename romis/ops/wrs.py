"""Weighted reservoir sampling (WRS) as order-invariant, vectorised math.

The reference's Reservoir::update (src/rendering/reservoir.cpp:10-32) is a
sequential, order-dependent stream: each candidate is routed to the
sub-reservoir with the smallest running wSum and accepted with probability
w/wSum using libc rand(). That is unvectorisable and irreproducible.

Vectorised reformulation (estimator-equivalent, deterministic):

- **K fixed lanes** replace the route-to-smallest-wSum load balancing:
  candidate j goes to lane j mod K (candidate generation) and an input
  reservoir's lane-k sample feeds output lane k (combination). Any fixed
  partition preserves the RIS estimator contract — K samples, each with
  W = wSum / (p_hat * M) over its own candidate subset.
- **Gumbel-max selection** replaces streaming accept/reject: within a lane,
  the winner is argmax(log w + Gumbel noise), which selects index i with
  probability w_i / sum(w) *exactly*, is associative/order-invariant, and is
  driven by counter-based jax.random keys (shard-invariant, reproducible).

Combination routines mirror ReSTIR Algorithms 5/6 as implemented by
Reservoir::combineBiased / combineUnbiased (reservoir.cpp:40-104).

Layout: image-minor (core/vec.py). Reservoir fields are [K, ..., H, W];
stacked neighbourhood inputs are [R, K, ..., H, W] with the combine reducing
over the leading R axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.features import Features
from ..core.types import Reservoirs, ShadeCtx
from ..core.vec import e, vnorm
from ..scene.lights import LightTable, sample_lights, sample_lights_planes
from .intersect import intersect_any_fast
from .shading import (
    target_pdf, target_pdf_planes, target_pdf_planes_analytic,
)


def _tp(features):
    """Planes-form target-PDF with the closed-form VJP when enabled
    (Features.analytic_phong_vjp) — identical forward values."""
    return (target_pdf_planes_analytic if features.analytic_phong_vjp
            else target_pdf_planes)

SHADOW_RAY_EPSILON = 1e-3  # reference src/utils/utils.h:16


def visibility(ctx_position, sample_pos, geometry) -> jnp.ndarray:
    """Shadow-ray visibility from surface points to light samples.

    Reference: testVisibilityLightSample (src/utils/utils.cpp:41-56) —
    direction computed from the unoffset point, origin pushed
    SHADOW_RAY_EPSILON along it, t_max = remaining distance.

    ctx_position: [3, H, W] (broadcasts); sample_pos: [..., 3, H, W].
    Returns bool [..., H, W] (True = visible). Coincident pairs are visible.

    Inputs are stop-gradded: the boolean output has zero gradient by
    definition, and detaching keeps reverse mode out of the traversal.
    """
    ctx_position = jax.lax.stop_gradient(ctx_position)
    sample_pos = jax.lax.stop_gradient(sample_pos)
    to = sample_pos - ctx_position
    dist = vnorm(to)
    d = to / e(jnp.maximum(dist, 1e-20))
    origin = ctx_position + SHADOW_RAY_EPSILON * d
    t_max = vnorm(sample_pos - origin)
    occluded = intersect_any_fast(origin, d, t_max, geometry)
    return (~occluded) | (dist <= SHADOW_RAY_EPSILON)


def _lane_layout(s: int, k: int):
    """Static lane geometry: S candidates → K lanes of ceil(S/K) slots,
    candidate j in lane j mod K, slot j // K. Returns (slots_per_lane,
    per-lane real counts [K], real mask [slots, K])."""
    import numpy as np

    sk = -(-s // k)
    j = np.arange(sk * k).reshape(sk, k)  # j = slot*K + lane
    real = j < s
    counts = real.sum(axis=0).astype(np.float32)
    return sk, counts, real


def _safe_big_w(w_sum, p_hat, m, cond):
    """W = wSum / (p_hat * m) under ``cond`` else 0, with the denominator
    substituted to 1 in the untaken branch: computing 1/max(p_hat,tiny) *
    1/max(m,tiny) when both are 0 overflows f32 to inf, and the where
    cotangent then turns 0*inf into NaN gradients."""
    denom = jnp.where(cond, p_hat * m, 1.0)
    return jnp.where(cond, w_sum / denom, 0.0)


def gen_canonical_samples(
    key: jax.Array,
    ctx: ShadeCtx,
    lights: LightTable,
    num_lights: int,
    geometry,
    features: Features,
) -> Reservoirs:
    """Per-pixel RIS candidate generation (reference genCanonicalSamples,
    src/scene/light.cpp:39-99).

    Draws S = initial_light_samples candidates per pixel — uniform light pick
    (probability 1/num_lights, reference light.cpp:48-51), uniform point on
    the light — weights each by p_hat / (1/num_lights), and runs lane-parallel
    WRS. W = wSum / (p_hat * M) per lane with the zero-p_hat guard
    (light.cpp:85-95); the optional initial visibility check kills W
    (light.cpp:85-88).

    Candidates stream through a `lax.scan` over slot index (one candidate per
    lane per step, all K lanes in parallel) so peak memory is O(K*H*W)
    instead of O(S*H*W). The running Gumbel-max over the stream is
    distribution-identical to a global argmax.
    """
    # Surrogate-gradient mode owns its own (detached) forward.
    if features.surrogate_resampling_grad:
        return _gen_canonical_surrogate(key, ctx, lights, num_lights,
                                        geometry, features)

    h, w_img = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    sk, lane_counts, lane_real = _lane_layout(s, k)

    keys = jax.random.split(key, sk)
    real_per_slot = jnp.asarray(lane_real)  # [sk, K] bool

    def step(carry, inp):
        # The whole scan body works on SCALAR COMPONENT PLANES [K, H, W]
        # (sample_lights_planes / target_pdf_planes): any [K, 3, H, W]
        # array here makes XLA's scan reverse-mode assign the size-3 axis
        # to the lane dimension of the stacked per-step buffers — a 42x
        # padded layout that OOMs the 1080p gradient pass.
        w_sum, best_score, sel_comps, sel_w, sel_p_hat = carry
        slot_key, real = inp  # real: [K]
        # One threefry invocation per slot covers light pick, (u, v) and the
        # Gumbel race — 4x fewer RNG kernels than separate draws.
        u4 = jax.random.uniform(slot_key, (4, k, h, w_img))
        idx = jnp.minimum((u4[0] * num_lights).astype(jnp.int32),
                          num_lights - 1)
        g = -jnp.log(-jnp.log(jnp.maximum(u4[3], 1e-37)) + 1e-37)

        comps = sample_lights_planes(lights, idx, u4[1], u4[2])  # 6x[K,H,W]
        p_hat = _tp(features)(ctx, *comps, features)  # [K, H, W]
        w = p_hat * float(num_lights) * real[:, None, None].astype(jnp.float32)

        score = jnp.where(w > 0.0, jnp.log(jnp.maximum(w, 1e-37)) + g, -jnp.inf)
        upd = score > best_score
        return (
            w_sum + w,
            jnp.where(upd, score, best_score),
            tuple(jnp.where(upd, c, sc) for c, sc in zip(comps, sel_comps)),
            jnp.where(upd, w, sel_w),
            jnp.where(upd, p_hat, sel_p_hat),
        ), None

    init = (
        jnp.zeros((k, h, w_img)),
        jnp.full((k, h, w_img), -jnp.inf),
        tuple(jnp.zeros((k, h, w_img)) for _ in range(6)),
        jnp.zeros((k, h, w_img)),
        jnp.zeros((k, h, w_img)),
    )
    # Checkpoint the step as well: scan reverse-mode then stores only the
    # stacked carries (~[S/K, K, H, W]) and recomputes each step's light
    # fetch + Phong instead of saving their per-step intermediates.
    (w_sum, _, sel_comps, sel_w, sel_p_hat), _ = jax.lax.scan(
        jax.checkpoint(step), init, (keys, real_per_slot)
    )
    sel_pos = jnp.stack(sel_comps[0:3], axis=1)  # [K, 3, H, W]
    sel_color = jnp.stack(sel_comps[3:6], axis=1)

    m = jnp.broadcast_to(
        jnp.asarray(lane_counts)[:, None, None], (k, h, w_img))
    big_w = _safe_big_w(w_sum, sel_p_hat, m, sel_p_hat > 0.0)

    if features.initial_samples_visibility_check:
        vis = visibility(ctx.position, sel_pos, geometry)
        big_w = jnp.where(vis, big_w, 0.0)

    return Reservoirs(
        pos=sel_pos, color=sel_color, w_sum=w_sum, m=m, big_w=big_w,
        chosen_w=sel_w,
    )


def _gen_canonical_surrogate(
    key: jax.Array,
    ctx: ShadeCtx,
    lights: LightTable,
    num_lights: int,
    geometry,
    features: Features,
    return_records: bool = False,
) -> Reservoirs:
    """gen_canonical_samples with the winner-replay surrogate gradient
    (Features.surrogate_resampling_grad).

    The candidate scan runs fully DETACHED (stop-gradded ctx/lights: no
    backward through the S slots) and carries only replay records — the
    winner's (light index, u1, u2) plus a SECOND, independent race's record.
    The reservoir outputs are then re-derived differentiably from the
    replay: pos/color/chosen_w/p_hat from the primary winner, and

        d(w_sum)/dtheta  ~=  stopgrad(w_sum / w_J') * d w_J' / dtheta

    from the second winner J' ~ w / sum(w): E_J'[(w_sum/w_J') dw_J'] =
    sum_j dw_j exactly, and J' independent of the primary winner keeps the
    composite estimator unbiased for the exact autodiff gradient
    (tests/test_grad_surrogate.py validates this statistically).

    Candidate draws reuse the exact path's u4 stream (the second race's
    uniform comes from a folded key), so sampled candidates, the primary
    winner, and every reservoir VALUE match the exact path (to ~1 ulp of
    fusion reassociation) — only the gradient is estimated."""
    h, w_img = ctx.depth_t.shape[-2:]
    s = features.initial_light_samples
    k = features.num_samples_in_reservoir
    sk, lane_counts, lane_real = _lane_layout(s, k)

    ctx_d = jax.lax.stop_gradient(ctx)
    lights_d = jax.lax.stop_gradient(lights)

    keys = jax.random.split(key, sk)
    real_per_slot = jnp.asarray(lane_real)

    def step(carry, inp):
        w_sum, best, sel_iuv, best2, sel2_iuv = carry
        slot_key, real = inp
        u4 = jax.random.uniform(slot_key, (4, k, h, w_img))
        u_g2 = jax.random.uniform(jax.random.fold_in(slot_key, 77),
                                  (k, h, w_img))
        idx = jnp.minimum((u4[0] * num_lights).astype(jnp.int32),
                          num_lights - 1)
        comps = sample_lights_planes(lights_d, idx, u4[1], u4[2])
        p_hat = target_pdf_planes(ctx_d, *comps, features)
        w = (p_hat * float(num_lights)
             * real[:, None, None].astype(jnp.float32))
        log_w = jnp.log(jnp.maximum(w, 1e-37))
        iuv = (idx.astype(jnp.float32), u4[1], u4[2])

        g1 = -jnp.log(-jnp.log(jnp.maximum(u4[3], 1e-37)) + 1e-37)
        score = jnp.where(w > 0.0, log_w + g1, -jnp.inf)
        upd = score > best
        g2 = -jnp.log(-jnp.log(jnp.maximum(u_g2, 1e-37)) + 1e-37)
        score2 = jnp.where(w > 0.0, log_w + g2, -jnp.inf)
        upd2 = score2 > best2
        return (
            w_sum + w,
            jnp.where(upd, score, best),
            tuple(jnp.where(upd, a, b) for a, b in zip(iuv, sel_iuv)),
            jnp.where(upd2, score2, best2),
            tuple(jnp.where(upd2, a, b) for a, b in zip(iuv, sel2_iuv)),
        ), None

    zeros = jnp.zeros((k, h, w_img))
    init = (
        zeros,
        jnp.full((k, h, w_img), -jnp.inf),
        (zeros, zeros, zeros),
        jnp.full((k, h, w_img), -jnp.inf),
        (zeros, zeros, zeros),
    )
    (w_sum, _, sel_iuv, _, sel2_iuv), _ = jax.lax.scan(
        step, init, (keys, real_per_slot))
    return _surrogate_tail(ctx, lights, num_lights, geometry, features,
                           lane_counts, jax.lax.stop_gradient(w_sum),
                           sel_iuv, sel2_iuv, return_records)


def _surrogate_tail(ctx, lights, num_lights, geometry, features,
                    lane_counts, w_sum, sel_iuv, sel2_iuv,
                    return_records: bool = False) -> Reservoirs:
    """Differentiable reservoir reconstruction from detached replay records
    (see _gen_canonical_surrogate). w_sum/sel_iuv/sel2_iuv are data."""
    h, w_img = ctx.depth_t.shape[-2:]
    k = features.num_samples_in_reservoir
    # A lane has a winner iff some candidate weight was positive.
    has_winner = jax.lax.stop_gradient(w_sum) > 0.0

    def reeval(iuv):
        idxf, u1, u2 = jax.lax.stop_gradient(iuv)  # replay record is data
        comps = sample_lights_planes(lights, idxf.astype(jnp.int32), u1, u2)
        p_hat = _tp(features)(ctx, *comps, features)
        return comps, p_hat

    comps1, p_hat1 = reeval(sel_iuv)
    _, p_hat2 = reeval(sel2_iuv)
    w2 = p_hat2 * float(num_lights)

    # Single-sample w_sum gradient: value = w_sum, grad = (w_sum/w2) dw2.
    w2_d = jax.lax.stop_gradient(w2)
    ratio = jnp.where(w2_d > 0.0,
                      w_sum / jnp.where(w2_d > 0.0, w2_d, 1.0), 0.0)
    w_sum_diff = w_sum + ratio * (w2 - w2_d)

    def mask(a):
        return jnp.where(has_winner, a, 0.0)

    sel_pos = jnp.stack([mask(c) for c in comps1[0:3]], axis=1)
    sel_color = jnp.stack([mask(c) for c in comps1[3:6]], axis=1)
    sel_p_hat = mask(p_hat1)
    sel_w = sel_p_hat * float(num_lights)

    m = jnp.broadcast_to(
        jnp.asarray(lane_counts)[:, None, None], (k, h, w_img))
    big_w = _safe_big_w(w_sum_diff, sel_p_hat, m, sel_p_hat > 0.0)

    if features.initial_samples_visibility_check:
        vis = visibility(ctx.position, sel_pos, geometry)
        big_w = jnp.where(vis, big_w, 0.0)

    res = Reservoirs(
        pos=sel_pos, color=sel_color, w_sum=w_sum_diff, m=m, big_w=big_w,
        chosen_w=sel_w,
    )
    if not return_records:
        return res
    # Replay record per lane [K, 3, H, W] (idxf | u1 | u2), idx = -1 where
    # the lane has no winner — the spatial/temporal replay-records path
    # (combine_biased_surrogate records mode) re-derives winner pos/color
    # from these instead of chaining pos-plane cotangents through gathers.
    idxf, u1, u2 = (jax.lax.stop_gradient(a) for a in sel_iuv)
    rec = jnp.stack([jnp.where(has_winner, idxf, -1.0), u1, u2], axis=1)
    return res, rec


def gen_canonical_with_records(key, ctx, lights, num_lights, geometry,
                               features: Features):
    """gen_canonical_samples in surrogate mode, additionally returning the
    winner replay records [K, 3, H, W] for the records-mode reuse combines.
    Requires features.surrogate_resampling_grad."""
    assert features.surrogate_resampling_grad
    return _gen_canonical_surrogate(key, ctx, lights, num_lights, geometry,
                                    features, return_records=True)


def _stream_weights(receiver: ShadeCtx, inputs: Reservoirs, in_mask, features):
    """Per-input-sample resampling weight at the receiver:
    w = p_hat_receiver(y) * W * M (reservoir.cpp:44-52).
    inputs fields [R, K, ..., H, W]; in_mask [R, H, W] → w, p_hat [R, K, H, W].

    Planes-form target_pdf (scalar component planes, not [R, K, 3, H, W]
    vector broadcasting): the vector-axis form materialises 3-minor
    temporaries that pad onto the (8, 128) tile — the R·K sweep is the
    spatial phase's hottest XLA loop (ops/shading.phong_shade_planes
    docstring; scripts/grad_bench.py spatial)."""
    p, c = inputs.pos, inputs.color
    p_hat = _tp(features)(
        receiver, p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :],
        c[..., 0, :, :], c[..., 1, :, :], c[..., 2, :, :], features)
    w = p_hat * inputs.big_w * inputs.m
    w = jnp.where(in_mask[:, None], w, 0.0)
    return w, p_hat


def _select_lanewise(key, w, p_hat, inputs: Reservoirs, in_mask,
                     gumbel=None):
    """Gumbel-max winner over the leading R axis, per output lane k.
    w/p_hat: [R, K, H, W]. ``gumbel`` injects pre-drawn noise (shard-parity
    tests feed both the single-device and halo paths identical planes)."""
    if gumbel is None:
        gumbel = jax.random.gumbel(key, w.shape)
    score = jnp.where(w > 0.0, jnp.log(jnp.maximum(w, 1e-37)) + gumbel,
                      -jnp.inf)
    win = jnp.argmax(score, axis=0)  # [K, H, W]

    r = w.shape[0]

    def gather(a):
        # Masked sum over the (small, static) R axis instead of
        # take_along_axis: XLA lowers the latter to a real gather.
        win_b = win if a.ndim == 4 else win[:, None]  # a: [R,K,H,W] | [R,K,3,H,W]
        out = jnp.zeros(a.shape[1:], a.dtype)
        for i in range(r):
            out = jnp.where(win_b == i, a[i], out)
        return out

    sel_pos = gather(inputs.pos)
    sel_color = gather(inputs.color)
    sel_w = gather(w)
    sel_p_hat = gather(p_hat)

    w_sum = jnp.sum(w, axis=0)  # [K, H, W]
    m_out = jnp.sum(jnp.where(in_mask[:, None], inputs.m, 0.0), axis=0)
    return sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out, win


def combine_biased(
    key: jax.Array,
    receiver: ShadeCtx,
    inputs: Reservoirs,  # fields [R, K, ..., H, W]
    in_mask: jnp.ndarray,  # [R, H, W] bool — which inputs participate
    features: Features,
    gumbel=None,
    records=None,  # [R, K, 3, H, W] replay records to pass through
):
    """ReSTIR Algorithm 5 (reference Reservoir::combineBiased,
    reservoir.cpp:40-66): re-weight every input sample by
    p_hat_receiver * W * M, resample one winner per lane, then
    W = wSum / (p_hat(winner) * M_total).

    With ``records``, also returns the winner's replay record (idx forced
    to -1 on lanes with no positive-weight winner) — the records-mode
    pipeline threads these through reuse phases (no effect on the
    reservoir outputs or their gradients)."""
    w, p_hat = _stream_weights(receiver, inputs, in_mask, features)
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out, win = \
        _select_lanewise(key, w, p_hat, inputs, in_mask, gumbel)
    big_w = _safe_big_w(w_sum, sel_p_hat, m_out,
                        (sel_p_hat > 0.0) & (m_out > 0.0))
    res = Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                     big_w=big_w, chosen_w=sel_w)
    if records is None:
        return res
    r = records.shape[0]
    rec_out = jnp.zeros(records.shape[1:], records.dtype)
    for i in range(r):
        rec_out = jnp.where(e(win == i), records[i], rec_out)
    won = jax.lax.stop_gradient(sel_w) > 0.0
    rec_out = jnp.where(e(won), rec_out,
                        rec_out.at[:, 0].set(-1.0))
    return res, rec_out


def combine_biased_surrogate(
    key: jax.Array,
    receiver: ShadeCtx,
    inputs: Reservoirs,  # fields [R, K, ..., H, W]
    in_mask: jnp.ndarray,  # [R, H, W]
    features: Features,
    gumbel=None,
    gumbel2=None,
    records=None,  # [R, K, 3, H, W] replay records (idxf|u1|u2, idx<0=none)
    lights=None,  # LightTable — required with records
):
    """combine_biased with the winner-replay surrogate gradient — the
    spatial/temporal race is the same select-one-of-R estimator as RIS
    candidate generation, so the same construction applies
    (_gen_canonical_surrogate):

    - the R x K stream-weight sweep and BOTH Gumbel races run DETACHED
      (no backward through R target_pdf evaluations per lane — the
      dominant spatial backward cost, scripts/grad_bench.py);
    - the winner's w and p_hat are RE-EVALUATED differentiably (one
      target_pdf per lane), so gradients flow into the selected input's
      pos/color/W/M and into the receiver context;
    - d(w_sum) comes from a SECOND independent race J' ~ w / sum(w):
      w_sum + stopgrad(w_sum / w_J') * (w_J' - stopgrad(w_J')) has value
      w_sum exactly and expected gradient sum_j dw_j
      (tests/test_grad_surrogate.py::test_spatial_surrogate_*).

    The primary race consumes the SAME gumbel draw as combine_biased, so
    every output VALUE matches the exact path bit-for-bit (up to fusion
    reassociation in the re-evaluated winner attributes); only the
    gradient is estimated.

    ``records`` mode (the spatial replay-records path, round 5): each input
    additionally carries the winner's (light idx, u1, u2) replay record,
    and the combine RE-DERIVES the selected sample's pos/color from the
    record against ``lights`` (sample_lights_planes — the same function the
    canonical tail evaluated, so values agree to ~1 ulp and the gradient
    w.r.t. light params is IDENTICAL to chaining pos-plane cotangents
    through the gathers). Inputs whose record is absent (idx < 0: no
    winner, or a previous-frame sample) keep their detached stored
    pos/color — their attributes are constants w.r.t. current-step params
    either way. With records, callers may gather every input plane
    DETACHED except big_w: pos/color cotangents no longer flow through the
    gather (grad_bench: the spatial backward's dominant term). Returns
    (Reservoirs, records_out [K, 3, H, W])."""
    recv_d = jax.lax.stop_gradient(receiver)
    in_d = jax.lax.stop_gradient(inputs)
    mask_d = jax.lax.stop_gradient(in_mask)
    w_d, p_hat_d = _stream_weights(recv_d, in_d, mask_d, features)

    if gumbel is None:
        gumbel = jax.random.gumbel(key, w_d.shape)
    log_w = jnp.log(jnp.maximum(w_d, 1e-37))
    score1 = jnp.where(w_d > 0.0, log_w + gumbel, -jnp.inf)
    win1 = jnp.argmax(score1, axis=0)  # [K, H, W]
    if gumbel2 is None:  # injection point for the exact-identity test
        gumbel2 = jax.random.gumbel(jax.random.fold_in(key, 77), w_d.shape)
    score2 = jnp.where(w_d > 0.0, log_w + gumbel2, -jnp.inf)
    win2 = jnp.argmax(score2, axis=0)

    r = w_d.shape[0]

    def sel(a, win):
        # R-way masked select (differentiable into the winning input);
        # same shape contract as _select_lanewise.gather.
        win_b = win if a.ndim == 4 else win[:, None]
        out = jnp.zeros(a.shape[1:], a.dtype)
        for i in range(r):
            out = jnp.where(win_b == i, a[i], out)
        return out

    def pdf_planes(pos, color):
        # Planes-form re-evaluation (see _stream_weights).
        return _tp(features)(
            receiver, pos[..., 0, :, :], pos[..., 1, :, :],
            pos[..., 2, :, :], color[..., 0, :, :], color[..., 1, :, :],
            color[..., 2, :, :], features)

    def replayed(win):
        """Winner pos/color: re-derived from the replay record where one
        exists, else the detached stored planes (see records-mode notes)."""
        rec = sel(records, win)  # [K, 3, H, W], detached data
        idxf, u1, u2 = rec[:, 0], rec[:, 1], rec[:, 2]
        has = e(idxf >= 0.0)
        comps = sample_lights_planes(
            lights, jnp.maximum(idxf, 0.0).astype(jnp.int32), u1, u2)
        pos_rd = jnp.stack(comps[0:3], axis=1)  # [K, 3, H, W]
        col_rd = jnp.stack(comps[3:6], axis=1)
        pos_det = jax.lax.stop_gradient(sel(inputs.pos, win))
        col_det = jax.lax.stop_gradient(sel(inputs.color, win))
        return (jnp.where(has, pos_rd, pos_det),
                jnp.where(has, col_rd, col_det), rec)

    # Differentiable winner re-evaluation (selection is data).
    if records is not None:
        sel_pos, sel_color, rec1 = replayed(win1)
    else:
        sel_pos = sel(inputs.pos, win1)
        sel_color = sel(inputs.color, win1)
    sel_big_w = sel(inputs.big_w, win1)
    sel_m = sel(inputs.m, win1)
    sel_p_hat = pdf_planes(sel_pos, sel_color)
    # Gate by the detached gathered weight: zero where the winner had w=0
    # (all-masked lane) — matches the exact path's gathered sel_w.
    won = sel(w_d, win1) > 0.0
    sel_w = jnp.where(won, sel_p_hat * sel_big_w * sel_m, 0.0)
    sel_p_hat = jnp.where(won, sel_p_hat, sel(p_hat_d, win1))

    # w_sum: detached value + single-sample gradient via the second race.
    w_sum_d = jnp.sum(w_d, axis=0)
    if records is not None:
        pos2, col2, _ = replayed(win2)
    else:
        pos2 = sel(inputs.pos, win2)
        col2 = sel(inputs.color, win2)
    w2 = (pdf_planes(pos2, col2)
          * sel(inputs.big_w, win2) * sel(inputs.m, win2))
    w2_d = jax.lax.stop_gradient(w2)
    ratio = jnp.where(w2_d > 0.0,
                      w_sum_d / jnp.where(w2_d > 0.0, w2_d, 1.0), 0.0)
    w_sum = w_sum_d + ratio * (w2 - w2_d)

    m_out = jnp.sum(jnp.where(in_mask[:, None], inputs.m, 0.0), axis=0)
    big_w = _safe_big_w(w_sum, sel_p_hat, m_out,
                        (jax.lax.stop_gradient(sel_p_hat) > 0.0)
                        & (m_out > 0.0))
    res = Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                     big_w=big_w, chosen_w=sel_w)
    if records is None:
        return res
    # Output record: the winner's record where the lane won and had one.
    rec_out = jnp.where(e(won), rec1,
                        jnp.stack([jnp.full_like(rec1[:, 0], -1.0),
                                   rec1[:, 1], rec1[:, 2]], axis=1))
    return res, rec_out


def combine_unbiased(
    key: jax.Array,
    receiver: ShadeCtx,
    inputs: Reservoirs,  # fields [R, K, ..., H, W]
    in_mask: jnp.ndarray,  # [R, H, W]
    input_ctxs: ShadeCtx,  # fields [R, ..., H, W] — each input's own geometry
    geometry,
    features: Features,
    gumbel=None,  # pre-drawn [R, K, H, W] race noise (bitwise parity tests)
) -> Reservoirs:
    """ReSTIR Algorithm 6 (reference Reservoir::combineUnbiased,
    reservoir.cpp:68-104): same resampling as the biased combine, but the
    denominator counts only inputs whose own target PDF (optionally ×
    visibility from *their* surface point, reservoir.cpp:85-93) is positive
    at the winning sample: W = wSum / (p_hat(winner) * Z).

    Bug fixed vs reference: the reference's Z adds ``totalSampleNums()`` —
    the M summed over ALL K sub-reservoirs (reservoir.cpp:92) — while its
    stream weights and biased combine use the per-lane M. With K > 1 that
    over-normalizes every lane by ~K per pass (measured 6.7x darker than
    ground truth at K=2, 2 passes). Counting the lane's own M matches
    Alg. 6 applied per lane, agrees with the biased combine when every
    input is valid, and reduces to the reference for K = 1."""
    w, p_hat = _stream_weights(receiver, inputs, in_mask, features)
    sel_pos, sel_color, sel_w, sel_p_hat, w_sum, m_out, _ = _select_lanewise(
        key, w, p_hat, inputs, in_mask, gumbel
    )

    # Z-count: evaluate the K winner samples at every input's geometry.
    # input ctx [R, 1(K), ..., H, W] × winners [K, ..., H, W] → [R, K, H, W].
    ctx_r = jax.tree.map(lambda a: a[:, None], input_ctxs)
    p_hat_at_inputs = target_pdf(ctx_r, sel_pos, sel_color, features)
    if features.spatial_reuse_visibility_check:
        vis = visibility_from(input_ctxs.position[:, None], sel_pos, geometry)
        p_hat_at_inputs = jnp.where(vis, p_hat_at_inputs, 0.0)

    z = jnp.sum(
        jnp.where((p_hat_at_inputs > 0.0) & in_mask[:, None], inputs.m, 0.0),
        axis=0,
    )  # [K, H, W]

    big_w = _safe_big_w(w_sum, sel_p_hat, z, (sel_p_hat > 0.0) & (z > 0.0))
    return Reservoirs(pos=sel_pos, color=sel_color, w_sum=w_sum, m=m_out,
                      big_w=big_w, chosen_w=sel_w)


def visibility_from(from_position, sample_pos, geometry) -> jnp.ndarray:
    """visibility() generalised to per-sample origins (neighbour surface
    points in the unbiased Z-count, reservoir.cpp:90).
    from_position [..., 3, H, W] broadcastable against sample_pos.
    Inputs stop-gradded (see visibility)."""
    from_position = jax.lax.stop_gradient(from_position)
    sample_pos = jax.lax.stop_gradient(sample_pos)
    to = sample_pos - from_position
    dist = vnorm(to)
    d = to / e(jnp.maximum(dist, 1e-20))
    origin = from_position + SHADOW_RAY_EPSILON * d
    t_max = vnorm(sample_pos - origin)
    origin = jnp.broadcast_to(origin, d.shape)
    occluded = intersect_any_fast(origin, d, t_max, geometry)
    return (~occluded) | (dist <= SHADOW_RAY_EPSILON)


def clamp_temporal_m(prev: Reservoirs, current_total_m, clamp: float) -> Reservoirs:
    """Temporal M-clamping (reference temporalReuse,
    render_utils.cpp:151-163): if the predecessor's total M exceeds
    clamp * current_total_m + 1, rescale each lane's wSum by (bound / M_lane)
    and set M_lane = bound. Float math (the reference uses integer division at
    render_utils.cpp:160 — a documented quirk we do not copy)."""
    bound = clamp * current_total_m + 1.0  # [H, W]
    needs = prev.total_m() > bound  # [H, W]
    lane_nonzero = prev.m > 0.0
    scale = jnp.where(lane_nonzero,
                      bound[None] / jnp.maximum(prev.m, 1e-37), 1.0)
    apply = needs[None] & lane_nonzero
    new_w_sum = jnp.where(apply, prev.w_sum * scale, prev.w_sum)
    new_m = jnp.where(apply, jnp.broadcast_to(bound[None], prev.m.shape),
                      prev.m)
    return prev.replace(w_sum=new_w_sum, m=new_m)
