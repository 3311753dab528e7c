"""The ReSTIR pipeline: trace → RIS → temporal reuse → spatial reuse → shade.

Reference analog: renderReSTIR (src/rendering/render.cpp:28-62) and its
building blocks (src/rendering/render_utils.cpp). Each phase is a pure
function over image-minor SoA state (core/vec.py layout); the whole frame is
one jittable function and an animation is a `lax.scan` over frames carrying
``TemporalState`` (replacing the reference's shared_ptr<ReservoirGrid> frame
carry, src/main.cpp:65,165).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.camera import CameraParams, generate_rays, project_to_pixel
from ..core.features import Features
from ..core.types import (
    Rays, Reservoirs, ShadeCtx, empty_reservoirs, pytree_dataclass,
)
from ..core.vec import e, vdot
from ..ops.gather import halo_offset_gather
from ..ops.intersect import closest_hit_diff, make_hit_record, make_shade_ctx
from ..ops.shading import exposure_tone_mapping, phong_shade
from ..ops.wrs import (
    clamp_temporal_m,
    combine_biased,
    combine_unbiased,
    gen_canonical_samples,
    visibility,
)

# Phase ids for RNG key folding — every random draw in a frame derives from
# fold_in(frame_key, PHASE)... — deterministic and shard-invariant (replaces
# the reference's seedless libc rand(), see SURVEY §5 RNG note).
PH_CANDIDATES = 1
PH_TEMPORAL = 2
PH_SPATIAL = 3

# Spatial-reuse similarity gates, hardcoded in the reference's inline check
# (render_utils.cpp:113-118): >10% depth difference or >25° normal difference
# rejects a neighbour. cos(25°) = 0.90630778703.
SPATIAL_DEPTH_FRAC = 0.1
SPATIAL_NORMAL_COS = 0.90630778703


@pytree_dataclass
class TemporalState:
    """Frame-to-frame carry for temporal reuse."""

    reservoirs: Reservoirs  # [K, ..., H, W]
    ctx: ShadeCtx  # previous frame's receiver geometry
    cam: CameraParams  # previous frame's camera (for motion reprojection)
    has_prev: jnp.ndarray  # [] bool


def gather_image(a, ny, nx):
    """Gather pixel data at integer coords ny/nx [R, H, W] from an
    image-minor field a [..., H, W] → [R, ..., H, W]."""
    g = a[..., ny, nx]  # [..., R, H, W]
    return jnp.moveaxis(g, -3, 0)


def trace_primary(rays: Rays, geometry, features: Features):
    """Primary hits for the full ray grid (reference genPrimaryRayHits,
    render_utils.cpp:13-34)."""
    t, tri, u, v = closest_hit_diff(rays, geometry)
    hits = make_hit_record(rays, geometry, t, tri, u, v)
    ctx = make_shade_ctx(rays, hits, geometry, features)
    return hits, ctx


def temporal_reuse(
    key,
    ctx: ShadeCtx,
    current: Reservoirs,
    prev: TemporalState,
    height: int,
    width: int,
    features: Features,
    records=None,  # [K, 3, H, W] canonical replay records (records mode)
    lights=None,
):
    """Temporal reuse with M-clamping (reference temporalReuse,
    render_utils.cpp:142-177): clamp the predecessor's history, then a 2-way
    biased combine of {current, predecessor}.

    With ``features.temporal_reprojection`` the predecessor is fetched at the
    motion-reprojected pixel (project the current hit point through the
    previous camera) and validated with depth/normal gates — a capability the
    reference lacks (it reuses the same screen coordinate,
    render_utils.cpp:151-172; report §2).

    The fetch is bounded to ±features.reprojection_radius pixels;
    out-of-band motion reuse-REJECTS (disocclusion treatment)."""
    if features.temporal_reprojection:
        rows_f, cols_f, in_front = project_to_pixel(
            prev.cam, ctx.position, height, width
        )  # each [H, W]
        ri = jnp.clip(jnp.round(rows_f).astype(jnp.int32), 0, height - 1)
        ci = jnp.clip(jnp.round(cols_f).astype(jnp.int32), 0, width - 1)
        in_bounds = (
            (rows_f >= -0.5) & (rows_f <= height - 0.5)
            & (cols_f >= -0.5) & (cols_f <= width - 0.5) & in_front
        )
        rows = jnp.arange(height, dtype=jnp.int32)[:, None]
        cols = jnp.arange(width, dtype=jnp.int32)[None, :]
        dy = ri - rows
        dx = ci - cols
        rr = features.reprojection_radius
        in_band = (jnp.abs(dy) <= rr) & (jnp.abs(dx) <= rr)
        # Clipping only shrinks |offset| toward 0 and ri/ci are screen-
        # clamped, so i + dy stays in [0, H-1] (the gather contract);
        # out-of-band pixels read a clamped cell whose value pred_mask
        # discards.
        dy = jnp.clip(dy, -rr, rr)
        dx = jnp.clip(dx, -rr, rr)

        k = prev.reservoirs.m.shape[0]
        # Slim pack: reservoir planes + the 5 gate planes (normal, depth,
        # valid) — position/view/kd/ks of the previous ctx are never read.
        planes = jnp.concatenate([
            pack_reservoir_planes(prev.reservoirs),
            prev.ctx.normal, prev.ctx.depth_t[None],
            prev.ctx.valid.astype(jnp.float32)[None],
        ], axis=0)
        g = halo_offset_gather(planes, dy[None], dx[None])[0]
        pred = unpack_reservoir_planes(g[:10 * k], k)
        p_normal = g[10 * k:10 * k + 3]
        p_depth = g[10 * k + 3]
        p_valid = g[10 * k + 4] > 0.5
        # Validity gates: depth within 10%, normals within 25° (reuse of the
        # reference's similarity thresholds, fixed — see
        # neighbour_selection.cpp:16-18 bug note).
        depth_ok = (
            jnp.abs(1.0 - p_depth / jnp.maximum(ctx.depth_t, 1e-20))
            <= SPATIAL_DEPTH_FRAC
        )
        normal_ok = vdot(p_normal, ctx.normal) >= SPATIAL_NORMAL_COS
        pred_mask = (in_bounds & in_band & ctx.valid & p_valid & depth_ok
                     & normal_ok)
    else:
        pred = prev.reservoirs
        pred_mask = jnp.ones((height, width), bool)

    pred_mask = pred_mask & prev.has_prev

    pred = clamp_temporal_m(pred, current.total_m(),
                            float(features.temporal_clamp_m))

    inputs = jax.tree.map(
        lambda a, b: jnp.stack([a, b], axis=0), current, pred
    )  # [2, K, ..., H, W]
    in_mask = jnp.stack(
        [jnp.ones((height, width), bool), pred_mask], axis=0)
    if records is not None:
        # Records mode: temporal inputs are same-pixel (no gather), so the
        # EXACT combine keeps serving values AND gradients unchanged — it
        # only additionally selects the winner's replay record for the
        # downstream spatial passes. The predecessor carries no record
        # (idx = -1): its sample attributes are previous-frame data,
        # constant w.r.t. current-step params.
        no_rec = records.at[:, 0].set(-1.0)
        rec_in = jnp.stack([records, no_rec], axis=0)
        return combine_biased(key, ctx, inputs, in_mask, features,
                              records=rec_in)
    return combine_biased(key, ctx, inputs, in_mask, features)


def spatial_pass(
    combine_key,
    ctx: ShadeCtx,
    reservoirs: Reservoirs,
    nbr: Reservoirs,  # gathered neighbours, fields [R, K, ..., h, w]
    nbr_ctx: ShadeCtx,  # gathered neighbour geometry, fields [R, ..., h, w]
    geometry,
    features: Features,
    gumbel=None,  # optional pre-drawn [R+1, K, h, w] race noise (parity tests)
    records=None,  # (self_rec [K,3,h,w], nbr_rec [R,K,3,h,w]) records mode
    lights=None,
):
    """One spatial-reuse combine given already-gathered neighbours: apply the
    depth/normal rejection gates (biased mode, render_utils.cpp:113-118) and
    combine {neighbours..., self} (render_utils.cpp:121-132). Shared by the
    single-device gather path and the shard_map halo-exchange path."""
    hw = ctx.depth_t.shape[-2:]
    k_n = nbr.m.shape[0]

    if features.unbiased_combination:
        nbr_mask = jnp.ones((k_n,) + hw, bool)
    else:
        depth_ok = (
            jnp.abs(1.0 - nbr_ctx.depth_t / jnp.maximum(ctx.depth_t, 1e-20))
            <= SPATIAL_DEPTH_FRAC
        )
        normal_ok = vdot(nbr_ctx.normal, ctx.normal) >= SPATIAL_NORMAL_COS
        nbr_mask = depth_ok & normal_ok & ctx.valid & nbr_ctx.valid

    # Stream order in the reference is [neighbours..., self]
    # (render_utils.cpp:121-124); order is immaterial here (order-invariant
    # selection) but the mask layout mirrors it.
    inputs = jax.tree.map(
        lambda nb, s: jnp.concatenate([nb, s[None]], axis=0),
        nbr, reservoirs,
    )
    in_mask = jnp.concatenate([nbr_mask, jnp.ones((1,) + hw, bool)], axis=0)

    if features.unbiased_combination:
        input_ctxs = jax.tree.map(
            lambda nc, s: jnp.concatenate([nc, s[None]], axis=0),
            nbr_ctx, ctx,
        )
        return combine_unbiased(
            combine_key, ctx, inputs, in_mask, input_ctxs, geometry,
            features, gumbel
        )
    if features.surrogate_resampling_grad:
        # Winner-replay surrogate for the spatial race (same estimator
        # shape as RIS candidate generation): detached R-way sweep, winner
        # re-evaluated backward, w_sum gradient via a second race. Values
        # match combine_biased bit-for-bit (shared primary gumbel).
        from ..ops.wrs import combine_biased_surrogate

        rec_in = None
        if records is not None:
            self_rec, nbr_rec = records
            rec_in = jnp.concatenate([nbr_rec, self_rec[None]], axis=0)
        return combine_biased_surrogate(combine_key, ctx, inputs, in_mask,
                                        features, gumbel, records=rec_in,
                                        lights=lights)
    return combine_biased(combine_key, ctx, inputs, in_mask, features,
                          gumbel)


def pack_pixel_planes(res: Reservoirs, ctx: ShadeCtx) -> jnp.ndarray:
    """Planes-first packing [C, H, W] for the spatial neighbour gather —
    pure concatenation, no transposes (image-minor layout preserved)."""
    h, w = ctx.depth_t.shape[-2:]

    def flat(a):
        return a.reshape((-1, h, w))

    return jnp.concatenate([
        flat(res.pos), flat(res.color), res.w_sum, res.m, res.big_w,
        res.chosen_w,
        ctx.position, ctx.normal, ctx.view_origin, ctx.kd, ctx.ks,
        ctx.shininess[None], ctx.depth_t[None],
        ctx.geom_id.astype(jnp.float32)[None],
        ctx.valid.astype(jnp.float32)[None],
    ], axis=0)


def unpack_pixel_planes(g: jnp.ndarray, k: int):
    """Inverse of pack_pixel_planes for gathered planes [N, C, H, W] →
    (Reservoirs [N, K, ..., H, W], ShadeCtx [N, ..., H, W])."""
    n = g.shape[0]
    hw = g.shape[-2:]
    pos = [0]

    def take(cnt, shape):
        a = g[:, pos[0]:pos[0] + cnt]
        pos[0] += cnt
        return a.reshape((n,) + shape + hw)

    res = Reservoirs(
        pos=take(3 * k, (k, 3)), color=take(3 * k, (k, 3)),
        w_sum=take(k, (k,)), m=take(k, (k,)), big_w=take(k, (k,)),
        chosen_w=take(k, (k,)),
    )
    ctx = ShadeCtx(
        valid=jnp.zeros(()),
        position=take(3, (3,)), normal=take(3, (3,)),
        view_origin=take(3, (3,)), kd=take(3, (3,)), ks=take(3, (3,)),
        shininess=take(1, ()), depth_t=take(1, ()),
        geom_id=take(1, ()).astype(jnp.int32),
    )
    ctx = ctx.replace(valid=take(1, ()) > 0.5)
    return res, ctx


def pack_reservoir_planes(res: Reservoirs) -> jnp.ndarray:
    """Reservoirs → the [10K, H, W] plane block of pack_pixel_planes
    (reservoir part only): pos 3K | color 3K | w_sum K | m K | big_w K |
    chosen_w K."""
    hw = res.w_sum.shape[-2:]
    return jnp.concatenate([
        res.pos.reshape((-1,) + hw), res.color.reshape((-1,) + hw),
        res.w_sum, res.m, res.big_w, res.chosen_w,
    ], axis=0)


def unpack_reservoir_planes(g: jnp.ndarray, k: int) -> Reservoirs:
    """[10K, H, W] reservoir-plane block (pack_pixel_planes order) →
    Reservoirs."""
    hw = g.shape[-2:]
    return Reservoirs(
        pos=g[0:3 * k].reshape((k, 3) + hw),
        color=g[3 * k:6 * k].reshape((k, 3) + hw),
        w_sum=g[6 * k:7 * k],
        m=g[7 * k:8 * k],
        big_w=g[8 * k:9 * k],
        chosen_w=g[9 * k:10 * k],
    )


def spatial_reuse(
    key,
    ctx: ShadeCtx,
    reservoirs: Reservoirs,
    height: int,
    width: int,
    geometry,
    features: Features,
    inject=None,  # per-pass (offs [2,R,H,W], gumbel [R+1,K,H,W]) — tests
    records=None,  # [K, 3, H, W] replay records → returns (res, records)
    lights=None,
):
    """Spatial reuse (reference spatialReuse, render_utils.cpp:87-140):
    per pass, every pixel picks ``num_neighbours_to_sample`` uniform offsets
    in the ±radius box (clamped to the screen), rejects dissimilar neighbours
    when using the biased combine (depth/normal gates,
    render_utils.cpp:113-118), and combines {neighbours..., self}."""
    k_n = features.num_neighbours_to_sample
    radius = features.spatial_resample_radius
    k = features.num_samples_in_reservoir

    if records is not None and inject is None:
        # ===== replay-records gradient path =====
        # Every input plane is gathered DETACHED except big_w: the combine
        # re-derives winner pos/color from the gathered replay records
        # (combine_biased_surrogate records mode), so pos/color cotangents
        # no longer chain through the gather/select graph. The race
        # keys/offsets match the non-records surrogate path exactly, so
        # forward values are unchanged (up to ~1 ulp of winner
        # re-derivation).
        rec = records
        k = features.num_samples_in_reservoir
        rows = jnp.arange(height, dtype=jnp.int32)[:, None]
        cols = jnp.arange(width, dtype=jnp.int32)[None, :]
        for p in range(features.spatial_resampling_passes):
            kp = jax.random.fold_in(key, p)
            planes = jnp.concatenate([
                pack_pixel_planes(reservoirs, ctx),
                rec.reshape(3 * k, height, width)], axis=0)
            planes_d = jax.lax.stop_gradient(planes)
            c_main = planes.shape[0] - 3 * k
            bw = reservoirs.big_w  # the ONE differentiable gather (K planes)
            if features.coherent_spatial_offsets:
                offs = jax.random.randint(kp, (2, k_n), -radius, radius + 1)
                pad2 = ((0, 0), (radius, radius), (radius, radius))
                padded = jnp.pad(planes_d, pad2, mode="edge")
                bw_pad = jnp.pad(bw, pad2, mode="edge")
                g = jnp.stack([
                    jax.lax.dynamic_slice(
                        padded,
                        (0, radius + offs[0, n], radius + offs[1, n]),
                        planes_d.shape) for n in range(k_n)])
                bw_g = jnp.stack([
                    jax.lax.dynamic_slice(
                        bw_pad,
                        (0, radius + offs[0, n], radius + offs[1, n]),
                        bw.shape) for n in range(k_n)])
            else:
                offs = jax.random.randint(kp, (2, k_n, height, width),
                                          -radius, radius + 1)
                dy = jnp.clip(rows[None] + offs[0], 0, height - 1) \
                    - rows[None]
                dx = jnp.clip(cols[None] + offs[1], 0, width - 1) \
                    - cols[None]
                g = halo_offset_gather(planes_d, dy, dx)
                bw_g = halo_offset_gather(bw, dy, dx)
            nbr, nbr_ctx = unpack_pixel_planes(g[:, :c_main], k)
            nbr = nbr.replace(big_w=bw_g)
            nbr_rec = g[:, c_main:].reshape(k_n, k, 3, height, width)
            reservoirs, rec = spatial_pass(
                jax.random.fold_in(kp, 1000), ctx, reservoirs, nbr,
                nbr_ctx, geometry, features, records=(rec, nbr_rec),
                lights=lights)
        return reservoirs, rec

    if features.coherent_spatial_offsets and inject is None:
        # Gradient-path formulation: ONE offset per (pass, neighbour) shared
        # by every pixel (Features.coherent_spatial_offsets). The gather is
        # a dynamic_slice of the edge-padded stack — its VJP is a pad, not
        # the per-pixel gather's segment_sum scatter. Edge padding = the
        # reference's border clamp (render_utils.cpp:109-110).
        for p in range(features.spatial_resampling_passes):
            kp = jax.random.fold_in(key, p)
            offs = jax.random.randint(kp, (2, k_n), -radius, radius + 1)
            planes = pack_pixel_planes(reservoirs, ctx)
            padded = jnp.pad(planes, ((0, 0), (radius, radius),
                                      (radius, radius)), mode="edge")
            g = jnp.stack([
                jax.lax.dynamic_slice(
                    padded, (0, radius + offs[0, n], radius + offs[1, n]),
                    planes.shape)
                for n in range(k_n)])
            nbr, nbr_ctx = unpack_pixel_planes(
                g, features.num_samples_in_reservoir)
            reservoirs = spatial_pass(
                jax.random.fold_in(kp, 1000), ctx, reservoirs, nbr, nbr_ctx,
                geometry, features,
            )
        return reservoirs

    rows = jnp.arange(height, dtype=jnp.int32)[:, None]
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]

    for p in range(features.spatial_resampling_passes):
        kp = jax.random.fold_in(key, p)
        gumbel = None
        if inject is not None:
            offs, gumbel = inject[p]
        else:
            offs = jax.random.randint(kp, (2, k_n, height, width),
                                      -radius, radius + 1)
        ny = jnp.clip(rows[None] + offs[0], 0, height - 1)  # [R, H, W]
        nx = jnp.clip(cols[None] + offs[1], 0, width - 1)
        planes = pack_pixel_planes(reservoirs, ctx)
        g = halo_offset_gather(planes, ny - rows[None], nx - cols[None])
        nbr, nbr_ctx = unpack_pixel_planes(
            g, features.num_samples_in_reservoir)

        reservoirs = spatial_pass(
            jax.random.fold_in(kp, 1000), ctx, reservoirs, nbr, nbr_ctx,
            geometry, features, gumbel,
        )

    return reservoirs


def final_shade(ctx: ShadeCtx, reservoirs: Reservoirs, geometry,
                features: Features) -> jnp.ndarray:
    """Final shading (reference finalShading, render_utils.cpp:54-65):
    per lane, visibility ray × Phong × W, averaged over the K lanes.
    → [3, H, W]."""
    vis = visibility(ctx.position, reservoirs.pos, geometry)  # [K, H, W]
    shade = phong_shade(ctx, reservoirs.pos, reservoirs.color, features)
    contrib = jnp.where(e(vis), shade, 0.0) * e(reservoirs.big_w)
    return jnp.sum(contrib, axis=0) / reservoirs.k


def render_restir_frame(
    key,
    cam: CameraParams,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
    prev: TemporalState,
):
    """One full ReSTIR frame (reference renderReSTIR, render.cpp:28-62).
    Returns (image [H, W, 3], TemporalState for the next frame).

    Each phase is rematerialized (jax.checkpoint): transparent for
    forward-only rendering, and under autodiff the backward recomputes a
    phase instead of storing its per-candidate residuals — without this,
    reverse-mode at 1080p stacks the RIS scan's per-slot samples into
    [S/K, K, 3, H, W] temporaries whose padded layouts exceed HBM
    (SURVEY §0: remat trades FLOPs for memory)."""
    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features)

    # Replay-records mode: on the surrogate gradient path the winner's
    # (light idx, u1, u2) record rides through temporal/spatial reuse so
    # each phase re-derives winner pos/color straight from the light
    # table — gather/select chains drop out of the backward (see
    # spatial_reuse's records branch).
    use_records = (features.surrogate_resampling_grad
                   and not features.unbiased_combination)

    if use_records:
        from ..ops.wrs import gen_canonical_with_records

        res, rec = jax.checkpoint(
            lambda k_, c_, li_, ge_: gen_canonical_with_records(
                k_, c_, li_, num_lights, ge_, features))(
            jax.random.fold_in(key, PH_CANDIDATES), ctx, lights, geometry)
    else:
        rec = None
        res = jax.checkpoint(lambda k_, c_, li_, ge_: gen_canonical_samples(
            k_, c_, li_, num_lights, ge_, features))(
            jax.random.fold_in(key, PH_CANDIDATES), ctx, lights, geometry)

    if features.temporal_reuse:
        if use_records:
            res, rec = jax.checkpoint(
                lambda k_, c_, r_, rc_, p_, li_: temporal_reuse(
                    k_, c_, r_, p_, height, width, features, records=rc_,
                    lights=li_))(
                jax.random.fold_in(key, PH_TEMPORAL), ctx, res, rec, prev,
                lights)
        else:
            res = jax.checkpoint(lambda k_, c_, r_, p_: temporal_reuse(
                k_, c_, r_, p_, height, width, features))(
                jax.random.fold_in(key, PH_TEMPORAL), ctx, res, prev)

    if features.spatial_reuse:
        if use_records:
            res, rec = spatial_reuse(
                jax.random.fold_in(key, PH_SPATIAL), ctx, res, height,
                width, geometry, features, records=rec, lights=lights)
        else:
            sp = lambda k_, c_, r_, ge_: spatial_reuse(  # noqa: E731
                k_, c_, r_, height, width, ge_, features)
            if (not features.surrogate_resampling_grad
                    or features.unbiased_combination):
                # Under the winner-replay surrogate the R-way sweep is
                # detached, so the phase's true residuals are small (winner
                # selects + two re-eval inputs) — rematerialising would
                # re-run the whole detached sweep in the backward for
                # nothing. Exact gradients keep the checkpoint (the sweep's
                # per-input residuals at 1080p exceed HBM otherwise).
                sp = jax.checkpoint(sp)
            res = sp(jax.random.fold_in(key, PH_SPATIAL), ctx, res,
                     geometry)

    color = final_shade(ctx, res, geometry, features)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = jnp.moveaxis(color, 0, -1)  # [H, W, 3] for display/output

    state = TemporalState(
        reservoirs=res, ctx=ctx, cam=cam, has_prev=jnp.array(True)
    )
    return image, state


def initial_temporal_state(height: int, width: int, k: int,
                           cam: CameraParams) -> TemporalState:
    """Zero-filled carry for the first frame (mask has_prev=False)."""
    z3 = jnp.zeros((3, height, width))
    zs = jnp.zeros((height, width))
    ctx = ShadeCtx(
        valid=jnp.zeros((height, width), bool), position=z3, normal=z3,
        view_origin=z3, kd=z3, ks=z3, shininess=zs,
        geom_id=jnp.full((height, width), -1, jnp.int32), depth_t=zs,
    )
    return TemporalState(
        reservoirs=empty_reservoirs(height, width, k), ctx=ctx, cam=cam,
        has_prev=jnp.array(False),
    )
