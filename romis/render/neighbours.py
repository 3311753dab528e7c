"""Fixed per-pixel resampling neighbourhoods for R-MIS / R-OMIS.

Reference: src/rendering/neighbour_selection.cpp. Every pixel gets a fixed
list of D+1 coordinates (itself first, neighbour_selection.cpp:38/75) chosen
once from the ±radius box around it, either uniformly at random
(indicesRandom, 24-43) or by similarity classification + per-strategy
sampling without replacement (indicesSimilarity, 45-105).

Formulation: sampling-without-replacement per class is Gumbel top-D with
a large class offset added to the preferred class's scores — uniformly random
within a class, preferred class first, deficit falls back to the other class
(exactly std::sample + deficit fill). The (2r+1)² box is streamed in offset
blocks with a running top-D merge so memory stays O(D·H·W), not O(box·H·W).

Bug fixed vs reference: areSimilar compares the normal dot product against
the *angle in radians* instead of its cosine (neighbour_selection.cpp:16-18);
we compare against cos(angle).

Layout: image-minor; returns neighbour coordinate fields [D+1, H, W].
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.features import Features, NeighbourSelectionStrategy
from ..core.types import ShadeCtx
from ..core.vec import vdot

_CLASS_OFFSET = 1e6  # ranks preferred-class scores above the other class


def _similar(ctx: ShadeCtx, nbr_ctx: ShadeCtx, features: Features):
    """areSimilar (neighbour_selection.cpp:7-22), cosine fix applied.
    ctx fields [H, W]; nbr_ctx fields [B, ..., H, W] → [B, H, W]."""
    ok = jnp.ones(nbr_ctx.depth_t.shape, bool)
    if features.neighbour_same_geometry:
        ok &= nbr_ctx.geom_id == ctx.geom_id
    depth_frac = jnp.abs(
        1.0 - ctx.depth_t / jnp.maximum(nbr_ctx.depth_t, 1e-20))
    ok &= depth_frac <= features.neighbour_max_depth_difference_fraction
    max_cos = np.cos(features.neighbour_max_normal_angle_difference_radians)
    ok &= vdot(ctx.normal, nbr_ctx.normal) >= max_cos
    return ok


def _similar_planes(ctx: ShadeCtx, g5, features: Features):
    """_similar against a gathered [5, H, W] gate stack (geom_id, depth,
    normal3) instead of a full ShadeCtx."""
    ok = jnp.ones(g5.shape[-2:], bool)
    if features.neighbour_same_geometry:
        ok &= g5[0].astype(jnp.int32) == ctx.geom_id
    depth_frac = jnp.abs(1.0 - ctx.depth_t / jnp.maximum(g5[1], 1e-20))
    ok &= depth_frac <= features.neighbour_max_depth_difference_fraction
    max_cos = np.cos(features.neighbour_max_normal_angle_difference_radians)
    ok &= (ctx.normal[0] * g5[2] + ctx.normal[1] * g5[3]
           + ctx.normal[2] * g5[4]) >= max_cos
    return ok


def select_neighbour_indices(
    key,
    ctx: ShadeCtx,
    height: int,
    width: int,
    features: Features,
):
    """Per-pixel neighbour coordinates (rows [D+1, H, W], cols [D+1, H, W]),
    self first. Reference: generateResampleIndicesGrid
    (neighbour_selection.cpp:107-122).

    ``ctx`` is stop-gradded: the output is integer coordinates (zero
    gradient by definition — neighbour choice is a discrete decision, the
    same stop-grad-the-selection treatment as WRS winners, SURVEY §7.1)."""
    ctx = jax.lax.stop_gradient(ctx)
    d = features.num_neighbours_to_sample
    radius = features.spatial_resample_radius
    rows = jnp.arange(height, dtype=jnp.int32)[:, None]
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]
    self_r = jnp.broadcast_to(rows, (1, height, width))
    self_c = jnp.broadcast_to(cols, (1, height, width))

    strategy = features.neighbour_selection_strategy
    if strategy == NeighbourSelectionStrategy.RANDOM:
        # indicesRandom (24-43): D uniform picks in the *clamped* window.
        lo_y = jnp.maximum(rows - radius, 0)
        hi_y = jnp.minimum(rows + radius, height - 1)
        lo_x = jnp.maximum(cols - radius, 0)
        hi_x = jnp.minimum(cols + radius, width - 1)
        ky, kx = jax.random.split(key)
        u_y = jax.random.uniform(ky, (d, height, width))
        u_x = jax.random.uniform(kx, (d, height, width))
        ny = lo_y + jnp.floor(u_y * (hi_y - lo_y + 1)).astype(jnp.int32)
        nx = lo_x + jnp.floor(u_x * (hi_x - lo_x + 1)).astype(jnp.int32)
        return (jnp.concatenate([self_r, ny], axis=0),
                jnp.concatenate([self_c, nx], axis=0))

    # Similarity strategies: stream the (2r+1)²-1 box offsets in blocks,
    # keeping a running top-D per class-weighted score. The selected
    # *coordinates* are carried as packed ny*width+nx integers.
    offsets = [
        (dy, dx)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
        if not (dy == 0 and dx == 0)
    ]
    offsets = np.asarray(offsets, np.int32)
    block = 8
    pad = (-len(offsets)) % block
    pad_mask = np.concatenate(
        [np.ones(len(offsets), bool), np.zeros(pad, bool)])
    if pad:
        offsets = np.concatenate(
            [offsets, np.tile(offsets[-1:], (pad, 1))], axis=0)
    n_blocks = len(offsets) // block
    off_blocks = jnp.asarray(offsets.reshape(n_blocks, block, 2))
    mask_blocks = jnp.asarray(pad_mask.reshape(n_blocks, block))

    keys = jax.random.split(key, n_blocks)

    want_two_classes = (
        strategy == NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR
    )
    prefer_similar = strategy in (
        NeighbourSelectionStrategy.SIMILAR,
        NeighbourSelectionStrategy.EQUAL_SIMILAR_DISSIMILAR,
    )

    # The similarity inputs of every box offset are SHIFTED copies of the
    # same 5 planes (geom_id, depth, normal3). Fetch them with
    # lax.dynamic_slice out of one padded stack — bandwidth-bound copies —
    # instead of per-offset XLA gathers, which are HBM-latency-bound at
    # ~53 ns/index and made this phase cost seconds per frame (the gather
    # also dragged all ~20 ShadeCtx planes, not 5).
    gate = jnp.concatenate([
        ctx.geom_id.astype(jnp.float32)[None], ctx.depth_t[None], ctx.normal,
    ], axis=0)
    gate_pad = jnp.pad(gate, ((0, 0), (radius, radius), (radius, radius)))

    def block_scores(blk_key, offs, valid_mask):
        """One offset block → (packed idx [B, H, W], similar, in_bounds,
        gumbel). Only in-bounds coords are classified (the reference iterates
        the window clamped to the screen, neighbour_selection.cpp:55-58) —
        out-of-screen lanes read zero-pad but are masked by in_b."""
        ny = rows[None] + offs[:, 0, None, None]  # [B, H, W]
        nx = cols[None] + offs[:, 1, None, None]
        in_b = ((ny >= 0) & (ny < height) & (nx >= 0) & (nx < width)
                & valid_mask[:, None, None])
        nyc = jnp.clip(ny, 0, height - 1)
        nxc = jnp.clip(nx, 0, width - 1)
        idx = nyc * width + nxc
        sim = jnp.stack([
            _similar_planes(
                ctx,
                jax.lax.dynamic_slice(
                    gate_pad, (0, radius + offs[b, 0], radius + offs[b, 1]),
                    (5, height, width)),
                features)
            for b in range(offs.shape[0])
        ], axis=0)
        g = jax.random.gumbel(blk_key, sim.shape)
        return idx, sim, in_b, g

    def topd_merge(scores_a, idx_a, scores_b, idx_b):
        # Top-D of D+B items per pixel by repeated max-extraction with
        # one-hot selects — argsort + take_along_axis along axis 0 lower to
        # per-pixel sorts and gathers.
        s = jnp.concatenate([scores_a, scores_b], axis=0)
        i = jnp.concatenate([idx_a, idx_b], axis=0)
        n = s.shape[0]
        lane = jnp.arange(n, dtype=jnp.int32)[:, None, None]
        out_s, out_i = [], []
        for _ in range(d):
            am = jnp.argmax(s, axis=0)  # first max wins (stable)
            sel = lane == am[None]
            out_s.append(jnp.max(s, axis=0))
            out_i.append(jnp.sum(jnp.where(sel, i, 0), axis=0))
            s = jnp.where(sel, -jnp.inf, s)
        return jnp.stack(out_s, axis=0), jnp.stack(out_i, axis=0)

    def unpack(idx):
        return idx // width, idx % width

    if not want_two_classes:
        def body(carry, inp):
            best_s, best_i = carry
            blk_key, offs, vmask = inp
            idx, sim, in_b, g = block_scores(blk_key, offs, vmask)
            cls = sim if prefer_similar else ~sim
            score = jnp.where(in_b, g + cls * _CLASS_OFFSET, -jnp.inf)
            return topd_merge(best_s, best_i, score, idx), None

        init = (jnp.full((d, height, width), -jnp.inf),
                jnp.zeros((d, height, width), jnp.int32))
        (best_s, best_i), _ = jax.lax.scan(
            body, init, (keys, off_blocks, mask_blocks))
        self_pack = rows * width + cols
        best_i = jnp.where(jnp.isfinite(best_s), best_i, self_pack[None])
        ny, nx = unpack(best_i)
        return (jnp.concatenate([self_r, ny], axis=0),
                jnp.concatenate([self_c, nx], axis=0))

    # EqualSimilarDissimilar (neighbour_selection.cpp:91-99): keep top-D of
    # each class plus class counts, then take
    # n_sim = min(D//2 + 1, |similar|) (deficit-corrected) similars and
    # D - n_sim dissimilars.
    def body(carry, inp):
        s_s, i_s, s_d, i_d, c_s, c_d = carry
        blk_key, offs, vmask = inp
        idx, sim, in_b, g = block_scores(blk_key, offs, vmask)
        sim_score = jnp.where(in_b & sim, g, -jnp.inf)
        dis_score = jnp.where(in_b & ~sim, g, -jnp.inf)
        (s_s, i_s) = topd_merge(s_s, i_s, sim_score, idx)
        (s_d, i_d) = topd_merge(s_d, i_d, dis_score, idx)
        c_s = c_s + jnp.sum(in_b & sim, axis=0)
        c_d = c_d + jnp.sum(in_b & ~sim, axis=0)
        return (s_s, i_s, s_d, i_d, c_s, c_d), None

    init = (jnp.full((d, height, width), -jnp.inf),
            jnp.zeros((d, height, width), jnp.int32),
            jnp.full((d, height, width), -jnp.inf),
            jnp.zeros((d, height, width), jnp.int32),
            jnp.zeros((height, width), jnp.int32),
            jnp.zeros((height, width), jnp.int32))
    (s_s, i_s, s_d, i_d, c_s, c_d), _ = jax.lax.scan(
        body, init, (keys, off_blocks, mask_blocks))

    n_sim = jnp.minimum(d // 2 + 1, c_s)
    n_sim = jnp.maximum(n_sim, d - jnp.minimum(c_d, d))  # deficit fill
    n_sim = jnp.minimum(n_sim, d)  # [H, W]
    ranks = jnp.arange(d)[:, None, None]
    take_sim = ranks < n_sim[None]
    sim_pick = jnp.where(take_sim & jnp.isfinite(s_s), i_s, -1)
    dis_rank = ranks - n_sim[None]
    take_dis = (dis_rank >= 0) & (dis_rank < (d - n_sim)[None])
    dis_idx_at = jnp.take_along_axis(i_d, jnp.clip(dis_rank, 0, d - 1),
                                     axis=0)
    dis_fin = jnp.take_along_axis(jnp.isfinite(s_d),
                                  jnp.clip(dis_rank, 0, d - 1), axis=0)
    picks = jnp.where(take_sim, sim_pick,
                      jnp.where(take_dis & dis_fin, dis_idx_at, -1))
    self_pack = rows * width + cols
    picks = jnp.where(picks < 0, self_pack[None], picks)
    ny, nx = unpack(picks)
    return (jnp.concatenate([self_r, ny], axis=0),
            jnp.concatenate([self_c, nx], axis=0))
