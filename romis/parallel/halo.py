"""Hand-scheduled shard_map spatial reuse with ppermute halo exchange.

This is the bandwidth-optimal alternative to letting GSPMD lower the spatial
neighbour gathers (parallel/shard.py): the image is sharded into horizontal
row bands, and before each reuse pass every device exchanges only a
``radius``-row halo with its two mesh neighbours
(`jax.lax.ppermute`, NCCL peer-to-peer on GPUs) — the structural analog the SURVEY maps spatial reuse
onto (§2.4 "Halo exchange for spatial reuse", §5 sequence-parallel row).

The neighbour offsets are bounded by ±radius per pass
(render_utils.cpp:108-111), so a fixed halo of ``radius`` rows suffices; the
halo must be re-exchanged after every pass because the combine rewrites the
whole grid (the reference's per-pass grid copy, render_utils.cpp:138).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from ..core.features import Features
from ..core.types import Reservoirs, ShadeCtx
from ..render.restir import spatial_pass
from .mesh import TILE_AXIS


def _halo_extend(x, radius: int, n_dev: int):
    """Extend a local row-band [..., h_loc, W] with radius rows from the
    mesh neighbours above and below → [..., h_loc + 2r, W]. Edge devices
    receive zeros (never read thanks to global clamping)."""
    if n_dev == 1:
        pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (0, 0)]
        return jnp.pad(x, pad)
    top = x[..., :radius, :]
    bottom = x[..., -radius:, :]
    # Halo above my band = previous device's bottom rows.
    from_above = jax.lax.ppermute(
        bottom, TILE_AXIS, [(i, i + 1) for i in range(n_dev - 1)])
    from_below = jax.lax.ppermute(
        top, TILE_AXIS, [(i + 1, i) for i in range(n_dev - 1)])
    return jnp.concatenate([from_above, x, from_below], axis=-2)


def _gather_local(a, iy, ix):
    """Gather [..., h_ext, W] at local coords iy/ix [R, h_loc, W]
    → [R, ..., h_loc, W]."""
    g = a[..., iy, ix]
    return jnp.moveaxis(g, -3, 0)


def render_frame_halo(
    key,
    cam,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
    prev,
    mesh,
):
    """Full ReSTIR frame with the explicit halo-exchange spatial reuse: all
    per-pixel phases run under GSPMD row sharding (parallel/shard.py) and the
    spatial passes run as shard_map with ppermute halos. Returns
    (image [H, W, 3], TemporalState)."""
    import jax.numpy as jnp

    from ..core.camera import generate_rays
    from ..ops.shading import exposure_tone_mapping
    from ..ops.wrs import gen_canonical_samples
    from ..render.restir import (
        PH_CANDIDATES, PH_SPATIAL, PH_TEMPORAL, TemporalState, final_shade,
        temporal_reuse, trace_primary,
    )
    from .mesh import shard_pixels

    rays = shard_pixels(generate_rays(cam, height, width), mesh)
    _, ctx = trace_primary(rays, geometry, features)
    ctx = shard_pixels(ctx, mesh)

    res = gen_canonical_samples(
        jax.random.fold_in(key, PH_CANDIDATES), ctx, lights, num_lights,
        geometry, features)
    res = shard_pixels(res, mesh)

    if features.temporal_reuse:
        res = temporal_reuse(jax.random.fold_in(key, PH_TEMPORAL), ctx, res,
                             prev, height, width, features)
        res = shard_pixels(res, mesh)

    if features.spatial_reuse:
        res = spatial_reuse_halo(jax.random.fold_in(key, PH_SPATIAL), ctx,
                                 res, height, width, geometry, features,
                                 mesh)

    color = final_shade(ctx, res, geometry, features)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = jnp.moveaxis(color, 0, -1)
    state = TemporalState(reservoirs=res, ctx=ctx, cam=cam,
                          has_prev=jnp.array(True))
    return image, state


def spatial_reuse_halo(
    key,
    ctx: ShadeCtx,
    reservoirs: Reservoirs,
    height: int,
    width: int,
    geometry,
    features: Features,
    mesh,
    inject=None,  # per-pass (offs [2,R,H,W], gumbel [R+1,K,H,W]) — tests
) -> Reservoirs:
    """shard_map spatial reuse over row bands. Semantically equivalent to
    render.restir.spatial_reuse (same gates, same combines); the random
    neighbour draws use per-device folded keys so the offset *pattern*
    differs from the single-device path, but the estimator contract is
    identical. ``inject`` feeds explicit global offsets + race noise so
    parity tests can assert BITWISE equality against the single-device
    path (tests/test_parallel.py)."""
    n_dev = mesh.shape[TILE_AXIS]
    assert height % n_dev == 0, "image rows must divide the mesh"
    h_loc = height // n_dev
    radius = features.spatial_resample_radius
    k_n = features.num_neighbours_to_sample

    def spec_for(a):
        return P(*([None] * (a.ndim - 2)), TILE_AXIS, None)

    pix_specs_ctx = jax.tree.map(spec_for, ctx)
    pix_specs_res = jax.tree.map(spec_for, reservoirs)
    rep = jax.tree.map(lambda a: P(), geometry)
    inj = tuple(inject) if inject is not None else ()
    inj_specs = jax.tree.map(spec_for, inj)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), pix_specs_ctx, pix_specs_res, rep, inj_specs),
        out_specs=pix_specs_res,
        check_rep=False,
    )
    def run(key, ctx_l, res_l, geometry, inj_l):
        dev = jax.lax.axis_index(TILE_AXIS)
        base = dev * h_loc  # first global row of this band
        rows_g = base + jnp.arange(h_loc, dtype=jnp.int32)[:, None]
        cols = jnp.arange(width, dtype=jnp.int32)[None, :]
        dkey = jax.random.fold_in(key, dev)

        for p in range(features.spatial_resampling_passes):
            kp = jax.random.fold_in(dkey, p)
            gumbel = None
            if inj_l:
                offs, gumbel = inj_l[p]
            else:
                offs = jax.random.randint(kp, (2, k_n, h_loc, width),
                                          -radius, radius + 1)
            gy = jnp.clip(rows_g[None] + offs[0], 0, height - 1)
            nx = jnp.clip(cols[None] + offs[1], 0, width - 1)
            iy = gy - base + radius  # local index into the halo-extended band

            res_ext = jax.tree.map(
                lambda a: _halo_extend(a, radius, n_dev), res_l)
            ctx_ext = jax.tree.map(
                lambda a: _halo_extend(a, radius, n_dev), ctx_l)

            nbr = jax.tree.map(lambda a: _gather_local(a, iy, nx), res_ext)
            nbr_ctx = jax.tree.map(lambda a: _gather_local(a, iy, nx),
                                   ctx_ext)

            res_l = spatial_pass(
                jax.random.fold_in(kp, 1000), ctx_l, res_l, nbr, nbr_ctx,
                geometry, features, gumbel,
            )
        return res_l

    return run(key, ctx, reservoirs, geometry, inj)
