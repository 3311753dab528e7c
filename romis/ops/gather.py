"""Table and neighbourhood gathers in image-minor layout, with scatter-add
backward passes.

- ``gather_rows``: packed row table [T, C] + index field → planes-first
  [C, ..., H, W]; one row fetch per index instead of C column gathers
  (reference rtcInterpolate0 + geomID→Material map,
  embree_interface.cpp:76-82).
- ``halo_offset_gather``: pixel planes fetched at bounded per-pixel
  offsets (spatial reuse, temporal reprojection, R-MIS neighbourhoods).

Both are linear in the gathered array, so the backward of each is one
``segment_sum`` of the output cotangent into the source rows or pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.custom_vjp
def gather_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table [T, C] f32, idx [..., H, W] int32 (in [0, T)) → [C, ..., H, W].
    """
    return jnp.moveaxis(table[idx], -1, 0)


def _gather_rows_fwd(table, idx):
    return gather_rows(table, idx), (table.shape, idx)


def _gather_rows_bwd(res, ct):
    (t, c), idx = res
    # d_table[r, comp] = Σ_{pixels p: idx[p]=r} ct[comp, p].
    flat_ct = ct.reshape(c, -1).T  # [N, C]
    d_table = jax.ops.segment_sum(flat_ct, idx.ravel(), num_segments=t)
    return d_table, None


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


@jax.custom_vjp
def halo_offset_gather(planes, dy, dx):
    """out[d, c, i, j] = planes[c, i + dy[d,i,j], j + dx[d,i,j]].

    planes [C, H, W]; dy/dx [D, H, W] int32 offsets whose target coordinates
    are in bounds (the callers clamp). → [D, C, H, W]."""
    return _halo_offset_impl(planes, dy, dx)


def _halo_offset_impl(planes, dy, dx):
    h, w = planes.shape[-2:]
    rows = jnp.arange(h, dtype=jnp.int32)[:, None]
    cols = jnp.arange(w, dtype=jnp.int32)[None, :]
    g = planes[:, rows[None] + dy, cols[None] + dx]  # [C, D, H, W]
    return jnp.moveaxis(g, 0, 1)


def _halo_offset_fwd(planes, dy, dx):
    return _halo_offset_impl(planes, dy, dx), (dy, dx, planes.shape)


def _halo_offset_bwd(res, ct):
    dy, dx, (c, h, w) = res
    z = lambda a: np.zeros(jnp.shape(a), dtype=jax.dtypes.float0)  # noqa: E731
    rows = jnp.arange(h, dtype=jnp.int32)[:, None]
    cols = jnp.arange(w, dtype=jnp.int32)[None, :]
    flat_idx = ((rows[None] + dy) * w + (cols[None] + dx)).ravel()
    ct_flat = jnp.moveaxis(ct, 1, -1).reshape(-1, c)  # [(D H W), C]
    d_planes = jax.ops.segment_sum(ct_flat, flat_idx, num_segments=h * w)
    return (jnp.moveaxis(d_planes.reshape(h, w, c), -1, 0), z(dy), z(dx))


halo_offset_gather.defvjp(_halo_offset_fwd, _halo_offset_bwd)
