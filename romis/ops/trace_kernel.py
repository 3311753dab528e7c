"""Closest-hit and any-hit over a small triangle soup as one GPU kernel
(Pallas, Triton route).

The XLA block scan (ops/intersect.py) streams 8-triangle-or-larger blocks
through a ``lax.scan``: every step writes its running best (t, index, u, v)
back to device memory and launches again. Here each program takes a block
of ``BLOCK`` rays, keeps that state in registers, and loops over every
triangle of the soup, reading each triangle's 10 floats as broadcast scalar
loads from the packed table (served from cache after the first block).

Same Möller–Trumbore arithmetic and tie rule as ops/intersect._mt_block
(triangles visited in index order, strict ``<`` update: the lowest index
wins a tie). No VJP: closest_hit_diff and intersect_any_fast re-evaluate
the winner in XLA for gradients.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MT_EPSILON = 1e-9  # ops/intersect.MT_EPSILON
BLOCK = 128  # rays per program (a power of two, as Triton blocks must be)
MAX_TRIS = 2048  # above this the soup belongs to the BVH traversal
_ROW = 16  # packed table row: v0 e1 e2 active, padded to a power of two


def _tri_table(geometry):
    """[T_pow2, 16] rows v0(3) e1(3) e2(3) active(1) pad(6)."""
    t = geometry.num_tris
    rows = jnp.concatenate(
        [geometry.v0, geometry.e1, geometry.e2,
         geometry.active.astype(jnp.float32)[:, None],
         jnp.zeros((t, _ROW - 10), jnp.float32)], axis=1)
    t_pow2 = max(8, 1 << (t - 1).bit_length())
    return jnp.pad(rows, ((0, t_pow2 - t), (0, 0)))


def _mt(tri_ref, i, o, d):
    """Möller–Trumbore of ray block (o, d) against triangle i →
    (hit mask, t, u, v), as in ops/intersect._mt_block."""
    v0 = [tri_ref[i, c] for c in range(0, 3)]
    e1 = [tri_ref[i, c] for c in range(3, 6)]
    e2 = [tri_ref[i, c] for c in range(6, 9)]
    active = tri_ref[i, 9] > 0.5
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    det_ok = jnp.abs(det) > MT_EPSILON
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0) & active)
    return ok, t, u, v


def _closest_kernel(n_tris, ox, oy, oz, dx, dy, dz, tmax_ref, tri_ref,
                    t_out, i_out, u_out, v_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    t_max = tmax_ref[...]

    def body(i, carry):
        best_t, best_i, best_u, best_v = carry
        ok, t, u, v = _mt(tri_ref, i, o, d)
        better = ok & (t < t_max) & (t < best_t)
        return (jnp.where(better, t, best_t),
                jnp.where(better, i, best_i),
                jnp.where(better, u, best_u),
                jnp.where(better, v, best_v))

    init = (jnp.full(t_max.shape, jnp.inf, jnp.float32),
            jnp.full(t_max.shape, -1, jnp.int32),
            jnp.zeros(t_max.shape, jnp.float32),
            jnp.zeros(t_max.shape, jnp.float32))
    best_t, best_i, best_u, best_v = jax.lax.fori_loop(0, n_tris, body, init)
    t_out[...] = best_t
    i_out[...] = best_i
    u_out[...] = best_u
    v_out[...] = best_v


def _any_kernel(n_tris, ox, oy, oz, dx, dy, dz, tmax_ref, tri_ref, occ_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    t_max = tmax_ref[...]

    def body(i, occ):
        ok, t, _, _ = _mt(tri_ref, i, o, d)
        return jnp.where(ok & (t < t_max), 1, occ)

    occ_out[...] = jax.lax.fori_loop(
        0, n_tris, body, jnp.zeros(t_max.shape, jnp.int32))


def _launch(kernel, n_out, out_dtypes, origins, dirs, t_max, geometry,
            interpret):
    """Flatten rays [..., 3, H, W] to padded [N] component rows, run the
    kernel over blocks of BLOCK rays, and reshape the outputs back."""
    shape = t_max.shape
    n = t_max.size
    n_pad = -(-n // BLOCK) * BLOCK

    def flat(a):
        return jnp.pad(a.reshape(-1).astype(jnp.float32), (0, n_pad - n))

    comps = [flat(jnp.take(a, c, axis=-3)) for a in (origins, dirs)
             for c in range(3)]
    spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table = _tri_table(geometry)
    outs = pl.pallas_call(
        functools.partial(kernel, geometry.num_tris),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in out_dtypes],
        grid=(n_pad // BLOCK,),
        in_specs=[spec] * 7 + [pl.BlockSpec(table.shape, lambda i: (0, 0))],
        out_specs=[spec] * n_out,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*comps, flat(t_max), table)
    return [a[:n].reshape(shape) for a in outs]


def closest_hit_kernel(rays, geometry, t_max=None, interpret=False):
    """ops/intersect.intersect_closest on the kernel: rays [3, H, W] →
    (t, tri, u, v) each [H, W]; t = +inf / tri = -1 on miss."""
    h, w = rays.hw
    if t_max is None:
        t_max = jnp.full((h, w), jnp.inf, jnp.float32)
    t, i, u, v = _launch(
        _closest_kernel, 4,
        (jnp.float32, jnp.int32, jnp.float32, jnp.float32),
        rays.origin, rays.direction, jnp.broadcast_to(t_max, (h, w)),
        geometry, interpret)
    return t, i, u, v


def any_hit_kernel(origins, dirs, t_max, geometry, interpret=False):
    """ops/intersect.intersect_any on the kernel: origins/dirs
    [..., 3, H, W], t_max [..., H, W] → occluded bool [..., H, W]."""
    lead = jnp.broadcast_shapes(origins.shape, dirs.shape)
    origins = jnp.broadcast_to(origins, lead)
    dirs = jnp.broadcast_to(dirs, lead)
    t_max = jnp.broadcast_to(t_max, lead[:-3] + lead[-2:])
    (occ,) = _launch(_any_kernel, 1, (jnp.int32,), origins, dirs, t_max,
                     geometry, interpret)
    return occ > 0


def kernel_fits(geometry, *rays) -> bool:
    """The kernel serves float32 soups of at most MAX_TRIS triangles
    without a BVH, traced by float32 ``rays`` arrays; larger scenes take
    the BVH traversal, and float64 runs (x64 parity tests) the XLA scan."""
    return (geometry.bvh is None and geometry.num_tris <= MAX_TRIS
            and all(a.dtype == jnp.float32 for a in (geometry.v0,) + rays))
