"""Wavefront BVH traversal (pure-JAX while_loop backend).

Replaces Embree's rtcIntersect1/rtcOccluded1 (reference:
src/ray_tracing/embree_interface.cpp:58-90) with a stackless threaded
traversal over the DFS-preorder skip-link BVH (ops/bvh.py):

- every ray holds ONE int cursor; per wavefront step each active ray either
  descends (cursor+1 on box hit), skips (miss_link on box miss), or tests the
  <= MAX_LEAF triangles of a leaf (statically unrolled) and then skips,
- the whole image advances in lockstep inside a `lax.while_loop`; finished
  rays (cursor == -1) are masked out,
- closest-hit shrinks each ray's t_max as hits are found (box test prunes
  against it); any-hit terminates a ray on its first accepted hit.

This is the large-scene backend; the brute-force block scan (ops/intersect)
wins on small scenes, where divergence costs more than it saves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Rays
from ..core.vec import e, vcross, vdot
from .bvh import BVH, MAX_LEAF

MT_EPSILON = 1e-9


def _slab_test(bvh: BVH, node, o, inv_d, t_max):
    """Ray-AABB slab test for gathered nodes. node [..., H, W] int32;
    o/inv_d [..., 3, H, W]; t_max [..., H, W] → bool hit."""
    n = jnp.maximum(node, 0)
    ox, oy, oz = o[..., 0, :, :], o[..., 1, :, :], o[..., 2, :, :]
    ix, iy, iz = inv_d[..., 0, :, :], inv_d[..., 1, :, :], inv_d[..., 2, :, :]
    t0x = (bvh.bmin_x[n] - ox) * ix
    t1x = (bvh.bmax_x[n] - ox) * ix
    t0y = (bvh.bmin_y[n] - oy) * iy
    t1y = (bvh.bmax_y[n] - oy) * iy
    t0z = (bvh.bmin_z[n] - oz) * iz
    t1z = (bvh.bmax_z[n] - oz) * iz
    tnear = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                    jnp.minimum(t0y, t1y)),
                        jnp.minimum(t0z, t1z))
    tfar = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                   jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_max)


def _mt_one(o, d, v0, e1, e2):
    """Möller–Trumbore against one gathered triangle per ray.
    All vectors [..., 3, H, W] → (t, u, v, ok) scalars [..., H, W]."""
    pvec = vcross(d, e2)
    det = vdot(e1, pvec)
    det_ok = jnp.abs(det) > MT_EPSILON
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = o - v0
    u = vdot(tvec, pvec) * inv_det
    qvec = vcross(tvec, e1)
    v = vdot(d, qvec) * inv_det
    t = vdot(e2, qvec) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0))
    return t, u, v, ok


def _gather_tri(geometry, idx):
    """One packed row-gather of MT triangle data at [..., H, W] indices
    (scene.pack_tri_rows layout)."""
    rows = geometry.tri_rows[idx]  # [..., H, W, 12]

    def vec3(i):
        return jnp.moveaxis(rows[..., i:i + 3], -1, -3)

    return vec3(0), vec3(3), vec3(6)


def bvh_closest(rays: Rays, geometry, bvh: BVH, t_max=None):
    """Closest hit via threaded traversal. Same contract as
    ops.intersect.intersect_closest: returns (t, tri, u, v) each [H, W]."""
    h, w = rays.hw
    o, d = rays.origin, rays.direction
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / jnp.where(jnp.abs(d) > 1e-12,
                                                          d, 1.0),
                      jnp.float32(1e12))

    init = (
        jnp.zeros((h, w), jnp.int32),  # cursor
        jnp.full((h, w), jnp.inf) if t_max is None else t_max,  # best/t_max
        jnp.full((h, w), -1, jnp.int32),  # best tri
        jnp.zeros((h, w)),  # u
        jnp.zeros((h, w)),  # v
    )

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        cursor, best_t, best_i, best_u, best_v = state
        active = cursor >= 0
        node = jnp.maximum(cursor, 0)
        count = bvh.leaf_count[node]
        first = bvh.leaf_first[node]
        is_leaf = (count > 0) & active

        box_hit = _slab_test(bvh, node, o, inv_d, best_t) & active

        # Leaf: statically-unrolled MAX_LEAF triangle tests.
        for j in range(MAX_LEAF):
            tri_idx = jnp.minimum(first + j, geometry.num_tris - 1)
            tv0, te1, te2 = _gather_tri(geometry, tri_idx)
            t, u, v, ok = _mt_one(o, d, tv0, te1, te2)
            ok = ok & is_leaf & box_hit & (j < count) & (t < best_t)
            best_t = jnp.where(ok, t, best_t)
            best_i = jnp.where(ok, tri_idx, best_i)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, bvh.miss_link[node])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, best_t, best_i, best_u, best_v

    _, best_t, best_i, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return best_t, best_i, best_u, best_v


def bvh_any(origins, dirs, t_max, geometry, bvh: BVH):
    """Occlusion query via threaded traversal. Same contract as
    ops.intersect.intersect_any: origins/dirs [..., 3, H, W] → bool
    [..., H, W]. Rays terminate on their first accepted hit."""
    o, d = origins, jnp.broadcast_to(dirs, origins.shape)
    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / jnp.where(jnp.abs(d) > 1e-12,
                                                          d, 1.0),
                      jnp.float32(1e12))
    shape = t_max.shape

    init = (jnp.zeros(shape, jnp.int32), jnp.zeros(shape, bool))

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        cursor, occluded = state
        active = (cursor >= 0) & ~occluded
        node = jnp.maximum(cursor, 0)
        count = bvh.leaf_count[node]
        first = bvh.leaf_first[node]
        is_leaf = (count > 0) & active

        box_hit = _slab_test(bvh, node, o, inv_d, t_max) & active

        hit_any = jnp.zeros(shape, bool)
        for j in range(MAX_LEAF):
            tri_idx = jnp.minimum(first + j, geometry.num_tris - 1)
            tv0, te1, te2 = _gather_tri(geometry, tri_idx)
            t, _, _, ok = _mt_one(o, d, tv0, te1, te2)
            hit_any = hit_any | (ok & is_leaf & box_hit & (j < count)
                                 & (t < t_max))

        occluded = occluded | hit_any
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, bvh.miss_link[node])
        cursor = jnp.where(active, jnp.where(hit_any, -1, nxt), -1)
        return cursor, occluded

    _, occluded = jax.lax.while_loop(cond, body, init)
    return occluded
