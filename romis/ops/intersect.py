"""Ray-triangle intersection: batched Möller–Trumbore over the scene soup,
image-minor layout.

This is the brute-force backend (every ray tests every triangle) — the
baseline the BVH backend (ops/traverse.py) is validated against, and the
choice for small scenes, where one fused loop beats divergent traversal.

Reference analogs: EmbreeInterface::closestHit / anyHit
(src/ray_tracing/embree_interface.cpp:58-90). Embree's rtcIntersect1 becomes a
`lax.scan` over static triangle blocks with a running per-ray best hit;
memory is O(H*W*block) instead of O(H*W*T).

Semantics:
- closest hit accepts t in (0, t_max) and returns barycentrics (u toward v1,
  v toward v2) for attribute interpolation (embree rtcInterpolate0 analog),
- any-hit (shadow) accepts t in (0, t_max); the caller applies the
  SHADOW_RAY_EPSILON origin offset (reference utils.cpp:41-56),
- ties in t resolve to the lowest triangle index (deterministic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.features import Features
from ..core.types import HitRecord, Rays, ShadeCtx
from ..core.vec import e, vcross, vdot, vnorm
from .shading import diffuse_albedo
from .trace_kernel import any_hit_kernel, closest_hit_kernel, kernel_fits

MT_EPSILON = 1e-9


def _pick_block(rays_size: int, num_tris: int, budget: int = 1 << 26) -> int:
    """Triangle block size so the [block, rays...] working set stays ~budget
    elements (several f32 temps per element, fused by XLA). Minimum block
    of 8 even when over budget: tiny blocks mean one scan step per few
    triangles."""
    block = max(8, budget // max(rays_size, 1))
    block = min(block, num_tris)
    for cand in (256, 192, 128, 96, 64, 48, 32, 24, 16, 12, 8, 4, 2, 1):
        if cand <= block and num_tris % cand == 0:
            return cand
    return 1


def _tri_blocks(geometry, block: int):
    steps = geometry.num_tris // block

    def split(a):  # [T, ...] → [steps, block, 3, 1, 1] (image-minor)
        if a.ndim == 2:
            return a.reshape(steps, block, a.shape[1], 1, 1)
        return a.reshape(steps, block)

    return jax.tree.map(
        split, (geometry.v0, geometry.e1, geometry.e2, geometry.active)
    ), steps


def _mt_block(origins, dirs, v0, e1, e2, active):
    """Möller–Trumbore for rays [..., 3, H, W] against a triangle block
    [B, 3, 1, 1]. Returns (t, u, v) shaped [..., B, H, W]; t = +inf on miss.
    """
    d = jnp.expand_dims(dirs, -4)  # [..., 1, 3, H, W]
    o = jnp.expand_dims(origins, -4)
    pvec = vcross(d, e2)  # [..., B, 3, H, W]
    det = vdot(e1, pvec)  # [..., B, H, W]
    # Double-where keeps the backward pass NaN-free on degenerate triangles
    # (grad of 1/det at det→0 would otherwise poison vertex gradients).
    det_ok = jnp.abs(det) > MT_EPSILON
    det_safe = jnp.where(det_ok, det, 1.0)
    inv_det = jnp.where(det_ok, 1.0 / det_safe, 0.0)
    tvec = o - v0
    u = vdot(tvec, pvec) * inv_det
    qvec = vcross(tvec, e1)
    vv = vdot(d, qvec) * inv_det
    t = vdot(e2, qvec) * inv_det
    ok = (
        det_ok
        & (u >= 0.0) & (u <= 1.0)
        & (vv >= 0.0) & (u + vv <= 1.0)
        & (t > 0.0)
        & active[..., None, None]
    )
    return jnp.where(ok, t, jnp.inf), u, vv


def intersect_closest(rays: Rays, geometry, t_max=None):
    """Closest hit of each primary ray against the whole soup.

    rays: origin/direction [3, H, W]. Returns (t, tri_idx, u, v) each [H, W];
    t = +inf / tri = -1 on miss. Dispatches to the BVH wavefront traversal
    when geometry carries one. Reference: EmbreeInterface::closestHit
    (embree_interface.cpp:64-90)."""
    if geometry.bvh is not None:
        from .traverse import bvh_closest

        return bvh_closest(rays, geometry, geometry.bvh, t_max)
    h, w = rays.hw
    block = _pick_block(h * w, geometry.num_tris)
    blocks, steps = _tri_blocks(geometry, block)

    tmax0 = jnp.full((h, w), jnp.inf) if t_max is None else t_max

    def body(carry, blk):
        best_t, best_i, best_u, best_v, base = carry
        v0, e1, e2, act = blk
        t, u, v = _mt_block(rays.origin, rays.direction, v0, e1, e2, act)
        t = jnp.where(t < tmax0, t, jnp.inf)  # [B, H, W]
        loc = jnp.argmin(t, axis=0)  # [H, W], lowest index wins ties
        t_b = jnp.take_along_axis(t, loc[None], axis=0)[0]
        u_b = jnp.take_along_axis(u, loc[None], axis=0)[0]
        v_b = jnp.take_along_axis(v, loc[None], axis=0)[0]
        better = t_b < best_t
        best_t = jnp.where(better, t_b, best_t)
        best_i = jnp.where(better, base + loc.astype(jnp.int32), best_i)
        best_u = jnp.where(better, u_b, best_u)
        best_v = jnp.where(better, v_b, best_v)
        return (best_t, best_i, best_u, best_v, base + block), None

    init = (
        jnp.full((h, w), jnp.inf),
        jnp.full((h, w), -1, jnp.int32),
        jnp.zeros((h, w)),
        jnp.zeros((h, w)),
        jnp.int32(0),
    )
    (best_t, best_i, best_u, best_v, _), _ = jax.lax.scan(body, init, blocks)
    return best_t, best_i, best_u, best_v


def intersect_any(origins, dirs, t_max, geometry) -> jnp.ndarray:
    """Occlusion query: True where some triangle lies at t in (0, t_max).
    origins/dirs [..., 3, H, W], t_max [..., H, W] → occluded [..., H, W].
    Dispatches to the BVH wavefront traversal when geometry carries one.
    Reference: EmbreeInterface::anyHit (embree_interface.cpp:58-62)."""
    if geometry.bvh is not None:
        from .traverse import bvh_any

        return bvh_any(origins, dirs, t_max, geometry, geometry.bvh)
    lead = origins.shape[:-3]
    rays_size = 1
    for s in lead + origins.shape[-2:]:
        rays_size *= s
    block = _pick_block(rays_size, geometry.num_tris)
    blocks, steps = _tri_blocks(geometry, block)

    def body(occluded, blk):
        v0, e1, e2, act = blk
        t, _, _ = _mt_block(origins, dirs, v0, e1, e2, act)  # [..., B, H, W]
        hit = jnp.any(t < jnp.expand_dims(t_max, -3), axis=-3)
        return occluded | hit, None

    init = jnp.zeros(lead + origins.shape[-2:], bool)
    occluded, _ = jax.lax.scan(body, init, blocks)
    return occluded


@jax.custom_vjp
def closest_hit_diff(rays: Rays, geometry):
    """Differentiable closest hit with a re-evaluation backward pass
    (SURVEY §7.1): the forward runs the threaded BVH, the GPU trace kernel
    (ops/trace_kernel.py) or the block scan; the backward treats the *selection* (tri index) as fixed and
    re-derives d(t,u,v)/d(rays, vertices) analytically from one
    Möller–Trumbore evaluation of the selected triangle — no autodiff
    through the traversal loop."""
    return _closest_forward(rays, geometry)


def _closest_forward(rays: Rays, geometry):
    if kernel_fits(geometry, rays.origin, rays.direction):
        # Chosen per platform when lowering: the kernel on CUDA, the block
        # scan elsewhere (the CPU, and CPU references in a GPU process).
        return jax.lax.platform_dependent(
            rays, geometry, default=intersect_closest,
            cuda=closest_hit_kernel)
    return intersect_closest(rays, geometry)


def _reeval_tuv(rays: Rays, geometry, tri):
    """(t, u, v) of the already-selected triangles, differentiable.

    Vertex fetch rides ONE packed-row gather of a freshly packed v0|e1|e2
    row table instead of nine per-component gathers. The [T, 9] pack is a
    cheap concatenate re-done per call so gradients flow to the LIVE
    v0/e1/e2 columns (not a possibly stale geometry.tri_rows)."""
    from .gather import gather_rows
    from .traverse import _mt_one

    idx = jnp.maximum(tri, 0)
    packed = jnp.concatenate(
        [geometry.v0, geometry.e1, geometry.e2], axis=1)  # [T, 9]
    rows = gather_rows(packed, idx)  # [9, H, W]
    t, u, v, ok = _mt_one(rays.origin, rays.direction, rows[0:3], rows[3:6],
                          rows[6:9])
    valid = tri >= 0
    return (jnp.where(valid, t, jnp.inf), jnp.where(valid, u, 0.0),
            jnp.where(valid, v, 0.0))


def _closest_fwd(rays, geometry):
    t, tri, u, v = _closest_forward(rays, geometry)
    return (t, tri, u, v), (rays, geometry, tri)


def _closest_bwd(res, cots):
    rays, geometry, tri = res
    ct_t, _, ct_u, ct_v = cots
    ct_t = jnp.where(jnp.isfinite(ct_t), ct_t, 0.0)

    def f(rays, geometry):
        return _reeval_tuv(rays, geometry, tri)

    _, vjp = jax.vjp(f, rays, geometry)
    d_rays, d_geo = vjp((ct_t, ct_u, ct_v))
    return d_rays, d_geo


closest_hit_diff.defvjp(_closest_fwd, _closest_bwd)


def _any_fast_impl(origins, dirs, t_max, geometry):
    if kernel_fits(geometry, origins, dirs, t_max):
        return jax.lax.platform_dependent(
            origins, dirs, t_max, geometry, default=intersect_any,
            cuda=any_hit_kernel)
    return intersect_any(origins, dirs, t_max, geometry)


@jax.custom_jvp
def _any_fast_f32(origins, dirs, t_max, geometry):
    return _any_fast_impl(origins, dirs, t_max, geometry).astype(jnp.float32)


@_any_fast_f32.defjvp
def _any_fast_f32_jvp(primals, tangents):
    # Occlusion is a step function: derivative identically zero. The formal
    # rule matters under jax.checkpoint — remat's jvp_jaxpr INSTANTIATES
    # zero tangents as real zeros, so the upstream stop_gradients alone no
    # longer keep reverse-mode out of the traversal loops
    # (diff/grad.py render_mis_with_params hit this).
    out = _any_fast_impl(*primals).astype(jnp.float32)
    return out, jnp.zeros_like(out)


def intersect_any_fast(origins, dirs, t_max, geometry) -> jnp.ndarray:
    """Occlusion query routed through the fastest backend (boolean output —
    gradients are identically zero via a custom_jvp, matching the stop-grad
    visibility semantics)."""
    return _any_fast_f32(origins, dirs, t_max, geometry) > 0.5


def make_hit_record(rays: Rays, geometry, t, tri, u, v) -> HitRecord:
    """Gather interpolated hit attributes (reference rtcInterpolate0 calls,
    embree_interface.cpp:76-81) with ONE packed attr-row gather per pixel
    (scene.pack_attr_rows layout). Shading normals are normalized (deviation
    from the reference's raw interpolation — documented in ops/shading.py)."""
    from .gather import gather_rows

    valid = jnp.isfinite(t)
    idx = jnp.maximum(tri, 0)  # [H, W]
    # Planes-first packed gather [24, H, W]: one row fetch per pixel.
    rows = gather_rows(geometry.attr_rows, idx)

    def vec3(i):
        return rows[i:i + 3]

    def vec2(i):
        return rows[i:i + 2]

    bw = e(1.0 - u - v)  # [1, H, W]
    bu = e(u)
    bv = e(v)
    normal = bw * vec3(0) + bu * vec3(3) + bv * vec3(6)
    normal = normal / jnp.maximum(e(vnorm(normal)), 1e-20)
    uv = bw * vec2(9) + bu * vec2(11) + bv * vec2(13)
    mat_id = rows[15].astype(jnp.int32)
    geom_id = rows[16].astype(jnp.int32)
    return HitRecord(
        valid=valid,
        t=t,
        normal=jnp.where(e(valid), normal, 0.0),
        uv=jnp.where(e(valid), uv, 0.0),
        mat_id=jnp.where(valid, mat_id, 0),
        geom_id=jnp.where(valid, geom_id, -1),
        prim_id=jnp.where(valid, tri, -1),
    )


def make_shade_ctx(rays: Rays, hits: HitRecord, geometry,
                   features: Features) -> ShadeCtx:
    """Bundle everything the target PDF / shading needs about the receiver.
    One packed mat-row gather (scene.pack_mat_rows layout) + optional
    texture overlay."""
    from .gather import gather_rows
    from .shading import acquire_texel

    safe_t = jnp.where(hits.valid, hits.t, 0.0)
    position = rays.origin + e(safe_t) * rays.direction
    rows = gather_rows(geometry.mat_rows, hits.mat_id)  # [8, H, W]
    kd = rows[0:3]
    ks = rows[3:6]
    shininess = rows[6]
    tex_id = rows[7].astype(jnp.int32)
    if features.enable_texture_mapping and geometry.tex_data.shape[1] > 1:
        texel = acquire_texel(geometry.tex_data, geometry.tex_size,
                              tex_id, hits.uv)
        kd = jnp.where(e(tex_id >= 0), texel, kd)
    return ShadeCtx(
        valid=hits.valid,
        position=position,
        normal=hits.normal,
        view_origin=rays.origin,
        kd=kd,
        ks=ks,
        shininess=shininess,
        geom_id=hits.geom_id,
        depth_t=safe_t,
    )
