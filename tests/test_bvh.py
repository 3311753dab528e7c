"""BVH build + threaded traversal vs brute-force intersection."""

import numpy as np
import jax.numpy as jnp
import pytest

from romis.ops.bvh import (
    BVH, _build_arrays_numpy, _thread_links, build_bvh, native_builder,
    sah_cost,
)
from romis.ops.intersect import intersect_any, intersect_closest
from romis.ops.traverse import bvh_any, bvh_closest
from romis.scene.scene import load_prebuilt

from helpers import make_rays, pack_scalar, unpack_scalar


def _rand_rays(rng, n, spread=2.0):
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return make_rays(origins, dirs)


@pytest.mark.parametrize("scene_name", ["cube", "cornell_box", "blob"])
def test_bvh_closest_matches_bruteforce(scene_name):
    scene = load_prebuilt(scene_name)
    bvh, geo = build_bvh(scene.geometry)
    rng = np.random.default_rng(1)
    rays = _rand_rays(rng, 256)

    t_b, tri_b, u_b, v_b = intersect_closest(rays, geo)
    t_v, tri_v, u_v, v_v = bvh_closest(rays, geo, bvh)

    t_b, t_v = unpack_scalar(t_b), unpack_scalar(t_v)
    hit_b = np.isfinite(t_b)
    hit_v = np.isfinite(t_v)
    np.testing.assert_array_equal(hit_b, hit_v)
    np.testing.assert_allclose(t_v[hit_b], t_b[hit_b], rtol=1e-4, atol=1e-6)
    # Same triangle except exact-tie cases; compare hit points instead.
    np.testing.assert_allclose(unpack_scalar(u_v)[hit_b],
                               unpack_scalar(u_b)[hit_b], rtol=1e-3,
                               atol=1e-4)
    assert hit_b.sum() > 10


@pytest.mark.parametrize("scene_name", ["cornell_box", "blob"])
def test_bvh_any_matches_bruteforce(scene_name):
    scene = load_prebuilt(scene_name)
    bvh, geo = build_bvh(scene.geometry)
    rng = np.random.default_rng(2)
    rays = _rand_rays(rng, 256)
    t_max = pack_scalar(np.full(256, 1.2, np.float32))

    occ_b = unpack_scalar(intersect_any(rays.origin, rays.direction, t_max,
                                        geo))
    occ_v = unpack_scalar(bvh_any(rays.origin, rays.direction, t_max, geo,
                                  bvh))
    np.testing.assert_array_equal(occ_v, occ_b)
    assert 5 < occ_b.sum() < 250  # both classes exercised


def test_bvh_preserves_materials():
    """The triangle permutation must keep per-triangle attributes aligned."""
    scene = load_prebuilt("cornell_box")
    bvh, geo = build_bvh(scene.geometry)
    rng = np.random.default_rng(3)
    rays = _rand_rays(rng, 128, spread=1.5)
    t_b, tri_b, _, _ = intersect_closest(rays, scene.geometry)
    t_v, tri_v, _, _ = bvh_closest(rays, geo, bvh)
    hit = np.isfinite(unpack_scalar(t_b))
    # Compare material ids at the hit (robust to permuted indices).
    mat_b = np.asarray(scene.geometry.mat_id)[
        np.maximum(unpack_scalar(tri_b), 0)]
    mat_v = np.asarray(geo.mat_id)[np.maximum(unpack_scalar(tri_v), 0)]
    np.testing.assert_array_equal(mat_b[hit], mat_v[hit])


def test_native_builder_available_and_better():
    """The C++ SAH builder must load and produce an equal-or-better tree than
    the median-split fallback on a real mesh."""
    assert native_builder() is not None, "native builder did not build"
    scene = load_prebuilt("blob")
    act = np.asarray(scene.geometry.active)
    v0 = np.ascontiguousarray(np.asarray(scene.geometry.v0)[act])
    e1 = np.ascontiguousarray(np.asarray(scene.geometry.e1)[act])
    e2 = np.ascontiguousarray(np.asarray(scene.geometry.e2)[act])

    def mk(arrays):
        bmin, bmax, left, right, lfirst, lcount, order = arrays
        miss = _thread_links(left, right)
        return BVH(
            bmin_x=jnp.asarray(bmin[:, 0]), bmin_y=jnp.asarray(bmin[:, 1]),
            bmin_z=jnp.asarray(bmin[:, 2]), bmax_x=jnp.asarray(bmax[:, 0]),
            bmax_y=jnp.asarray(bmax[:, 1]), bmax_z=jnp.asarray(bmax[:, 2]),
            miss_link=jnp.asarray(miss), leaf_first=jnp.asarray(lfirst),
            leaf_count=jnp.asarray(lcount))

    from romis.ops.bvh import _build_arrays_native

    sah_native = sah_cost(mk(_build_arrays_native(v0, e1, e2, 4)))
    sah_median = sah_cost(mk(_build_arrays_numpy(v0, e1, e2, 4)))
    assert sah_native <= sah_median * 1.05, (sah_native, sah_median)


def test_leaf_ranges_cover_all_triangles():
    scene = load_prebuilt("blob")
    bvh, geo = build_bvh(scene.geometry)
    first = np.asarray(bvh.leaf_first)
    count = np.asarray(bvh.leaf_count)
    covered = np.zeros(int(np.asarray(scene.geometry.active).sum()), bool)
    for f, c in zip(first, count):
        if c > 0:
            assert not covered[f:f + c].any(), "overlapping leaves"
            covered[f:f + c] = True
    assert covered.all()


def test_full_render_with_bvh_matches_bruteforce():
    """End-to-end: a ReSTIR frame rendered through the BVH dispatch must
    match the brute-force render except at triangle-edge tie pixels."""
    import jax
    from romis.core.camera import make_camera
    from romis.core.features import Features
    from romis.ops.bvh import with_bvh
    from romis.render.restir import (
        initial_temporal_state, render_restir_frame,
    )

    scene = load_prebuilt("cornell_box_parallelogram_light")
    geo_bvh = with_bvh(scene.geometry)
    h, w = 24, 24
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=2.5, fov_deg=50, resolution=(h, w))
    feats = Features(initial_light_samples=8, spatial_resample_radius=2)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    img_b, _ = fn(jax.random.PRNGKey(0), cam, scene.geometry, scene.lights,
                  scene.num_lights, h, w, feats, prev)
    img_v, _ = fn(jax.random.PRNGKey(0), cam, geo_bvh, scene.lights,
                  scene.num_lights, h, w, feats, prev)
    a, b = np.asarray(img_b), np.asarray(img_v)
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert close.mean() > 0.97, close.mean()
