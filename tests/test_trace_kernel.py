"""The GPU trace kernel (ops/trace_kernel.py) in Pallas interpret mode,
against the XLA block scan and the float64 oracle, and its dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import generate_rays, make_camera
from romis.ops.bvh import with_bvh
from romis.ops.intersect import (
    closest_hit_diff, intersect_any, intersect_any_fast, intersect_closest,
)
from romis.ops.trace_kernel import (
    BLOCK, MAX_TRIS, _tri_table, any_hit_kernel, closest_hit_kernel,
    kernel_fits,
)
from romis.scene.scene import load_blob_field, load_prebuilt

from helpers import make_rays, unpack_scalar
from oracle import closest_hit as oracle_closest

_CAMS = {
    "cornell_box": dict(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                        distance=2.5, fov_deg=50),
    "cornell_nightclub": dict(look_at=(2.57, 1.23, -1.35),
                              rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                              fov_deg=30.0),
}


def _random_rays(rng, n, spread):
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


@pytest.mark.parametrize("name", ["cornell_box", "cornell_nightclub"])
def test_closest_kernel_matches_block_scan(name):
    """Camera rays (an image that is not a multiple of BLOCK pixels):
    identical triangle indices, t and barycentrics to float rounding."""
    scene = load_prebuilt(name)
    h, w = 9, 30
    assert (h * w) % BLOCK != 0
    rays = generate_rays(make_camera(resolution=(h, w), **_CAMS[name]), h, w)
    ref = [np.asarray(a) for a in intersect_closest(rays, scene.geometry)]
    got = [np.asarray(a) for a in closest_hit_kernel(
        rays, scene.geometry, interpret=True)]
    np.testing.assert_array_equal(got[1], ref[1])
    assert (ref[1] >= 0).sum() > 20  # the rays hit something
    hit = ref[1] >= 0
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5)
    # u, v: the two programs round differently; at the nightclub's scale
    # (coordinates ~10) the dot products cancel to ~1e-6 absolute.
    for a, b in ((got[2], ref[2]), (got[3], ref[3])):
        np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["single_triangle", "cornell_nightclub"])
def test_closest_kernel_matches_oracle(name):
    """Random rays against the float64 Möller–Trumbore oracle; the soups
    are 1 triangle (table padded to 8 rows) and 166 (padded to 256)."""
    scene = load_prebuilt(name)
    geo = scene.geometry
    assert _tri_table(geo).shape[0] == (8 if name == "single_triangle"
                                        else 256)
    rng = np.random.default_rng(3)
    spread = 1.0 if name == "single_triangle" else 8.0
    origins, dirs = _random_rays(rng, 200, spread)
    t, tri, _, _ = closest_hit_kernel(make_rays(origins, dirs), geo,
                                      interpret=True)
    t, tri = unpack_scalar(t), unpack_scalar(tri)
    act = np.asarray(geo.active)
    v0 = np.asarray(geo.v0, np.float64)[act]
    e1 = np.asarray(geo.e1, np.float64)[act]
    e2 = np.asarray(geo.e2, np.float64)[act]
    tris = list(zip(v0, e1, e2))
    n_hits = 0
    for i in range(len(origins)):
        ot, oi, _, _ = oracle_closest(origins[i], dirs[i], tris)
        if oi == -1:
            assert tri[i] == -1, i
        else:
            n_hits += 1
            np.testing.assert_allclose(t[i], ot, rtol=2e-4, atol=1e-5)
    assert n_hits > 5


def test_closest_kernel_respects_t_max():
    scene = load_prebuilt("cornell_box")
    rng = np.random.default_rng(5)
    rays = make_rays(*_random_rays(rng, 150, 0.3))
    t_max = jnp.full((1, 150), 0.4)
    ref = intersect_closest(rays, scene.geometry, t_max)
    got = closest_hit_kernel(rays, scene.geometry, t_max, interpret=True)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    assert (np.asarray(ref[1]) == -1).any()


def test_any_kernel_matches_block_scan_with_leading_dims():
    """Shadow rays with a leading sample axis [S, 3, H, W] and t_max
    limits on both sides of the hits."""
    scene = load_prebuilt("cornell_box")
    rng = np.random.default_rng(1)
    s, n = 3, 70
    o = rng.uniform(-0.5, 0.5, (s, n, 3)).astype(np.float32)
    d = rng.normal(size=(s, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.asarray(o.transpose(0, 2, 1)[:, :, None, :])
    d = jnp.asarray(d.transpose(0, 2, 1)[:, :, None, :])
    t_max = jnp.asarray(rng.uniform(0.05, 1.5, (s, 1, n)).astype(np.float32))
    ref = np.asarray(intersect_any(o, d, t_max, scene.geometry))
    got = np.asarray(any_hit_kernel(o, d, t_max, scene.geometry,
                                    interpret=True))
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.mean() < 1


def test_kernel_choice_by_triangle_count_and_bvh():
    """Soups up to MAX_TRIS triangles without a BVH take the kernel on
    CUDA; larger scenes and scenes carrying a BVH never do."""
    box = load_prebuilt("cornell_box").geometry
    assert kernel_fits(box)
    assert not kernel_fits(with_bvh(box))
    assert not kernel_fits(box, jnp.zeros((3, 1, 1), jnp.float16))
    field = load_blob_field(3).geometry
    assert field.num_tris > MAX_TRIS == 2048
    assert not kernel_fits(field)


def test_cpu_dispatch_runs_the_block_scan():
    """On the CPU, the platform-dependent dispatch lowers the XLA branch:
    closest_hit_diff / intersect_any_fast equal the block scan exactly,
    jitted and with gradients."""
    scene = load_prebuilt("cornell_box")
    rng = np.random.default_rng(2)
    rays = make_rays(*_random_rays(rng, 64, 1.0))
    ref = intersect_closest(rays, scene.geometry)
    got = jax.jit(closest_hit_diff)(rays, scene.geometry)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t_max = jnp.full((1, 64), 0.7)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(intersect_any_fast)(rays.origin, rays.direction,
                                               t_max, scene.geometry)),
        np.asarray(intersect_any(rays.origin, rays.direction, t_max,
                                 scene.geometry)))
    g = jax.grad(lambda o: jnp.sum(jnp.where(
        jnp.isfinite(closest_hit_diff(rays.replace(origin=o),
                                      scene.geometry)[0]),
        closest_hit_diff(rays.replace(origin=o), scene.geometry)[0], 0.0)))(
        rays.origin)
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0
