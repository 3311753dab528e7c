"""Ray-triangle intersection vs the NumPy oracle, plus loader checks."""

import numpy as np
import jax
import jax.numpy as jnp

from romis.core.types import Rays
from romis.ops.intersect import (
    closest_hit_diff, intersect_any, intersect_closest, make_hit_record,
)
from romis.scene.objloader import SubMesh, Material
from romis.scene.scene import build_geometry, load_prebuilt

from helpers import make_rays, pack_scalar, unpack_scalar, unpack_vec
from oracle import closest_hit as oracle_closest


def _random_geometry(rng, n_tris=37):
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.7, 0.7, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.7, 0.7, (n_tris, 3)).astype(np.float32)
    tris = np.stack([v0, v1, v2], axis=1)
    sm = SubMesh(
        positions=tris.reshape(-1, 3),
        normals=np.tile(np.array([0, 0, 1], np.float32), (n_tris * 3, 1)),
        texcoords=np.zeros((n_tris * 3, 2), np.float32),
        triangles=np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3),
        material=Material(),
    )
    return build_geometry([sm]), tris


def test_closest_hit_matches_oracle():
    rng = np.random.default_rng(42)
    geometry, tris = _random_geometry(rng)
    n_rays = 64
    origins = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rays = make_rays(origins, dirs)
    t, tri, u, v = intersect_closest(rays, geometry)
    t, tri = unpack_scalar(t), unpack_scalar(tri)

    oracle_tris = [(tr[0].astype(np.float64),
                    (tr[1] - tr[0]).astype(np.float64),
                    (tr[2] - tr[0]).astype(np.float64)) for tr in tris]
    n_hits = 0
    for i in range(n_rays):
        ot, oi, ou, ov = oracle_closest(origins[i], dirs[i], oracle_tris)
        if oi == -1:
            assert tri[i] == -1, f"ray {i}: oracle miss, got tri {tri[i]}"
        else:
            n_hits += 1
            assert np.isfinite(t[i])
            np.testing.assert_allclose(t[i], ot, rtol=2e-4, atol=1e-5)
    assert n_hits > 5  # the test actually exercised hits


def test_any_hit_consistent_with_closest():
    rng = np.random.default_rng(7)
    geometry, _ = _random_geometry(rng, n_tris=20)
    n_rays = 128
    origins = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    rays = make_rays(origins, dirs)
    t = unpack_scalar(intersect_closest(rays, geometry)[0])

    t_max = np.full((n_rays,), 1.5, np.float32)
    occ = unpack_scalar(intersect_any(rays.origin, rays.direction,
                                      pack_scalar(t_max), geometry))
    # Occluded ⇔ closest hit within t_max.
    np.testing.assert_array_equal(occ, np.isfinite(t) & (t < t_max))


def test_any_hit_with_leading_sample_dims():
    """Shadow-ray batches carry leading sample axes [S, 3, H, W]."""
    rng = np.random.default_rng(9)
    geometry, _ = _random_geometry(rng, n_tris=10)
    n_rays, s = 32, 3
    origins = rng.uniform(-2, 2, (s, n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(s, n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = jnp.asarray(origins.transpose(0, 2, 1)[:, :, None, :])  # [S,3,1,N]
    d = jnp.asarray(dirs.transpose(0, 2, 1)[:, :, None, :])
    t_max = jnp.full((s, 1, n_rays), 2.0)
    occ = np.asarray(intersect_any(o, d, t_max, geometry))  # [S, 1, N]
    # Each leading slice must equal the independent per-slice query.
    for i in range(s):
        occ_i = np.asarray(intersect_any(o[i], d[i], t_max[i], geometry))
        np.testing.assert_array_equal(occ[i], occ_i)


def test_single_triangle_barycentrics():
    sm = SubMesh(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        normals=np.tile(np.array([0, 0, 1], np.float32), (3, 1)),
        texcoords=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
        triangles=np.array([[0, 1, 2]], np.int32),
        material=Material(),
    )
    geometry = build_geometry([sm])
    origins = np.array([[0.25, 0.25, 1.0], [0.9, 0.9, 1.0]], np.float32)
    dirs = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    rays = make_rays(origins, dirs)
    t, tri, u, v = intersect_closest(rays, geometry)
    tri_f = unpack_scalar(tri)
    assert tri_f[0] == 0 and tri_f[1] == -1
    np.testing.assert_allclose(unpack_scalar(t)[0], 1.0, rtol=1e-5)
    # Barycentric u toward v1, v toward v2 → equals hit (x, y) here.
    np.testing.assert_allclose(unpack_scalar(u)[0], 0.25, atol=1e-5)
    np.testing.assert_allclose(unpack_scalar(v)[0], 0.25, atol=1e-5)

    hits = make_hit_record(rays, geometry, t, tri, u, v)
    np.testing.assert_allclose(np.asarray(hits.uv)[:, 0, 0], [0.25, 0.25],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(hits.normal)[:, 0, 0], [0, 0, 1],
                               atol=1e-5)
    assert not bool(np.asarray(hits.valid)[0, 1])


def test_prebuilt_scene_counts():
    """Triangle counts from BASELINE.md (cube 12, cornell box 32 after quad
    split, triangle 1)."""
    tri = load_prebuilt("single_triangle")
    assert int(np.asarray(tri.geometry.active).sum()) == 1
    assert tri.num_lights == 1
    cube = load_prebuilt("cube")
    assert int(np.asarray(cube.geometry.active).sum()) == 12
    box = load_prebuilt("cornell_box_parallelogram_light")
    assert int(np.asarray(box.geometry.active).sum()) == 32
    club = load_prebuilt("cornell_nightclub")
    assert club.num_lights == 512


def test_padding_never_hits():
    geometry = load_prebuilt("single_triangle").geometry
    from romis.scene.scene import TRI_PAD
    assert geometry.num_tris % TRI_PAD == 0
    rng = np.random.default_rng(3)
    origins = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = make_rays(origins, dirs)
    _, tri, _, _ = intersect_closest(rays, geometry)
    assert unpack_scalar(tri).max() < 1  # only the real triangle (or miss)


def _rand_rays(rng, n, spread=2.0):
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return make_rays(origins, dirs)


def test_custom_vjp_matches_autodiff_gradients():
    """The re-evaluation backward must equal autodiff through the block
    scan (away from selection ties)."""
    scene = load_prebuilt("cornell_box")
    rng = np.random.default_rng(2)
    rays = _rand_rays(rng, 128)

    def loss_via(fn):
        def f(origin, v0):
            g = scene.geometry.replace(v0=v0)
            t, tri, u, v = fn(Rays(origin=origin, direction=rays.direction),
                              g)
            t = jnp.where(jnp.isfinite(t), t, 0.0)
            return jnp.sum(t * 1.7 + u * 0.3 - v * 0.2)
        return jax.grad(f, argnums=(0, 1))(rays.origin, scene.geometry.v0)

    g_ref = loss_via(intersect_closest)
    g_new = loss_via(closest_hit_diff)
    for a, b in zip(g_ref, g_new):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)
