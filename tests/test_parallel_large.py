"""Large-scene x multi-device composition: a >2048-tri scene rendered
through the sharded paths on the 8-virtual-device CPU mesh.

With a BVH attached, the sharded renderers route every intersection through
the lockstep wavefront traversal (ops/traverse.py) with the BVH arrays
REPLICATED across the mesh while pixels shard. The reference serves every
estimator at any scene size through one Embree code path under its OpenMP
loops (embree_interface.cpp:30-51,58-90); these tests pin the equivalent
single-code-path property.

Scene: blob_field 2x2 (3,842 tris) with a binned-SAH BVH attached. Tiny
frames keep the CPU wavefront affordable.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera, generate_rays
from romis.core.features import Features, MISWeight, RayTraceMode
from romis.ops.bvh import with_bvh
from romis.ops.wrs import gen_canonical_samples
from romis.parallel.mesh import make_mesh
from romis.parallel.mis import render_rmis_sharded, render_romis_sharded
from romis.parallel.shard import render_frame_sharded
from romis.render.restir import (
    initial_temporal_state, render_restir_frame, trace_primary,
)
from romis.render.rmis import render_rmis
from romis.render.romis import render_romis
from romis.scene.scene import load_blob_field

H, W = 32, 16
D = 2
K = 2
RADIUS = 2
ITERS = 2

MIS_FEATS = Features(initial_light_samples=4, num_samples_in_reservoir=K,
                     num_neighbours_to_sample=D, spatial_resample_radius=RADIUS,
                     max_iterations_mis=ITERS)


@pytest.fixture(scope="module")
def setup():
    scene = load_blob_field(2)
    assert scene.geometry.num_tris > 2048
    scene.geometry = with_bvh(scene.geometry)
    assert scene.geometry.bvh is not None
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(25, 30, 0),
                      distance=5.0, fov_deg=50, resolution=(H, W))
    key = jax.random.PRNGKey(3)

    rays = generate_rays(cam, H, W)
    _, ctx = trace_primary(rays, scene.geometry, MIS_FEATS)

    rows = jnp.arange(H, dtype=jnp.int32)[:, None]
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    offs = jax.random.randint(jax.random.fold_in(key, 1),
                              (2, D, H, W), -RADIUS, RADIUS + 1)
    ny = jnp.concatenate([jnp.broadcast_to(rows, (1, H, W)),
                          jnp.clip(rows[None] + offs[0], 0, H - 1)], axis=0)
    nx = jnp.concatenate([jnp.broadcast_to(cols, (1, H, W)),
                          jnp.clip(cols[None] + offs[1], 0, W - 1)], axis=0)
    res_list = [
        gen_canonical_samples(jax.random.fold_in(key, 10 + i), ctx,
                              scene.lights, scene.num_lights,
                              scene.geometry, MIS_FEATS)
        for i in range(ITERS)
    ]
    return dict(scene=scene, cam=cam, key=key,
                inject=(ny, nx, res_list), mesh=make_mesh())


def test_sharded_restir_large_scene_parity(setup):
    """GSPMD ReSTIR frame on the >2048-tri scene == single device (the BVH
    wavefront runs replicated under the pixel sharding)."""
    s = setup
    scene, cam = s["scene"], s["cam"]
    feats = Features(initial_light_samples=4, spatial_resample_radius=2)
    prev = initial_temporal_state(H, W, feats.num_samples_in_reservoir, cam)

    img_1, _ = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))(
        jax.random.PRNGKey(3), cam, scene.geometry, scene.lights,
        scene.num_lights, H, W, feats, prev)

    with s["mesh"]:
        fn = jax.jit(lambda key, cam, prev: render_frame_sharded(
            key, cam, scene.geometry, scene.lights,
            scene.num_lights, H, W, feats, prev, s["mesh"]))
        img_n, _ = fn(jax.random.PRNGKey(3), cam, prev)

    assert np.isfinite(np.asarray(img_n)).all()
    np.testing.assert_allclose(np.asarray(img_n), np.asarray(img_1),
                               rtol=1e-4, atol=1e-5)


def test_rmis_sharded_large_scene_bitwise(setup):
    """Equal-weight R-MIS through shard_map + halo exchange, traversal via
    the replicated BVH: bitwise vs the single-device XLA formulation."""
    s = setup
    feats = MIS_FEATS.replace(ray_trace_mode=RayTraceMode.RMIS,
                              mis_weight_rmis=MISWeight.EQUAL)
    nl = s["scene"].num_lights
    single = np.asarray(jax.jit(lambda k, c, g, li, inj: render_rmis(
        k, c, g, li, nl, H, W, feats, inject=inj))(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["inject"]))
    sharded = np.asarray(jax.jit(lambda k, c, g, li, inj: render_rmis_sharded(
        k, c, g, li, nl, H, W, feats, s["mesh"], inject=inj))(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["inject"]))
    assert np.isfinite(sharded).all()
    np.testing.assert_array_equal(single, sharded)


def test_romis_sharded_large_scene(setup):
    """Direct R-OMIS on the same composition (α solve per band): matches the
    single-device render to the f32 reassociation band used by
    test_parallel_mis.test_romis_sharded_bitwise_parity."""
    s = setup
    feats = MIS_FEATS.replace(ray_trace_mode=RayTraceMode.ROMIS)
    nl = s["scene"].num_lights
    single = np.asarray(jax.jit(lambda k, c, g, li, inj: render_romis(
        k, c, g, li, nl, H, W, feats, inject=inj))(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["inject"]))
    sharded = np.asarray(jax.jit(
        lambda k, c, g, li, inj: render_romis_sharded(
            k, c, g, li, nl, H, W, feats, s["mesh"], inject=inj))(
        s["key"], s["cam"], s["scene"].geometry, s["scene"].lights,
        s["inject"]))
    assert np.isfinite(sharded).all()
    np.testing.assert_allclose(single, sharded, rtol=2e-3, atol=1e-3)
