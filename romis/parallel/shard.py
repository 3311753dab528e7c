"""SPMD frame rendering and training step over a device mesh.

Strategy (SURVEY §2.4 table): image-tile data parallelism. The [H*W] pixel
axis is sharded over the ``tiles`` mesh axis via sharding constraints inside
one jitted program; GSPMD partitions every per-pixel op, turns the spatial
reuse neighbour gathers into collectives, and all-reduces scene-parameter
gradients (the replicated-operand psum) inside the backward pass.

This is the pjit/GSPMD path; a hand-scheduled shard_map + ppermute halo
exchange lives in parallel/halo.py for the bandwidth-optimal spatial reuse.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features
from ..diff.grad import SceneParams, apply_params
from ..ops.shading import exposure_tone_mapping
from ..ops.wrs import gen_canonical_samples
from ..render.restir import (
    PH_CANDIDATES, PH_SPATIAL, PH_TEMPORAL, TemporalState, final_shade,
    spatial_reuse, temporal_reuse, trace_primary,
)
from .mesh import make_mesh, shard_pixels


def render_frame_sharded(
    key, cam: CameraParams, geometry, lights, num_lights: int,
    height: int, width: int, features: Features, prev: TemporalState,
    mesh,
):
    """Same math as render_restir_frame, with the pixel axis sharded over the
    mesh. Rays are generated replicated and immediately constrained to the
    tile sharding; everything downstream follows it."""
    rays = generate_rays(cam, height, width)
    rays = shard_pixels(rays, mesh)
    _, ctx = trace_primary(rays, geometry, features)
    ctx = shard_pixels(ctx, mesh)

    res = gen_canonical_samples(
        jax.random.fold_in(key, PH_CANDIDATES), ctx, lights, num_lights,
        geometry, features,
    )
    res = shard_pixels(res, mesh)

    if features.temporal_reuse:
        res = temporal_reuse(
            jax.random.fold_in(key, PH_TEMPORAL), ctx, res, prev,
            height, width, features,
        )
        res = shard_pixels(res, mesh)

    if features.spatial_reuse:
        res = spatial_reuse(
            jax.random.fold_in(key, PH_SPATIAL), ctx, res, height, width,
            geometry, features,
        )
        res = shard_pixels(res, mesh)

    color = final_shade(ctx, res, geometry, features)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    image = jnp.moveaxis(color, 0, -1)  # [H, W, 3]

    state = TemporalState(reservoirs=res, ctx=ctx, cam=cam,
                          has_prev=jnp.array(True))
    return image, state


def make_sharded_train_step(
    geometry, lights, num_lights: int, height: int, width: int,
    features: Features, mesh, lr: float = 1e-2,
):
    """Jitted SPMD training step: L2 loss of the sharded render against a
    target image, SGD on the differentiable scene parameters. Scene params
    are replicated; their gradients are psum-reduced across tiles by GSPMD
    automatically (the analog of the gradient all-reduce row in SURVEY §2.4).
    """

    grad_features = features
    if not grad_features.exact_gradients:
        grad_features = grad_features.replace(coherent_spatial_offsets=True)

    def loss_fn(params: SceneParams, target, key, cam, prev):
        g, l = apply_params(geometry, lights, params)
        img, state = render_frame_sharded(
            key, cam, g, l, num_lights, height, width, grad_features, prev,
            mesh,
        )
        return jnp.mean((img - target) ** 2), state

    @jax.jit
    def train_step(params: SceneParams, target, key, cam,
                   prev: TemporalState):
        (loss, state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, target, key, cam, prev)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss, state

    return train_step
