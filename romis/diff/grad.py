"""Differentiable rendering: gradients of the rendered image w.r.t. scene
parameters.

The reference has no gradients at all (it is a forward C++ renderer); this is
the differentiability capability named in the north star: the whole
RIS/reuse/shading pipeline is pure JAX, so we differentiate w.r.t.

- light emission (the four corner colors of every light),
- light placement (v0 / edge01 / edge02),
- material albedo kd and specular ks / shininess,
- vertex positions (via the Möller–Trumbore hit math).

Discrete choices (light pick, WRS winners, closest-hit triangle id,
visibility booleans) contribute zero gradient — selection is effectively
stop-gradded, evaluation is differentiated, the standard estimator-level
treatment (SURVEY §7.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.camera import CameraParams
from ..core.features import Features
from ..core.types import pytree_dataclass
from ..render.restir import TemporalState, render_restir_frame


@pytree_dataclass
class SceneParams:
    """The differentiable subset of the scene."""

    light_c0: jnp.ndarray  # [L, 3]
    light_c1: jnp.ndarray
    light_c2: jnp.ndarray
    light_c3: jnp.ndarray
    light_v0: jnp.ndarray  # [L, 3]
    light_e01: jnp.ndarray
    light_e02: jnp.ndarray
    mat_kd: jnp.ndarray  # [M, 3]
    mat_ks: jnp.ndarray  # [M, 3]
    mat_shininess: jnp.ndarray  # [M]
    tri_v0: jnp.ndarray  # [T, 3]
    tri_e1: jnp.ndarray
    tri_e2: jnp.ndarray


def extract_params(geometry, lights) -> SceneParams:
    return SceneParams(
        light_c0=lights.c0, light_c1=lights.c1, light_c2=lights.c2,
        light_c3=lights.c3, light_v0=lights.v0, light_e01=lights.edge01,
        light_e02=lights.edge02,
        mat_kd=geometry.mat_kd, mat_ks=geometry.mat_ks,
        mat_shininess=geometry.mat_shininess,
        tri_v0=geometry.v0, tri_e1=geometry.e1, tri_e2=geometry.e2,
    )


def apply_params(geometry, lights, params: SceneParams):
    from ..scene.lights import _pack_rows_jnp
    from ..scene.scene import repack_rows

    geometry = repack_rows(geometry.replace(
        mat_kd=params.mat_kd, mat_ks=params.mat_ks,
        mat_shininess=params.mat_shininess,
        v0=params.tri_v0, e1=params.tri_e1, e2=params.tri_e2,
    ))
    lights = lights.replace(
        c0=params.light_c0, c1=params.light_c1, c2=params.light_c2,
        c3=params.light_c3, v0=params.light_v0, edge01=params.light_e01,
        edge02=params.light_e02,
    )
    lights = lights.replace(rows=_pack_rows_jnp(
        lights.v0, lights.edge01, lights.edge02, lights.c0, lights.c1,
        lights.c2, lights.c3))
    return geometry, lights


def render_with_params(
    params: SceneParams,
    key,
    cam: CameraParams,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
    prev: TemporalState,
):
    """Forward render with ``params`` substituted into the scene.
    Tone mapping is typically disabled for optimisation (linear losses)."""
    geometry, lights = apply_params(geometry, lights, params)
    # Spatial offsets go coherent BY DEFAULT so the neighbour-gather VJP is
    # a pad instead of a scatter (Features.coherent_spatial_offsets
    # docstring); Features.exact_gradients keeps the caller's estimator
    # choices.
    if not features.exact_gradients:
        features = features.replace(coherent_spatial_offsets=True)
    return render_restir_frame(key, cam, geometry, lights, num_lights,
                               height, width, features, prev)


def l2_image_loss(
    params: SceneParams, target, key, cam, geometry, lights,
    num_lights: int, height: int, width: int, features: Features,
    prev: TemporalState,
):
    """Mean-squared error against a target image — the canonical inverse
    rendering objective."""
    img, _ = render_with_params(params, key, cam, geometry, lights,
                                num_lights, height, width, features, prev)
    return jnp.mean((img - target) ** 2)


def make_grad_fn(geometry, lights, num_lights, height, width, features):
    """Returns jit-ready value_and_grad of the L2 loss w.r.t. SceneParams."""

    def loss(params, target, key, cam, prev):
        return l2_image_loss(params, target, key, cam, geometry, lights,
                             num_lights, height, width, features, prev)

    return jax.value_and_grad(loss)


# ---------------------------------------------------------------------------
# R-MIS / R-OMIS gradients
# ---------------------------------------------------------------------------
#
# The MIS estimators (render.cpp:64-119 renderRMIS, :121-265 renderROMIS)
# are differentiated directly: neighbour selection and visibility are
# detached (discrete decisions / boolean outputs —
# exactly zero gradient), and everything else (canonical RIS weights, the
# colvec sweep, the α Cholesky solve, Phong shading) is differentiated
# exactly. Per-iteration jax.checkpoint in render_rmis/render_romis bounds
# the backward's residual memory to one iteration.


def render_mis_with_params(
    params: SceneParams,
    key,
    cam: CameraParams,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
):
    """Forward R-MIS or R-OMIS render (selected by features.ray_trace_mode)
    with ``params`` substituted into the scene, on the differentiable path."""
    from ..core.features import RayTraceMode
    from ..render.rmis import render_rmis
    from ..render.romis import render_romis

    geometry, lights = apply_params(geometry, lights, params)
    if features.ray_trace_mode == RayTraceMode.RMIS:
        return render_rmis(key, cam, geometry, lights, num_lights,
                           height, width, features)
    return render_romis(key, cam, geometry, lights, num_lights,
                        height, width, features)


def mis_l2_image_loss(
    params: SceneParams, target, key, cam, geometry, lights,
    num_lights: int, height: int, width: int, features: Features,
):
    """Mean-squared error of an R-MIS/R-OMIS render against a target."""
    img = render_mis_with_params(params, key, cam, geometry, lights,
                                 num_lights, height, width, features)
    return jnp.mean((img - target) ** 2)


def make_mis_grad_fn(geometry, lights, num_lights, height, width, features):
    """jit-ready value_and_grad of the MIS L2 loss w.r.t. SceneParams."""

    def loss(params, target, key, cam):
        return mis_l2_image_loss(params, target, key, cam, geometry, lights,
                                 num_lights, height, width, features)

    return jax.value_and_grad(loss)
