"""Core SoA pytree types, image-minor layout.

The reference keeps per-pixel state as arrays-of-structs
(``ReservoirGrid = vector<vector<Reservoir>>``, src/rendering/reservoir.h:28-75,
``HitInfo`` src/utils/common.h:43-49). Here everything is
structure-of-arrays in **image-minor layout** (see core/vec.py): the last two
axes of every field are (H, W); 3-vectors live on axis -3 and sample axes
(K lanes, R neighbours) lead.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree whose fields are all
    children, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


@pytree_dataclass
class Rays:
    """A batch of rays over the image grid.
    Reference analog: framework/include/framework/ray.h."""

    origin: jnp.ndarray  # [3, H, W]
    direction: jnp.ndarray  # [3, H, W] (normalized)

    @property
    def hw(self):
        return self.origin.shape[-2:]


@pytree_dataclass
class HitRecord:
    """Closest-hit results.

    Reference analog: ``HitInfo`` + ``RayHit`` (src/utils/common.h:43-54),
    produced by ``EmbreeInterface::closestHit``
    (src/ray_tracing/embree_interface.cpp:64-90). Materials are carried as
    indices into the scene material table instead of inline structs.
    """

    valid: jnp.ndarray  # [H, W] bool — ray hit something
    t: jnp.ndarray  # [H, W] hit distance (inf on miss)
    normal: jnp.ndarray  # [3, H, W] interpolated shading normal (normalized)
    uv: jnp.ndarray  # [2, H, W] interpolated texture coordinate
    mat_id: jnp.ndarray  # [H, W] int32 material index
    geom_id: jnp.ndarray  # [H, W] int32 submesh id (reference geometryId)
    prim_id: jnp.ndarray  # [H, W] int32 triangle index


@pytree_dataclass
class ShadeCtx:
    """Per-pixel shading context: everything the target PDF / Phong shading
    needs about the receiving surface point. SoA replacement for the
    reference carrying ``cameraRay`` + ``hitInfo`` inside each Reservoir
    (src/rendering/reservoir.h:33-36)."""

    valid: jnp.ndarray  # [H, W] bool
    position: jnp.ndarray  # [3, H, W] hit point (ray.origin + t*dir)
    normal: jnp.ndarray  # [3, H, W]
    view_origin: jnp.ndarray  # [3, H, W] camera ray origin (for V)
    kd: jnp.ndarray  # [3, H, W] effective diffuse albedo (texture applied)
    ks: jnp.ndarray  # [3, H, W]
    shininess: jnp.ndarray  # [H, W]
    geom_id: jnp.ndarray  # [H, W] int32
    depth_t: jnp.ndarray  # [H, W] primary-hit distance (similarity gates)


@pytree_dataclass
class Reservoirs:
    """K-lane weighted reservoirs over the image grid.

    Reference analog: ``Reservoir`` (src/rendering/reservoir.h:28-75), with
    the AoS-of-vectors replaced by dense lane-leading arrays and the
    sequential route-to-smallest-wSum update (reservoir.cpp:10-32) replaced by
    fixed, order-invariant lanes (see ops/wrs.py)."""

    pos: jnp.ndarray  # [K, 3, H, W] selected light-sample positions
    color: jnp.ndarray  # [K, 3, H, W] selected light-sample colors
    w_sum: jnp.ndarray  # [K, H, W] sum of resampling weights
    m: jnp.ndarray  # [K, H, W] float sample counts (reference sampleNums)
    big_w: jnp.ndarray  # [K, H, W] unbiased contribution weight W
    chosen_w: jnp.ndarray  # [K, H, W] weight of the chosen sample (R-OMIS)

    @property
    def k(self) -> int:
        return self.pos.shape[0]

    @property
    def hw(self):
        return self.pos.shape[-2:]

    def total_m(self) -> jnp.ndarray:
        """Reference Reservoir::totalSampleNums (reservoir.cpp:34-38).
        → [H, W]."""
        return jnp.sum(self.m, axis=0)


def empty_reservoirs(height: int, width: int, k: int) -> Reservoirs:
    return Reservoirs(
        pos=jnp.zeros((k, 3, height, width), jnp.float32),
        color=jnp.zeros((k, 3, height, width), jnp.float32),
        w_sum=jnp.zeros((k, height, width), jnp.float32),
        m=jnp.zeros((k, height, width), jnp.float32),
        big_w=jnp.zeros((k, height, width), jnp.float32),
        chosen_w=jnp.zeros((k, height, width), jnp.float32),
    )
