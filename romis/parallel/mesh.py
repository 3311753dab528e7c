"""Device-mesh construction and sharding specs.

The reference's parallelism is OpenMP rows + one thread per camera
(SURVEY §2.4). Here the [H*W] pixel/ray/reservoir axis is sharded over a
1-D ``tiles`` mesh axis as horizontal image bands; the scene (triangles,
materials, lights) is replicated on every device. Gradients of replicated
scene parameters are reduced by GSPMD's automatic psum; cross-band
reservoir reads in spatial reuse lower to collective gathers/permutes. The
mesh follows the algorithm (bands in a line), not the interconnect: the
cards of one host reach each other all to all.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (TILE_AXIS,))


def row_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the image row axis (axis -2 in image-minor layout): tiles are
    horizontal image bands. Leading sample axes and the lane (W) axis stay
    replicated-contiguous per device."""
    spec = [None] * ndim
    if ndim >= 2:
        spec[-2] = TILE_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pixels(tree, mesh: Mesh):
    """Constrain every array in an image-minor pytree to be sharded on its
    row (H) axis."""
    return jax.tree.map(
        lambda a: jax.lax.with_sharding_constraint(
            a, row_sharding(mesh, a.ndim)),
        tree,
    )
