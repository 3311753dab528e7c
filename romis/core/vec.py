"""Vector math for image-minor SoA layout.

The framework-wide convention is **image-minor**:

- scalar pixel field:  [..., H, W]
- 3-vector field:      [..., 3, H, W]   (vector axis = -3)
- reservoir lanes:     [K, ..., H, W]   (sample axes lead)

Leading axes are free, and broadcasting across sample dimensions is plain
NumPy leading-dim broadcast. These helpers do 3-vector algebra on axis -3.
"""

from __future__ import annotations

import jax.numpy as jnp

VEC_AXIS = -3


def e(s):
    """Expand a scalar field [..., H, W] with a vector axis → [..., 1, H, W]
    so it broadcasts against [..., 3, H, W] vectors."""
    return jnp.expand_dims(s, VEC_AXIS)


def vdot(a, b):
    """[..., 3, H, W] x [..., 3, H, W] → [..., H, W]."""
    return jnp.sum(a * b, axis=VEC_AXIS)


def vcross(a, b):
    """Component-wise cross product on axis -3. Hand-rolled instead of
    jnp.cross, whose moveaxis/stack lowering transposes the [..., 3, H, W]
    temporaries; slicing the component planes keeps everything
    image-minor."""
    ax, ay, az = (jnp.take(a, i, axis=VEC_AXIS) for i in range(3))
    bx, by, bz = (jnp.take(b, i, axis=VEC_AXIS) for i in range(3))
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx],
        axis=VEC_AXIS,
    )


def vnorm(a, eps: float = 1e-30):
    """Grad-safe L2 norm over the vector axis: exactly 0 for the zero vector,
    gradient 0 (not NaN) there."""
    sq = vdot(a, a)
    ok = sq > eps
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, sq, 1.0)), 0.0)


def vnormalize(a, eps: float = 1e-20):
    return a * e(jnp.reciprocal(jnp.maximum(vnorm(a), eps)))


def vec(x, y, z):
    """Stack three scalar fields into a [..., 3, H, W] vector."""
    return jnp.stack([x, y, z], axis=VEC_AXIS)


def vx(a):
    return jnp.take(a, 0, axis=VEC_AXIS)


def vy(a):
    return jnp.take(a, 1, axis=VEC_AXIS)


def vz(a):
    return jnp.take(a, 2, axis=VEC_AXIS)


import jax


@jax.custom_vjp
def from_table(table, idx):
    """Gather [..., C, H, W] vectors from a [L, C] host table by an
    [..., H, W] integer field.

    Gathers per component from [L] columns so the result stays
    image-minor; the backward scatter-adds all C components of a pixel into
    its table row with one segment_sum."""
    cols = [table[:, c][idx] for c in range(table.shape[1])]
    return jnp.stack(cols, axis=VEC_AXIS)


def _from_table_fwd(table, idx):
    return from_table(table, idx), (table.shape, idx)


def _from_table_bwd(res, ct):
    (t, c), idx = res
    ct_planes = jnp.moveaxis(ct, VEC_AXIS, 0)  # [C, ..., H, W]
    flat_ct = ct_planes.reshape(c, -1).T  # [N, C]
    d_table = jax.ops.segment_sum(flat_ct, idx.ravel(), num_segments=t)
    return d_table, None


from_table.defvjp(_from_table_fwd, _from_table_bwd)


def const_vec(v, like=None):
    """A [3] constant as a broadcastable [3, 1, 1] vector."""
    a = jnp.asarray(v, jnp.float32).reshape(3, 1, 1)
    return a
