"""Shared test helpers for the image-minor layout.

Tests are written against flat lists of rays/points; these helpers pack them
into the framework's [..., H, W] layout with H=1 so per-ray comparisons stay
simple (pixel i ↔ column i).
"""

import numpy as np
import jax.numpy as jnp

from romis.core.types import Rays, ShadeCtx


def pack_vec(a):
    """[N, 3] → [3, 1, N]."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.T[:, None, :])


def pack_scalar(a, dtype=None):
    """[N] → [1, N]."""
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    return jnp.asarray(a[None, :])


def unpack_vec(a):
    """[3, 1, N] → [N, 3] numpy."""
    return np.asarray(a)[:, 0, :].T


def unpack_scalar(a):
    """[1, N] → [N] numpy."""
    return np.asarray(a)[0]


def make_rays(origins, dirs) -> Rays:
    return Rays(origin=pack_vec(origins), direction=pack_vec(dirs))


def random_reservoirs_and_ctx(rng, h, w, k):
    """Plausible random Reservoirs + ShadeCtx over a full [H, W] grid
    (unit normals, positive depths, mixed validity) for combine tests."""
    from romis.core.types import Reservoirs

    def f(*shape):
        return jnp.asarray(rng.uniform(0.1, 2.0, shape).astype(np.float32))

    normal = rng.normal(size=(3, h, w)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    res = Reservoirs(
        pos=jnp.asarray(
            rng.uniform(-3, 3, (k, 3, h, w)).astype(np.float32)),
        color=f(k, 3, h, w),
        w_sum=f(k, h, w),
        m=jnp.asarray(
            rng.integers(1, 20, (k, h, w)).astype(np.float32)),
        big_w=f(k, h, w),
        chosen_w=f(k, h, w),
    )
    ctx = ShadeCtx(
        valid=jnp.asarray(rng.uniform(size=(h, w)) > 0.15),
        position=jnp.asarray(
            rng.uniform(-2, 2, (3, h, w)).astype(np.float32)),
        normal=jnp.asarray(normal),
        view_origin=jnp.asarray(
            rng.uniform(-2, 2, (3, h, w)).astype(np.float32)),
        kd=f(3, h, w),
        ks=f(3, h, w) * 0.2,
        shininess=jnp.asarray(
            rng.uniform(1, 30, (h, w)).astype(np.float32)),
        depth_t=f(h, w),
        geom_id=jnp.zeros((h, w), jnp.int32),
    )
    return res, ctx


def make_ctx(n=None, *, valid=None, position, normal, view_origin, kd, ks,
             shininess, geom_id=None, depth_t=None) -> ShadeCtx:
    position = np.asarray(position, np.float32).reshape(-1, 3)
    n = len(position)
    return ShadeCtx(
        valid=pack_scalar(np.ones(n, bool) if valid is None else valid),
        position=pack_vec(position),
        normal=pack_vec(normal),
        view_origin=pack_vec(view_origin),
        kd=pack_vec(kd),
        ks=pack_vec(ks),
        shininess=pack_scalar(np.asarray(shininess, np.float32)),
        geom_id=pack_scalar(
            np.zeros(n) if geom_id is None else geom_id, np.int32),
        depth_t=pack_scalar(
            np.ones(n) if depth_t is None else depth_t, np.float32),
    )
