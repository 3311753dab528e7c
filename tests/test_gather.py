"""Table and neighbourhood gathers (ops/gather.py, core/vec.from_table)
and their scatter-add backward passes, against direct NumPy indexing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.vec import from_table
from romis.ops.gather import gather_rows, halo_offset_gather


def _scatter_ref(ct, idx, t):
    c = ct.shape[0]
    out = np.zeros((t, c), np.float32)
    np.add.at(out, np.asarray(idx).ravel(), np.asarray(ct).reshape(c, -1).T)
    return out


@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "leading_dims"])
def test_rows_gather_matches_and_grads(lead):
    """Planes-first packed row gather == direct indexing, and its backward
    scatter-adds the cotangent into the table rows."""
    rng = np.random.default_rng(8)
    t, c, h, w = 200, 7, 40, 150
    table = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, t, lead + (h, w)).astype(np.int32))

    direct = np.moveaxis(np.asarray(table)[np.asarray(idx)], -1, 0)
    np.testing.assert_array_equal(np.asarray(gather_rows(table, idx)),
                                  direct)

    weights = jnp.asarray(rng.normal(size=(c,) + lead + (h, w))
                          .astype(np.float32))
    g = jax.grad(lambda tb: jnp.sum(gather_rows(tb, idx) * weights))(table)
    np.testing.assert_allclose(np.asarray(g), _scatter_ref(weights, idx, t),
                               rtol=1e-5, atol=1e-4)


def test_from_table_grad_matches_autodiff():
    rng = np.random.default_rng(2)
    t, c, h, w = 83, 3, 16, 24
    table = jnp.asarray(rng.normal(size=(t, c)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, t, (h, w)).astype(np.int32))
    proj = jnp.asarray(rng.normal(size=(c, h, w)).astype(np.float32))

    def loss(tab):
        g = from_table(tab, idx)  # [C, H, W] (VEC_AXIS = -3)
        return jnp.sum(g * proj)

    def loss_plain(tab):
        g = jnp.stack([tab[:, i][idx] for i in range(c)], axis=0)
        return jnp.sum(g * proj)

    np.testing.assert_allclose(np.asarray(jax.grad(loss)(table)),
                               np.asarray(jax.grad(loss_plain)(table)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax.grad(loss)(table)),
                               _scatter_ref(proj, idx, t),
                               rtol=1e-5, atol=1e-5)


def _offsets(rng, h, w, d_n, r):
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    # In-bounds offsets within the box (what neighbour selection produces).
    ny = np.clip(ys + rng.integers(-r, r + 1, (d_n, h, w)), 0, h - 1)
    nx = np.clip(xs + rng.integers(-r, r + 1, (d_n, h, w)), 0, w - 1)
    return ny, nx, (ny - ys).astype(np.int32), (nx - xs).astype(np.int32)


def test_halo_offset_gather_exact():
    """Exact-offset gather (R-MIS/R-OMIS neighbour fetch) vs direct
    indexing — fully deterministic, offsets are inputs."""
    h, w, r, d_n, c = 48, 180, 5, 3, 4
    rng = np.random.default_rng(6)
    planes = rng.normal(size=(c, h, w)).astype(np.float32)
    ny, nx, dy, dx = _offsets(rng, h, w, d_n, r)
    got = np.asarray(halo_offset_gather(
        jnp.asarray(planes), jnp.asarray(dy), jnp.asarray(dx)))
    expect = planes[:, ny, nx].transpose(1, 0, 2, 3)  # [D, C, H, W]
    np.testing.assert_array_equal(got, expect)


def test_halo_offset_gather_vjp():
    """The differentiable exact-offset halo gather's backward must equal the
    direct scatter-add of cotangents (the gather is linear in the planes)."""
    rng = np.random.default_rng(0)
    c, h, w, d_n, r = 4, 16, 24, 3, 2
    planes = jnp.asarray(rng.normal(size=(c, h, w)).astype(np.float32))
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    ny = np.clip(ys + rng.integers(-r, r + 1, (d_n, h, w)), 0, h - 1)
    nx = np.clip(xs + rng.integers(-r, r + 1, (d_n, h, w)), 0, w - 1)
    dy = jnp.asarray((ny - ys).astype(np.int32))
    dx = jnp.asarray((nx - xs).astype(np.int32))
    wts = rng.normal(size=(d_n, c, h, w)).astype(np.float32)

    # Forward equals direct indexing.
    got = np.asarray(halo_offset_gather(planes, dy, dx))
    np.testing.assert_array_equal(
        got, np.moveaxis(np.asarray(planes)[:, ny, nx], 0, 1))

    g = jax.grad(lambda p: jnp.sum(
        halo_offset_gather(p, dy, dx) * jnp.asarray(wts)))(planes)
    expect = np.zeros((c, h, w), np.float32)
    for di in range(d_n):
        for cc in range(c):
            np.add.at(expect[cc], (ny[di], nx[di]), wts[di, cc])
    np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-5, atol=1e-5)


def test_halo_offset_scatter_kernel_matches_segment_sum():
    """The gather's segment_sum backward must reproduce the direct
    scatter-add exactly — including duplicate targets and image borders,
    on a non-square image."""
    rng = np.random.default_rng(5)
    c, h, w, d_n, r = 6, 40, 150, 4, 3
    ny, nx, dy, dx = _offsets(rng, h, w, d_n, r)
    ct = rng.normal(size=(d_n, c, h, w)).astype(np.float32)
    planes = jnp.zeros((c, h, w), jnp.float32)
    _, vjp = jax.vjp(lambda p: halo_offset_gather(
        p, jnp.asarray(dy), jnp.asarray(dx)), planes)
    got = np.asarray(vjp(jnp.asarray(ct))[0])
    expect = np.zeros((c, h, w), np.float32)
    for di in range(d_n):
        for cc in range(c):
            np.add.at(expect[cc], (ny[di], nx[di]), ct[di, cc])
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
