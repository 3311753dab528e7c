"""Camera math tests against an independent NumPy/quaternion oracle."""

import numpy as np
import jax.numpy as jnp

from romis.core.camera import (
    CameraParams, camera_position, generate_rays, make_camera,
    project_to_pixel, quat_from_euler_xyz, quat_rotate,
)


def _np_quat(euler):
    half = np.asarray(euler, np.float64) * 0.5
    c, s = np.cos(half), np.sin(half)
    return np.array([
        c[0] * c[1] * c[2] + s[0] * s[1] * s[2],
        s[0] * c[1] * c[2] - c[0] * s[1] * s[2],
        c[0] * s[1] * c[2] + s[0] * c[1] * s[2],
        c[0] * c[1] * s[2] - s[0] * s[1] * c[2],
    ])


def _np_rotate(q, v):
    w, x, y, z = q
    qv = np.array([x, y, z])
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def test_quat_identity():
    q = quat_from_euler_xyz(jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(q), [1, 0, 0, 0], atol=1e-7)
    v = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(np.asarray(quat_rotate(q, v)), [1, 2, 3],
                               atol=1e-6)


def test_quat_rotation_matches_oracle():
    rng = np.random.default_rng(0)
    for _ in range(10):
        e = rng.uniform(-np.pi, np.pi, 3)
        v = rng.normal(size=3)
        got = np.asarray(quat_rotate(quat_from_euler_xyz(jnp.asarray(e)),
                                     jnp.asarray(v, jnp.float32)))
        want = _np_rotate(_np_quat(e), v)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_rotation_preserves_length():
    rng = np.random.default_rng(1)
    e = rng.uniform(-np.pi, np.pi, 3)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    out = np.asarray(quat_rotate(quat_from_euler_xyz(jnp.asarray(e)),
                                 jnp.asarray(v)))
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                               np.linalg.norm(v, axis=-1), rtol=1e-5)


def test_camera_position():
    # rotation 0: position = look_at + (0, 0, -dist) (trackball.cpp:75-78)
    cam = make_camera(look_at=(1, 2, 3), rotation_deg=(0, 0, 0), distance=5.0)
    np.testing.assert_allclose(np.asarray(camera_position(cam)), [1, 2, -2],
                               atol=1e-5)
    # yaw 180°: behind the look_at on +z
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 180, 0), distance=2.0)
    np.testing.assert_allclose(np.asarray(camera_position(cam)), [0, 0, 2],
                               atol=1e-5)


def test_ray_grid_structure():
    h, w = 8, 16
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0), distance=3.0,
                      fov_deg=60, resolution=(h, w))
    rays = generate_rays(cam, h, w)
    assert rays.origin.shape == (3, h, w)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(rays.direction), axis=0), 1.0, rtol=1e-5)
    d = np.moveaxis(np.asarray(rays.direction), 0, -1)  # [H, W, 3]
    # All rays share the camera origin.
    o = np.asarray(rays.origin)
    np.testing.assert_allclose(
        o, np.broadcast_to(o[:, :1, :1], o.shape), atol=1e-6)
    # Row 0 is the image top: +y in camera space (py > 0 up).
    assert d[0, :, 1].mean() > d[-1, :, 1].mean()
    # Reference negates x: leftmost column (px = -1) has the *largest*
    # camera-space x (trackball.cpp:105-114).
    assert d[:, 0, 0].mean() > d[:, -1, 0].mean()


def test_ray_matches_reference_formula():
    """Spot-check one ray against a literal NumPy transcription of
    Trackball::generateRay (trackball.cpp:105-114)."""
    h, w = 4, 4
    look_at = np.array([0.5, -0.25, 1.0])
    rot = np.deg2rad([10.3, 30.0, 0.0])
    dist, fov = 2.5, np.deg2rad(45.0)
    cam = CameraParams(look_at=jnp.asarray(look_at, jnp.float32),
                       rotation=jnp.asarray(rot, jnp.float32),
                       distance=jnp.float32(dist), fovy=jnp.float32(fov),
                       aspect=jnp.float32(1.0))
    rays = generate_rays(cam, h, w)
    q = _np_quat(rot)
    pos = look_at + _np_rotate(q, np.array([0, 0, -dist]))
    half_h = np.tan(fov / 2)
    x, r = 2, 1  # column 2, image row 1 → py index (h-1-r)
    px = x / w * 2 - 1
    py = (h - 1 - r) / h * 2 - 1
    d = _np_rotate(q, normalize(np.array([-px * half_h, py * half_h, 1.0])))
    np.testing.assert_allclose(np.asarray(rays.origin)[:, r, x], pos,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(rays.direction)[:, r, x], d,
                               atol=1e-5)


def normalize(v):
    return v / np.linalg.norm(v)


def test_project_inverts_generate():
    h, w = 32, 48
    cam = make_camera(look_at=(0.3, 0.1, -0.2), rotation_deg=(15, 40, 0),
                      distance=2.0, fov_deg=50, resolution=(h, w))
    rays = generate_rays(cam, h, w)
    # Points along each ray must project back to their own pixel.
    pts = np.asarray(rays.origin) + 1.7 * np.asarray(rays.direction)
    rows, cols, in_front = project_to_pixel(cam, jnp.asarray(pts), h, w)
    rows, cols = np.asarray(rows), np.asarray(cols)
    assert np.asarray(in_front).all()
    want_r = np.broadcast_to(np.arange(h)[:, None], (h, w))
    want_c = np.broadcast_to(np.arange(w)[None, :], (h, w))
    np.testing.assert_allclose(rows, want_r, atol=0.02)
    np.testing.assert_allclose(cols, want_c, atol=0.02)
