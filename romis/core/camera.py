"""Orbit ("trackball") camera and primary-ray generation.

Re-implements the math of the reference Trackball camera
(framework/src/trackball.cpp:75-114) as a pure JAX function of a camera
parameter pytree, so camera parameters are differentiable and animated
cameras are just a batch/scan axis.

Conventions copied from the reference:
- rotation is an (x, y, z) Euler triple in radians converted to a quaternion
  with the glm XYZ Tait-Bryan formula (glm::quat(glm::vec3)),
- camera position = look_at + R * (0, 0, -distance)   (trackball.cpp:75-78),
- a ray through normalized pixel coords (px, py) ∈ [-1, 1]² has camera-space
  direction normalize(-px*halfW, py*halfH, 1)          (trackball.cpp:105-114),
- halfH = tan(fovy/2), halfW = aspect * halfH          (trackball.cpp:26-27).

The reference screen flips y when writing pixels (src/rendering/screen.cpp:37-43)
so that +py (up) lands in the top image rows; we generate rays directly in
display order (row 0 = top of image) instead.
"""

from __future__ import annotations

import jax.numpy as jnp

from .types import Rays, pytree_dataclass


@pytree_dataclass
class CameraParams:
    """Differentiable orbit-camera parameters.

    Reference analog: CameraConfig (src/utils/config.h:21-26) + Trackball
    internal state. Angles in radians.
    """

    look_at: jnp.ndarray  # [3]
    rotation: jnp.ndarray  # [3] Euler angles (x, y, z), radians
    distance: jnp.ndarray  # [] scalar
    fovy: jnp.ndarray  # [] vertical field of view, radians
    aspect: jnp.ndarray  # [] width / height


def make_camera(
    look_at=(0.0, 0.0, 0.0),
    rotation_deg=(20.0, 20.0, 0.0),
    distance=3.0,
    fov_deg=50.0,
    resolution=(256, 256),
) -> CameraParams:
    """Build CameraParams from the TOML-config-style fields
    (src/utils/config.cpp:252-258: field_of_view, distance_from_look_at,
    look_at, rotation — all degrees)."""
    height, width = resolution
    return CameraParams(
        look_at=jnp.asarray(look_at, jnp.float32),
        rotation=jnp.deg2rad(jnp.asarray(rotation_deg, jnp.float32)),
        distance=jnp.float32(distance),
        fovy=jnp.deg2rad(jnp.float32(fov_deg)),
        aspect=jnp.float32(width / height),
    )


def quat_from_euler_xyz(euler: jnp.ndarray) -> jnp.ndarray:
    """glm::quat(glm::vec3 euler) component formula → [w, x, y, z]."""
    half = euler * 0.5
    c = jnp.cos(half)
    s = jnp.sin(half)
    w = c[0] * c[1] * c[2] + s[0] * s[1] * s[2]
    x = s[0] * c[1] * c[2] - c[0] * s[1] * s[2]
    y = c[0] * s[1] * c[2] + s[0] * c[1] * s[2]
    z = c[0] * c[1] * s[2] - s[0] * s[1] * c[2]
    return jnp.stack([w, x, y, z])


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v [..., 3] by quaternion q [w, x, y, z]."""
    qv = q[1:]
    w = q[0]
    t = 2.0 * jnp.cross(jnp.broadcast_to(qv, v.shape), v)
    return v + w * t + jnp.cross(jnp.broadcast_to(qv, t.shape), t)


def camera_position(cam: CameraParams) -> jnp.ndarray:
    """Trackball::position (trackball.cpp:75-78)."""
    q = quat_from_euler_xyz(cam.rotation)
    return cam.look_at + quat_rotate(q, jnp.array([0.0, 0.0, -1.0]) * cam.distance)


def generate_rays(cam: CameraParams, height: int, width: int) -> Rays:
    """Generate the primary ray grid [3, H, W] in display order
    (row 0 = image top). Reference: genPrimaryRayHits NDC mapping
    (src/rendering/render_utils.cpp:23-26) + Trackball::generateRay
    (trackball.cpp:105-114)."""
    from .vec import vnormalize

    q = quat_from_euler_xyz(cam.rotation)
    origin = cam.look_at + quat_rotate(q, jnp.array([0.0, 0.0, -1.0]) * cam.distance)

    half_h = jnp.tan(cam.fovy * 0.5)
    half_w = cam.aspect * half_h

    # Reference NDC: px = x/W*2-1 for x in [0, W); py likewise. Screen
    # setPixel flips y, so image row r corresponds to py index (H-1-r).
    xs = jnp.arange(width, dtype=jnp.float32) / width * 2.0 - 1.0
    ys = (height - 1 - jnp.arange(height, dtype=jnp.float32)) / height * 2.0 - 1.0
    px, py = jnp.meshgrid(xs, ys)  # [H, W]

    dirs_cam = jnp.stack(
        [-px * half_w, py * half_h, jnp.ones_like(px)], axis=0
    )  # [3, H, W]
    dirs_cam = vnormalize(dirs_cam)
    dirs = quat_rotate_imgminor(q, dirs_cam)

    origins = jnp.broadcast_to(origin[:, None, None], dirs.shape)
    return Rays(origin=origins, direction=dirs)


def quat_rotate_imgminor(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate image-minor vectors v [..., 3, H, W] by quaternion q."""
    from .vec import vcross

    qv = q[1:][:, None, None]  # [3, 1, 1]
    w = q[0]
    qvb = jnp.broadcast_to(qv, v.shape)
    t = 2.0 * vcross(qvb, v)
    return v + w * t + vcross(jnp.broadcast_to(qv, t.shape), t)


def project_to_pixel(
    cam: CameraParams, points: jnp.ndarray, height: int, width: int
):
    """Project world points [..., 3, H, W] back to (row, col) pixel
    coordinates under ``cam`` — the inverse of generate_rays, used for
    temporal motion reprojection (a capability the reference lacks: its
    temporal reuse indexes the same screen coordinate,
    render_utils.cpp:151-172).

    Returns (rows, cols float32, in_front bool), each [..., H, W].
    """
    from .vec import vx, vy, vz

    q = quat_from_euler_xyz(cam.rotation)
    origin = cam.look_at + quat_rotate(q, jnp.array([0.0, 0.0, -1.0]) * cam.distance)
    # Inverse rotation = conjugate quaternion.
    q_inv = q * jnp.array([1.0, -1.0, -1.0, -1.0])
    v_cam = quat_rotate_imgminor(
        q_inv, points - origin[:, None, None])  # camera space, forward = +z

    half_h = jnp.tan(cam.fovy * 0.5)
    half_w = cam.aspect * half_h
    z = vz(v_cam)
    in_front = z > 1e-6
    zs = jnp.where(in_front, z, 1.0)
    px = -(vx(v_cam) / zs) / half_w  # [-1, 1]
    py = (vy(v_cam) / zs) / half_h

    # Match the forward mapping: col index x has px = x/W*2-1 → x = (px+1)/2*W;
    # row r has py = (H-1-r)/H*2-1 → r = H-1 - (py+1)/2*H.
    col = (px + 1.0) * 0.5 * width
    row = (height - 1) - (py + 1.0) * 0.5 * height
    return row, col, in_front
