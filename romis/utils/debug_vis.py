"""Headless visual-debug channel.

The reference's debug channel is GL immediate-mode ray drawing (camera rays
green/red, shadow rays cyan/red — src/ui/draw.cpp:178-200,
embree_interface.cpp:86-88, utils.cpp:50-55) plus R-OMIS α visualisations.
The headless analog renders diagnostic *images* of the same signals:

- hit/miss mask (camera-ray green/red analog)
- depth, shading normals, submesh id, material albedo
- shadow-ray visibility fraction per pixel (cyan/red analog)
- reservoir diagnostics: M, W, wSum heatmaps

Use from the CLI via ``--debug-vis`` or directly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features
from ..core.vec import e
from ..ops.wrs import gen_canonical_samples, visibility
from ..render.restir import trace_primary


def _to_img(x) -> np.ndarray:
    """[3, H, W] or [H, W] device array → [H, W, 3] numpy in [0, 1]."""
    a = np.asarray(x, np.float32)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=0)
    return np.clip(np.moveaxis(a, 0, -1), 0.0, 1.0)


def _heat(x, lo=None, hi=None) -> np.ndarray:
    """Scalar field → blue-orange heatmap image."""
    a = np.asarray(x, np.float32)
    lo = np.nanmin(a) if lo is None else lo
    hi = np.nanmax(a) if hi is None else hi
    t = np.clip((a - lo) / max(hi - lo, 1e-12), 0, 1)
    # 0 → blue (0, 0.5, 1), 1 → orange (1, 0.5, 0)
    return np.stack([t, np.full_like(t, 0.5), 1.0 - t], axis=-1)


def debug_images(
    key,
    cam: CameraParams,
    scene,
    height: int,
    width: int,
    features: Features,
) -> dict[str, np.ndarray]:
    """Render the full diagnostic set. Returns name → [H, W, 3] image."""
    g, l, nl = scene.geometry, scene.lights, scene.num_lights
    rays = generate_rays(cam, height, width)
    hits, ctx = trace_primary(rays, g, features)

    out = {}
    hit = np.asarray(hits.valid)
    # Camera-ray debug colors (embree_interface.h:22-23): green hit, red miss.
    out["hit_mask"] = np.where(hit[..., None], [0.2, 0.9, 0.2],
                               [0.9, 0.2, 0.2]).astype(np.float32)
    t = np.asarray(hits.t)
    finite = np.isfinite(t)
    tmax = t[finite].max() if finite.any() else 1.0
    out["depth"] = _heat(np.where(finite, t, tmax), 0.0, tmax)
    out["normals"] = _to_img((jnp.asarray(hits.normal) + 1.0) * 0.5)
    out["albedo"] = _to_img(ctx.kd)
    gid = np.asarray(hits.geom_id).astype(np.float32)
    out["geom_id"] = _heat(np.where(gid >= 0, gid, 0), 0,
                           max(gid.max(), 1))

    # Shadow-ray channel: visibility fraction of the canonical samples
    # (cyan = clear, red = blocked — utils.h:17-18 colors).
    res = gen_canonical_samples(key, ctx, l, nl, g, features)
    vis = np.asarray(visibility(ctx.position, res.pos, g)).mean(axis=0)
    out["shadow_visibility"] = (
        vis[..., None] * np.array([0.2, 0.9, 0.9])
        + (1 - vis)[..., None] * np.array([0.9, 0.2, 0.2])
    ).astype(np.float32)

    # Reservoir diagnostics.
    out["reservoir_m"] = _heat(np.asarray(res.total_m()))
    out["reservoir_w"] = _heat(np.asarray(res.big_w).mean(axis=0))
    out["reservoir_wsum"] = _heat(np.asarray(res.w_sum).mean(axis=0))
    return out


def save_debug_images(prefix: str, images: dict[str, np.ndarray]) -> list[str]:
    from ..io.image import write_image

    paths = []
    for name, img in images.items():
        path = f"{prefix}_{name}.png"
        write_image(path, img)
        paths.append(path)
    return paths
