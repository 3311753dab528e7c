"""Slow, obviously-correct NumPy oracle used to validate the JAX pipeline.

Implements the estimator math with plain Python loops, independently of the
romis implementation (the reference semantics re-derived from
src/rendering/shading.cpp, reservoir.cpp, light.cpp — see SURVEY §2/§3).
Tests feed both sides identical pre-drawn random numbers.
"""

import numpy as np


def normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def phong(light_pos, light_color, origin, hit_pos, normal, kd, ks, shininess,
          enable_shading=True):
    """computeShading (shading.cpp:7-34) with the documented clamped-specular
    deviation."""
    if not enable_shading:
        return np.array(kd, np.float64)
    p = np.asarray(hit_pos, np.float64)
    l_vec = np.asarray(light_pos, np.float64) - p
    dist = np.linalg.norm(l_vec)
    if dist == 0.0:
        l_dir = np.zeros(3)
    else:
        l_dir = l_vec / dist
    dot_nl = float(np.dot(normal, l_dir))
    if dot_nl < 0.0:
        return np.zeros(3)
    v = normalize(np.asarray(origin, np.float64) - p)
    r = normalize(2.0 * dot_nl * np.asarray(normal) - l_dir)
    cos_theta = float(np.dot(r, v))
    diffuse = np.asarray(light_color) * np.asarray(kd) * dot_nl
    spec = np.asarray(light_color) * np.asarray(ks) * max(cos_theta, 0.0) ** shininess
    diffuse = np.where(np.isnan(diffuse), 0.0, diffuse)
    spec = np.where(np.isnan(spec), 0.0, spec)
    d = 1.0 if dist < 1e-5 else dist
    return (diffuse + spec) / (d * d)


def target_pdf(light_pos, light_color, origin, hit_pos, normal, kd, ks,
               shininess, valid=True):
    if not valid:
        return 0.0
    return float(np.linalg.norm(
        phong(light_pos, light_color, origin, hit_pos, normal, kd, ks,
              shininess)))


def moller_trumbore(origin, direction, v0, e1, e2):
    """Single ray-triangle intersection; returns (t, u, v) or None."""
    eps = 1e-9
    pvec = np.cross(direction, e2)
    det = np.dot(e1, pvec)
    if abs(det) <= eps:
        return None
    inv_det = 1.0 / det
    tvec = np.asarray(origin, np.float64) - v0
    u = np.dot(tvec, pvec) * inv_det
    if u < 0.0 or u > 1.0:
        return None
    qvec = np.cross(tvec, e1)
    v = np.dot(direction, qvec) * inv_det
    if v < 0.0 or u + v > 1.0:
        return None
    t = np.dot(e2, qvec) * inv_det
    if t <= 0.0:
        return None
    return t, u, v


def closest_hit(origin, direction, tris):
    """tris: list of (v0, e1, e2). Returns (t, idx, u, v) or (inf, -1, 0, 0)."""
    best = (np.inf, -1, 0.0, 0.0)
    for i, (v0, e1, e2) in enumerate(tris):
        r = moller_trumbore(origin, direction, v0, e1, e2)
        if r is not None and r[0] < best[0]:
            best = (r[0], i, r[1], r[2])
    return best


def wrs_lane_select(weights, gumbels):
    """Gumbel-max winner among candidates with the given weights.
    Returns index or -1 if all weights are zero."""
    scores = np.where(np.asarray(weights) > 0,
                      np.log(np.maximum(weights, 1e-37)) + gumbels, -np.inf)
    if np.all(~np.isfinite(scores)):
        return 0
    return int(np.argmax(scores))


def ris_lane(cands_w, gumbels):
    """One lane's RIS bookkeeping: returns (winner_idx, w_sum, m)."""
    w = np.asarray(cands_w, np.float64)
    return wrs_lane_select(w, gumbels), float(w.sum()), len(w)
