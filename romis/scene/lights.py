"""Unified SoA light table.

The reference stores lights as a variant<PointLight, SegmentLight,
ParallelogramLight> (src/utils/common.h:72-87) and branches per light when
sampling (src/scene/light.cpp:63-82). Here every light is canonicalised into
the parallelogram form so sampling is branch-free gathers + FMAs:

- point:          v0 = position, edge01 = edge02 = 0, all corner colors equal
- segment:        v0 = endpoint0, edge01 = endpoint1 - endpoint0, edge02 = 0,
                  colors (c0, c1, c0, c1) so the bilinear lerp reduces to the
                  reference's single-axis mix (light.cpp:19-23)
- parallelogram:  direct (light.cpp:27-34)

Sampling one light with two uniforms (u, v):
    position = v0 + u*edge01 + v*edge02
    color    = mix(mix(c0, c1, u), mix(c2, c3, u), v)
which matches sampleParallelogramLight (light.cpp:27-34) exactly and is the
identity-on-(u,·) / constant mapping for segment / point lights.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.types import pytree_dataclass


POINT, SEGMENT, PARALLELOGRAM = 0, 1, 2


@pytree_dataclass
class LightTable:
    v0: jnp.ndarray  # [L, 3]
    edge01: jnp.ndarray  # [L, 3]
    edge02: jnp.ndarray  # [L, 3]
    c0: jnp.ndarray  # [L, 3]
    c1: jnp.ndarray  # [L, 3]
    c2: jnp.ndarray  # [L, 3]
    c3: jnp.ndarray  # [L, 3]
    kind: jnp.ndarray  # [L] int32 (POINT/SEGMENT/PARALLELOGRAM, metadata only)
    # Packed row table [L, 24]: v0|e01|e02|c0|c1|c2|c3|pad. Sampling fetches
    # ONE row per candidate index instead of 21 per-component gathers.
    rows: jnp.ndarray

    @property
    def n(self) -> int:
        return self.v0.shape[0]


def _pack_rows(v0, e01, e02, c0, c1, c2, c3) -> jnp.ndarray:
    import numpy as np

    cols = np.concatenate(
        [np.asarray(x, np.float32) for x in (v0, e01, e02, c0, c1, c2, c3)],
        axis=1)
    pad = np.zeros((cols.shape[0], 24 - cols.shape[1]), np.float32)
    return jnp.asarray(np.concatenate([cols, pad], axis=1))


def _pack_rows_jnp(v0, e01, e02, c0, c1, c2, c3) -> jnp.ndarray:
    """Traced variant (used when differentiating through light params)."""
    cols = jnp.concatenate([v0, e01, e02, c0, c1, c2, c3], axis=1)
    return jnp.concatenate(
        [cols, jnp.zeros((cols.shape[0], 24 - cols.shape[1]))], axis=1)


class LightListBuilder:
    """Host-side builder mirroring the reference light variants."""

    def __init__(self):
        self.rows = []

    def add_point(self, position, color):
        """Reference PointLight (common.h:72-75)."""
        z = (0.0, 0.0, 0.0)
        self.rows.append((position, z, z, color, color, color, color, POINT))
        return self

    def add_segment(self, endpoint0, endpoint1, color0, color1):
        """Reference SegmentLight (common.h:77-81)."""
        e0 = np.asarray(endpoint0, np.float32)
        e1 = np.asarray(endpoint1, np.float32)
        z = (0.0, 0.0, 0.0)
        self.rows.append((e0, e1 - e0, z, color0, color1, color0, color1, SEGMENT))
        return self

    def add_parallelogram(self, v0, edge01, edge02, color0, color1, color2, color3):
        """Reference ParallelogramLight (common.h:83-87)."""
        self.rows.append((v0, edge01, edge02, color0, color1, color2, color3,
                          PARALLELOGRAM))
        return self

    def build(self) -> LightTable:
        if not self.rows:
            # Keep a 1-row dummy table (weight-0 lights) so shapes stay static.
            z = np.zeros((1, 3), np.float32)
            return LightTable(
                v0=jnp.asarray(z), edge01=jnp.asarray(z), edge02=jnp.asarray(z),
                c0=jnp.asarray(z), c1=jnp.asarray(z), c2=jnp.asarray(z),
                c3=jnp.asarray(z), kind=jnp.zeros((1,), jnp.int32),
                rows=_pack_rows(z, z, z, z, z, z, z),
            )
        cols = list(zip(*self.rows))
        arrs = [np.asarray(c, np.float32).reshape(-1, 3) for c in cols[:7]]
        kind = np.asarray(cols[7], np.int32)
        return LightTable(
            v0=jnp.asarray(arrs[0]), edge01=jnp.asarray(arrs[1]),
            edge02=jnp.asarray(arrs[2]), c0=jnp.asarray(arrs[3]),
            c1=jnp.asarray(arrs[4]), c2=jnp.asarray(arrs[5]),
            c3=jnp.asarray(arrs[6]), kind=jnp.asarray(kind),
            rows=_pack_rows(*arrs),
        )

    def __len__(self):
        return len(self.rows)


def sample_lights(
    lights: LightTable,
    light_idx: jnp.ndarray,  # [..., H, W] int32
    u: jnp.ndarray,  # [..., H, W] uniform in [0, 1]
    v: jnp.ndarray,  # [..., H, W] uniform in [0, 1]
):
    """Vectorised light sampling in image-minor layout. Returns
    (position [..., 3, H, W], color [..., 3, H, W]).

    Matches sampleParallelogramLight (light.cpp:27-34) with the point/segment
    cases falling out of the canonicalised table.
    """
    from ..core.vec import VEC_AXIS, e
    from ..ops.gather import gather_rows

    # ONE packed planes-first row-gather per index (see LightTable.rows):
    # [24, ..., H, W].
    rows = gather_rows(lights.rows, light_idx)

    def comp(i):  # [..., 3, H, W] slice of the packed row
        return jnp.moveaxis(rows[3 * i:3 * i + 3], 0, VEC_AXIS)

    v0, e01, e02 = comp(0), comp(1), comp(2)
    c0, c1, c2, c3 = comp(3), comp(4), comp(5), comp(6)
    uu = e(u)
    vv = e(v)
    pos = v0 + uu * e01 + vv * e02
    lerp01 = c0 * (1.0 - uu) + c1 * uu
    lerp23 = c2 * (1.0 - uu) + c3 * uu
    color = lerp01 * (1.0 - vv) + lerp23 * vv
    return pos, color


def sample_lights_planes(
    lights: LightTable,
    light_idx: jnp.ndarray,  # [..., H, W] int32
    u: jnp.ndarray,
    v: jnp.ndarray,
):
    """sample_lights on scalar component planes: returns
    (px, py, pz, cr, cg, cb), each [..., H, W]. Avoids [..., 3, H, W]
    intermediates inside scan reverse-mode (see
    ops/shading.target_pdf_planes)."""
    from ..ops.gather import gather_rows

    rows = gather_rows(lights.rows, light_idx)  # [24, ..., H, W]
    px = rows[0] + u * rows[3] + v * rows[6]
    py = rows[1] + u * rows[4] + v * rows[7]
    pz = rows[2] + u * rows[5] + v * rows[8]
    cols = []
    for c in range(3):
        lerp01 = rows[9 + c] * (1.0 - u) + rows[12 + c] * u
        lerp23 = rows[15 + c] * (1.0 - u) + rows[18 + c] * u
        cols.append(lerp01 * (1.0 - v) + lerp23 * v)
    return px, py, pz, cols[0], cols[1], cols[2]


def regular_light_grid(
    builder: LightListBuilder,
    start_pos,
    counts,
    edge01,
    edge02,
    color,
    empty_space_percentage: float = 0.1,
):
    """Grid of parallelogram lights. Reference: regularLightGrid
    (src/scene/scene.cpp:5-28)."""
    start_pos = np.asarray(start_pos, np.float32)
    edge01 = np.asarray(edge01, np.float32)
    edge02 = np.asarray(edge02, np.float32)
    cx, cy = counts
    space01 = edge01 / cx
    space02 = edge02 / cy
    light01 = edge01 * (1.0 - empty_space_percentage) / cx
    light02 = edge02 * (1.0 - empty_space_percentage) / cy
    for xl in range(cx):
        for yl in range(cy):
            origin = start_pos + space01 * xl + space02 * yl
            builder.add_parallelogram(origin, light01, light02,
                                      color, color, color, color)
    return builder
