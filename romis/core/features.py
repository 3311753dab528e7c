"""Feature/config flags for the renderer.

Re-design of the reference `Features` struct
(reference: src/utils/common.h:89-148). Unlike the reference, this is a frozen,
hashable dataclass so it can be closed over by / passed statically into
``jax.jit`` — every field is trace-static and changing any field recompiles.

Dead reference flags (``enableRecursive``, ``enableHardShadow``,
``enableSoftShadow``, ``enableNormalInterp``, ``enableAccelStructure`` —
read by no rendering code, see src/utils/common.h:91-97) are dropped.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass


class RayTraceMode(enum.Enum):
    """Reference: src/utils/common.h:25-29."""

    RESTIR = "restir"
    RMIS = "rmis"
    ROMIS = "romis"


class MISWeight(enum.Enum):
    """Reference: src/utils/common.h:31-34."""

    EQUAL = "equal"
    BALANCE = "balance"


class NeighbourSelectionStrategy(enum.Enum):
    """Reference: src/utils/common.h:36-41."""

    RANDOM = "random"
    SIMILAR = "similar"
    DISSIMILAR = "dissimilar"
    EQUAL_SIMILAR_DISSIMILAR = "equal_similar_dissimilar"


@dataclass(frozen=True)
class Features:
    """Renderer feature flags and parameters.

    Field defaults mirror the reference defaults
    (src/utils/common.h:89-148) except ``ray_trace_mode`` which defaults to
    ReSTIR here (the reference default is ROMIS).
    """

    # Global toggles (reference common.h:91-97)
    enable_shading: bool = True
    enable_texture_mapping: bool = True

    # Shared RIS / ReSTIR parameters (reference common.h:103-108)
    ray_trace_mode: RayTraceMode = RayTraceMode.RESTIR
    initial_samples_visibility_check: bool = False
    num_samples_in_reservoir: int = 2  # K sub-reservoir lanes
    initial_light_samples: int = 32  # RIS candidates per pixel
    num_neighbours_to_sample: int = 5
    spatial_resample_radius: int = 10

    # Neighbour-selection heuristics (reference common.h:111-113).
    # NOTE: the reference compares the normal dot product against the *angle
    # in radians* (src/rendering/neighbour_selection.cpp:16-18, a bug); we
    # compare against cos(angle).
    neighbour_same_geometry: bool = True
    neighbour_max_depth_difference_fraction: float = 0.10
    neighbour_max_normal_angle_difference_radians: float = 0.436332

    # R-MIS / R-OMIS parameters (reference common.h:116-121)
    max_iterations_mis: int = 5
    neighbour_selection_strategy: NeighbourSelectionStrategy = (
        NeighbourSelectionStrategy.SIMILAR
    )
    mis_weight_rmis: MISWeight = MISWeight.EQUAL
    use_progressive_romis: bool = False
    progressive_update_mod: int = 1

    # ReSTIR feature flags (reference common.h:124-131)
    unbiased_combination: bool = False
    spatial_reuse: bool = True
    spatial_reuse_visibility_check: bool = False
    temporal_reuse: bool = True
    spatial_resampling_passes: int = 2
    temporal_clamp_m: int = 20

    # Gradient-path RIS: winner-replay surrogate backward. The candidate
    # scan runs DETACHED (no autodiff through S slots) and the reservoir
    # outputs are re-derived differentiably from the winner's replay record
    # (light index, u1, u2); d(w_sum)/dtheta uses a SECOND independent
    # resampling race: E[(w_sum / w_J') * dw_J'] over J' ~ w/sum(w) equals
    # sum_j dw_j exactly, and independence from the primary winner keeps the
    # full gradient estimator unbiased for the exact autodiff gradient
    # (statistically validated in tests/test_grad_surrogate.py). Cost: the
    # backward evaluates 2 candidates per lane instead of S (16x fewer at
    # reference defaults). Loss VALUES match the exact path to fusion-level
    # float reassociation (~1 ulp); only the gradient is estimated —
    # finite-difference tests keep this off. Gradient benches/production
    # set it True.
    surrogate_resampling_grad: bool = False

    # Fused closed-form VJPs for the planes-form Phong / target-PDF evals
    # (ops/shading.phong_shade_planes_analytic): identical forward values,
    # backward recomputes ~25 shared scalars from the inputs and emits
    # every cotangent in closed form — no per-call AD temporaries or remat
    # bookkeeping in the O(J·D1·K) MIS sweep backwards. Default off: the
    # AD path is the tested one.
    analytic_phong_vjp: bool = False

    # Gradient-path spatial offsets: draw ONE (dy, dx) per (pass, neighbour)
    # shared by every pixel instead of per-pixel offsets. The neighbour
    # gather then becomes lax.dynamic_slice of an edge-padded stack whose
    # VJP is a pad — the per-pixel path's gather VJP is a segment_sum
    # scatter.
    # Per-pixel offset MARGINALS are identical (uniform on the clamped
    # +-radius box), so per-pixel image expectations — and hence any
    # per-pixel loss such as L2 — are unchanged for a single pass. With
    # multiple passes the shared offsets additionally correlate each pixel's
    # own reuse lineage (pass 2 revisits pixels whose pass-1 neighbours were
    # shifted identically), not just cross-pixel noise — per-pixel
    # expectations still match, higher moments differ. Gradient paths
    # (diff/grad.py, parallel/shard.py) default this True unless
    # ``exact_gradients`` is set; forward rendering keeps per-pixel offsets.
    coherent_spatial_offsets: bool = False

    # Escape hatch for the gradient APIs (diff/grad.py render_with_params,
    # parallel/shard.py make_sharded_train_step): when True they leave
    # coherent_spatial_offsets and surrogate_resampling_grad exactly as the
    # caller set them instead of applying the fast-path defaults — the exact
    # per-pixel-offset estimator is then reachable through the public API.
    exact_gradients: bool = False

    # Temporal reprojection with motion vectors. The reference explicitly
    # lacks motion vectors (report §2; render_utils.cpp:151-172 indexes the
    # same screen coordinate); we add camera-motion reprojection as a
    # first-class feature.
    temporal_reprojection: bool = False

    # Bounded-motion radius for temporal reprojection: reprojected fetches
    # reach at most ±radius pixels; pixels whose motion exceeds the band
    # fall back to reuse-REJECT (fresh history), the standard
    # real-time-ReSTIR disocclusion treatment.
    reprojection_radius: int = 16

    # Tone mapping (reference common.h:134-136)
    enable_tone_mapping: bool = True
    gamma: float = 1.0
    exposure: float = 1.5

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        """Provenance dump, analogous to the reference's cereal JSON archive
        written per render (src/rendering/render.cpp:282-288)."""
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.Enum):
                d[k] = v.value
        return json.dumps(d, indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Features":
        kw = dict(d)
        if "ray_trace_mode" in kw:
            kw["ray_trace_mode"] = RayTraceMode(kw["ray_trace_mode"])
        if "mis_weight_rmis" in kw:
            kw["mis_weight_rmis"] = MISWeight(kw["mis_weight_rmis"])
        if "neighbour_selection_strategy" in kw:
            kw["neighbour_selection_strategy"] = NeighbourSelectionStrategy(
                kw["neighbour_selection_strategy"]
            )
        return Features(**kw)
