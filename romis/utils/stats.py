"""Tracing / metrics / observability.

Reference analog (SURVEY §5): wall-clock prints (main.cpp:168-170), progress
bars, and per-render config JSON. Here: structured per-frame statistics,
ray/reservoir-update accounting, and a phase timer that synchronises
correctly on remote-dispatch backends (where block_until_ready is a no-op —
only fetching a scalar forces completion).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..core.features import Features


def frame_ray_counts(height: int, width: int, features: Features) -> dict:
    """Static per-frame ray/update accounting for the ReSTIR pipeline
    (mirrors the loops in render.cpp:28-62 / render_utils.cpp)."""
    n = height * width
    k = features.num_samples_in_reservoir
    primary = n
    final_shadow = n * k
    init_vis = n * k if features.initial_samples_visibility_check else 0
    unbiased_vis = 0
    if (features.spatial_reuse and features.unbiased_combination
            and features.spatial_reuse_visibility_check):
        unbiased_vis = (n * features.spatial_resampling_passes
                        * (features.num_neighbours_to_sample + 1) * k)
    reservoir_updates = n * features.initial_light_samples
    if features.temporal_reuse:
        reservoir_updates += n * 2 * k
    if features.spatial_reuse:
        reservoir_updates += (n * features.spatial_resampling_passes
                              * (features.num_neighbours_to_sample + 1) * k)
    total_rays = primary + final_shadow + init_vis + unbiased_vis
    return {
        "primary_rays": primary,
        "shadow_rays": final_shadow + init_vis + unbiased_vis,
        "total_rays": total_rays,
        "reservoir_updates": reservoir_updates,
        "target_pdf_evals": n * (
            features.initial_light_samples
            + (2 * k + k if features.temporal_reuse else 0)
            + (features.spatial_resampling_passes
               * ((features.num_neighbours_to_sample + 1) * k + k)
               if features.spatial_reuse else 0)),
    }


def reservoir_stats(reservoirs) -> dict:
    """Device-side summary of a reservoir grid (fetches 6 scalars)."""
    return {
        "m_mean": float(jnp.mean(reservoirs.total_m())),
        "m_max": float(jnp.max(reservoirs.total_m())),
        "w_mean": float(jnp.mean(reservoirs.big_w)),
        "w_max": float(jnp.max(reservoirs.big_w)),
        "w_sum_mean": float(jnp.mean(reservoirs.w_sum)),
        "zero_w_frac": float(jnp.mean((reservoirs.big_w == 0.0)
                                      .astype(jnp.float32))),
    }


@dataclass
class PhaseTimer:
    """Accumulates per-phase wall-clock with correct device sync.

    Usage:
        timer = PhaseTimer()
        with timer("trace"):
            out = traced_fn(...)
            timer.sink(out)   # sync point inside the context
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    _current: str | None = None
    _t0: float = 0.0

    def __call__(self, name: str):
        self._current = name
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sink(self, tree):
        jax.block_until_ready(tree)

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        name = self._current or "?"
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return False

    def report(self) -> str:
        rows = [
            f"{name}: {total:.3f}s total, "
            f"{1000 * total / max(self.counts[name], 1):.1f} ms/call "
            f"({self.counts[name]} calls)"
            for name, total in sorted(self.totals.items(),
                                      key=lambda kv: -kv[1])
        ]
        return "\n".join(rows)


class JsonlLogger:
    """Append structured per-frame records to a JSONL file (SURVEY §5
    'structured per-frame stats dict ... optional JSONL log')."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
