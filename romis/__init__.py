"""romis — a differentiable ReSTIR renderer in JAX.

A from-scratch re-design of the capabilities of MrMagnifico/romis (a CPU
Whitted tracer with ReSTIR / R-MIS / R-OMIS direct-lighting estimators) for
accelerators: SoA pytrees, order-invariant weighted reservoir sampling,
batched wavefront ray tracing, pjit/shard_map image-tile parallelism, and
end-to-end differentiability w.r.t. scene parameters.
"""

from .core.features import Features, RayTraceMode, MISWeight, NeighbourSelectionStrategy

__version__ = "0.1.0"
