"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic is tested on CPU with
``xla_force_host_platform_device_count=8`` (see SURVEY §4) — no cards
needed. This must run before JAX initialises a backend.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# The tests run on the CPU even where JAX would pick a GPU.
jax.config.update("jax_platforms", "cpu")
