"""Process set-up shared by the entry points: the persistent compile cache,
the accelerator check, and the card's identity."""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads that variable itself); when it is unset, in the fixed,
    git-ignored ``.jax_cache/`` at the repository root. Returns the
    directory."""
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    return cache


def require_gpu():
    """The first device, which must be a GPU: measurements never fall back
    to the CPU. Raises SystemExit otherwise."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU found (JAX devices: {devs})")
    return devs[0]


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()
