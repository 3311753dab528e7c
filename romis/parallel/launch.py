"""Multi-host launch plumbing.

The reference scales with OpenMP threads inside one process (SURVEY §2.4);
the scale-out here is one process per host, all hosts running the SAME
jitted SPMD program over a global mesh (jax.distributed + GSPMD/shard_map).
One process drives every card of its own host.

Single-process runs need none of this: every entry point works unchanged.
To run the same program on N hosts, start each process with the cluster
variables below and call ``maybe_init_distributed()`` first — it is a no-op
when they are unset, so one code path serves one process and a cluster.

    COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=4 PROCESS_ID=0 \
        python -m romis.cli --config scene.toml

Used by: romis/cli.py (before device queries).
"""

from __future__ import annotations

import os

import jax


def maybe_init_distributed() -> bool:
    """Initialise jax.distributed when a cluster is configured.

    Returns True when running as part of a multi-process cluster. Safe to
    call unconditionally: without COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID it does nothing.

    NB: must not touch the backend (jax.devices / jax.process_count) before
    jax.distributed.initialize — backend init pins the single-process
    topology and initialize() then raises (tests/test_distributed.py
    exercises this for real with two OS processes)."""
    if jax.distributed.is_initialized():
        return True
    addr = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if addr and nproc and pid is not None:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(pid),
        )
        return True
    return False


def global_mesh():
    """1-D tiles mesh over every device in the (possibly multi-host)
    cluster. With jax.distributed initialised, jax.devices() spans all
    hosts and the SPMD renderers (parallel/shard.py, parallel/halo.py)
    need no changes — pixel bands land on whichever host owns them."""
    from .mesh import make_mesh

    return make_mesh(len(jax.devices()))
