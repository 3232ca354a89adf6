"""Multi-host (DCN) initialization helpers.

The reference is single-core (SURVEY.md §5: no NCCL/MPI analog).
Cross-host scale-out is `jax.distributed` + a global Mesh: each host
contributes its local cards, and XLA hands collectives to NCCL (NVLink
within a host, the network across hosts).  These helpers make that a
one-liner while staying inert on a single host (the only configuration
testable in this environment — see BASELINE.md north star #2 for the
≥80% scaling target these feed).

Typical pod usage (same script on every host):

    from idsp_tpu.parallel import distributed
    distributed.initialize_from_env()          # no-op on single host
    mesh = distributed.global_mesh({"sp": 4, "dp": jax.device_count() // 4})

Axis layout guidance: put the highest-traffic axis (the IIR carry relay
/ halo-exchange `sp` axis) INSIDE a slice so its `ppermute` rides ICI;
keep only the embarrassingly-parallel channel axis (`dp`) across the
DCN boundary — its per-block traffic is zero.
"""

from __future__ import annotations

import os

import jax

from .mesh import make_mesh

_INITIALIZED = False


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize `jax.distributed` if a multi-process launch is detected.

    Detection order: explicit args, then the standard launcher env vars
    (`JAX_COORDINATOR_ADDRESS`/`COORDINATOR_ADDRESS`, `JAX_NUM_PROCESSES`
    / `NUM_PROCESSES`, `JAX_PROCESS_ID`/`PROCESS_ID`); any partial env
    is forwarded as-is.  Without a cluster launcher, pass the
    coordinator address, process count and process id explicitly.

    Returns True if `jax.distributed.initialize` was called, False when
    running single-process (no env, no args) — in which case nothing is
    touched and single-host behavior is identical to never importing
    this module.  Idempotent: repeated calls return the first outcome.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True

    def env(*names):
        for n in names:
            v = os.environ.get(n)
            if v is not None:
                return v
        return None

    coordinator_address = coordinator_address or env(
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"
    )
    num_str = env("JAX_NUM_PROCESSES", "NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(num_str) if num_str else None
    )
    pid_str = env("JAX_PROCESS_ID", "PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(pid_str) if pid_str else None
    )

    if coordinator_address is None and num_processes is None:
        return False  # single-process: stay inert
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    return True


def global_mesh(axis_sizes: dict[str, int]):
    """A Mesh over ALL processes' devices (`jax.devices()` is global
    after `jax.distributed.initialize`).  Same contract as
    `make_mesh`; sizes must multiply to the global device count."""
    return make_mesh(axis_sizes, devices=jax.devices())


def process_info() -> dict:
    """Topology summary for logs/metrics: process index/count and
    local vs global device counts."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
