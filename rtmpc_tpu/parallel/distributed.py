"""Multi-process launch path: ``jax.distributed`` init + global DP mesh.

The reference is single-process, single-threaded (SURVEY.md §2.4:
"Multi-host: absent"); here the Monte-Carlo batch is sharded over every
device of every process, with cross-host traffic only at init and at
result gather.

* ``initialize_from_env()`` — guarded ``jax.distributed.initialize``.  The
  coordinator address, process count and process id come from the
  arguments or the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID`` env vars.  A single process with nothing set is a
  no-op (nothing to coordinate), so the same entry point works from one
  card to many hosts.
* ``global_dp_mesh()`` — a flat 1-D "dp" mesh over every device of every
  process (the sweep's only parallel axis; QPs are tiny, so there is no
  model axis to shard — SURVEY.md §2.4 TP/PP/SP/EP rationale).  NVLink
  joins a host's cards all to all, so the mesh needs no topology.
* ``distributed_mc_arrays()`` — lay a host-local batch shard out as one
  globally-sharded array via ``jax.make_array_from_process_local_data``
  so each host only materializes its own rows.

Launch (one command per process; ``tests/distributed_worker.py`` is a
two-process example):

    JAX_COORDINATOR_ADDRESS=host0:12345 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=0 python -c "
    from rtmpc_tpu.parallel.distributed import initialize_from_env, \
        global_dp_mesh
    initialize_from_env()
    mesh = global_dp_mesh()
    # ... build arrays/cfg, run run_mc_sweep(..., mesh=mesh) ...
    "

Every process executes the same program (SPMD); ``run_mc_sweep``'s
results come back via ordinary device-to-host transfer of the
globally-sharded outputs (addressable shards only on each host; use
``jax.experimental.multihost_utils.process_allgather`` when a full copy
per host is wanted).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["initialize_from_env", "global_dp_mesh",
           "distributed_mc_arrays", "is_distributed"]

_INITIALIZED = False


def is_distributed() -> bool:
    """True once ``initialize_from_env`` has actually initialized the
    ``jax.distributed`` runtime (multi-process run)."""
    return _INITIALIZED


def initialize_from_env(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """Guarded ``jax.distributed.initialize``.

    Resolution order for each field: explicit argument, then the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    env vars.

    Returns True when the distributed runtime was initialized, False when
    the call degenerated to single-process (no coordinator and at most one
    process requested).  Idempotent: a second call is a no-op.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)

    if coordinator_address is None:
        if num_processes is None or num_processes == 1:
            return False        # nothing to coordinate: one process
        raise ValueError(
            "JAX_NUM_PROCESSES > 1 but no coordinator address: set "
            "JAX_COORDINATOR_ADDRESS=<host0>:<port> on every process")
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _INITIALIZED = True
    return True


def global_dp_mesh(axis_name: str = "dp"):
    """1-D mesh with the given axis over EVERY device of every process.

    After ``initialize_from_env``, ``jax.devices()`` is the global device
    list, so the mesh spans hosts; single-process it spans the local cards
    (or the virtual CPU devices under
    ``xla_force_host_platform_device_count``).
    """
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), axis_names=(axis_name,))


def distributed_mc_arrays(mesh, *host_local_arrays, axis_name: str = "dp"):
    """Assemble per-process batch shards into globally-sharded arrays.

    Each process passes only ITS rows (batch axis 0 = its slice of the
    global Monte-Carlo batch); the returned ``jax.Array``s are globally
    shaped and sharded over the mesh without any cross-host data motion
    (``jax.make_array_from_process_local_data`` places each host's rows on
    its own devices).  Single-process this is an ordinary ``device_put``
    with a ``NamedSharding``.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    sharding = NamedSharding(mesh, PartitionSpec(axis_name))
    n_proc = getattr(jax, "process_count", lambda: 1)()
    out = []
    for a in host_local_arrays:
        a = np.asarray(a)
        if n_proc == 1:
            out.append(jax.device_put(a, sharding))
        else:
            global_shape = (a.shape[0] * n_proc,) + a.shape[1:]
            out.append(jax.make_array_from_process_local_data(
                sharding, a, global_shape))
    return tuple(out) if len(out) != 1 else out[0]
