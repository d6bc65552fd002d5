"""Multi-host utilities.

Thin, test-friendly wrappers around ``jax.distributed`` and per-host data
placement (the reference is strictly single-process, SURVEY §2.5; this is
the BASELINE config-5 scaffolding).  On a multi-host job:

    initialize(...)                    # once per process
    mesh = make_global_mesh()          # ('data','model') over all cards
    rays = host_local_rays(cfg, mesh)  # each host feeds its shard

XLA hands the gradient all-reduce to NCCL, over NVLink within a host
(parallel/sharded.py).
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed (no-op when single-process or already
    initialized).  Without a cluster environment, pass
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly."""
    if jax.process_count() > 1:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # single-process run (tests, one host) — nothing to do
        pass


def make_global_mesh(model_parallel=None):
    """('data','model') mesh over every device in the job (all hosts)."""
    from ascendpathtracing.parallel.mesh import make_mesh

    return make_mesh(len(jax.devices()), model_parallel=model_parallel)


def host_local_rays(rays_global: np.ndarray, mesh):
    """Build a globally-sharded ray array from per-host NumPy data.

    Each process passes the FULL logical array (cheap at these sizes);
    ``jax.make_array_from_process_local_data`` with an explicit
    ``global_shape`` slices out and transfers only this host's shard.
    (Without global_shape the API treats the input as the LOCAL portion
    and a 2-process job silently doubled the ray axis — caught by the
    first real multi-process run, tests/test_multiprocess.py.)
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(("data", "model"), None))
    return jax.make_array_from_process_local_data(
        sharding, rays_global, global_shape=rays_global.shape
    )


def process_info():
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
