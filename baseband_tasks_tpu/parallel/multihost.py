"""Multi-host initialization and pod-slice mesh construction.

SURVEY.md §7 step 10: multi-host runs initialize ``jax.distributed`` (one
process per host, all hosts see the global mesh).  This module wraps the
init + mesh construction so pipelines are launched the same way on one
device, one host, or N hosts:

    from baseband_tasks_tpu.parallel import multihost
    multihost.initialize()              # no-op on a single process
    mesh = multihost.pod_mesh(chan=8)   # (time, chan) over ALL devices

Per-host data feeding: each host supplies its local shard of every global
array via ``jax.make_array_from_process_local_data`` (wrapped here as
``host_local``).
"""

from __future__ import annotations

import numpy as np

import jax

from .mesh import make_mesh

__all__ = ["initialize", "pod_mesh", "host_local"]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Initialize jax.distributed when running multi-process.

    With explicit arguments they are passed through.  With none, the
    cluster is auto-detected by ``jax.distributed.initialize()`` when a
    coordinator is configured in the environment
    (``JAX_COORDINATOR_ADDRESS``, or a cluster manager JAX detects such
    as SLURM); otherwise this is a no-op.  Safe to call always.
    """
    # NB: do not touch jax.process_count()/device_count() before the
    # distributed init — the first device query initializes the backend,
    # after which jax.distributed.initialize silently cannot take effect.
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not _in_multihost_env():
        return
    if explicit and "cpu" in str(jax.config.jax_platforms or ""):
        # multi-process CPU runs (tests, local dryruns) need gloo
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    try:
        if explicit:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        else:
            jax.distributed.initialize()
    except RuntimeError:
        # already initialized
        pass


def _in_multihost_env():
    import os
    return any(os.environ.get(k) for k in
               ("JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID",
                "OMPI_COMM_WORLD_SIZE"))


def pod_mesh(time=-1, chan=1):
    """A (time, chan) mesh over all devices of all hosts."""
    return make_mesh(time=time, chan=chan, devices=jax.devices())


def host_local(global_array, sharding):
    """Build a globally-sharded array from per-host local data."""
    return jax.make_array_from_process_local_data(sharding, global_array)
