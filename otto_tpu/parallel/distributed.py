"""Multi-host runtime initialization.

Replaces the reference's Dask LocalCluster bootstrap (reference:
dask_utils.py:9-32) for the multi-host case: `jax.distributed` across
hosts, with the (data, model) mesh laid out so model-parallel collectives
stay among one host's devices and only data-parallel reductions cross the
network (SURVEY.md §5.8). Within a host every card reaches every other
(NVLink, all to all), so the mesh follows the algorithm alone.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import jax

from otto_tpu.parallel.mesh import MeshContext, make_mesh

log = logging.getLogger(__name__)


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed when running multi-host. No-op single
    host. Args default from the standard env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None and num_processes is None:
        log.info("single-host run; jax.distributed not initialized")
        return
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    log.info(
        "jax.distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def global_mesh(model_parallel: int = 1) -> MeshContext:
    """(data, model) mesh over ALL global devices. The model axis is kept
    within a host's devices by construction: jax.devices() orders devices
    host-major, and model_parallel must divide the local device count so
    table shards never span hosts."""
    local = jax.local_device_count()
    if model_parallel > 1 and local % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide local device "
            f"count {local} to keep table shards within a host"
        )
    return make_mesh(jax.devices(), model_parallel=model_parallel)
