"""Device mesh + sharding helpers.

This replaces the reference's Dask LocalCluster factory (reference:
dask_utils.py:9-32) as the distribution substrate: instead of a task-graph
scheduler shuffling partitions between worker threads, we lay out a
`jax.sharding.Mesh` over all chips and express every distributed op as an
SPMD program with XLA collectives (NCCL on GPUs).

Axes:
  data  — batch/session sharding (pure data parallelism).
  model — row-sharded parameter/count tables (embedding tables, count shards).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class MeshContext:
    mesh: Mesh
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def n_data(self) -> int:
        return self.mesh.shape[self.data_axis]

    @property
    def n_model(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    # -- common shardings ---------------------------------------------------
    def data(self, *trailing_none: int) -> NamedSharding:
        """Shard leading axis over 'data', replicate the rest."""
        return NamedSharding(self.mesh, P(self.data_axis))

    def rows(self) -> NamedSharding:
        """Shard leading axis over 'model' (row-sharded tables)."""
        return NamedSharding(self.mesh, P(self.model_axis))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def spec(self, *axes: Optional[str]) -> P:
        return P(*axes)


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    data_parallel: int = -1,
    model_parallel: int = 1,
    data_axis: str = "data",
    model_axis: str = "model",
) -> MeshContext:
    """Build a 2D (data, model) mesh over the given devices.

    data_parallel = -1 means "all remaining devices". A single-chip mesh is a
    valid 1x1 mesh, so every code path is mesh-aware from the start.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data_parallel == -1:
        if n % model_parallel != 0:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} != {n} devices"
        )
    dev_array = np.asarray(devices).reshape(data_parallel, model_parallel)
    mesh = Mesh(dev_array, (data_axis, model_axis))
    return MeshContext(mesh=mesh, data_axis=data_axis, model_axis=model_axis)


def data_sharding(ctx: MeshContext) -> NamedSharding:
    return NamedSharding(ctx.mesh, P(ctx.data_axis))


def row_sharding(ctx: MeshContext) -> NamedSharding:
    return NamedSharding(ctx.mesh, P(ctx.model_axis))


def replicated_sharding(ctx: MeshContext) -> NamedSharding:
    return NamedSharding(ctx.mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
