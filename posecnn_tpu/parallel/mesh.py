"""Device mesh + sharding rules for distributed training.

This is NEW capability — the reference is strictly single-GPU
(SURVEY.md §2.4: one `tf.Session`, no NCCL/MPI anywhere). The
design follows the standard JAX recipe: build a `Mesh` with a 'data'
axis (optionally a 'model' axis for the 25088×4096 fc6/fc7 matmuls),
annotate batch arrays with `NamedSharding(P('data', …))`, replicate
parameters (or shard fc kernels over 'model'), and let XLA insert the
gradient all-reduce under `jit` (NCCL over NVLink on a GPU host).

Scaling story:
  DP  — batch axis over 'data'; gradients all-reduced by XLA.
  TP  — optional 'model' axis sharding fc6/fc7 kernels column-wise
        (the only >100 MB layers); activations all-gathered by XLA.
  PP/SP/EP — N/A for a conv detector (no sequence dim, no experts);
        documented out of scope, matching SURVEY.md §2.4.
Multi-host: `jax.distributed.initialize()` + per-host data loading
(data/pipeline.py shards the file list by process index).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(
    num_data: int = -1,
    num_model: int = 1,
    *,
    data_axis: str = "data",
    model_axis: str = "model",
    devices=None,
) -> Mesh:
    """Build a (data × model) mesh. num_data=-1 → all remaining devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if num_data == -1:
        if n % num_model != 0:
            raise ValueError(f"{n} devices not divisible by num_model={num_model}")
        num_data = n // num_model
    if num_data * num_model > n:
        raise ValueError(
            f"mesh {num_data}×{num_model} needs {num_data * num_model} devices, have {n}"
        )
    grid = devices[: num_data * num_model].reshape(num_data, num_model)
    return Mesh(grid, (data_axis, model_axis))


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim over 'data', replicate the rest."""
    return NamedSharding(mesh, P(data_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(
    mesh: Mesh,
    params,
    *,
    shard_fc: bool = False,
    model_axis: str = "model",
):
    """Sharding tree for the parameter pytree.

    Default: fully replicated (pure DP). With shard_fc=True the pose
    head fc6/fc7 kernels — the dominant parameters (25088×4096 ≈ 100M
    of PoseCNN's ≈134M) — are sharded column-wise over 'model'
    (tensor parallelism); XLA all-gathers the 4096-wide activations.
    """

    def rule(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        if shard_fc and any(n in ("fc6", "fc7") for n in names) and leaf.ndim == 2:
            return NamedSharding(mesh, P(None, model_axis))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, params)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Multi-host runtime init (jax.distributed) — call before any
    device use on each host of a pod slice. No-op for single-process
    runs. Returns (process_index, process_count) for the data
    pipeline's per-host sharding (data/pipeline.ShuffledIndexer,
    data/shards.ShardReader)."""
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()
