"""Multi-host data parallelism: per-host input sharding + global stats.

The reference's only scaling axis is reads-parallelism on one machine
(SURVEY 2.2). Across hosts, one process per host owns all of that host's
cards:

- each host reads a disjoint subset of the pod5 inputs (files are the
  natural shard unit; `shard_files` below mirrors the reference's
  bidx-sharded outputs with per-host shard naming),
- every host runs the same fused demux step over its local minibatches
  on its local cards (parallel/mesh.py shards over a host's cards),
- global per-class counters come back through a psum over the global mesh
  (class_counts_psum), the analog of the reference's Manager-lock shared
  counters,
- outputs stay host-local (csv.gz/npz shards named with the host index),
  exactly like the reference's per-process bidx shards.

`init_distributed()` wires jax.distributed from explicit coordinator
arguments (address, process count, process index); nothing is read from
the environment. Everything degrades to single-host when
process_count == 1, which is how the unit tests run.
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize the JAX distributed runtime (no-op when single-host or
    already initialized). Returns (process_index, process_count).

    coordinator_address is "host:port" of process 0's coordinator; None
    is an explicit single-host no-op.
    """
    # NOTE: do not touch jax.process_count() before initialize() — querying
    # it initializes the backends, after which distributed init is a no-op.
    if jax.distributed.is_initialized() or coordinator_address is None:
        return jax.process_index(), jax.process_count()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
    return jax.process_index(), jax.process_count()


def shard_files(
    files: list[str], process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """This host's share of the input files (round-robin, deterministic)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [f for i, f in enumerate(files) if i % pc == pi]


def host_shard_tag(process_index: int | None = None) -> str:
    """Suffix for output shard names so hosts never collide."""
    pi = jax.process_index() if process_index is None else process_index
    return f"h{pi:03d}"


def global_class_counts(local_counts: np.ndarray) -> np.ndarray:
    """All-reduce per-class read counters across every host/chip.

    local_counts: (k+1,) int — this host's counts (the mesh step's psum
    already reduced over local chips). Uses a tiny pmapped psum over the
    global device set; single-process returns the input unchanged.
    """
    if jax.process_count() == 1:
        return np.asarray(local_counts)
    n_local = jax.local_device_count()
    # contribute from device 0 only; zeros elsewhere
    per_dev = np.zeros((n_local,) + local_counts.shape, local_counts.dtype)
    per_dev[0] = local_counts
    summed = jax.pmap(
        lambda x: jax.lax.psum(x, "d"), axis_name="d"
    )(per_dev)
    return np.asarray(summed[0])
