"""Multi-host (multi-process) deployment of the object-sharded runtime.

The reference's multi-GPU story is single-host only: replicate the dataset
to every GPU and round-robin objects (ref nerf_manager.cu:202-217); there
is no cross-machine path at all. Across hosts the natural extension keeps
the same shape — the object axis shards over the GLOBAL device mesh
(NVLink within a host, the network across hosts), the frame store is
replicated per host,
and, because objects are embarrassingly parallel, the train step still
lowers with ZERO collectives: each process executes only its local object
rows, and nothing ever crosses DCN except the coordination-service
handshake at startup.

Usage on each host of an N-process job:

    from romap_tpu.parallel import multihost
    multihost.initialize(coordinator="host0:8476",
                         num_processes=N, process_id=i)
    mesh = multihost.global_mesh()               # all devices, 1D "obj" axis
    state = multihost.shard_objects_global(local_state, mesh)
    # ... nerf.train_objects(state, ...) exactly as single-host ...

`tests/test_multihost.py` exercises this for real: two coordinated CPU
processes, each with 4 virtual devices, build the global 8-device mesh, run
the sharded train step, and their per-shard losses must match the
single-process oracle to fp32 tolerance (SPMD partitioning may reorder
reductions).
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from romap_tpu.parallel.sharding import object_sharding


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the jax distributed runtime (idempotent).

    `coordinator` is "host:port" of process 0. After this returns,
    `jax.devices()` enumerates the GLOBAL device set and
    `jax.local_devices()` this process's slice.
    """
    if num_processes == 1:
        return
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return
    # NB: must run before the first backend touch (jax.devices() etc.) —
    # do NOT probe jax.process_count() here, that would initialize it.
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh() -> Mesh:
    """1D "obj" mesh over every device of every process, local-major order
    (process 0's devices first) so each process's object rows land on its
    own chips and no resharding traffic crosses DCN."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), ("obj",))


def local_object_slice(capacity: int, mesh: Mesh) -> slice:
    """The [start, stop) rows of the global object table owned by this
    process (capacity must be a multiple of the mesh size — see
    sharding.pad_capacity)."""
    n = mesh.devices.size
    assert capacity % n == 0, f"capacity {capacity} not divisible by {n}"
    per_dev = capacity // n
    mine = [i for i, d in enumerate(mesh.devices.flat)
            if d.process_index == jax.process_index()]
    assert mine == list(range(min(mine), max(mine) + 1)), (
        "this process's devices are not contiguous in the mesh — build it "
        "with global_mesh() (local-major order) so each process owns one "
        f"contiguous row block; got positions {mine}")
    return slice(min(mine) * per_dev, (max(mine) + 1) * per_dev)


def shard_objects_global(local_tree: Any, mesh: Mesh) -> Any:
    """Assemble a GLOBAL object-sharded array tree from process-local rows.

    Each process passes only its own rows (axis 0 = its slice of the object
    table, see `local_object_slice`); the result is a tree of global jax
    Arrays addressable by the usual single-host code paths.
    """
    s = object_sharding(mesh)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(s, np.asarray(x)),
        local_tree,
    )


def replicate_global(tree: Any, mesh: Mesh) -> Any:
    """Replicate host data (the frame store) to every device of the mesh.
    Every process must pass identical values."""
    s = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(s, np.asarray(x)),
        tree,
    )


def local_losses(global_losses: jax.Array) -> np.ndarray:
    """This process's rows of a [capacity] object-sharded result array."""
    shards = [
        (s.index[0].start or 0, np.asarray(s.data))
        for s in global_losses.addressable_shards
    ]
    return np.concatenate([d for _, d in sorted(shards, key=lambda t: t[0])])
