"""Object-axis sharding over a device mesh.

The reference scales to multiple GPUs by replicating the whole dataset to
every GPU and round-robin-assigning objects (ref nerf_manager.cu:202-217,
nerf.cu:27-33); GPUs never communicate. The batched equivalent
(SURVEY.md §2.3): a 1D jax mesh over the local devices (on four H100s
NVLink joins every card to every other, so the mesh follows the algorithm
alone), the OBJECT axis of every batched state leaf sharded across cards
("dp over objects" — objects are
embarrassingly parallel, so the train step lowers with zero collectives),
and the keyframe store replicated (it is shared, read-only input).

Because the batched train step is pure data-parallel over axis 0, sharding
is applied by placing the data (`shard_objects` / `replicate`) and letting
jit propagate — no shard_map needed, XLA partitions the vmapped step along
the object axis.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("obj",))


def object_sharding(mesh: Mesh) -> NamedSharding:
    """Partition axis 0 (the object axis) across the mesh."""
    return NamedSharding(mesh, P("obj"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_objects(tree: Any, mesh: Mesh) -> Any:
    """Place every leaf with its object axis sharded across the mesh."""
    s = object_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    s = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def pad_capacity(capacity: int, mesh: Mesh) -> int:
    """Round the object-table capacity up to a multiple of the mesh size."""
    n = mesh.devices.size
    return ((capacity + n - 1) // n) * n
