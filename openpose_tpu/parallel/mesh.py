"""Device mesh + sharding rules for multi-chip execution.

The reference scales by replicating the whole net per GPU and round-robining
frames (SURVEY §2.2); this design instead lays out one global mesh
with two axes:

* ``data``  — frame batch (the throughput axis)
* ``model`` — conv output channels (tensor parallelism for the VGG+CPM
  stages; XLA GSPMD inserts the all-gathers/reduce-scatters)

Param sharding rule: every conv kernel [kh, kw, cin, cout] and bias [cout]
shards cout over ``model``; PReLU slopes likewise.  Activations shard batch
over ``data`` and are otherwise replicated — for OpenPose-sized nets the
activation tensors are small enough that channel-sharding activations buys
nothing at typical batch sizes, so the collective pattern stays all-gather on
weights only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None,
              data: Optional[int] = None, model: int = 1) -> Mesh:
    """Create a (data, model) mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def param_sharding(mesh: Mesh, params) -> dict:
    """NamedSharding pytree matching `params` (channel-sharded over model)."""
    model_size = mesh.shape["model"]

    def shard_leaf(leaf):
        # Shard the channel dim only when it divides evenly (the small final
        # 26/52-channel heads stay replicated).
        if leaf.ndim == 4 and leaf.shape[3] % model_size == 0:
            spec = P(None, None, None, "model")
        elif leaf.ndim == 1 and leaf.shape[0] % model_size == 0:
            spec = P("model")
        else:
            spec = P()
        return NamedSharding(mesh, spec)
    return jax.tree.map(shard_leaf, params)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
