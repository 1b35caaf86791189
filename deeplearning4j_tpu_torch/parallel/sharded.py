"""ZeRO-3 sharded data-parallel training: parameters and their updater
slots partitioned over the data axis (port of ``parallel/sharded.py``).

Every parameter leaf and its updater slots (Adam mu/nu, momentum traces)
are held as this rank's block, leaf for leaf by ``zero3_spec`` (the first
axis divisible by dp; leaves below ``min_shard_size`` elements
replicate, as in the JAX package, so the per-rank layout and
``per_device_param_bytes`` equal the JAX ``ShardedTrainer``'s).  Each
step gathers a layer's sharded leaves just before its forward, drops
them after it and gathers them again in its backward, as the JAX
package's GSPMD program gathers each leaf at its use; each gradient is
reduce-scattered (SUM) back to the rank's block as the backward reaches
it, the replicated leaves' gradients are all-reduced, and the update runs
block-locally (``parallel/exchange``).  At most one layer's leaves are
whole at a time.
The explicit ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` per
leaf around the port's functional step replaces GSPMD's derived
collectives; FSDP is not used (it cannot leave a leaf replicated).

A ``sparse_grad=True`` embedding table is the first large leaf this rule
shards (by rows where the vocabulary divides dp): its touched rows are
gathered from their owners, and each rank updates the touched rows it
owns (``nn/sparse``).

``gather_compute_overlap`` is accepted for the JAX package's signature;
the port issues each layer's gather when the layer starts, not a layer
ahead, so ``overlap_armed`` stays False, as on the JAX package's CPU
rig.

Checkpoints: ``save_sharded`` writes this rank's blocks plus the topology
manifest (``faulttolerance/checkpoint``), in the JAX package's layout,
so either package restores the other's directory at any dp.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .mesh import DEFAULT_MIN_SHARD_SIZE, Mesh, shard_params, zero3_spec
from .wrapper import ParallelWrapper, _param_shapes

__all__ = ["ShardedTrainer", "per_device_param_bytes", "param_bytes",
           "DEFAULT_MIN_SHARD_SIZE"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping) or (hasattr(v, "items")
                                      and not isinstance(v, torch.Tensor)):
            yield from _leaves(v)
        else:
            yield v


def _shape_dtype(leaf):
    """``(shape, itemsize)`` of a tensor, array or ``(shape, dtype)``
    spec."""
    if isinstance(leaf, tuple) and len(leaf) == 2 and \
            isinstance(leaf[0], tuple):
        shape, dt = leaf
    else:
        shape, dt = tuple(leaf.shape), leaf.dtype
    if isinstance(dt, torch.dtype):
        size = torch.empty((), dtype=dt).element_size()
    else:
        size = np.dtype(dt).itemsize
    return tuple(int(s) for s in shape), size


def param_bytes(params) -> int:
    """Global (unsharded) parameter bytes of a tree of tensors, arrays or
    ``(shape, dtype)`` specs."""
    total = 0
    for leaf in _leaves(params):
        shape, size = _shape_dtype(leaf)
        total += int(np.prod(shape, dtype=np.int64)) * size
    return total


def per_device_param_bytes(params, dp: int = 1,
                           min_size: int = DEFAULT_MIN_SHARD_SIZE) -> int:
    """Bytes ONE rank holds for a parameter tree under the ZeRO-3 layout
    at ``dp`` ranks: a sharded leaf counts its block, a replicated leaf
    counts whole (the JAX package's ``sharding.shard_shape`` sum)."""
    total = 0
    for leaf in _leaves(params):
        shape, size = _shape_dtype(leaf)
        d = zero3_spec(shape, dp, min_size)
        if d is not None:
            shape = shape[:d] + (shape[d] // dp,) + shape[d + 1:]
        total += int(np.prod(shape, dtype=np.int64)) * size
    return total


class ShardedTrainer(ParallelWrapper):
    """Drop-in ``fit`` with ZeRO-3 param + updater sharding over ``data``.

    The same contract as :class:`ParallelWrapper` (it IS one: the batch
    loop, trimming and listener plumbing are inherited); the layout
    differs: parameters, gradients and updater slots live sharded over
    the data axis, so per-rank parameter memory is ~1/dp of the
    replicated wrapper's and the gradient all-reduce becomes
    reduce-scatter + (forward) all-gather.

    ``min_shard_size``: leaves with fewer elements replicate.
    ``gather_compute_overlap``: accepted; ``overlap_armed`` is False.
    """

    def __init__(self, model, mesh: Optional[Mesh] = None, *,
                 min_shard_size: int = DEFAULT_MIN_SHARD_SIZE,
                 gather_compute_overlap: bool = True):
        self.min_shard_size = int(min_shard_size)
        self.gather_compute_overlap = bool(gather_compute_overlap)
        self.overlap_armed = False
        super().__init__(model, mesh)

    def _plans(self):
        plan = shard_params(self.mesh, _param_shapes(self.model),
                            min_size=self.min_shard_size)
        return plan, plan

    # ------------------------------------------------------- memory view
    def layout(self) -> Dict[str, Dict[str, Optional[int]]]:
        """``{layer: {name: sharded dim or None}}`` of this mesh."""
        return self.exchange.param_plan

    def per_device_param_bytes(self) -> int:
        return per_device_param_bytes(self.model.param_spec(),
                                      self.mesh.dp, self.min_shard_size)

    def global_param_bytes(self) -> int:
        return param_bytes(self.model.param_spec())

    # ---------------------------------------------------------- persist
    def save_sharded(self, manager, **kwargs) -> str:
        """Shard-aware checkpoint through a ``CheckpointManager``: this
        rank writes only its blocks + the topology manifest
        (``faulttolerance.checkpoint.save_sharded``).  A world of several
        ranks passes ``barrier=ShardBarrier(...)`` (or runs under
        ``ElasticTrainer``, which builds the barrier from the cluster
        view)."""
        return manager.save_sharded(self.model, **kwargs)

    def average_params(self):
        """No-op like the parent's; the returned tree is SHARDED."""
        return self.model.params
