"""The data-parallel mesh and the ZeRO-3 layout rule (port of
``parallel/mesh.py``).

The JAX package lays parameters and data out over a
``jax.sharding.Mesh`` of devices and lets GSPMD insert the collectives.
The port's mesh is a ``torch.distributed`` process group: one rank per
device, NCCL between cards, gloo on the CPU.  There is no global mutable
mesh: a wrapper holds its own.

Axis names are the JAX package's (``data``, ``model``, ``seq``).  Only
the data axis is ported: a mesh with a ``model`` (tensor-parallel) or
``seq`` (sequence-parallel) axis larger than 1 is refused (ROADMAP queue
1, item 8).

``zero3_spec`` is the JAX rule exactly: the first axis of a leaf whose
size is at least dp and divisible by dp is sharded over ``data``; a leaf
of fewer than ``max(min_size, dp)`` elements replicates.  It returns the
sharded dim (or None) where the JAX package returns a ``PartitionSpec``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "DEFAULT_MIN_SHARD_SIZE",
           "Mesh", "make_mesh", "zero3_spec", "shard_params", "shard_batch",
           "place_sharded", "shard_of", "refuse_model_axes"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

#: ZeRO-3 layout threshold: param leaves with fewer elements replicate
#: (sharding a bias saves nothing and adds a collective)
DEFAULT_MIN_SHARD_SIZE = 1024

_ITEM8 = "is not ported yet (ROADMAP queue 1, item 8)"


def refuse_model_axes(tp: int, sp: int) -> None:
    if int(tp) > 1:
        raise NotImplementedError(
            f"a mesh with a '{MODEL_AXIS}' axis of {tp} (tensor "
            f"parallelism) {_ITEM8}")
    if int(sp) > 1:
        raise NotImplementedError(
            f"a mesh with a '{SEQ_AXIS}' axis of {sp} (sequence "
            f"parallelism) {_ITEM8}")


class Mesh:
    """A ``(data, model, seq)`` mesh over a process group: ``dp`` ranks
    on the data axis (model and seq are 1).  ``rank`` is this process's
    place on the data axis (None where the process is not in the mesh),
    ``group`` the process group its collectives run on (None: the
    default group), ``device`` the device this rank trains on."""

    def __init__(self, dp: int, rank: Optional[int], group=None,
                 device=None):
        self.dp = int(dp)
        self.rank = rank
        self.group = group
        self.device = torch.device(device) if device is not None else None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: 1, SEQ_AXIS: 1}

    @property
    def axis_names(self):
        return (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

    @property
    def size(self) -> int:
        return self.dp

    def __repr__(self) -> str:
        return f"Mesh(data={self.dp}, rank={self.rank})"


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def make_mesh(n_devices: Optional[int] = None, *, dp: Optional[int] = None,
              tp: int = 1, sp: int = 1, device=None) -> Mesh:
    """A data-parallel mesh over the default process group (or this one
    process when none is initialized).  ``dp`` defaults to every rank; an
    explicit ``dp`` smaller than the world takes the first ``dp`` ranks
    (a subgroup: every rank of the world must call ``make_mesh`` with the
    same arguments, as ``torch.distributed.new_group`` requires).
    ``device`` is this rank's device (default: ``cuda:<local rank>``
    where CUDA is up, else the CPU)."""
    refuse_model_axes(tp, sp)
    world = _world()
    if n_devices is None:
        n_devices = world
    n_devices = min(int(n_devices), world)
    if dp is None:
        if n_devices % (tp * sp):
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp={tp * sp}")
        dp = n_devices // (tp * sp)
    need = int(dp) * tp * sp
    if need > world:
        raise ValueError(
            f"mesh dp*tp*sp = {dp}*{tp}*{sp} = {need} oversubscribes the "
            f"{world} available device(s) — lower dp (or tp/sp), or "
            "start more ranks")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    rank = _rank()
    group = None
    if world > 1 and dp < world:
        import torch.distributed as dist
        group = dist.new_group(list(range(int(dp))))
    if device is None:
        if torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    return Mesh(int(dp), rank if rank < dp else None, group, device)


def zero3_spec(shape: Sequence[int], dp: int, min_size: int
               ) -> Optional[int]:
    """ZeRO-3 row-sharding rule for ONE parameter leaf: the first axis
    divisible by the data-axis size is sharded (its index is returned);
    leaves with fewer than ``max(min_size, dp)`` elements replicate
    (None) — sharding them saves nothing and costs a collective per
    step."""
    if dp <= 1 or int(np.prod(tuple(shape), dtype=np.int64)) < \
            max(int(min_size), int(dp)):
        return None
    for i, n in enumerate(shape):
        if n >= dp and n % dp == 0:
            return i
    return None


def shard_params(mesh_or_dp, tree,
                 min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Dict[str, Any]:
    """The layout plan of a param (or param-shaped) tree: the same nesting
    with each leaf replaced by its sharded dim under ``zero3_spec`` (None:
    replicated).  Leaves may be tensors, arrays or shape tuples; the tree
    may be a network's ``params`` (module dicts)."""
    dp = mesh_or_dp.dp if isinstance(mesh_or_dp, Mesh) else int(mesh_or_dp)

    def plan(v):
        if isinstance(v, Mapping) or hasattr(v, "items"):
            return {k: plan(c) for k, c in v.items()}
        shape = tuple(v) if isinstance(v, (tuple, list)) else \
            tuple(getattr(v, "shape", ()))
        return zero3_spec(shape, dp, min_size)

    return plan(tree)


def shard_of(t: torch.Tensor, dim: Optional[int], dp: int,
             rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along ``dim`` (``t`` itself when
    ``dim`` is None), as a contiguous copy."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t.narrow(dim, rank * n, n).contiguous()


def place_sharded(x, mesh: Mesh, dim: Optional[int]):
    """This rank's block of a global tensor or array under a layout
    decision (``zero3_spec``'s result), on the mesh's device."""
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    if mesh.device is not None:
        t = t.to(mesh.device)
    return shard_of(t, dim, mesh.dp, mesh.rank or 0)


def shard_batch(mesh: Mesh, x):
    """This rank's rows of a global batch leaf (leading dim divisible by
    the data axis)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [shard_batch(mesh, e) for e in x]
    n = int(x.shape[0])
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"{mesh.dp} data-parallel ranks")
    k = n // mesh.dp
    r = mesh.rank or 0
    return x[r * k:(r + 1) * k]
