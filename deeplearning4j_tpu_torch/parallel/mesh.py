"""Meshes of ranks, the axis environment and the ZeRO-3 layout rule
(port of ``parallel/mesh.py``).

The JAX package lays parameters and data out over a
``jax.sharding.Mesh`` of devices and lets GSPMD insert the collectives.
The port's mesh is a grid of ``torch.distributed`` ranks, one rank per
device (NCCL between cards, gloo on the CPU), laid out row-major as
``np.array(devices).reshape(...)`` lays out the JAX package's devices:
the last axis varies fastest.  Each axis of the grid has one process
group per line of ranks along it (an :class:`Axis`).  There is no
global mutable mesh: a wrapper holds its own.

Axis names are the JAX package's (``data``, ``model``, ``seq``);
``make_mesh`` builds that ``(data, model, seq)`` grid and ``make_grid``
any other, such as the demos' ``("data", "pipe", "seq")`` and
``("data", "expert")``.  Entering a grid (``with grid:``) makes its axes
the axis environment of the enclosed code, the counterpart of
``shard_map``'s: ``resolve_axis("seq")`` is this rank's ``seq`` axis
there, and outside every grid it raises ``NameError`` as an unbound JAX
axis name does.  An axis of one rank in a world of several runs every
collective as the identity; so does every axis of a process that
started no process group.

``zero3_spec`` is the JAX rule exactly: the first axis of a leaf whose
size is at least dp and divisible by dp is sharded over ``data``; a leaf
of fewer than ``max(min_size, dp)`` elements replicates.  It returns the
sharded dim (or None) where the JAX package returns a ``PartitionSpec``.
A tensor-parallel ``param_rule`` returns a :class:`P`, the port's
``PartitionSpec``.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "DEFAULT_MIN_SHARD_SIZE",
           "P", "Axis", "Grid", "Mesh", "make_grid", "make_mesh",
           "current_grid", "resolve_axis", "zero3_spec", "shard_params",
           "shard_batch", "place_sharded", "shard_of"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

#: ZeRO-3 layout threshold: param leaves with fewer elements replicate
#: (sharding a bias saves nothing and adds a collective)
DEFAULT_MIN_SHARD_SIZE = 1024


class P(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dim of a
    leaf, a mesh axis name or None (not sharded); missing trailing
    entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def sharded(self) -> List[tuple]:
        """``[(dim, axis name), ...]`` of the sharded dims."""
        return [(i, a) for i, a in enumerate(self) if a is not None]


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    return _dist().get_world_size() if _initialized() else 1


def _rank() -> int:
    return _dist().get_rank() if _initialized() else 0


class Axis:
    """One axis of a grid as this rank sees it: ``size`` ranks, this
    rank at ``index`` (None: not in the grid), ``ranks`` the global ranks
    along it in axis order, ``group`` the process group over them (None
    with ``live``: the default group, which the axis spans)."""

    def __init__(self, name: str, size: int, index: Optional[int],
                 ranks: Optional[Sequence[int]] = None, group=None):
        self.name = name
        self.size = int(size)
        self.index = index
        self.ranks = list(ranks) if ranks is not None else None
        self.group = group

    @property
    def live(self) -> bool:
        """Whether collectives over this axis go through a process group
        (else each is the identity: one rank)."""
        return _initialized() and self.index is not None and (
            self.group is not None or self.size == _world())

    def global_rank(self, i: int) -> int:
        """The global rank at place ``i`` of this axis."""
        return self.ranks[i] if self.ranks is not None else int(i)

    def __repr__(self) -> str:
        return f"Axis({self.name}={self.size}, index={self.index})"


_env = threading.local()


def current_grid() -> Optional["Grid"]:
    """The innermost grid the calling thread entered, or None."""
    stack = getattr(_env, "stack", None)
    return stack[-1] if stack else None


def resolve_axis(axis) -> Axis:
    """An :class:`Axis` as given, or the axis of that name in the entered
    grid.  Outside every grid, or where the grid has no such axis, raises
    ``NameError`` (JAX: "unbound axis name")."""
    if isinstance(axis, Axis):
        return axis
    g = current_grid()
    if g is None or axis not in g.axes:
        where = "no mesh is entered" if g is None else \
            f"the entered mesh has axes {g.axis_names}"
        raise NameError(f"unbound axis name: {axis!r} ({where}; run the "
                        f"code inside `with mesh:` of a mesh with a "
                        f"{axis!r} axis)")
    return g.axes[axis]


class Grid:
    """Named axes over ranks (``make_grid``).  ``with grid:`` enters its
    axis environment; ``device`` is this rank's device."""

    def __init__(self, axes: Sequence[Axis], device=None):
        self.axes: Dict[str, Axis] = {a.name: a for a in axes}
        self.device = torch.device(device) if device is not None else None

    @property
    def axis_names(self):
        return tuple(self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {n: a.size for n, a in self.axes.items()}

    @property
    def size(self) -> int:
        return int(np.prod([a.size for a in self.axes.values()]))

    def index(self, name: str) -> Optional[int]:
        return self.axes[name].index

    @property
    def member(self) -> bool:
        """Whether this rank is in the grid."""
        return all(a.index is not None for a in self.axes.values())

    def __enter__(self) -> "Grid":
        stack = getattr(_env, "stack", None)
        if stack is None:
            stack = _env.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _env.stack.pop()

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={a.size}" for n, a in self.axes.items())
        return f"{type(self).__name__}({inner})"


def _build_axes(names: Sequence[str], sizes: Sequence[int]) -> List[Axis]:
    """The axes of a row-major grid of ``sizes`` over the first
    ``prod(sizes)`` ranks of the world.  Collective: every rank of the
    world calls it with the same arguments (``new_group``), and makes
    the groups in the same order; an axis of one rank, or one that spans
    the world, makes none."""
    sizes = [int(s) for s in sizes]
    n = int(np.prod(sizes))
    world, me = _world(), _rank()
    if n > world:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {n} ranks and "
            f"oversubscribes the {world} available device(s)")
    my = tuple(int(c) for c in np.unravel_index(me, sizes)) if me < n \
        else None
    axes = []
    for a, name in enumerate(names):
        size = sizes[a]
        index = None if my is None else my[a]
        mine = None if my is None else [
            int(np.ravel_multi_index(my[:a] + (j,) + my[a + 1:], sizes))
            for j in range(size)]
        group = None
        if _initialized() and 1 < size < world:
            others = [range(s) for i, s in enumerate(sizes) if i != a]
            for combo in itertools.product(*others):
                ranks = [int(np.ravel_multi_index(
                    combo[:a] + (j,) + combo[a:], sizes))
                    for j in range(size)]
                g = _dist().new_group(ranks)
                if mine is not None and ranks == mine:
                    group = g
        axes.append(Axis(name, size, index, mine, group))
    return axes


def make_grid(names: Sequence[str], sizes: Sequence[int], *,
              device=None) -> Grid:
    """A grid of named axes over the first ``prod(sizes)`` ranks of the
    default process group, laid out row-major (the last axis fastest),
    as ``Mesh(np.array(devices).reshape(sizes), names)`` is in the JAX
    package.  Every rank of the world calls it with the same arguments;
    ``device`` defaults to ``cuda:<current>`` where CUDA is up, else the
    CPU."""
    if len(names) != len(sizes):
        raise ValueError(f"{len(names)} axis names for {len(sizes)} sizes")
    device = _default_device(device)
    return Grid(_build_axes(names, sizes), device)


def _default_device(device):
    """``device``, or the current card; with no device given and no CUDA,
    an error (the caller asks for the CPU by name)."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Mesh(Grid):
    """A ``(data, model, seq)`` mesh over ranks.  ``dp``/``rank``/``group``
    are this rank's data axis: its size, this rank's place on it (None
    where the process is not in the mesh) and the process group its
    data-parallel collectives run on (None: the default group).
    ``Mesh(dp, rank, group, device)`` is a data-parallel mesh (model and
    seq of one rank); ``make_mesh`` builds the others."""

    def __init__(self, dp: int, rank: Optional[int], group=None,
                 device=None, *, axes: Optional[Sequence[Axis]] = None):
        if axes is None:
            ranks = None if rank is None else list(range(int(dp)))
            me = None if rank is None else [_rank()]
            axes = [Axis(DATA_AXIS, dp, rank, ranks, group),
                    Axis(MODEL_AXIS, 1, None if rank is None else 0, me),
                    Axis(SEQ_AXIS, 1, None if rank is None else 0, me)]
        super().__init__(axes, device)

    @property
    def dp(self) -> int:
        return self.axes[DATA_AXIS].size

    @property
    def tp(self) -> int:
        return self.axes[MODEL_AXIS].size

    @property
    def sp(self) -> int:
        return self.axes[SEQ_AXIS].size

    @property
    def rank(self) -> Optional[int]:
        return self.axes[DATA_AXIS].index

    @property
    def group(self):
        return self.axes[DATA_AXIS].group

    def __repr__(self) -> str:
        return f"Mesh(data={self.dp}, model={self.tp}, seq={self.sp}, " \
               f"rank={self.rank})"


def make_mesh(n_devices: Optional[int] = None, *, dp: Optional[int] = None,
              tp: int = 1, sp: int = 1, device=None) -> Mesh:
    """A ``(data, model, seq)`` mesh over the default process group (or
    this one process when none is initialized).  ``dp`` defaults to
    filling the ranks; an explicit mesh smaller than the world takes the
    first ``dp*tp*sp`` ranks (every rank of the world must call
    ``make_mesh`` with the same arguments, as
    ``torch.distributed.new_group`` requires).  ``device`` is this rank's
    device (default: ``cuda:<current>``; without CUDA it must be given,
    "cpu")."""
    tp, sp = int(tp), int(sp)
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
    if dp < 1 or tp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, tp={tp}, "
                         f"sp={sp}")
    device = _default_device(device)
    if tp == 1 and sp == 1:
        rank = _rank()
        group = None
        if world > 1 and dp < world:
            group = _dist().new_group(list(range(int(dp))))
        return Mesh(int(dp), rank if rank < dp else None, group, device)
    return Mesh(int(dp), None, device=device, axes=_build_axes(
        (DATA_AXIS, MODEL_AXIS, SEQ_AXIS), (dp, tp, sp)))


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
    ``dim`` is None), as a copy: a view (``contiguous()`` of a dim-0
    block is one) would keep the whole tensor's storage alive."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


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
