"""The gradient exchange of the port's data-parallel train step.

In the JAX package GSPMD inserts the gradient psum into the one SPMD
program of the global batch.  The port's step runs once per rank on the
rank's rows; ``nn/_common.backward_and_update`` hands the gradients
autograd made to a :class:`GradientExchange`, which sums them over the
ranks before the loss scale's finiteness check and before gradient
normalization, so both see the global gradient as in JAX, and a
non-finite gradient on one rank skips the step on every rank.

Three layouts share the one exchange, each by a per-leaf plan of sharded
dims (``mesh.zero3_spec``; None = replicated):

* ``ParallelWrapper``: every leaf replicated; the gradients are
  all-reduced (SUM), coalesced into one buffer per dtype;
* ``ParallelWrapper(shard_optimizer_state=True)`` (ZeRO-1): parameters
  replicated, updater slots sharded (threshold 0).  Each rank updates its
  block of each sharded leaf from its block of the slots, then the blocks
  are all-gathered into the replicated parameter;
* ``ShardedTrainer`` (ZeRO-3): parameters and their slots sharded.  The
  network's layer walk all-gathers a layer's sharded leaves just before
  its forward (``at_use``) and drops them after it: the ops that need a
  leaf in the backward save a token in its place
  (``saved_tensors_hooks``), and the backward gathers it again.  Each
  gathered leaf's gradient is reduce-scattered (SUM) to the rank's block
  as the backward reaches it, and the update runs block-locally on the
  stored shard.  So at most one layer's leaves are whole at a time, and
  the collectives and their sums are those of gathering every leaf for
  the whole step (a layer with l1/l2 gathers its leaves once more for
  that term, whose gradient is then reduce-scattered apart from the
  forward's).  Under ``cache_mode("remat")`` the checkpointed layer
  keeps its gathered leaves for its replay.

A fourth layout is tensor parallelism (``TensorParallelExchange``,
``ParallelWrapper(param_rule=...)``): the leaves a rule splits are held
as this rank's block over the mesh's ``model`` axis, and the gradients
are summed over the ``data`` axis only.

Norms (gradient normalization, the step's gradient statistics) of a
sharded leaf sum its blocks' squares over the ranks.  A leaf that no
plan shards takes the single-device expression unchanged, so at world
size 1 (every leaf replicated) the step computes plain ``fit``'s ops.
One rank with no process group initialized runs every collective as the
identity.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

import torch

from ..nn._common import (LocalNorms, apply_constraints_all, cast_floats,
                          hyperparam_conf)
from ..utils import global_batch
from . import collectives
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

Tree = Dict[str, Dict[str, torch.Tensor]]
Key = Tuple[str, str]

__all__ = ["GradientExchange", "TensorParallelExchange"]


def _dist():
    import torch.distributed as dist
    return dist


def _all_gather(block: torch.Tensor, dim: int, group, n: int
                ) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``group`` joined along ``dim``."""
    src = block.detach()
    if dim:
        src = src.movedim(dim, 0)
    src = src.contiguous()
    out = torch.empty((src.shape[0] * n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _dist().all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


class _GatherAtUse(torch.autograd.Function):
    """A sharded leaf gathered whole for one layer; the backward
    reduce-scatters its gradient (SUM) to this rank's block."""

    @staticmethod
    def forward(ctx, block, ex, dim):
        ctx.ex, ctx.dim = ex, dim
        return ex.gather_blocks(block, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.reduce_scatter_dim(g, ctx.dim), None, None


class _Regather:
    """What a saved whole leaf is packed into: its block, the sharded dim
    and the saved view's geometry."""

    __slots__ = ("block", "dim", "size", "stride", "offset")

    def __init__(self, block, dim, t):
        self.block, self.dim = block, dim
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class GradientExchange(LocalNorms):
    """The collectives of one wrapper's train step over ``mesh``.

    ``param_plan``/``opt_plan`` are ``{layer: {name: dim or None}}``
    (missing = replicated): the sharded dim of each parameter (ZeRO-3)
    and of its updater slots (ZeRO-1 or ZeRO-3)."""

    def __init__(self, mesh: Mesh, param_plan: Optional[Dict] = None,
                 opt_plan: Optional[Dict] = None):
        self.mesh = mesh
        self.group = mesh.group
        self.dp = int(mesh.dp)
        self.rank = int(mesh.rank or 0)
        self.param_plan = param_plan or {}
        self.opt_plan = opt_plan if opt_plan is not None else \
            self.param_plan
        # one rank and no process group over it: each collective is the
        # identity (a sum over one rank); with a group, the collectives
        # run even at dp 1
        self.solo = self.dp == 1 and not mesh.axes[DATA_AXIS].live
        self._storage: Optional[Tree] = None
        # leaves the current step treats as replicated whatever the plan
        # (the sparse table's row-space gradient)
        self.rowspace: Set[Key] = set()
        # sharded leaves the step computes with as the stored block (the
        # tensor-parallel pairs), not all-gathered first
        self.local: Set[Key] = set()
        # {layer: forward} the network's layer walk runs in place of
        # those layers' own (the tensor-parallel pairs)
        self.roles: Dict[str, Callable] = {}
        # the current step gathers its sharded leaves layer by layer
        # (``at_use``), so their gradients arrive as blocks
        self.per_layer = False
        self._skip: Set[Key] = set()

    # ------------------------------------------------- the sharded axis
    @property
    def shard_count(self) -> int:
        """How many blocks a sharded leaf is cut into."""
        return self.dp

    @property
    def shard_index(self) -> int:
        """Which block this rank holds."""
        return self.rank

    @property
    def block_replica(self) -> int:
        """Which of the ranks that hold this rank's blocks it is (0: the
        one that writes them to a sharded checkpoint)."""
        return 0

    @property
    def writer_count(self) -> int:
        """Ranks that write a sharded checkpoint of this layout."""
        return self.dp

    @property
    def writer_index(self) -> int:
        """This rank's place among them."""
        return self.rank

    def leaf_cuts(self, dim: int):
        """``[(dim, axis)]``: the cuts of a leaf this layout shards on
        ``dim``."""
        return [(dim, DATA_AXIS)]

    def block_of(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole tensor along ``dim``."""
        m = t.shape[dim] // self.shard_count
        return t.narrow(dim, self.shard_index * m, m)

    def gather_blocks(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of a sharded leaf joined along ``dim``."""
        return self.all_gather_dim(block, dim)

    def _shard_sum_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """An all-reduce over the ranks that hold different blocks."""
        return self.all_reduce_(t, op)

    # ---------------------------------------------------------- layout
    def pdim(self, layer: str, name: str) -> Optional[int]:
        if (layer, name) in self.rowspace:
            return None
        return self.param_plan.get(layer, {}).get(name)

    def odim(self, layer: str, name: str) -> Optional[int]:
        return self.opt_plan.get(layer, {}).get(name)

    @property
    def zero3(self) -> bool:
        return any(d is not None for g in self.param_plan.values()
                   for d in g.values())

    def batch(self, local_rows: int):
        """The global-batch context of one step (``utils/global_batch``)."""
        return global_batch.global_batch(self.group, self.dp, self.rank,
                                         local_rows,
                                         self.mesh.axes[DATA_AXIS])

    # ------------------------------------------------------ collectives
    def all_gather_dim(self, block: torch.Tensor, dim: int
                       ) -> torch.Tensor:
        """The ``dp`` ranks' blocks concatenated along ``dim``."""
        if self.solo:
            return block.detach().clone()
        return _all_gather(block, dim, self.group, self.dp)

    def reduce_scatter_dim(self, full: torch.Tensor, dim: int
                           ) -> torch.Tensor:
        """SUM over the ranks of ``full``, this rank's block along
        ``dim``."""
        if self.solo:
            return full.clone()
        dist = _dist()
        src = full.movedim(dim, 0).contiguous() if dim else \
            full.contiguous()
        out = torch.empty((src.shape[0] // self.dp,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous() if dim else out

    def all_reduce_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        if self.solo:
            return t
        dist = _dist()
        if op is None:
            dist.all_reduce(t, group=self.group)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Equal-shaped per-rank tensors stacked along dim 0."""
        return self.all_gather_dim(t, 0)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.solo:
            return t
        dist = _dist()
        if self.group is None:
            dist.broadcast(t, src=src)
        else:
            dist.broadcast(t, src=dist.get_global_rank(self.group, src),
                           group=self.group)
        return t

    # ------------------------------------------------------------ step
    #: whether a step may gather a layer's leaves at its use (``at_use``)
    #: instead of every leaf up front
    GATHERS_AT_USE = True

    def gather(self, storage: Tree, skip: Iterable[Key] = ()) -> Tree:
        """The parameters one step differentiates.  With ZeRO-3 leaves
        and ``GATHERS_AT_USE`` these are the stored blocks, and the layer
        walk gathers each layer's leaves at its use (``at_use``); else
        each sharded leaf is all-gathered here into a fresh leaf tensor
        (once per step).  Replicated leaves (and ``skip``) are the stored
        tensors themselves."""
        self._storage = storage
        self.per_layer = self.zero3 and self.GATHERS_AT_USE
        self._skip = set(skip)
        if not self.zero3 or self.per_layer:
            return storage
        skip = set(skip)
        out: Tree = {}
        for k, group in storage.items():
            out[k] = {}
            for n, p in group.items():
                d = self.param_plan.get(k, {}).get(n)
                if d is None or (k, n) in skip or (k, n) in self.local:
                    out[k][n] = p
                else:
                    out[k][n] = self.gather_blocks(p, d).requires_grad_(
                        p.requires_grad)
        return out

    @contextmanager
    def at_use(self, layer: str, lp: Dict[str, torch.Tensor],
               dtype: Optional[torch.dtype] = None):
        """A layer's params for its forward: each sharded leaf gathered
        whole (``_GatherAtUse``), the whole layer cast to ``dtype`` (a
        precision policy's compute dtype) after that.  While the block
        runs, an op that saves a view of a gathered leaf for its backward
        saves a ``_Regather`` token instead, which the backward gathers
        again; the whole leaves die with the caller's references after
        the block."""
        full, owners = {}, {}
        for n, p in lp.items():
            d = self.pdim(layer, n)
            if d is None or (layer, n) in self._skip or \
                    (layer, n) in self.local:
                full[n] = p
                continue
            t = _GatherAtUse.apply(p, self, d)
            owners[t.untyped_storage().data_ptr()] = (p, d)
            full[n] = t
        if dtype is not None:
            full = cast_floats(full, dtype)
        if not owners:
            yield full
            return

        def pack(t):
            own = owners.get(t.untyped_storage().data_ptr()) \
                if t.layout == torch.strided else None
            return t if own is None else _Regather(own[0], own[1], t)

        def unpack(s):
            if not isinstance(s, _Regather):
                return s
            whole = self.gather_blocks(s.block, s.dim)
            return whole.as_strided(s.size, s.stride, s.offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield full

    def reduce(self, grads: Tree) -> Tree:
        """The global gradient: replicated leaves all-reduced (SUM, one
        coalesced buffer per dtype), ZeRO-3 leaves reduce-scattered to
        this rank's block (in the backward already, where the step
        gathered them at use)."""
        rep = [(k, n, g) for k, group in grads.items()
               for n, g in group.items()
               if self.pdim(k, n) is None and g.is_floating_point()]
        out = self._sum_coalesced(grads, rep)
        if self.per_layer:
            return out
        for k, group in grads.items():
            for n, g in group.items():
                d = self.pdim(k, n)
                if d is not None:
                    out[k][n] = self.reduce_scatter_dim(g, d)
        return out

    def _sum_coalesced(self, grads: Tree, items) -> Tree:
        """``grads`` with the ``(layer, name, grad)`` items summed over
        the data axis, one buffer per dtype."""
        by_dtype: Dict[torch.dtype, list] = {}
        for k, n, g in items:
            by_dtype.setdefault(g.dtype, []).append((k, n, g))
        out: Tree = {k: dict(group) for k, group in grads.items()}
        for same in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for _, _, g in same])
            self.all_reduce_(flat)
            off = 0
            for k, n, g in same:
                out[k][n] = flat[off:off + g.numel()].view_as(g)
                off += g.numel()
        return out

    def total(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss: the ranks' shares summed."""
        return self.all_reduce_(loss.detach().clone())

    def all_finite(self, finite: torch.Tensor) -> torch.Tensor:
        """A gradient finite on every rank (sharded leaves are checked
        block by block)."""
        if not self.zero3:
            return finite
        flag = finite.to(torch.int32).reshape(1)
        self._shard_sum_(flag, op=_dist().ReduceOp.MIN)
        return flag[0].bool()

    def update(self, tx, params: Tree, grads: Tree, opt_state,
               confs) -> None:
        """``tx.step`` on this rank's layout (``targets``), the ZeRO-1
        blocks gathered back (``finish``), then the layers' constraints
        (``constrain``)."""
        targets, gs, post = self.targets(params, grads)
        tx.step(targets, gs, opt_state)
        self.finish(post)
        self.constrain(params, confs)

    def targets(self, params: Tree, grads: Tree
                ) -> Tuple[Tree, Tree, list]:
        """``(targets, grads, post)`` for the updater: a ZeRO-3 leaf's
        target is its stored block (its gradient is already the block); a
        ZeRO-1 leaf's target is its block of the replicated parameter (a
        view, updated in place) with its block of the gradient, and
        ``post`` lists the leaves to all-gather after the update."""
        targets: Tree = {}
        gs: Tree = {}
        post = []
        for k, group in params.items():
            targets[k], gs[k] = {}, {}
            for n, p in group.items():
                g = grads[k][n]
                if self.pdim(k, n) is not None:
                    targets[k][n], gs[k][n] = self._storage[k][n], g
                    continue
                od = self.odim(k, n)
                if od is not None and (k, n) not in self.rowspace:
                    view = self.block_of(p.detach(), od)
                    targets[k][n] = view
                    gs[k][n] = self.block_of(g, od)
                    post.append((p, od, view))
                    continue
                targets[k][n], gs[k][n] = p, g
        return targets, gs, post

    @torch.no_grad()
    def finish(self, post: list) -> None:
        """All-gather the ZeRO-1 blocks into the replicated parameters."""
        for p, od, view in post:
            p.detach().copy_(self.gather_blocks(view, od))

    @torch.no_grad()
    def constrain(self, params: Tree, confs) -> None:
        """The layers' constraints after the update, on the full
        parameters: a ZeRO-3 leaf of a constrained layer is gathered,
        constrained and written back as this rank's block."""
        full: Tree = {}
        back = []
        for k, group in params.items():
            hc = hyperparam_conf(confs.get(k))
            constrained = bool(getattr(hc, "constraints", None))
            full[k] = {}
            for n, p in group.items():
                d = self.pdim(k, n)
                if d is None or not constrained:
                    full[k][n] = p if d is None else self._storage[k][n]
                    continue
                t = self.gather_blocks(self._storage[k][n], d)
                full[k][n] = t
                back.append((k, n, d, t))
        apply_constraints_all(full, confs)
        for k, n, d, t in back:
            self._storage[k][n].copy_(self.block_of(t, d))

    # ------------------------------------------------------------ norms
    def _split(self, layer: str, group: Dict[str, torch.Tensor]):
        sharded = [g for n, g in group.items()
                   if self.pdim(layer, n) is not None
                   and g.is_floating_point()]
        return sharded

    def _sq_sharded(self, leaves) -> torch.Tensor:
        s = sum(torch.sum(g * g) for g in leaves).reshape(1).clone()
        return self._shard_sum_(s)[0]

    def group_norm(self, layer: str, group: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        sharded = self._split(layer, group)
        if not sharded:
            return super().group_norm(layer, group)
        rep = [g for n, g in group.items()
               if self.pdim(layer, n) is None and g.is_floating_point()]
        total = self._sq_sharded(sharded)
        if rep:
            total = total + sum(torch.sum(g * g) for g in rep)
        return torch.sqrt(total)

    def leaf_norm(self, layer: str, name: str, g: torch.Tensor
                  ) -> torch.Tensor:
        if self.pdim(layer, name) is None:
            return super().leaf_norm(layer, name, g)
        return torch.sqrt(self._sq_sharded([g]))

    def global_norm(self, grads: Tree) -> torch.Tensor:
        if not self.zero3:
            return super().global_norm(grads)
        sharded = [g for k, group in grads.items()
                   for g in self._split(k, group)]
        rep = [g for k, group in grads.items() for n, g in group.items()
               if self.pdim(k, n) is None and g.is_floating_point()]
        total = self._sq_sharded(sharded) if sharded else \
            torch.zeros((), dtype=torch.float32)
        if rep:
            total = total + sum(torch.sum(g * g) for g in rep)
        return torch.sqrt(total)


class TensorParallelExchange(GradientExchange):
    """The collectives of a tensor-parallel wrapper's step over a ``(data,
    model)`` mesh.  ``param_plan`` is ``{layer: {name: dim}}`` of the
    leaves the rule splits over the ``model`` axis (each rank holds its
    block of them, and of their updater slots); ``local`` the split
    leaves the step computes with as the block (the Megatron pairs); every
    other split leaf is all-gathered over ``model`` for the step, as
    XLA's inserted collective would, and its gradient cut back to the
    block.  Gradients and the loss are summed over ``data`` only: the
    ranks of one model group share their rows and compute the same loss."""

    # the split leaves that are not paired are gathered for the whole
    # step: their gradients are summed over ``data`` with the rest before
    # each rank keeps its block
    GATHERS_AT_USE = False

    def __init__(self, mesh: Mesh, param_plan: Dict, local=()):
        super().__init__(mesh, param_plan, param_plan)
        self.model_axis = mesh.axes[MODEL_AXIS]
        self.local = set(local)
        self.roles = _pair_roles(self)

    @property
    def shard_count(self) -> int:
        return self.model_axis.size

    @property
    def shard_index(self) -> int:
        return int(self.model_axis.index or 0)

    @property
    def block_replica(self) -> int:
        return self.rank

    @property
    def writer_count(self) -> int:
        return self.dp * self.mesh.tp * self.mesh.sp

    @property
    def writer_index(self) -> int:
        seq = self.mesh.axes["seq"]
        return (self.rank * self.mesh.tp + self.shard_index) \
            * self.mesh.sp + int(seq.index or 0)

    def leaf_cuts(self, dim: int):
        return [(dim, MODEL_AXIS)]

    def gather_blocks(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        ax = self.model_axis
        if not ax.live:
            return block.detach().clone()
        return _all_gather(block, dim, ax.group, ax.size)

    def _shard_sum_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        ax = self.model_axis
        if ax.live:
            if op is None:
                _dist().all_reduce(t, group=ax.group)
            else:
                _dist().all_reduce(t, op=op, group=ax.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src`` of the data axis's value over the data axis, then
        the model axis's first rank's over the model axis: every rank of
        the mesh ends equal to its first."""
        super().broadcast_(t, src)
        ax = self.model_axis
        if ax.live:
            _dist().broadcast(t, src=ax.global_rank(0), group=ax.group)
        return t

    def reduce(self, grads: Tree) -> Tree:
        """Every gradient summed over the data axis (one buffer per
        dtype); a leaf the step gathered takes this rank's block."""
        items = [(k, n, g) for k, group in grads.items()
                 for n, g in group.items() if g.is_floating_point()]
        out = self._sum_coalesced(grads, items)
        for k, group in self.param_plan.items():
            for n, d in group.items():
                if d is not None and (k, n) not in self.local and \
                        n in out.get(k, {}):
                    out[k][n] = self.block_of(out[k][n], d).contiguous()
        return out


def _pair_roles(ex: TensorParallelExchange) -> Dict[str, Callable]:
    """``{layer: forward}`` of the pairs' layers in the step, each
    ``forward(lc, params, state, x, train=, key=, mask=)``: the column
    layer computes its output columns from an input whose cotangent is
    summed over ``model``; the row layer sums its partial products over
    ``model`` before its bias and activation."""
    ax = ex.model_axis
    cols = {k for k, n in ex.local if n == "W"
            and ex.param_plan[k]["W"] == 1}
    rows = {k for k, n in ex.local if n == "W"
            and ex.param_plan[k]["W"] == 0}

    def column(lc, params, state, x, *, train=False, key=None, mask=None):
        return lc.apply(params, collectives.copy_to(x, ax), train=train,
                        key=key), state

    def row(lc, params, state, x, *, train=False, key=None, mask=None):
        z = collectives.reduce_from(x @ params["W"], ax)
        if lc.has_bias:
            z = z + params["b"]
        return lc.act_fn(z), state

    out = {k: column for k in cols}
    out.update({k: row for k in rows})
    return out
