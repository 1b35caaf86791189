"""Sparse embedding gradients: the densified row exchange (port of
``nn/sparse.py``).

An embedding gradient is a handful of rows of a ``[vocab, dim]`` table.
With ``sparse_grad=True`` on a network's first layer (an
``EmbeddingLayer`` or ``EmbeddingSequenceLayer``) the train step works
in row space, as the JAX package's does:

1. **coalesce outside the gradient**: :func:`coalesce` gives the sorted
   unique touched row ids at a static capacity (fill slots hold
   ``vocab``) and the position-to-slot map;
2. **differentiate row space**: the step gathers ``rows = W[uniq]`` and
   differentiates them in the table's place: the forward reads them
   with a zero trash row after them (the slot of invalid ids) and the
   ids become their slots, so the table's gradient is the ``[capacity,
   dim]`` block's; :func:`embedding_lookup`'s backward is
   one deterministic segment sum (positions sorted stably by slot, each
   slot's rows summed in position order);
3. the gradient is the touched rows' indices (``RowContext.uniq``) and
   coalesced values, :class:`SparseRows` as one object (``to_dense``);
4. **lazy row-space updater**: the updater runs on the touched rows of
   the table and of its slots (Adam mu/nu, momentum traces), which are
   scattered back; untouched rows of the table and of its slots stay
   bit-identical (exact for stateless updaters such as SGD; stateful
   ones skip the decay of untouched rows, the lazy-Adam trade).

In a data-parallel step (``parallel/exchange``) the touched set is the
global batch's: the ids are all-gathered, every rank coalesces the same
``uniq``, and the row block's gradient is all-reduced.  Under ZeRO-3 the
table and its slots are sharded by ``zero3_spec`` (rows when the vocab
divides): the touched rows are gathered from their owners by one
``[capacity, dim]`` all-reduce, and each rank updates and writes back
the touched rows it owns.

Capacity contract: ``capacity=None`` is the exact bound ``min(n_ids,
vocab)``; a configured ``sparse_grad_capacity`` below it is refused
(:func:`effective_capacity`): silent truncation of gradient rows is the
one behaviour this path must never have.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["SparseRows", "coalesce", "slot_map", "effective_capacity",
           "embedding_lookup", "RowContext", "gather_rows_tree",
           "scatter_rows_tree", "table_is_unambiguous",
           "sparse_embedding_conf"]

TABLE = ("layer_0", "W")


@dataclass
class SparseRows:
    """Densified-sparse gradient of a ``[n_rows, dim]`` table:
    ``indices`` ``[capacity]`` sorted unique touched row ids (fill slots
    hold ``n_rows``), ``values`` ``[capacity, dim]`` their coalesced
    gradients."""

    indices: torch.Tensor
    values: torch.Tensor
    n_rows: int

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[-1])

    def touched(self) -> torch.Tensor:
        """Count of real (non-fill) row slots."""
        return torch.sum(self.indices < self.n_rows, dtype=torch.int32)

    def to_dense(self) -> torch.Tensor:
        """The dense ``[n_rows, dim]`` gradient (tests and interop only;
        the train step never builds it)."""
        dense = torch.zeros((self.n_rows, self.dim), dtype=self.values.dtype,
                            device=self.values.device)
        keep = self.indices < self.n_rows
        return dense.index_put_((self.indices[keep],), self.values[keep],
                                accumulate=True)


def effective_capacity(n_ids: int, n_rows: int,
                       configured: Optional[int] = None) -> int:
    """Static row capacity of one step's exchange block: the exact bound
    ``min(n_ids, n_rows)``, or a configured capacity that may only pad up
    to it (an undersized one is refused: it would truncate rows)."""
    exact = min(int(n_ids), int(n_rows))
    if configured is None:
        return exact
    configured = int(configured)
    if configured < exact:
        raise ValueError(
            f"sparse_grad_capacity={configured} is below the exact "
            f"touched-row bound min(n_ids={n_ids}, vocab={n_rows}) = "
            f"{exact}: an overflowing capacity would silently truncate "
            "gradient rows — raise the capacity (or leave it None for "
            "the exact bound)")
    return min(configured, int(n_rows))


def _masked_flat(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Flat int64 ids with every invalid id (negative or >= n_rows)
    collapsed onto the fill value ``n_rows``."""
    flat = ids.reshape(-1).to(torch.int64)
    fill = torch.full_like(flat, int(n_rows))
    return torch.where((flat >= 0) & (flat < n_rows), flat, fill)


def slot_map(uniq: torch.Tensor, ids: torch.Tensor, n_rows: int
             ) -> torch.Tensor:
    """``ids``-shaped slot map into ``uniq``: ``uniq[inv] == id`` where
    the id made it into ``uniq``, ``capacity`` (the trash slot)
    otherwise."""
    capacity = int(uniq.shape[0])
    flat = _masked_flat(ids, n_rows)
    slot = torch.searchsorted(uniq, flat)
    slot_c = torch.clamp(slot, 0, capacity - 1)
    inv = torch.where(uniq[slot_c] == flat, slot_c,
                      torch.full_like(slot_c, capacity))
    return inv.reshape(ids.shape)


def coalesce(ids: torch.Tensor, capacity: int, n_rows: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uniq, inv)`` of an id tensor: ``uniq`` ``[capacity]`` sorted
    unique ids, fill slots = ``n_rows``; ``inv`` the ``ids``-shaped slot
    map (``slot_map``).  Invalid ids collapse onto the fill value first,
    so they read the clamp row forward and shed their gradient at a
    dropped fill slot: never a misattributed row."""
    capacity = int(capacity)
    flat = _masked_flat(ids, n_rows)
    s, _ = torch.sort(flat)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = first & (pos < capacity)
    uniq = torch.full((capacity,), int(n_rows), dtype=torch.int64,
                      device=ids.device)
    uniq[pos[keep]] = s[keep]
    return uniq, slot_map(uniq, ids, n_rows)


class _Lookup(torch.autograd.Function):
    """``table[idx]`` whose backward is one deterministic segment sum."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        dim = ct.shape[-1]
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sidx = flat[order]
        vals = ct.reshape(-1, dim)[order]
        segs, counts = torch.unique_consecutive(sidx, return_counts=True)
        sums = torch.segment_reduce(vals, "sum", lengths=counts, axis=0)
        grad = torch.zeros((ctx.n_rows, dim), dtype=ct.dtype,
                           device=ct.device)
        grad[segs] = sums.to(ct.dtype)
        return grad, None


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Gather ``table[idx]`` whose backward is one coalesced segment sum
    (the densified accumulation).  In the sparse train step ``table`` is
    the substituted row block, so its gradient is the row block's."""
    return _Lookup.apply(table, idx.to(torch.int64))


def table_is_unambiguous(params, table_shape) -> bool:
    """True when exactly one param leaf has the table's shape (the JAX
    package finds the table's slots by shape; the port keeps the rule so
    both refuse the same networks)."""
    n = sum(1 for g in params.values() for p in g.values()
            if tuple(p.shape) == tuple(table_shape))
    return n == 1


def gather_rows_tree(tree: Dict[str, torch.Tensor], index: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Row-space view of one leaf's updater slots: each floating slot
    gathered at ``index``."""
    return {k: t[index] if t.is_floating_point() else t
            for k, t in tree.items()}


@torch.no_grad()
def scatter_rows_tree(old: Dict[str, torch.Tensor],
                      new: Dict[str, torch.Tensor], index: torch.Tensor
                      ) -> None:
    """Inverse of :func:`gather_rows_tree` after the row-space update:
    the touched rows of each slot written back in place (untouched rows
    keep their bytes)."""
    for k, t in old.items():
        if t.is_floating_point():
            t[index] = new[k].to(t.dtype)


def sparse_embedding_conf(conf):
    """The stack's sparse-gradient embedding layer, or None.  Only the
    first layer is eligible (its ids are the batch input); anything else
    is a configuration error, raised when the train step is built."""
    from .layers.feedforward import EmbeddingLayer, EmbeddingSequenceLayer
    found = None
    for i, lc in enumerate(conf.layers):
        if not getattr(lc, "sparse_grad", False):
            continue
        if i != 0:
            raise ValueError(
                f"layer '{lc.name}': sparse_grad=True requires the "
                "embedding to be the first layer (its ids must be the "
                "batch input for the densified pre-pass); position "
                f"{i} gets dense gradients — drop the flag there")
        if not isinstance(lc, (EmbeddingLayer, EmbeddingSequenceLayer)):
            raise ValueError(
                f"layer '{lc.name}': sparse_grad is an embedding-layer "
                "contract")
        if float(lc.resolved("l1", 0.0) or 0.0) or \
                float(lc.resolved("l2", 0.0) or 0.0):
            raise ValueError(
                f"layer '{lc.name}': sparse_grad=True with l1/l2 on the "
                "table is unsupported — dense weight decay touches every "
                "row, defeating the touched-rows-only exchange; drop the "
                "regularization or the flag")
        found = lc
    return found


class RowContext:
    """One step's touched-row workspace.

    ``table`` is the stored table: the whole ``[n_rows, dim]`` table, or
    this rank's block of it under ZeRO-3 (``pdim``, the sharded dim).
    ``exchange`` (None on one device) supplies the ranks: the ids are
    all-gathered so every rank coalesces the global batch's touched set.
    ``odim`` is the sharded dim of the table's updater slots (ZeRO-1 or
    ZeRO-3)."""

    def __init__(self, table: torch.Tensor, ids: torch.Tensor,
                 configured_capacity: Optional[int], exchange=None,
                 pdim: Optional[int] = None, odim: Optional[int] = None):
        self.exchange = exchange
        self.table = table
        self.pdim, self.odim = pdim, odim
        dp = 1 if exchange is None else exchange.dp
        rank = 0 if exchange is None else exchange.rank
        self.dp, self.rank = dp, rank
        shape = list(table.shape)
        if pdim is not None:
            shape[pdim] *= dp
        n_rows, dim = int(shape[0]), int(shape[1])
        self.n_rows, self.dim = n_rows, dim
        all_ids = ids if exchange is None else \
            exchange.all_gather_rows(ids.reshape(1, -1))
        n_ids = int(np.prod(tuple(all_ids.shape), dtype=np.int64))
        cap = effective_capacity(n_ids, n_rows, configured_capacity)
        self.capacity = cap
        self.uniq, _ = coalesce(all_ids, cap, n_rows)
        self.inv = slot_map(self.uniq, ids, n_rows)
        self.valid = self.uniq < n_rows
        self.safe = torch.clamp(self.uniq, 0, n_rows - 1)
        with torch.no_grad():
            rows = self._gather_rows()
        # the differentiated leaf: the touched rows, whose gradient is
        # the SparseRows values; the forward reads them with one zero
        # trash row after them (slot ``capacity``), whose gradient the
        # concatenation drops
        self.rows = rows.requires_grad_(True)
        self.rows_ext = torch.cat(
            [self.rows, torch.zeros((1, dim), dtype=rows.dtype,
                                    device=rows.device)])
        self.x_sub = self.inv

    # --------------------------------------------------------- ownership
    def _owned(self, dim: Optional[int], index: torch.Tensor,
               among: torch.Tensor):
        """``(sel, local, cols)`` of the slots among ``among`` whose rows
        (dim 0) or columns (dim 1) this rank holds under a layout sharded
        on ``dim``: ``local`` indexes the rank's block."""
        if dim is None:
            return among, index[among], slice(None)
        if dim == 0:
            r = self.n_rows // self.dp
            lo = self.rank * r
            sel = among & (index >= lo) & (index < lo + r)
            return sel, index[sel] - lo, slice(None)
        c = self.dim // self.dp
        return among, index[among], slice(self.rank * c, (self.rank + 1) * c)

    def _gather_rows(self) -> torch.Tensor:
        if self.pdim is None:
            return self.table[self.safe]
        # each slot's row from its owner: one [capacity, dim] all-reduce
        every = torch.ones_like(self.valid)
        sel, local, cols = self._owned(self.pdim, self.safe, every)
        block = torch.zeros((self.capacity, self.dim), dtype=self.table.dtype,
                            device=self.table.device)
        idx = torch.nonzero(sel).reshape(-1)
        if isinstance(cols, slice) and cols == slice(None):
            block[idx] = self.table[local]
        else:
            block[idx, cols] = self.table[local]
        return self.exchange.all_reduce_(block)

    def touched(self) -> torch.Tensor:
        return torch.sum(self.valid, dtype=torch.int32)

    def updater(self, tx) -> "_RowSpaceUpdater":
        """``tx`` with the table in row space, for the step's update."""
        return _RowSpaceUpdater(self, tx)

    # ------------------------------------------------------------ update
    @torch.no_grad()
    def update(self, tx, targets: Dict[str, Dict[str, torch.Tensor]],
               grads: Dict[str, Dict[str, torch.Tensor]],
               opt_state: Dict[str, Any]) -> None:
        """One updater step on ``targets`` (every leaf as the caller laid
        it out; the table's entry is the row block) with the table in row
        space: the touched rows this rank owns of the table and its
        slots, updated together with every other parameter (one step
        count), then written back."""
        lk, pn = TABLE
        targets = {k: dict(g) for k, g in targets.items()}
        gs = {k: dict(g) for k, g in grads.items()}
        od = self.odim if self.pdim is None else self.pdim
        sel, local, cols = self._owned(od, self.uniq, self.valid)
        g_rows = grads[lk][pn][sel][:, cols]
        if self.pdim is not None:
            p_rows = self.table[local]
        else:
            p_rows = self.table[self.uniq[sel]][:, cols]
        slot_full = opt_state["slots"][lk][pn]
        slot_rows = gather_rows_tree(slot_full, local)
        targets[lk][pn] = p_rows
        gs[lk][pn] = g_rows
        slots = dict(opt_state["slots"])
        slots[lk] = dict(slots[lk])
        slots[lk][pn] = slot_rows
        tx.step(targets, gs, {**opt_state, "slots": slots})
        scatter_rows_tree(slot_full, slot_rows, local)
        if self.pdim is not None:
            self.table[local] = p_rows
        elif od is None:
            self.table[self.uniq[sel]] = p_rows
        else:
            # ZeRO-1: the replicated table takes every rank's rows back
            block = torch.zeros((self.capacity, self.dim),
                                dtype=self.table.dtype,
                                device=self.table.device)
            idx = torch.nonzero(sel).reshape(-1)
            block[idx, cols] = p_rows
            self.exchange.all_reduce_(block)
            vidx = torch.nonzero(self.valid).reshape(-1)
            self.table[self.uniq[vidx]] = block[vidx]


class _RowSpaceUpdater:
    """The updater of a sparse-embedding step: ``step(params, grads,
    opt_state)`` as the updater groups', through ``RowContext.update``."""

    def __init__(self, ctx: RowContext, tx):
        self.ctx, self.tx = ctx, tx

    def step(self, params, grads, opt_state) -> None:
        self.ctx.update(self.tx, params, grads, opt_state)
