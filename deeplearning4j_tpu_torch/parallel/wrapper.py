"""ParallelWrapper: data-parallel training of a network over a mesh of
ranks (port of ``parallel/wrapper.py``).

The JAX wrapper runs ONE jitted SPMD program over the global batch and
GSPMD inserts the gradient psum.  The port runs one process per rank
(``torch.distributed``: NCCL between cards, gloo on the CPU); every rank
takes the same global batches, trims them as the JAX wrapper does
(``_trim``), keeps its own rows, and runs the network's own train step
with a :class:`~.exchange.GradientExchange`: global loss denominators,
global batch statistics and global dropout masks in the forward
(``utils/global_batch``), the gradients summed over the ranks right
after autograd.  Replicas therefore stay equal to one another and to the
JAX package's single program (the reference's ``averagingFrequency=1``
with exact sync).

``shard_optimizer_state=True`` is ZeRO-1: the updater slots are sharded
by ``zero3_spec`` with threshold 0 (``place_opt_state``); each rank
updates its block of each sharded leaf and the blocks are all-gathered
into the replicated parameters, with the same numbers.

Tensor parallelism (``param_rule``, absent in the reference): the rule
gives each parameter leaf a :class:`~.mesh.P` over the mesh's ``model``
axis (``megatron_dense_rule``: even dense layers split their columns,
odd ones their rows).  Each split leaf, and its updater slots, is stored
as this rank's block (``TensorParallelExchange``).  In the step, a
column-split ``DenseLayer`` followed by a row-split one (a Megatron
pair) computes with its blocks: the column layer its own output
columns, from an input whose cotangent is summed over ``model``
(``collectives.copy_to``), the row layer its partial products, summed
over ``model`` by one all-reduce (``collectives.reduce_from``) before
its bias and activation (the exchange's ``roles``, which the network's
layer walk runs in place of those layers' forward).  Every other split
leaf (the LM's embedding and output layers, a dense layer without a
partner) is all-gathered for the step and its gradient cut back to the
block, as XLA's inserted collective would.  The result equals the data-parallel run's.
``output``, ``score``, ``evaluate`` and ``clone`` gather the leaves
first (``gathered``).  ``shard_optimizer_state=True`` with a rule is
refused, as in the JAX package: the rule already shards the updater
state.  A mixture-of-experts layer (``AUX_LOSS``) routes the global
batch, as in the JAX package's step: the exchange's global-batch context
carries the data axis, over which each layer exchanges its ranks'
per-expert counts (``parallel/expert``); the experts stay replicated on
the data axis.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import torch

from ..observability.clock import monotonic_s
from ..observability.registry import default_registry
from ..observability.tracer import get_tracer
from .exchange import GradientExchange, TensorParallelExchange
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, P, make_mesh, shard_of,
                   shard_params)

__all__ = ["ParallelWrapper", "place_opt_state", "megatron_dense_rule"]


def _param_specs(params, rule: Optional[Callable[[str, str, Any], P]]):
    """A ``P`` per parameter leaf: ``rule(layer, name, leaf)``, or
    replicated without a rule."""
    if rule is None:
        return {lname: {pname: P() for pname in lp}
                for lname, lp in params.items()}
    return {lname: {pname: rule(lname, pname, leaf)
                    for pname, leaf in lp.items()}
            for lname, lp in params.items()}


def megatron_dense_rule(params) -> Callable[[str, str, Any], P]:
    """Alternate column/row parallel sharding for stacked dense layers:
    even layers split n_out over 'model', odd layers split n_in —
    activations stay sharded between the pair and one all-reduce per pair
    sums them."""
    def _pos(name):
        tail = name.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else None

    order = sorted((n for n in params.keys() if _pos(n) is not None),
                   key=_pos)
    idx = {n: i for i, n in enumerate(order)}  # non-layer_N names replicate

    def rule(lname, pname, leaf):
        if pname == "W" and getattr(leaf, "ndim", 0) == 2:
            col = idx.get(lname, 0) % 2 == 0
            return P(None, MODEL_AXIS) if col else P(MODEL_AXIS, None)
        if pname == "b" and idx.get(lname, 0) % 2 == 0 and \
                getattr(leaf, "ndim", 0) == 1:
            return P(MODEL_AXIS)
        return P()

    return rule


def place_opt_state(opt_state: Dict[str, Any], plan: Dict[str, Any],
                    dp: int, rank: int) -> Dict[str, Any]:
    """The port's updater state (``{"count", "slots"}``) with every slot
    of a sharded leaf (``plan[layer][name]`` a dim) cut to this rank's
    block of ``dp``; counts stay host ints."""
    slots = {k: {n: {s: shard_of(t, plan.get(k, {}).get(n), dp, rank)
                     for s, t in sl.items()}
                 for n, sl in g.items()}
             for k, g in opt_state["slots"].items()}
    return {"count": opt_state["count"], "slots": slots}


class ParallelWrapper:
    """Train a network over a mesh; a drop-in for the network's ``fit``."""

    def __init__(self, model, mesh: Optional[Mesh] = None, *,
                 param_rule: Optional[Callable] = None,
                 shard_optimizer_state: bool = False):
        if shard_optimizer_state and param_rule is not None:
            raise ValueError(
                "shard_optimizer_state=True is only supported with "
                "replicated params (param_rule=None): a TP param_rule "
                "already shards the optimizer state with the params")
        if not model.params:
            model.init()
        self.model = model
        self.mesh = mesh if mesh is not None else \
            make_mesh(device=model.device)
        self.param_rule = param_rule
        self.shard_optimizer_state = bool(shard_optimizer_state)
        self._place()

    # ------------------------------------------------------------ layout
    def _plans(self):
        """``(param plan, updater plan)`` for this mesh."""
        if not self.shard_optimizer_state:
            return {}, {}
        return {}, shard_params(self.mesh, _param_shapes(self.model),
                                min_size=0)

    def _exchange(self) -> GradientExchange:
        """The step's collectives for this layout."""
        if self.param_rule is None:
            return GradientExchange(self.mesh, *self._plans())
        plan = _model_plan(self.model, self.param_rule)
        return TensorParallelExchange(
            self.mesh, plan, _megatron_pairs(self.model, plan))

    def _place(self) -> None:
        """Lay the network's state out on the mesh: gather any earlier
        sharded layout back, make every rank equal to rank 0 (params,
        layer state, updater state, key), then shard what this layout
        shards and install the exchange in the network's train step."""
        m = self.model
        if m.opt_state is None:
            m._init_updater()
        _unshard(m)
        ex = self._exchange()
        if self.mesh.size > 1:
            with torch.no_grad():
                for t in _state_tensors(m):
                    ex.broadcast_(t)
        _reshard(m, (ex, ex.param_plan, ex.opt_plan))
        m._exchange = ex
        m._step = None
        self.exchange = ex

    def remesh(self, mesh: Mesh) -> "ParallelWrapper":
        """Re-target the wrapper onto another mesh and lay the state out
        again under it (the elastic shrink/grow path)."""
        _unshard(self.model)
        self.mesh = mesh
        self._place()
        return self

    def retarget(self, mesh: Mesh) -> "ParallelWrapper":
        """Point the wrapper at ``mesh`` WITHOUT gathering the live layout
        (no collective on the old mesh: a lost rank's blocks are gone with
        it).  The caller restores a checkpoint next; the restore lays the
        state out on ``mesh`` (``ElasticTrainer.restore_latest``)."""
        self.model._shard_layout = None
        self.model._exchange = None
        self.model._step = None
        self.mesh = mesh
        return self

    # ------------------------------------------- model duck-typing
    @property
    def params(self):
        return self.model.params

    def init(self):
        self.release()
        self.model.init()
        self._place()
        return self

    def release(self):
        """The network back on its own: every sharded leaf gathered, the
        exchange removed from its train step."""
        _unshard(self.model)
        self.model._exchange = None
        self.model._step = None
        return self.model

    def get_score(self) -> float:
        return self.model.get_score()

    def score(self, *a, **kw) -> float:
        if not a and not kw:
            return self.model.score()
        with self.gathered() as m:
            return m.score(*a, **kw)

    def _normalize_batch(self, b):
        return self.model._normalize_batch(b)

    def clone(self):
        """Snapshot of the UNDERLYING model (savers keep plain models)."""
        with self.gathered() as m:
            out = m.clone()
        out._exchange = None
        out._step = None
        out._shard_layout = None
        return out

    def evaluate(self, *a, **kw):
        with self.gathered() as m:
            return m.evaluate(*a, **kw)

    # ----------------------------------------------- full-tensor views
    def _leaves_sharded(self) -> bool:
        return any(d is not None for g in self.exchange.param_plan.values()
                   for d in g.values())

    @contextmanager
    def gathered(self):
        """The network with every leaf whole for the enclosed block
        (forward-only uses: output, score, evaluation, a clone), then
        sharded again: each rank cuts its block out of the whole tensors
        it gathered, with no broadcast (the ranks already agree; only a
        re-layout, ``init`` or ``remesh``, goes through ``_place``)."""
        m = self.model
        layout = m._shard_layout
        if not self._leaves_sharded():
            yield m
            return
        _unshard(m)
        try:
            yield m
        finally:
            if layout is not None:
                _reshard(m, layout)

    def full_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every parameter whole, as new tensors (one all-gather per
        sharded leaf)."""
        ex = self.exchange
        out = {}
        for k, g in self.model.params.items():
            out[k] = {}
            for n, p in g.items():
                d = ex.param_plan.get(k, {}).get(n)
                out[k][n] = p.detach().clone() if d is None else \
                    ex.gather_blocks(p.detach(), d)
        return out

    def per_device_param_bytes(self) -> int:
        """Bytes of parameters one rank holds under this layout."""
        return int(sum(p.numel() * p.element_size()
                       for g in self.model.params.values()
                       for p in g.values()))

    def output(self, *a, **kw):
        with self.gathered() as m:
            return m.output(*a, **kw)

    def _data_axis_size(self) -> int:
        return int(self.mesh.shape.get(DATA_AXIS, 1))

    def _trim(self, batch):
        """Drop the remainder rows of a partial batch so the leading dim
        splits evenly over the data axis (standard DP practice; the
        reference round-robins whole batches to workers instead)."""
        d = self._data_axis_size()
        x = batch[0][0] if isinstance(batch[0], (list, tuple)) else batch[0]
        n = int(x.shape[0])
        keep = (n // d) * d
        if keep == n:
            return batch
        if keep == 0:
            return None   # batch smaller than the data axis: skip it

        def cut(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return [None if e is None else e[:keep] for e in a]
            return a[:keep]

        return tuple(cut(p_) for p_ in batch)

    def _rows(self, a):
        """This rank's rows of one (trimmed) batch leaf."""
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [self._rows(e) for e in a]
        k = int(a.shape[0]) // self.mesh.dp
        r = int(self.mesh.rank or 0)
        return a[r * k:(r + 1) * k]

    def _step_batch(self, batch) -> Optional[int]:
        """One train step on one global batch; returns its (trimmed)
        global row count, or None when the batch was smaller than the
        data axis."""
        m = self.model
        trimmed = self._trim(m._normalize_batch(batch))
        if trimmed is None:
            return None
        x = trimmed[0]
        xb = x[0] if isinstance(x, (list, tuple)) else x
        n = int(getattr(xb, "shape", (0,))[0])
        m._fit_one(*(self._rows(a) for a in trimmed))
        m.last_batch_size = n
        return n

    def fit_batch(self, batch) -> float:
        """One data-parallel train step on one batch, no epoch bookkeeping
        (the EarlyStoppingTrainer inner-loop contract)."""
        self._step_batch(batch)
        return float(self.model._score)

    # ------------------------------------------------------------- fit
    def fit(self, data=None, labels=None, *, epochs: int = 1,
            mask=None, label_mask=None):
        """Same contract as the network's ``fit``: ``(x, y)`` arrays or an
        iterable of batches, optional masks, several epochs.  Every rank
        passes the same global batches."""
        m = self.model
        if labels is not None:
            batches_factory = lambda: [(data, labels, mask, label_mask)]
        elif hasattr(data, "reset") or hasattr(data, "__iter__"):
            src = data
            if not hasattr(src, "reset") and epochs > 1 and iter(src) is src:
                src = [m._normalize_batch(b) for b in src]

            def batches_factory():
                if hasattr(src, "reset"):
                    src.reset()
                for b in src:
                    yield m._normalize_batch(b)
        else:
            raise ValueError("fit() needs (x, y) or an iterator")
        reg = default_registry()
        obs = reg.enabled
        if obs:
            steps_c = reg.counter("training_steps_total",
                                  "Optimizer steps taken")
            examples_c = reg.counter("training_examples_total",
                                     "Training examples consumed")
        n_examples = 0
        t_fit = monotonic_s()
        with get_tracer().span("wrapper.fit", epochs=epochs,
                               devices=self.mesh.dp):
            for _ in range(epochs):
                for lst in m.listeners:
                    lst.on_epoch_start(m)
                for raw in batches_factory():
                    n = self._step_batch(raw)
                    if n is None:
                        continue
                    if obs:
                        steps_c.inc()
                        examples_c.inc(n)
                    n_examples += n
                for lst in m.listeners:
                    lst.on_epoch_end(m)
                m.epoch += 1
            # one final sync: "fit returned" means "training finished"
            m._score = float(m._score)
        if obs and n_examples:
            dt = max(monotonic_s() - t_fit, 1e-9)
            reg.gauge("training_examples_per_sec",
                      "Training examples/sec over the last fit() "
                      "(compile excluded where the path can tell)"
                      ).set(n_examples / dt)
        return self

    def average_params(self):
        """No-op: the exchange keeps replicas exact (the reference's
        ``averageModelsParams`` exists because its replicas drift)."""
        return self.model.params


def _param_shapes(m) -> Dict[str, Dict[str, tuple]]:
    """``{layer: {name: global shape}}`` of a network's parameters."""
    return {k: {n: sh for n, (sh, _) in g.items()}
            for k, g in m.param_spec().items()}


def _state_tensors(m):
    """Every tensor a rank must hold equal to rank 0's."""
    out = [p.detach() for g in m.params.values() for p in g.values()]
    out += [t for g in m.state.values() for t in g.values()
            if isinstance(t, torch.Tensor)]
    if m.opt_state is not None:
        out += [t for g in m.opt_state["slots"].values()
                for sl in g.values() for t in sl.values()]
    out.append(m._rng)
    return out


@torch.no_grad()
def _reshard(m, layout) -> None:
    """Lay a network whose leaves are whole out under ``layout``
    (``(exchange, param plan, updater plan)``): each rank keeps its own
    block of each sharded leaf, cut locally (no collective)."""
    ex, p_plan, o_plan = layout
    for k, g in p_plan.items():
        for n, d in g.items():
            if d is not None:
                p = m.params[k][n]
                m.params[k][n] = torch.nn.Parameter(
                    shard_of(p.detach(), d, ex.shard_count, ex.shard_index),
                    requires_grad=p.requires_grad)
    m.opt_state = place_opt_state(m.opt_state, o_plan, ex.shard_count,
                                  ex.shard_index)
    m._shard_layout = layout


@torch.no_grad()
def _unshard(m) -> None:
    """Gather a network's sharded leaves (ZeRO-3 params, ZeRO-1/3 slots)
    back into full tensors on every rank."""
    layout = getattr(m, "_shard_layout", None)
    if layout is None:
        return
    ex, p_plan, o_plan = layout
    for k, g in p_plan.items():
        for n, d in g.items():
            if d is not None:
                p = m.params[k][n]
                m.params[k][n] = torch.nn.Parameter(
                    ex.gather_blocks(p.detach(), d),
                    requires_grad=p.requires_grad)
    if m.opt_state is not None:
        for k, g in o_plan.items():
            for n, d in g.items():
                if d is not None:
                    sl = m.opt_state["slots"][k][n]
                    for s in list(sl):
                        sl[s] = ex.gather_blocks(sl[s], d)
    m._shard_layout = None


def _model_plan(m, rule) -> Dict[str, Dict[str, Optional[int]]]:
    """``{layer: {name: dim}}`` of the leaves ``rule`` splits over the
    ``model`` axis (``_param_specs``).  A leaf split over another axis,
    or over two, is refused: the port's tensor parallelism lays leaves
    out over ``model`` only."""
    params = {k: dict(g.items()) for k, g in m.params.items()}
    plan: Dict[str, Dict[str, Optional[int]]] = {}
    for k, g in _param_specs(params, rule).items():
        for n, spec in g.items():
            cuts = P(*spec).sharded()
            if not cuts:
                continue
            if len(cuts) > 1 or cuts[0][1] != MODEL_AXIS:
                raise NotImplementedError(
                    f"param_rule lays {k}/{n} out as {spec!r}: the port's "
                    f"tensor parallelism splits a leaf over the "
                    f"'{MODEL_AXIS}' axis only")
            plan.setdefault(k, {})[n] = cuts[0][0]
    return plan


def _pair_ok(lc) -> bool:
    """A plain dense layer whose step the pair runs on blocks: no input
    dropout, weight noise or l1/l2 (each reads the whole leaf or the
    whole activation)."""
    from ..nn.layers.base import draws
    from ..nn.layers.feedforward import DenseLayer
    if type(lc) is not DenseLayer or draws(lc):
        return False
    return not any(float(lc.resolved(a, 0.0) or 0.0)
                   for a in ("l1", "l2", "l1_bias", "l2_bias"))


def _megatron_pairs(m, plan) -> set:
    """The leaves the Megatron pairs compute with as blocks: a dense
    layer whose ``W`` splits its columns (and its ``b`` with them, or
    no bias) followed by a dense layer whose ``W`` splits its rows and
    whose bias is replicated, with no preprocessor between them."""
    layers = getattr(m.conf, "layers", None)
    if layers is None:      # a graph: every split leaf is gathered
        return set()
    local = set()
    for i in range(len(layers) - 1):
        col, row = f"layer_{i}", f"layer_{i + 1}"
        a, b = layers[i], layers[i + 1]
        pa, pb = plan.get(col, {}), plan.get(row, {})
        if (col, "W") in local or not (_pair_ok(a) and _pair_ok(b)):
            continue
        if pa.get("W") != 1 or pb.get("W") != 0 or pb.get("b") is not None:
            continue
        if a.has_bias and pa.get("b") != 0:
            continue
        if m.conf.preprocessor(i + 1) is not None:
            continue
        local |= {(col, "W"), (row, "W")}
        if a.has_bias:
            local.add((col, "b"))
    return local
