"""Machinery shared by the network types (port of ``nn/_common.py``):
the updater groups (``build_tx``), gradient normalization, constraints,
the precision casts (``cast_act``, ``cast_floats``, ``precision_cast_map``),
the backward-and-update half of a train step (with the loss scale's
unscale, check and skip, and the data-parallel gradient exchange's
hook), the device-resident epoch
trainer behind ``fit_on_device``, the fit loop's step forensics
(``_StepForensics``), and ``Network``, the base of ``MultiLayerNetwork``
and ``ComputationGraph`` (parameter and state storage, init, loading, the
dropout key stream, the fit loop with its listener hooks, metrics, step
profiler and checkpoints, ``clone`` and evaluation).

The fit loop is observed as the JAX package's is: ``training_*`` metrics
in the default registry, a per-fit ``StepProfiler`` with a sampled
device fence, the flight recorder's ``train`` channel and, where one is
installed, the health monitor.  The step's loss stays a device scalar
unless a health monitor is armed (its NaN reaction is same-step).
``fit(checkpoint=..., resume_from=...)`` saves crash-consistent
checkpoints and resumes at the saved batch cursor
(``faulttolerance/checkpoint.py``).

Gradients and parameters are ``{layer_i: {name: tensor}}`` dicts, as the
JAX package's pytrees.  ``build_tx`` returns an ``UpdaterGroups`` in
place of an optax transform: one ``UpdaterConf`` per label (the network
default, a layer's own updater, a layer's bias updater, or ``None`` for a
frozen group), a label per parameter, and a step count per label.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..observability.clock import monotonic_s, wall_s
from ..observability.registry import default_registry
from ..utils import _random
from ..utils.device import resolve_device
from . import precision as _precision
from .conf.updaters import Sgd, UpdaterConf
from .layers.base import BaseLayerConf, LayerConf, flatten_group

Tree = Dict[str, Dict[str, torch.Tensor]]

log = logging.getLogger("deeplearning4j_tpu_torch.nn")

# training-step histogram bounds: sub-ms CPU steps up to multi-second
# first steps (kernel builds) in the "compile" phase series
_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# time blocked on the data pipeline per batch (the JAX package's
# data/pipeline.ETL_BUCKETS)
_ETL_BUCKETS = _STEP_BUCKETS


def hyperparam_conf(lc: Optional[LayerConf]) -> Optional[BaseLayerConf]:
    """The conf that carries hyperparams (updater/constraints/
    normalization): wrappers (Bidirectional, LastTimeStep) delegate to the
    layer they wrap."""
    while lc is not None and not isinstance(lc, BaseLayerConf):
        lc = getattr(lc, "underlying", None) or getattr(lc, "fwd", None)
    return lc


def float_grad_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """Floating gradient leaves of a ``{name: tensor}`` group or a
    ``{layer: {name: tensor}}`` tree, in insertion order."""
    out = []
    for v in tree.values():
        if isinstance(v, dict):
            out += float_grad_leaves(v)
        elif v is not None and v.is_floating_point():
            out.append(v)
    return out


def _map_float(fn, group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: fn(g) if g.is_floating_point() else g
            for k, g in group.items()}


def _l2(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves))


class LocalNorms:
    """The norms of one step's gradients, on one device: a layer's L2
    norm, a leaf's, and the global one.  The data-parallel exchange
    (``parallel/exchange.GradientExchange``) overrides them for leaves
    sharded over the ranks."""

    def group_norm(self, layer: str, group: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        return _l2(float_grad_leaves(group))

    def leaf_norm(self, layer: str, name: str, g: torch.Tensor
                  ) -> torch.Tensor:
        return torch.linalg.norm(g.reshape(-1))

    def global_norm(self, grads: Tree) -> torch.Tensor:
        gleaves = float_grad_leaves(grads)
        return torch.sqrt(sum(torch.sum(g * g) for g in gleaves)) \
            if gleaves else torch.zeros((), dtype=torch.float32)


_LOCAL = LocalNorms()


def apply_gradient_normalization(mode: Optional[str], threshold: float,
                                 grads: Dict[str, torch.Tensor],
                                 layer: str = "",
                                 norms: LocalNorms = _LOCAL
                                 ) -> Dict[str, torch.Tensor]:
    """One layer's gradients under the reference's ``preApply`` modes."""
    if not mode or mode == "none":
        return grads
    mode = mode.lower()
    if mode == "renormalizel2perlayer":
        norm = norms.group_norm(layer, grads)
        return _map_float(lambda g: g / (norm + 1e-8), grads)
    if mode == "renormalizel2perparamtype":
        return {n: g / (norms.leaf_norm(layer, n, g) + 1e-8)
                if g.is_floating_point() else g for n, g in grads.items()}
    if mode == "clipelementwiseabsolutevalue":
        return _map_float(lambda g: torch.clamp(g, -threshold, threshold),
                          grads)
    if mode == "clipl2perlayer":
        scale = torch.clamp(threshold / (norms.group_norm(layer, grads)
                                         + 1e-8), max=1.0)
        return _map_float(lambda g: g * scale, grads)
    if mode == "clipl2perparamtype":
        def clip(n, g):
            nrm = norms.leaf_norm(layer, n, g)
            return g * torch.clamp(threshold / (nrm + 1e-8), max=1.0)
        return {n: clip(n, g) if g.is_floating_point() else g
                for n, g in grads.items()}
    raise ValueError(f"unknown gradient normalization '{mode}'")


def is_frozen(lc: Optional[LayerConf]) -> bool:
    return bool(getattr(lc, "FROZEN", False))


class UpdaterGroups:
    """The port's counterpart of the optax transform ``build_tx`` makes:
    ``transforms[label]`` (``None`` = frozen: no update, no state) and
    ``labels[layer][name]``."""

    def __init__(self, transforms: Dict[str, Optional[UpdaterConf]],
                 labels: Dict[str, Dict[str, str]]):
        self.transforms = transforms
        self.labels = labels

    def init(self, params: Tree) -> Dict[str, Any]:
        """``{"count": {label: 0}, "slots": {layer: {name: {slot:
        tensor}}}}``, zero slots shaped like each parameter."""
        slots = {}
        for layer, group in params.items():
            slots[layer] = {}
            for name, p in group.items():
                u = self.transforms[self.labels[layer][name]]
                slots[layer][name] = u.init_slots(p) if u is not None else {}
        return {"count": {lab: 0 for lab, u in self.transforms.items()
                          if u is not None},
                "slots": slots}

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree, state: Dict[str, Any]) -> None:
        """Apply one update to ``params`` in place (``p += u``, as
        ``optax.apply_updates``) and advance ``state``."""
        count = state["count"]
        for layer, group in params.items():
            for name, p in group.items():
                u_conf = self.transforms[self.labels[layer][name]]
                if u_conf is None:
                    continue
                u = u_conf.update(grads[layer][name],
                                  state["slots"][layer][name],
                                  count[self.labels[layer][name]], p)
                p.add_(u.to(p.dtype))
        for lab in count:
            count[lab] += 1


def build_tx(default_u: UpdaterConf, confs: Dict[str, Optional[LayerConf]],
             params: Tree) -> UpdaterGroups:
    """Label every parameter: the network default, a layer's own updater
    (``{layer}/w``), its bias updater for bias-like params (``{layer}/b``),
    or ``frozen``."""
    resolved = {name: hyperparam_conf(lc) for name, lc in confs.items()}
    frozen = {name for name, lc in confs.items() if is_frozen(lc)}
    transforms: Dict[str, Optional[UpdaterConf]] = {"default": default_u}
    if frozen:
        transforms["frozen"] = None
    labels = {}
    for name, pgroup in params.items():
        lc = resolved.get(name)
        if name in frozen:
            labels[name] = {p: "frozen" for p in pgroup}
            continue
        if lc is None or (lc.updater is None and lc.bias_updater is None):
            labels[name] = {p: "default" for p in pgroup}
            continue
        wl = f"{name}/w"
        transforms[wl] = lc.updater or default_u
        lab = {}
        for pname in pgroup:
            if lc.bias_updater is not None and pname in lc._BIAS_PARAMS:
                transforms[f"{name}/b"] = lc.bias_updater
                lab[pname] = f"{name}/b"
            else:
                lab[pname] = wl
        labels[name] = lab
    return UpdaterGroups(transforms, labels)


def apply_gradient_norm_all(grads: Tree,
                            confs: Dict[str, Optional[LayerConf]],
                            gn_mode: Optional[str], gn_thr: float,
                            norms: LocalNorms = _LOCAL) -> Tree:
    """Per-layer ``preApply``; a layer's own setting replaces the
    network's."""
    for name, lc in confs.items():
        hc = hyperparam_conf(lc)
        own = getattr(hc, "gradient_normalization", None)
        m = own or gn_mode
        if m and grads.get(name):
            t = getattr(hc, "gradient_normalization_threshold", None)
            t = float(t) if t is not None and own else gn_thr
            grads[name] = apply_gradient_normalization(m, t, grads[name],
                                                       name, norms)
    return grads


def cast_act(h, dtype: Optional[str]):
    """A floating activation cast to a policy dtype name; integer token
    ids (and None) pass through untouched (JAX ``_cast_act``)."""
    if dtype is None or not isinstance(h, torch.Tensor) or \
            not h.is_floating_point():
        return h
    want = _precision.torch_dtype(dtype)
    return h if h.dtype == want else h.to(want)


def cast_floats(group: Mapping[str, torch.Tensor], dtype: torch.dtype,
                only: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Floating leaves of a ``{name: tensor}`` group (nested groups
    too) cast to ``dtype`` (JAX ``_cast_floats``): the f32 ones, or with
    ``only`` the ones of that dtype.  The casts are differentiable, so a
    cast master's gradient lands on the f32 master."""
    src = torch.float32 if only is None else only

    def cast(a):
        if isinstance(a, dict):
            return cast_floats(a, dtype, only)
        if isinstance(a, torch.Tensor) and a.dtype == src:
            return a.to(dtype)
        return a
    return {k: cast(v) for k, v in group.items()}


def precision_cast_map(pol, confs: Mapping[str, Any]
                       ) -> Dict[str, torch.dtype]:
    """``{layer key: compute dtype}`` for the layers a policy runs below
    f32 (keep_f32 classes and f32 overrides are absent: their params are
    never cast)."""
    out = {}
    if pol is not None:
        for name, lc in confs.items():
            dt = pol.layer_dtype(lc)
            if dt not in (None, "float32"):
                out[name] = _precision.torch_dtype(dt)
    return out


def cast_params(params: Mapping[str, Mapping[str, torch.Tensor]],
                cast_map: Mapping[str, torch.dtype]) -> Dict[str, Any]:
    """The param tree with each layer of ``cast_map`` cast to its compute
    dtype, inside the autograd graph."""
    if not cast_map:
        return params
    return {k: (cast_floats(v, cast_map[k]) if k in cast_map else v)
            for k, v in params.items()}


@torch.no_grad()
def apply_constraints_all(params: Tree,
                          confs: Dict[str, Optional[LayerConf]]) -> None:
    """The layers' constraints after an update, in place (reference
    ``applyConstraints``; JAX ``apply_constraints_all``): each constraint
    of a layer, in order, on its weights (``apply_to_weights``) and its
    bias-like params (``apply_to_biases``)."""
    for name, lc in confs.items():
        hc = hyperparam_conf(lc)
        cs = getattr(hc, "constraints", None)
        if not cs or not params.get(name):
            continue
        for c in cs:
            for pname, p in params[name].items():
                is_bias = pname in hc._BIAS_PARAMS
                if (c.apply_to_biases if is_bias else c.apply_to_weights):
                    p.copy_(c.apply(p))


def carry_thread_context(fn: Callable) -> Callable:
    """``fn`` run in the calling thread's step contexts: the global batch
    of a data-parallel step (``utils/global_batch``) and the entered mesh
    (the axis environment ring and Ulysses attention resolve their axis
    in).  ``torch.utils.checkpoint`` replays a layer's forward in the
    backward, which runs on autograd's device thread on CUDA, where those
    thread-local contexts are not set."""
    from contextlib import nullcontext

    from ..parallel import mesh
    from ..utils import global_batch
    gb = global_batch.snapshot()
    grid = mesh.current_grid()

    def run(*args, **kwargs):
        with global_batch.reentered(gb), \
                (grid if grid is not None else nullcontext()):
            return fn(*args, **kwargs)
    return run


def backward_and_update(loss: torch.Tensor, params: Tree, opt_state,
                        tx: "UpdaterGroups",
                        confs: Dict[str, Optional[LayerConf]],
                        gn_mode: Optional[str], gn_thr: float,
                        scale: Optional[torch.Tensor] = None,
                        exchange=None
                        ) -> Tuple[Dict[str, Any], bool]:
    """The second half of the SGD-path train step: gradients of ``loss``
    by autograd, gradient normalization, then the updaters, in place on
    ``params`` and ``opt_state``.  Returns the gradient statistics
    (global and per-layer L2 norms, device scalars) and whether the
    update ran.

    With a loss ``scale`` (``loss`` is then the scaled objective) the
    gradients are unscaled and checked first (``unscale_and_check``); if
    any is not finite the step is skipped wholesale: no normalization, no
    update, no step count, no constraint.  That check is the step's one
    host read.

    ``tx`` is anything with ``step(params, grads, opt_state)``: the
    updater groups, or the sparse-embedding step's row-space updater
    (``nn/sparse.RowContext.updater``).  ``exchange`` (a
    ``parallel/exchange.GradientExchange``) sums the gradients over the
    data-parallel ranks right after autograd, so the finiteness check and
    the normalization see the global gradient, and runs the update and
    the constraints on the ranks' layout; None is the single-device
    step."""
    keys = [(k, n) for k, group in params.items() for n in group]
    leaves = [params[k][n] for k, n in keys]
    flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads: Tree = {k: {} for k in params}
    for (k, n), g, p in zip(keys, flat, leaves):
        # a param the loss does not reach has gradient 0, as in JAX
        grads[k][n] = torch.zeros_like(p) if g is None else g
    norms = _LOCAL if exchange is None else exchange
    finite = None
    with torch.no_grad():
        if exchange is not None:
            grads = exchange.reduce(grads)
        if scale is not None:
            grads, finite = _precision.unscale_and_check(grads, scale)
            if exchange is not None:
                finite = exchange.all_finite(finite)
        grads = apply_gradient_norm_all(grads, confs, gn_mode, gn_thr, norms)
        gnorm = norms.global_norm(grads)
        glayer = {k: norms.group_norm(k, v) for k, v in grads.items() if v}
    gstats = {"global_norm": gnorm, "layer_norms": glayer}
    if finite is not None:
        gstats["finite"] = finite
        if not bool(finite):
            return gstats, False
    if exchange is None:
        tx.step(params, grads, opt_state)
        apply_constraints_all(params, confs)
    else:
        exchange.update(tx, params, grads, opt_state, confs)
    return gstats, True


def finish_precision_step(pol, state: Tree, new_state: Tree,
                          gstats: Dict[str, Any], updated: bool) -> Tree:
    """The layer state a policy step leaves behind (JAX
    ``overflow_skip`` and the f32 pin of ``_build_train_step``): state
    leaves the compute dtype made are cast back to f32; a skipped step
    keeps the pre-step layer state; the loss-scale state moves on
    (``next_scale_state``) and ``gstats`` gains ``loss_scale`` (the scale
    this step used) and ``overflow`` (int32 0/1).  State leaves leave the
    step detached from its graph (a mixture-of-experts layer's aux term
    is computed inside it)."""
    new_state = {k: {n: t.detach() if isinstance(t, torch.Tensor) else t
                     for n, t in v.items()} if isinstance(v, dict) else v
                 for k, v in new_state.items()}
    if pol is None:
        return new_state
    key = _precision.SCALE_STATE_KEY
    ls = state.get(key)
    if ls is not None and not updated:
        new_state = dict(state)
    new_state = {k: (v if k == key else cast_floats(
        v, torch.float32, only=_precision.torch_dtype(pol.compute_dtype)))
        for k, v in new_state.items()}
    if ls is not None:
        finite = gstats.pop("finite")
        new_state[key] = _precision.next_scale_state(pol, ls, finite)
        gstats["loss_scale"] = ls["scale"]
        gstats["overflow"] = torch.where(
            finite, 0, 1).to(torch.int32)
    return new_state


def batch_factory(data, one, normalize: Callable) -> Callable:
    """``factory() -> batches`` for one epoch of ``fit``: ``[one]`` when
    the caller passed labels, else ``data`` read as one batch (a 2- or
    4-tuple, or a ``DataSet``-like object with ``features``) or as an
    iterable of batches with an optional ``reset()`` (the DataSetIterator
    role).  ``normalize`` turns one batch into the network's 4-tuple."""
    if one is not None:
        return lambda: [one]
    if hasattr(data, "features") or \
            (isinstance(data, tuple) and len(data) in (2, 4)):
        return lambda: [normalize(data)]
    if hasattr(data, "reset") or hasattr(data, "__iter__"):
        if not hasattr(data, "reset") and iter(data) is data:
            # a bare generator cannot be iterated again per epoch
            batches = [normalize(b) for b in data]
            return lambda: batches

        def factory():
            if hasattr(data, "reset"):
                data.reset()
            for b in data:
                yield normalize(b)
        return factory
    raise ValueError("fit() needs (x, y) or an iterator")


class _StepForensics:
    """Per-step flight-recorder + health-monitor feed for the fit loops
    (JAX ``nn/multilayer._StepForensics``), amortized: :meth:`step` only
    captures a raw tuple (and, every ``grad_check_every``-th step, a
    *reference* to the still-on-device gradient stats) and :meth:`flush`
    drains the buffer through the recorder and ``observe_step()`` every
    ``FLUSH_EVERY`` steps.

    The loss is materialized per step (``float`` = host sync) only when a
    health MONITOR is armed: its NaN/stop/checkpoint reaction is
    same-step, and a non-finite loss still flushes immediately.
    Recorder-only forensics buffer the device scalar and read it at
    flush time, when it has long been computed.  Every dump path flushes
    first: the fit loop flushes on exception and in its ``finally``, and
    the checkpointer's preemption dump calls the ``pre_dump`` hook this
    helper installs."""

    FLUSH_EVERY = 16
    __slots__ = ("net", "rec", "ring", "mon", "ckpt", "_buf",
                 "_grad_every", "_wall0", "_saved_kinds")

    def __init__(self, net, rec, mon, ckpt):
        self.net = net
        self.rec = rec if (rec is not None and rec.enabled) else None
        self.ring = self.rec.channel("train") \
            if self.rec is not None else None
        self.mon = mon
        self.ckpt = ckpt
        self._grad_every = mon.config.grad_check_every \
            if mon is not None else 0
        # wall = mono + _wall0: record timestamps derive from the step
        # end the loop already clocked, saving a wall read per step
        self._wall0 = wall_s() - monotonic_s()
        self._buf: list = []
        self._saved_kinds: set = set()
        if ckpt is not None:
            ckpt.pre_dump = self.flush

    def step(self, ep: int, seq: int, compile_step: bool,
             dt: float, t_end: float) -> bool:
        """Capture one fitted step (``t_end`` = the loop's monotonic
        step-end read); returns True when the monitor's opt-in
        ``stop_training`` policy says to halt the fit."""
        net = self.net
        loss = net._score
        mon = self.mon
        if mon is not None:
            # the monitor's same-step NaN reaction needs the value now
            loss = float(loss)
        every = self._grad_every
        buf = self._buf
        buf.append(
            (t_end, net.iteration, ep, seq, net.last_batch_size,
             loss, dt, compile_step,
             net._last_grad_stats
             if every > 0 and net.iteration % every == 0 else None))
        # loss - loss is 0.0 for a finite loss, NaN for nan/±inf
        if len(buf) >= self.FLUSH_EVERY or \
                (mon is not None and loss - loss != 0.0):
            return self.flush()
        return False

    def flush(self) -> bool:
        """Drain buffered steps into the recorder ring and the monitor;
        returns the monitor's stop verdict."""
        buf = self._buf
        mon = self.mon
        if not buf:
            return mon.should_stop() if mon is not None else False
        self._buf = []
        ckpt, ring = self.ckpt, self.ring
        wall0 = self._wall0
        for t_end, it, ep, seq, bs, loss, dt, comp, gref in buf:
            # recorder-only steps buffered the device scalar: one D2H
            # each at drain time (the value computed steps ago)
            loss = float(loss)
            if ring is not None:
                ring.append({"ts": wall0 + t_end, "type": "step",
                             "iteration": it, "epoch": ep, "score": loss,
                             "batch": bs, "step_s": round(dt, 6),
                             "compile": comp})
            if mon is None:
                continue
            grad_norm = None
            if gref is not None:
                grad_norm = float(gref["global_norm"])
            eps = bs / dt if dt > 0 and not comp else None
            detections = mon.observe_step(
                loss=loss, grad_norm=grad_norm, examples_per_sec=eps,
                step=it)
            if detections and ckpt is not None and \
                    mon.config.checkpoint_on_detection and \
                    ckpt.manager is not None and \
                    any(d.kind not in self._saved_kinds
                        for d in detections):
                self._saved_kinds.update(d.kind for d in detections)
                # ONE immediate save per detection kind marks the
                # incident step durably; a failed emergency save must not
                # kill the fit
                try:
                    ckpt._save(ep, seq)
                    mon.checkpoint_saves += 1
                except Exception:
                    log.warning("emergency checkpoint at step %d failed",
                                it, exc_info=True)
        if self.rec is not None:
            self.rec.snapshot_metrics()   # internally time-throttled
        return mon.should_stop() if mon is not None else False


def fit_on_device_epochs(model: "Network", xs: List[torch.Tensor],
                         ys: List[torch.Tensor], batch_size: int,
                         epochs: int, shuffle: bool,
                         fit_tail: Callable, ckpt=None) -> "Network":
    """The device-resident epoch trainer behind both containers'
    ``fit_on_device`` (JAX ``fit_on_device_epochs``).  ``xs``/``ys`` are
    lists of tensors on the model's device; each step gathers its
    minibatch there by index.  ``model._device_step(bx, by, key)`` runs
    one train step with an explicit key; ``fit_tail(xt, yt)`` trains a
    ragged tail through the per-batch path.

    The key plumbing is the JAX package's, so the permutations and the
    dropout keys are its own:

    * fused (more than one epoch, no ragged tail, no listeners): one
      ``_rng, k = split(_rng)``, then per epoch ``k, pk, ek = split(k,
      3)``: ``pk`` draws the permutation, ``ek`` starts the step chain;
    * per epoch (otherwise): ``_rng, key, pk = split(_rng, 3)`` per
      epoch; listeners fire once per epoch, plus once for the tail's
      step.

    In a step chain each step takes ``k, step_key = split(k)``.  The
    epochs' permutations stay in ``model.last_permutations``.

    ``ckpt`` (a ``faulttolerance`` ``FitCheckpointer``) adds epoch-boundary
    checkpoints and resume: it pins the per-epoch path (the fused chain
    has no epoch boundary to save at), and a resumed run trains only the
    epochs its checkpoint's cursor has not done."""
    try:
        return _fit_on_device_epochs(model, xs, ys, batch_size, epochs,
                                     shuffle, fit_tail, ckpt)
    finally:
        if ckpt is not None:
            ckpt.close()


def _fit_on_device_epochs(model, xs, ys, batch_size, epochs, shuffle,
                          fit_tail, ckpt) -> "Network":
    n = int(xs[0].shape[0])
    if any(int(a.shape[0]) != n for a in list(xs) + list(ys)):
        raise ValueError(
            f"all inputs/labels need the same leading dimension; got "
            f"{[int(a.shape[0]) for a in list(xs) + list(ys)]}")
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset ({n})")
    used = nb * batch_size
    dev = xs[0].device

    def perm_of(pk):
        return _random.permutation(pk, n) if shuffle else \
            torch.arange(n, device=dev)

    def run_steps(key, perm):
        loss = None
        for s in range(nb):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            key, sk = _random.split(key)
            loss = model._device_step([a[idx] for a in xs],
                                      [a[idx] for a in ys], sk)
        return loss

    model.last_permutations = []
    fuse = epochs > 1 and used == n and not model.listeners \
        and (ckpt is None or ckpt.manager is None)
    epoch0 = ckpt.start_epoch if ckpt is not None else 0
    if epoch0:
        # resumed run: the restored cursor says this many epochs already
        # landed in the checkpoint — run only the remainder
        epochs = max(epochs - epoch0, 0)
        fuse = False
    if fuse:
        model._rng, k = _random.split(model._rng)
        for _ in range(epochs):
            k, pk, ek = _random.split(k, 3)
            perm = perm_of(pk)
            model.last_permutations.append(perm)
            model._score = run_steps(ek, perm)
        model.iteration += nb * epochs
        model.last_batch_size = batch_size
        # as the JAX package's fused program, no gradient stats survive
        model._last_grad_stats = None
        model.epoch += epochs
    else:
        for ep in range(epochs):
            for lst in model.listeners:
                lst.on_epoch_start(model)
            model._rng, key, pk = _random.split(model._rng, 3)
            perm = perm_of(pk)
            model.last_permutations.append(perm)
            model._score = run_steps(key, perm)
            model.iteration += nb
            model.last_batch_size = batch_size
            for lst in model.listeners:
                lst.iteration_done(model, model.iteration, model.epoch)
            if used < n:
                tail = perm[used:]
                fit_tail([a[tail] for a in xs], [a[tail] for a in ys])
            for lst in model.listeners:
                lst.on_epoch_end(model)
            model.epoch += 1
            if ckpt is not None and ckpt.after_epoch(epoch0 + ep):
                break   # SIGTERM: final save taken — return cleanly
    model._score = float(model._score)
    return model


class Network(nn.Module):
    """Parameters, state and updater state of a network, and what the
    two containers do alike with them.

    ``params`` is an ``nn.ModuleDict`` of one ``nn.ParameterDict`` per
    layer (or vertex), keyed and named as the JAX package's param tree,
    so a JAX checkpoint maps onto it one to one; ``state`` is a plain
    ``{key: {name: tensor}}`` dict (BatchNorm running stats), replaced by
    each training step.  A layer whose JAX group nests sub-groups
    (``Bidirectional``) holds them flat (``fwd/W``): ``_tensors`` flattens
    a JAX tree on the way in.  A subclass lists its layers in ``_layers``
    and runs one step in ``_fit_one`` (``_fit_step`` in ``fit``'s loop)."""

    def __init__(self, conf, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        conf.resolve()
        self.conf = conf
        self.params = nn.ModuleDict()
        self.state: Tree = {}
        self.opt_state: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self.last_batch_size = 0
        self._score: Any = float("nan")
        self._last_grad_stats: Optional[Dict[str, Any]] = None
        self._tx = None
        self._step = None
        # the data-parallel wrapper's GradientExchange (None: one device)
        # and, while a wrapper shards leaves, (exchange, param plan,
        # updater plan)
        self._exchange = None
        self._shard_layout = None
        self.listeners: List[Any] = []
        self.last_permutations: List[torch.Tensor] = []
        # the running fit's StepProfiler (None outside fit)
        self._stepprof = None
        # False until the first step after the train step was built: that
        # step builds the kernels and warms the allocator ("compile")
        self._warm_step = False
        # the dropout key stream: jax.random.PRNGKey(seed), as the
        # reference's ``_rng``, on the network's device
        self._rng = _random.prng_key(conf.seed, self.device)

    def _next_key(self) -> torch.Tensor:
        """``self._rng, key = split(self._rng)``: the key of one training
        step (or one ``train=True`` forward)."""
        new_rng, key = _random.split(self._rng)
        self._rng = new_rng
        return key

    def _layers(self) -> List[Tuple[str, Any, Any]]:
        """``(key, conf, input types)`` of every layer, in order; ``conf``
        has ``init(generator, itypes, device)`` and
        ``init_state(itypes, device)``."""
        raise NotImplementedError

    def _hyper_confs(self) -> Dict[str, Optional[LayerConf]]:
        """``{key: layer conf}`` for the updater labels, gradient
        normalization and constraints."""
        raise NotImplementedError

    def _set_params(self, groups: Mapping[str, Dict[str, torch.Tensor]]):
        self.params = nn.ModuleDict({
            key: nn.ParameterDict({
                name: nn.Parameter(t, requires_grad=t.is_floating_point())
                for name, t in group.items()})
            for key, group in groups.items()})

    def _param_tree(self) -> Tree:
        return {k: dict(g.items()) for k, g in self.params.items()}

    def init(self) -> "Network":
        """Fresh parameters from a ``torch.Generator`` seeded with the
        configuration's seed (torch's numbers, not JAX's), fresh state
        and fresh updater state."""
        gen = torch.Generator().manual_seed(self.conf.seed)
        self._set_params({key: c.init(gen, it, self.device)
                          for key, c, it in self._layers()})
        self.state = {key: c.init_state(it, self.device)
                      for key, c, it in self._layers()}
        self._init_scale_state()
        self._init_updater()
        return self

    def _init_scale_state(self) -> None:
        """The loss-scale state in ``state[SCALE_STATE_KEY]`` where the
        configuration's precision policy scales the loss."""
        ls = _precision.init_scale_state(
            _precision.resolve(self.conf.defaults), self.device)
        if ls is not None:
            self.state[_precision.SCALE_STATE_KEY] = ls

    def _default_updater(self) -> UpdaterConf:
        u = self.conf.defaults.get("updater")
        return u if u is not None else Sgd(learning_rate=0.1)

    def _init_updater(self) -> None:
        self._tx = build_tx(self._default_updater(), self._hyper_confs(),
                            self._param_tree())
        self.opt_state = self._tx.init(self._param_tree())
        self._step = None
        self._warm_step = False

    def _spec(self, what: str) -> Dict[str, Dict[str, Tuple[tuple,
                                                           torch.dtype]]]:
        gen, meta = torch.Generator(), torch.device("meta")
        out = {}
        for key, c, it in self._layers():
            made = c.init(gen, it, meta) if what == "params" \
                else c.init_state(it, meta)
            out[key] = {n: (tuple(t.shape), t.dtype) for n, t in made.items()}
        return out

    def param_spec(self) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        """``{key: {name: (shape, dtype)}}`` without allocating."""
        return self._spec("params")

    def state_spec(self) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        return self._spec("state")

    def _tensors(self, tree: Mapping[str, Mapping[str, Any]], what: str
                 ) -> Tree:
        """``tree`` checked against the spec of ``what`` (names and shapes
        exactly; a group with nothing in it may be absent; nested
        sub-groups are flattened to ``sub/name``) and moved to the device
        in the spec's dtypes."""
        spec = self._spec(what)
        extra = sorted(set(tree) - set(spec))
        if extra:
            raise ValueError(f"{what} tree has unknown groups {extra}")
        groups = {}
        for key, want in spec.items():
            got = flatten_group(dict(tree.get(key, {})))
            if set(got) != set(want):
                raise ValueError(
                    f"{key}: {what} names {sorted(got)} != expected "
                    f"{sorted(want)}")
            group = {}
            for name, (shape, dtype) in want.items():
                arr = np.asarray(got[name])
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}/{name}: shape {arr.shape} != "
                                     f"expected {shape}")
                group[name] = torch.tensor(arr, dtype=dtype,
                                           device=self.device)
            groups[key] = group
        return groups

    def load_params(self, tree: Mapping[str, Mapping[str, Any]]
                    ) -> "Network":
        """Install a JAX-layout param tree ``{key: {name: array}}``.
        Names and shapes must match exactly; a layer without params may be
        absent.  State is made fresh if there is none, and updater state
        is kept (made fresh if there is none)."""
        self._set_params(self._tensors(tree, "params"))
        if not self.state:
            self.state = {key: c.init_state(it, self.device)
                          for key, c, it in self._layers()}
            self._init_scale_state()
        if self.opt_state is None:
            self._init_updater()
        return self

    def load_state(self, tree: Mapping[str, Mapping[str, Any]]
                   ) -> "Network":
        """Install a JAX-layout state tree (BatchNorm running stats, and
        a policy net's loss-scale state under ``SCALE_STATE_KEY``: scale
        f32, good_steps and overflow_steps int32).  A policy net whose
        tree has no scale state keeps (or starts) its own."""
        key = _precision.SCALE_STATE_KEY
        tree = dict(tree)
        ls = tree.pop(key, None)
        old = self.state.get(key)
        self.state = self._tensors(tree, "state")
        if ls is not None:
            self.state[key] = {
                name: torch.tensor(np.asarray(ls[name]), dtype=dt,
                                   device=self.device)
                for name, dt in (("scale", torch.float32),
                                 ("good_steps", torch.int32),
                                 ("overflow_steps", torch.int32))}
        elif old is not None:
            self.state[key] = old
        else:
            self._init_scale_state()
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def param_bytes(self, per_device: bool = False) -> int:
        """Parameter memory: global bytes (every leaf whole), or with
        ``per_device=True`` the bytes this device holds, which a ZeRO-3
        sharded net (``parallel/sharded``) keeps at its blocks."""
        if per_device:
            return sum(p.numel() * p.element_size()
                       for p in self.params.parameters())
        return sum(int(np.prod(shape, dtype=np.int64))
                   * torch.empty((), dtype=dt).element_size()
                   for g in self.param_spec().values()
                   for shape, dt in g.values())

    def params_flat(self) -> np.ndarray:
        """All params as one flat host vector, layer by layer (vertex by
        vertex, in topological order), names sorted within each: a
        serialization view, as the JAX package's."""
        leaves = []
        for key, _, _ in self._layers():
            group = self.params[key] if key in self.params else {}
            for name in sorted(group):
                leaves.append(group[name].detach().cpu().numpy().reshape(-1))
        return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)

    def _on_device(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    def _fit_one(self, *batch) -> torch.Tensor:
        raise NotImplementedError

    def _fit_step(self, *batch) -> None:
        """One batch of ``fit``'s loop (a subclass may route it)."""
        self._fit_one(*batch)

    def _fit_epochs(self, factory: Callable, epochs: int, checkpoint=None,
                    resume_from=None) -> "Network":
        """``fit``'s loop (JAX ``MultiLayerNetwork.fit``): listeners at the
        JAX package's points (``on_epoch_start``, ``iteration_done`` per
        step, ``on_epoch_end``), the ``training_*`` metrics, step
        forensics, the step profiler, and checkpoints: ``checkpoint`` (a
        ``CheckpointConfig``) saves at its triggers, ``resume_from`` (a
        checkpoint directory, store or ``CheckpointManager``) restores the
        full training state and skips the batches the saved cursor had
        consumed, without fitting them or touching the key stream."""
        from ..observability.health import get_health_monitor
        from ..observability.profiler import step_profiler_for
        from ..observability.recorder import get_flight_recorder
        if not self.params:
            self.init()
        # built after every validation raise: the SIGTERM hook it installs
        # must always reach the loop's finally/close()
        ckpt = None
        if checkpoint is not None or resume_from is not None:
            from ..faulttolerance.checkpoint import FitCheckpointer
            ckpt = FitCheckpointer(self, checkpoint, resume_from)
        reg = default_registry()
        obs = reg.enabled
        rec = get_flight_recorder()
        rec_on = rec is not None and rec.enabled
        mon = get_health_monitor()
        forensics = _StepForensics(self, rec, mon, ckpt) \
            if (rec_on or mon is not None) else None
        prof = step_profiler_for("train_step", device=self.device)
        self._stepprof = prof
        if obs:
            steps_c = reg.counter("training_steps_total",
                                  "Optimizer steps taken")
            examples_c = reg.counter("training_examples_total",
                                     "Training examples consumed")
            step_h = reg.histogram(
                "training_step_seconds",
                "Train step wall time, split compile vs steady",
                ("phase",), buckets=_STEP_BUCKETS)
            etl_fetch_h = reg.histogram(
                "training_etl_seconds",
                "Time blocked on the data pipeline per batch, by stage",
                ("stage",), buckets=_ETL_BUCKETS).labels("fetch")
            step_compile_h = step_h.labels("compile")
            step_steady_h = step_h.labels("steady")
        steady_examples, steady_s = 0, 0.0
        start_epoch = ckpt.start_epoch if ckpt is not None else 0
        stop = False
        try:
            for ep in range(start_epoch, epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self)
                batches = iter(factory())
                skip = ckpt.skip_batches \
                    if (ckpt is not None and ep == ckpt.start_epoch) else 0
                seq = 0
                while True:
                    t_etl = monotonic_s()
                    batch = next(batches, None)
                    etl_s = monotonic_s() - t_etl
                    if batch is None:
                        break
                    if seq < skip:
                        seq += 1
                        continue
                    t_step = monotonic_s()
                    if prof is not None:
                        prof.begin(t_step, etl_s)
                    compile_step = not self._warm_step
                    self._fit_step(*batch)
                    self._warm_step = True
                    if prof is not None:
                        prof.dispatched(self._score)
                    t_end = monotonic_s()
                    dt = t_end - t_step
                    if obs:
                        (step_compile_h if compile_step
                         else step_steady_h).observe(dt)
                        etl_fetch_h.observe(etl_s)
                        steps_c.inc()
                        examples_c.inc(self.last_batch_size)
                        if not compile_step:
                            steady_examples += self.last_batch_size
                            steady_s += dt
                    seq += 1
                    if forensics is not None and \
                            forensics.step(ep, seq, compile_step, dt, t_end):
                        stop = True   # opt-in health stop: clean return
                    if prof is not None:
                        prof.lap("forensics")
                    if not stop and ckpt is not None and \
                            ckpt.after_batch(ep, seq):
                        stop = True   # SIGTERM: final save — return
                    if prof is not None:
                        if ckpt is not None:
                            prof.lap("checkpoint")
                        prof.end(self.iteration, compile_step)
                    if stop:
                        break
                if stop:
                    break
                for lst in self.listeners:
                    lst.on_epoch_end(self)
                self.epoch += 1
                if ckpt is not None and ckpt.after_epoch(ep):
                    break
        except Exception as e:
            # unhandled fit exception: commit the flight-recorder window
            # BEFORE propagating
            if rec_on:
                if forensics is not None:
                    try:
                        forensics.flush()
                    except Exception:
                        log.warning("forensics flush failed", exc_info=True)
                rec.record("train", "fit_exception",
                           error=f"{type(e).__name__}: {e}",
                           iteration=int(self.iteration))
                rec.maybe_dump(
                    "fit_exception",
                    directory=(ckpt.manager.directory
                               if ckpt is not None and ckpt.manager
                               is not None else None))
            raise
        finally:
            # telemetry must not mask the real error
            if forensics is not None:
                try:
                    forensics.flush()
                except Exception:
                    log.warning("forensics flush failed", exc_info=True)
            if prof is not None:
                self._stepprof = None
                prof.flush()
            if ckpt is not None:
                ckpt.close()
        if obs and steady_s > 0:
            reg.gauge("training_examples_per_sec",
                      "Training examples/sec over the last fit() "
                      "(compile excluded where the path can tell)"
                      ).set(steady_examples / steady_s)
        return self

    def _iteration_done(self) -> None:
        if not self.listeners:
            return
        t = monotonic_s()
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch)
        if self._stepprof is not None:
            self._stepprof.mark("listener", monotonic_s() - t)

    def get_score(self) -> float:
        """The loss of the most recent training batch (one host sync
        where it is still on the device)."""
        return float(self._score)

    # ----------------------------------------------------------- listeners
    def set_listeners(self, *listeners) -> "Network":
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners) -> "Network":
        self.listeners.extend(listeners)
        return self

    # --------------------------------------------------------------- clone
    def clone(self) -> "Network":
        """A deep copy on the same device: configuration, params, state,
        updater slots and counts, iteration and epoch.  The key stream is
        split as the JAX package's ``clone`` splits it (``self._rng,
        other._rng = split(self._rng)``), so replicas draw different
        dropout and a run that clones (early stopping's saver) keeps the
        JAX package's stream.  Listeners are not copied."""
        import copy
        other = type(self)(copy.deepcopy(self.conf), device=self.device)
        with torch.no_grad():
            other._set_params({k: {n: p.detach().clone()
                                   for n, p in g.items()}
                               for k, g in self.params.items()})
        other.state = {k: {n: t.clone() for n, t in g.items()}
                       for k, g in self.state.items()}
        other._init_updater()
        if self.opt_state is not None:
            other.opt_state = {
                "count": dict(self.opt_state["count"]),
                "slots": {k: {n: {s: t.clone() for s, t in sl.items()}
                              for n, sl in g.items()}
                          for k, g in self.opt_state["slots"].items()}}
        self._rng, other._rng = _random.split(self._rng)
        other.iteration, other.epoch = self.iteration, self.epoch
        other.last_batch_size = self.last_batch_size
        return other

    # ---------------------------------------------------------- evaluation
    def evaluate(self, iterator_or_x, y=None):
        """Classification ``Evaluation`` of the first output over a batch
        ``(x, y)`` or an iterator of batches; a labels mask (3-D time
        series) selects the steps that count."""
        from ..evaluation.classification import Evaluation
        return self._evaluate_with(Evaluation(), iterator_or_x, y)

    def evaluate_regression(self, iterator_or_x, y=None):
        from ..evaluation.regression import RegressionEvaluation
        return self._evaluate_with(RegressionEvaluation(), iterator_or_x, y)

    def evaluate_roc(self, iterator_or_x, y=None, threshold_steps: int = 0):
        from ..evaluation.roc import ROC
        return self._evaluate_with(ROC(threshold_steps), iterator_or_x, y)

    def _evaluate_with(self, ev, it, y):
        if y is not None:
            batches = [self._normalize_batch((it, y))]
        else:
            if hasattr(it, "reset"):
                it.reset()
            batches = (self._normalize_batch(b) for b in it)
        for x, yy, _, lm in batches:
            out = self._eval_output(x)
            ev.eval(_first(yy), out, mask=_first(lm))
        return ev

    def _eval_output(self, x) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _normalize_batch(b):
        raise NotImplementedError


def _first(a):
    """The first of a list (a graph's per-output labels or masks)."""
    return a[0] if isinstance(a, list) else a
