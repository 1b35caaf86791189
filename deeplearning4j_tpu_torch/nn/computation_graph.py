"""ComputationGraph: the DAG network (port of ``nn/computation_graph.py``):
init, output, the loss, the train step, fit and score.

The forward walks the configuration's topological order eagerly, one
vertex at a time; fan-in gradients (the residual adds) are summed by
autograd.  Features masks ride the walk as in the JAX package: each
vertex gets its inputs' masks (``LastTimeStepVertex`` the mask of the
network input it names) and hands its consumers ``feed_forward_mask`` of
them; an output's label mask defaults to the mask that reaches it.
Parameters live in one ``nn.ParameterDict`` per vertex, keyed by vertex
name and named as in the JAX package; state (BatchNorm running
statistics) in ``state``, replaced by each training step.

Dropout draws from the JAX package's threefry stream: the network keeps
``_rng = PRNGKey(seed)``, each training step splits it into the next
``_rng`` and the step's key, vertex ``vi`` of the topological order draws
from ``fold_in(key, vi)`` and output ``oi``'s loss from
``fold_in(key, 10000 + oi)``.

Training takes the JAX package's SGD path: forward to the output layers'
summed loss plus l1/l2, gradients by autograd (through the hand-written
BatchNorm kernel's ``autograd.Function`` where a layer selects it),
gradient normalization, then the updaters and the constraints.  The step
leaves the loss on the device.  Listeners, ``clone``, evaluation and
``fit_on_device`` are ``nn/_common.Network``'s.  A precision policy casts
each vertex's inputs and params to its compute dtype, as the
MultiLayerNetwork's step does per layer (``nn/multilayer``);
``cache_mode("remat")`` checkpoints each layer vertex.  As in the JAX
package, a graph trains by SGD whatever ``optimization_algo`` says (the
legacy solvers drive MultiLayerNetworks).  As in the JAX package, a
sparse-gradient vertex is refused (the densified pre-pass is the
MultiLayerNetwork step's); tBPTT is not ported for graphs.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import _random
from . import precision as _precision
from ._common import (Network, aux_term, backward_and_update, batch_factory,
                      cast_act, cast_params, carry_thread_context,
                      exchange_fetch, finish_precision_step,
                      fit_on_device_epochs, layer_scope, objective,
                      precision_cast_map, regularization)
from .conf.computation_graph import LayerVertex
from .layers.base import draws


def _as_list(x) -> List:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _vertex_confs(conf) -> Dict[str, Any]:
    return {name: getattr(v, "layer", None)
            for name, v in conf.vertices.items()}


def _is_loss_output(conf, name: str) -> bool:
    return name in conf.network_outputs and \
        hasattr(getattr(conf.vertices[name], "layer", None), "compute_loss")


def _vertex_key(key, index: int, v):
    """``fold_in(key, index)`` where the vertex draws, else None."""
    if key is None or not draws(getattr(v, "layer", None)):
        return None
    return _random.fold_in(key, index)


def _vertex_forward(v, params, state, xs, key, masks):
    """One vertex's training forward, the unit ``cache_mode("remat")``
    checkpoints."""
    return v.forward(params, state, xs, train=True, key=key, masks=masks)


def _graph_forward(conf, params, state, inputs: List[torch.Tensor], *,
                   train: bool, key=None, masks=None,
                   exclude_outputs: bool = False, precision=None, fetch=None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict, Dict]:
    """Walk the topological order; returns ``(acts, new_state,
    mask_of)``, acts and masks keyed by vertex name (plus the network
    inputs).  With ``exclude_outputs``, output layers that nothing
    consumes are skipped: the loss applies them itself.  ``precision``
    casts each vertex's inputs to its compute dtype; in training under
    ``cache_mode("remat")`` every layer vertex runs checkpointed.
    ``fetch`` (a ZeRO-3 step's, ``_common.layer_scope``) gives each
    vertex the params it computes with, for its forward only."""
    acts = dict(zip(conf.network_inputs, inputs))
    mask_of = {n: (masks[i] if masks and i < len(masks) else None)
               for i, n in enumerate(conf.network_inputs)}
    new_state = dict(state)
    remat = train and conf.defaults.get("cache_mode") == "remat"
    consumed = {src for ins in conf.vertex_inputs.values() for src in ins}
    for vi, name in enumerate(conf.topological_order):
        v = conf.vertices[name]
        if exclude_outputs and name not in consumed and \
                _is_loss_output(conf, name):
            continue
        ins = conf.vertex_inputs[name]
        xs = [acts[s] for s in ins]
        ms = [mask_of.get(s) for s in ins]
        # LastTimeStepVertex keys the lengths off a named input's mask
        mi = getattr(v, "mask_input", None)
        if mi:
            ms = [mask_of.get(mi)] + ms[1:]
        if precision is not None:
            vdt = precision.layer_dtype(getattr(v, "layer", None) or v)
            xs = [cast_act(x, vdt) for x in xs]
        vkey = _vertex_key(key, vi, v)
        with layer_scope(fetch, name, params.get(name, {})) as vp:
            if remat and isinstance(v, LayerVertex):
                acts[name], new_state[name] = checkpoint(
                    carry_thread_context(_vertex_forward), v, vp,
                    state.get(name, {}), xs, vkey, ms, use_reentrant=False)
            else:
                acts[name], new_state[name] = v.forward(
                    vp, state.get(name, {}), xs, train=train, key=vkey,
                    masks=ms)
        del vp
        mask_of[name] = v.feed_forward_mask(ms, xs)
    return acts, new_state, mask_of


def _graph_loss(conf, params, state, inputs, labels, *, train: bool,
                label_masks=None, key=None, masks=None, precision=None,
                fetch=None) -> Tuple[torch.Tensor, Dict]:
    """Sum of the output layers' losses plus regularization; returns
    ``(loss, new_state)``.  An output's label mask defaults to the
    features mask that reaches it."""
    acts, new_state, mask_of = _graph_forward(
        conf, params, state, inputs, train=train, key=key, masks=masks,
        exclude_outputs=True, precision=precision, fetch=fetch)
    total = None
    for oi, name in enumerate(conf.network_outputs):
        if not _is_loss_output(conf, name):
            raise ValueError(
                f"network output '{name}' is not an output layer vertex")
        src = conf.vertex_inputs[name][0]
        lm = label_masks[oi] if label_masks and oi < len(label_masks) \
            else None
        if lm is None:
            lm = mask_of.get(src)
        v = conf.vertices[name]
        h = acts[src]
        if precision is not None:
            # the head's product in the compute dtype; the loss
            # reductions widen to f32 inside nn/losses
            h = cast_act(h, precision.layer_dtype(v.layer))
        with layer_scope(fetch, name, params.get(name, {})) as vp:
            loss = v.compute_loss(
                vp, h, labels[oi], train=train,
                key=_vertex_key(key, 10_000 + oi, v), mask=lm)
        del vp
        total = loss if total is None else total + loss
    reg = torch.zeros((), dtype=total.dtype, device=total.device)
    shares = []
    for name, v in conf.vertices.items():
        lp = params.get(name, {})
        if lp:
            reg = reg + regularization(fetch, name, v, lp)
        if getattr(getattr(v, "layer", None), "AUX_LOSS", False):
            # a mixture-of-experts vertex's load-balancing term
            aux = new_state.get(name, {}).get("aux_loss")
            if aux is not None:
                reg = aux_term(reg, aux, shares)
    return objective(total, reg, shares), new_state


def _build_graph_train_step(conf, tx, exchange=None):
    """``step(params, state, opt_state, xs, ys, label_masks, key=None,
    masks=None) -> (loss, new_state, gstats)``, updating ``params`` and
    ``opt_state`` in place, drawing dropout from ``key``.  Port of the
    reference's graph train step (precision casts per vertex, the loss
    scale and its skip); as there, a sparse-gradient vertex is refused.
    ``exchange``: one data-parallel rank's step (``nn/multilayer``'s
    ``_build_train_step`` has the contract)."""
    confs = _vertex_confs(conf)
    for name, lc in confs.items():
        if getattr(lc, "sparse_grad", False) or \
                getattr(getattr(lc, "layer", None), "sparse_grad", False):
            # the densified pre-pass (nn/sparse) is wired into the
            # MultiLayerNetwork step only, as in the JAX package
            raise ValueError(
                f"vertex '{name}': sparse_grad=True is supported on "
                "MultiLayerNetwork (first-layer embedding) only; the "
                "ComputationGraph train step has no densified sparse-"
                "gradient pre-pass — drop the flag, or move the "
                "embedding model to a MultiLayerNetwork stack")
    gn_mode = conf.defaults.get("gradient_normalization")
    gn_thr = float(conf.defaults.get("gradient_normalization_threshold",
                                     1.0))
    pol = _precision.resolve(conf.defaults)
    cast_map = precision_cast_map(
        pol, {name: getattr(v, "layer", None) or v
              for name, v in conf.vertices.items()})

    def step(params, state, opt_state, xs, ys, label_masks, key=None,
             masks=None):
        fetch = None
        if exchange is not None:
            params = exchange.gather(params)
            fetch = exchange_fetch(exchange, cast_map)
        if pol is not None:
            xs = [cast_act(x, pol.compute_dtype) for x in xs]
        ls = state.get(_precision.SCALE_STATE_KEY) \
            if pol is not None and pol.scaled else None
        with (nullcontext() if exchange is None
              else exchange.batch(int(xs[0].shape[0]))):
            loss, new_state = _graph_loss(
                conf, params if fetch else cast_params(params, cast_map),
                state, xs, ys, train=True, label_masks=label_masks, key=key,
                masks=masks, precision=pol, fetch=fetch)
            obj = loss * ls["scale"] if ls is not None else loss
            gstats, updated = backward_and_update(
                obj, params, opt_state, tx, confs, gn_mode, gn_thr,
                scale=None if ls is None else ls["scale"],
                exchange=exchange)
        new_state = finish_precision_step(pol, state, new_state, gstats,
                                          updated)
        loss = loss.detach()
        if exchange is not None:
            loss = exchange.total(loss)
        return loss, new_state, gstats

    return step


def _normalize_batch(b):
    """``(inputs, labels, features_masks, labels_masks)``, each a list
    (or None for the masks), from a 2- or 4-tuple or a (Multi)DataSet-like
    object."""
    if isinstance(b, (tuple, list)):
        if len(b) == 2:
            return _as_list(b[0]), _as_list(b[1]), None, None
        if len(b) == 4:
            return (_as_list(b[0]), _as_list(b[1]),
                    None if b[2] is None else _as_list(b[2]),
                    None if b[3] is None else _as_list(b[3]))
    if hasattr(b, "features"):
        fm = getattr(b, "features_mask", None)
        lm = getattr(b, "labels_mask", None)
        return (_as_list(b.features), _as_list(b.labels),
                None if fm is None else _as_list(fm),
                None if lm is None else _as_list(lm))
    raise ValueError(f"cannot interpret batch of type {type(b)}")


class ComputationGraph(Network):
    """``ComputationGraph(conf, device="cuda").init()``, then ``fit``,
    ``output`` and ``score``."""

    def _layers(self):
        return [(name, self.conf.vertices[name],
                 self.conf.vertex_input_types[name])
                for name in self.conf.topological_order]

    def _hyper_confs(self):
        return _vertex_confs(self.conf)

    def forward(self, *inputs: torch.Tensor, train: bool = False,
                masks=None) -> List[torch.Tensor]:
        """Activations of the network outputs; ``train=True`` keeps
        dropout on with a fresh key from the network's stream."""
        if not self.params:
            raise RuntimeError("network has no params: call init() or "
                               "load_params() first")
        acts, _, _ = _graph_forward(
            self.conf, self._param_tree(), self.state, list(inputs),
            train=train, key=self._next_key() if train else None,
            masks=masks)
        return [acts[o] for o in self.conf.network_outputs]

    def _masks_on_device(self, masks):
        return None if masks is None else [self._on_device(m)
                                           for m in _as_list(masks)]

    def output(self, *inputs, train: bool = False, masks=None):
        """Forward on a batch (numpy arrays or tensors): the output
        activation, or a list of them for several outputs.  Results stay
        on the network's device.  ``train=True`` draws dropout as
        training does and advances the network's key stream; ``masks``
        are the inputs' features masks."""
        with torch.inference_mode():
            ys = self(*[self._on_device(x) for x in inputs], train=train,
                      masks=self._masks_on_device(masks))
        return ys[0] if len(ys) == 1 else ys

    def output_single(self, *inputs, train: bool = False, masks=None
                      ) -> torch.Tensor:
        """``output`` of a graph with one output; raises on several."""
        y = self.output(*inputs, train=train, masks=masks)
        if isinstance(y, list):
            raise ValueError("output_single on a multi-output graph")
        return y

    def feed_forward(self, *inputs, train: bool = False, masks=None
                     ) -> Dict[str, torch.Tensor]:
        """Every vertex's activation keyed by name; ``train=True`` keeps
        dropout on with a fresh key."""
        with torch.inference_mode():
            acts, _, _ = _graph_forward(
                self.conf, self._param_tree(), self.state,
                [self._on_device(x) for x in inputs], train=train,
                key=self._next_key() if train else None,
                masks=self._masks_on_device(masks))
        return acts

    # ------------------------------------------------------------ training
    def fit(self, data=None, labels=None, *, epochs: int = 1, masks=None,
            label_masks=None, checkpoint=None,
            resume_from=None) -> "ComputationGraph":
        """Train.  ``data`` may be (inputs, labels), each an array or a
        list of arrays, or an iterable of MultiDataSet-shaped batches.
        ``checkpoint``/``resume_from``: crash-consistent periodic saves and
        exact mid-epoch resume (see ``MultiLayerNetwork.fit``)."""
        one = (_as_list(data), _as_list(labels), masks, label_masks) \
            if labels is not None else None
        return self._fit_epochs(batch_factory(data, one, _normalize_batch),
                                epochs, checkpoint, resume_from)

    def _train_step(self):
        if self._step is None:
            if self.opt_state is None:
                self._init_updater()
            self._step = _build_graph_train_step(self.conf, self._tx,
                                                 self._exchange)
        return self._step

    def _fit_one(self, xs, ys, ms, lms) -> torch.Tensor:
        """One train step; returns (and keeps in ``_score``) the loss as a
        device scalar, without waiting for the device."""
        xs = [self._on_device(x) for x in _as_list(xs)]
        self.last_batch_size = int(xs[0].shape[0])
        step = self._train_step()
        lms = None if lms is None else [self._on_device(m)
                                        for m in _as_list(lms)]
        loss, self.state, gstats = step(
            self._param_tree(), self.state, self.opt_state, xs,
            [self._on_device(y) for y in _as_list(ys)], lms,
            self._next_key(), self._masks_on_device(ms))
        self._score = loss
        self._last_grad_stats = gstats
        self.iteration += 1
        self._iteration_done()
        return loss

    def _device_step(self, xs, ys, key) -> torch.Tensor:
        """One train step on minibatches already on the device, drawing
        from ``key`` (``fit_on_device``'s step); returns the loss."""
        loss, self.state, self._last_grad_stats = self._train_step()(
            self._param_tree(), self.state, self.opt_state, xs, ys, None,
            key, None)
        return loss

    def fit_on_device(self, inputs, labels, *, batch_size: int,
                      epochs: int = 1, shuffle: bool = True,
                      checkpoint=None, resume_from=None
                      ) -> "ComputationGraph":
        """Device-resident epoch training for graphs (see
        ``MultiLayerNetwork.fit_on_device``); ``inputs``/``labels`` are an
        array or a list of arrays."""
        if not self.params:
            self.init()
        ckpt = None
        if checkpoint is not None or resume_from is not None:
            from ..faulttolerance.checkpoint import FitCheckpointer
            ckpt = FitCheckpointer(self, checkpoint, resume_from)
        return fit_on_device_epochs(
            self, [self._on_device(a) for a in _as_list(inputs)],
            [self._on_device(a) for a in _as_list(labels)], batch_size,
            epochs, shuffle,
            fit_tail=lambda xt, yt: self._fit_one(xt, yt, None, None),
            ckpt=ckpt)

    def fit_batch(self, batch) -> float:
        """One train step on one batch, without epoch bookkeeping (the
        early-stopping trainer owns the epoch loop); returns its loss."""
        if not self.params:
            self.init()
        return float(self._fit_one(*_normalize_batch(batch)))

    _normalize_batch = staticmethod(_normalize_batch)

    def _eval_output(self, xs) -> torch.Tensor:
        out = self.output(*xs)
        return out[0] if isinstance(out, list) else out

    def score(self, dataset=None, inputs=None, labels=None) -> float:
        """Loss on a dataset; with no arguments, the score of the most
        recent training batch."""
        if dataset is None and inputs is None:
            return float(self._score)
        ms = lms = None
        if dataset is not None:
            inputs, labels, ms, lms = _normalize_batch(dataset)
        with torch.no_grad():
            loss, _ = _graph_loss(
                self.conf, self._param_tree(), self.state,
                [self._on_device(x) for x in _as_list(inputs)],
                [self._on_device(y) for y in _as_list(labels)], train=False,
                label_masks=self._masks_on_device(lms),
                masks=self._masks_on_device(ms))
        return float(loss)


def check_graph_gradients(net: ComputationGraph, inputs, labels, *,
                          epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                          min_abs_error: float = 1e-8, masks=None,
                          label_masks=None, print_results: bool = False,
                          subset: Optional[int] = None, seed: int = 12345,
                          exclude: tuple = ("centers",)) -> bool:
    """The gradient check of ``utils/gradient_check`` for a graph
    (reference ``checkGradients``, graph variant): float64 central
    differences against autograd, ``train=False``, on the network's
    device, the elements drawn as the JAX package draws them."""
    from ..utils.gradient_check import (_f64_on, _f64_tree,
                                        check_loss_gradients)
    if not net.params:
        net.init()
    dev = net.device
    state = _f64_tree(net.state)
    xs = [_f64_on(x, dev) for x in _as_list(inputs)]
    ys = [_f64_on(y, dev) for y in _as_list(labels)]
    ms, lms = net._masks_on_device(masks), net._masks_on_device(label_masks)

    def loss_fn(p):
        return _graph_loss(net.conf, p, state, xs, ys, train=False,
                           label_masks=lms, masks=ms)[0]

    return check_loss_gradients(loss_fn, net._param_tree(), epsilon,
                                max_rel_error, min_abs_error, print_results,
                                subset, seed, exclude)
