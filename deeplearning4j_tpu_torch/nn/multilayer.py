"""Sequential network (port of ``nn/multilayer.py``): init, output, the
loss, the train step, fit and score.

The forward is a plain Python loop over the layers.  The JAX package
runs identical repeated blocks under ``lax.scan``; PyTorch runs eagerly
and needs no such fold.  Parameters live in one ``nn.ParameterDict`` per
layer, keyed ``layer_i`` and named as in the JAX package, so a JAX
checkpoint maps onto them one to one.

Training (``fit``) takes the JAX package's SGD path: forward to the
output layer's loss plus l1/l2, gradients by autograd (through the
flash-attention backward kernels on CUDA), gradient normalization, then
the hand-written updater arithmetic of ``nn/conf/updaters.py``.  The
step leaves the loss on the device: ``score()``/``get_score()``
materialise it on demand.  Not ported, and refused when configured:
precision policies, the sparse-embedding gradient, tBPTT, remat, the
legacy solvers, layer constraints, dropout and weight noise.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.dataset import DataSet
from ..utils.device import resolve_device
from ._common import (apply_constraints_all, apply_gradient_norm_all,
                      build_tx, float_grad_leaves)
from .conf.multi_layer import MultiLayerConfiguration
from .conf.updaters import Sgd, UpdaterConf


def _layer_confs(conf) -> Dict[str, Any]:
    return {f"layer_{i}": lc for i, lc in enumerate(conf.layers)}


def _stack_loss(conf, params, x, y, *, train: bool,
                label_mask=None) -> torch.Tensor:
    """Forward to the last layer's loss, plus regularization (reference
    ``computeGradientAndScore``).  A free function over the
    configuration and a ``{layer_i: {name: tensor}}`` params mapping."""
    layers = conf.layers
    n = len(layers)
    h = x
    for i in range(n - 1):
        h = layers[i].apply(params[f"layer_{i}"], h, train=train)
    out_conf = layers[-1]
    if not hasattr(out_conf, "compute_loss"):
        raise ValueError(
            f"last layer '{out_conf.name}' is not an output layer")
    loss = out_conf.compute_loss(params[f"layer_{n - 1}"], h, y,
                                 train=train, mask=label_mask)
    reg = torch.zeros((), dtype=loss.dtype, device=loss.device)
    for i, lc in enumerate(layers):
        lp = params[f"layer_{i}"]
        if lp:
            reg = reg + lc.regularization_score(dict(lp))
    return loss + reg


def _refuse_unported_training(conf) -> None:
    """The JAX train step's branches this port does not have."""
    d = conf.defaults
    if d.get("precision") is not None or \
            str(d.get("compute_dtype") or "float32") != "float32":
        raise NotImplementedError(
            "precision policies (precision / compute_dtype) are not ported "
            "yet: training runs float32")
    if conf.backprop_type == "tbptt":
        raise NotImplementedError("backprop_type='tbptt' is not ported yet")
    if d.get("cache_mode") == "remat":
        raise NotImplementedError("cache_mode='remat' is not ported yet")
    algo = d.get("optimization_algo", "sgd")
    if algo not in ("sgd", "stochastic_gradient_descent"):
        raise NotImplementedError(
            f"optimization_algo='{algo}' (the legacy solvers) is not "
            "ported yet")
    for lc in conf.layers:
        if getattr(lc, "sparse_grad", False):
            raise NotImplementedError(
                f"layer '{lc.name}': sparse_grad=True (the sparse-embedding "
                "gradient) is not ported yet")


def _build_train_step(conf, tx):
    """``step(params, opt_state, x, y, label_mask) -> (loss, gstats)``:
    one SGD-path training step that updates ``params`` and ``opt_state``
    in place.  Port of the reference's ``_build_train_step`` without its
    sparse-embedding, precision and tBPTT-carry branches."""
    _refuse_unported_training(conf)
    gn_mode = conf.defaults.get("gradient_normalization")
    gn_thr = float(conf.defaults.get("gradient_normalization_threshold",
                                     1.0))
    confs = _layer_confs(conf)

    def step(params, opt_state, x, y, label_mask):
        # constraints are checked before anything moves: the reference
        # applies them after the update, and they are not ported
        apply_constraints_all(params, confs)
        loss = _stack_loss(conf, params, x, y, train=True,
                           label_mask=label_mask)
        keys = [(k, n) for k, group in params.items() for n in group]
        leaves = [params[k][n] for k, n in keys]
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in params}
        for (k, n), g, p in zip(keys, flat, leaves):
            # a param the loss does not reach has gradient 0, as in JAX
            grads[k][n] = torch.zeros_like(p) if g is None else g
        with torch.no_grad():
            grads = apply_gradient_norm_all(grads, confs, gn_mode, gn_thr)
            gleaves = float_grad_leaves(grads)
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gleaves)) \
                if gleaves else torch.zeros((), dtype=torch.float32)
            glayer = {k: torch.sqrt(sum(torch.sum(g * g)
                                        for g in float_grad_leaves(v)))
                      for k, v in grads.items() if v}
        tx.step(params, grads, opt_state)
        return loss.detach(), {"global_norm": gnorm, "layer_norms": glayer}

    return step


def _normalize_batch(b) -> Tuple[Any, Any, Any, Any]:
    """``(x, y, features_mask, labels_mask)`` from a 2- or 4-tuple or a
    ``DataSet``-like object."""
    if isinstance(b, (tuple, list)):
        if len(b) == 2:
            return b[0], b[1], None, None
        if len(b) == 4:
            return tuple(b)
    if hasattr(b, "features"):
        return (b.features, b.labels, getattr(b, "features_mask", None),
                getattr(b, "labels_mask", None))
    raise ValueError(f"cannot interpret batch of type {type(b)}")


class MultiLayerNetwork(nn.Module):
    """``MultiLayerNetwork(conf, device="cuda").init()``, then ``fit``,
    ``output`` and ``score``."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        conf.resolve()
        self.conf = conf
        self.layer_confs = conf.layers
        self.params = nn.ModuleDict()
        self.opt_state: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.epoch = 0
        self.last_batch_size = 0
        self._score: Any = float("nan")
        self._last_grad_stats: Optional[Dict[str, Any]] = None
        self._tx = None
        self._step = None
        self._id_layer = None

    def _set_params(self, groups: Mapping[str, Dict[str, torch.Tensor]]):
        self.params = nn.ModuleDict({
            key: nn.ParameterDict({
                name: nn.Parameter(t, requires_grad=t.is_floating_point())
                for name, t in group.items()})
            for key, group in groups.items()})

    def _param_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: dict(g.items()) for k, g in self.params.items()}

    def init(self) -> "MultiLayerNetwork":
        """Fresh parameters from a ``torch.Generator`` seeded with the
        configuration's seed (torch's numbers, not JAX's), and fresh
        updater state."""
        gen = torch.Generator().manual_seed(self.conf.seed)
        self._set_params({
            f"layer_{i}": lc.init(gen, self.conf.layer_input_types[i],
                                  self.device)
            for i, lc in enumerate(self.layer_confs)})
        self._init_updater()
        return self

    def _default_updater(self) -> UpdaterConf:
        u = self.conf.defaults.get("updater")
        return u if u is not None else Sgd(learning_rate=0.1)

    def _init_updater(self) -> None:
        self._tx = build_tx(self._default_updater(),
                            _layer_confs(self.conf), self._param_tree())
        self.opt_state = self._tx.init(self._param_tree())
        self._step = None

    def param_spec(self) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        """``{layer_i: {name: (shape, dtype)}}`` without allocating."""
        gen = torch.Generator()
        meta = torch.device("meta")
        return {f"layer_{i}": {n: (tuple(t.shape), t.dtype) for n, t in
                               lc.init(gen, self.conf.layer_input_types[i],
                                       meta).items()}
                for i, lc in enumerate(self.layer_confs)}

    def load_params(self, tree: Mapping[str, Mapping[str, Any]]
                    ) -> "MultiLayerNetwork":
        """Install a JAX-layout param tree ``{layer_i: {name: array}}``.
        Names and shapes must match exactly; a layer without params may
        be absent.  Updater state is kept (made fresh if there is none)."""
        spec = self.param_spec()
        extra = sorted(set(tree) - set(spec))
        if extra:
            raise ValueError(f"param tree has unknown groups {extra}")
        groups = {}
        for key, want in spec.items():
            got = tree.get(key, {})
            if set(got) != set(want):
                raise ValueError(
                    f"{key}: param names {sorted(got)} != expected "
                    f"{sorted(want)}")
            group = {}
            for name, (shape, dtype) in want.items():
                arr = np.asarray(got[name])
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}/{name}: shape {arr.shape} != "
                                     f"expected {shape}")
                group[name] = torch.tensor(arr, dtype=dtype, device=self.device)
            groups[key] = group
        self._set_params(groups)
        if self.opt_state is None:
            self._init_updater()
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.params:
            raise RuntimeError("network has no params: call init() or "
                               "load_params() first")
        h = x
        for i, lc in enumerate(self.layer_confs):
            h = lc.apply(self.params[f"layer_{i}"], h)
        return h

    def _validate_input_ids(self, x) -> None:
        """Host-side id-range check for an embedding-first network at the
        fit/output/score boundary (see ``feedforward.validate_host_ids``;
        tensors and float batches pass through)."""
        from .layers.feedforward import (EmbeddingSequenceLayer,
                                         validate_host_ids)
        if self._id_layer is None:
            lc = self.layer_confs[0] if self.layer_confs else None
            self._id_layer = lc if isinstance(lc, EmbeddingSequenceLayer) \
                else False
        if self._id_layer:
            validate_host_ids(self._id_layer, x)

    def _on_device(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    def output(self, x) -> torch.Tensor:
        """Inference forward on a batch (numpy array or tensor); the
        result stays on the network's device."""
        self._validate_input_ids(x)
        with torch.inference_mode():
            return self(self._on_device(x))

    # ------------------------------------------------------------ training
    def fit(self, data=None, labels=None, *, epochs: int = 1, mask=None,
            label_mask=None) -> "MultiLayerNetwork":
        """Train.  ``data`` may be ``(x, y)`` arrays (or ``x`` with
        ``labels``), a ``DataSet``, or an iterable of batches with an
        optional ``reset()`` (the DataSetIterator role)."""
        if not self.params:
            self.init()
        if labels is not None:
            batches_factory = lambda: [(data, labels, mask, label_mask)]
        elif isinstance(data, DataSet) or \
                (isinstance(data, tuple) and len(data) in (2, 4)):
            batches_factory = lambda: [_normalize_batch(data)]
        elif hasattr(data, "reset") or hasattr(data, "__iter__"):
            if not hasattr(data, "reset") and epochs > 1 and \
                    iter(data) is data:
                # a bare generator cannot be iterated again per epoch
                data = [_normalize_batch(b) for b in data]
                batches_factory = lambda: data
            else:
                src = data

                def batches_factory():
                    if hasattr(src, "reset"):
                        src.reset()
                    for b in src:
                        yield _normalize_batch(b)
        else:
            raise ValueError("fit() needs (x, y) or an iterator")
        for _ in range(epochs):
            for x, y, m, lm in batches_factory():
                self.last_batch_size = int(getattr(x, "shape", (0,))[0])
                self._fit_one(x, y, m, lm)
            self.epoch += 1
        return self

    def _fit_one(self, x, y, m, lm) -> torch.Tensor:
        """One train step; returns (and keeps in ``_score``) the loss as a
        device scalar, without waiting for the device."""
        self._validate_input_ids(x)
        if m is not None:
            raise NotImplementedError(
                "features masks in training are not ported yet")
        if self._step is None:
            if self.opt_state is None:
                self._init_updater()
            self._step = _build_train_step(self.conf, self._tx)
        loss, gstats = self._step(self._param_tree(), self.opt_state,
                                  self._on_device(x), self._on_device(y),
                                  self._on_device(lm))
        self._score = loss
        self._last_grad_stats = gstats
        self.iteration += 1
        return loss

    def fit_batch(self, batch) -> float:
        """One train step on one batch, without epoch bookkeeping."""
        if not self.params:
            self.init()
        return float(self._fit_one(*_normalize_batch(batch)))

    def score(self, dataset=None, x=None, y=None) -> float:
        """Loss on a dataset; with no arguments, the score of the most
        recent training batch (reference ``score()`` /
        ``score(DataSet)``)."""
        if dataset is None and x is None:
            return float(self._score)
        if dataset is not None:
            x, y, _, _ = _normalize_batch(dataset)
        self._validate_input_ids(x)
        with torch.no_grad():
            loss = _stack_loss(self.conf, self.params, self._on_device(x),
                               self._on_device(y), train=False)
        return float(loss)

    def get_score(self) -> float:
        return float(self._score)
