"""Sequential network (port of ``nn/multilayer.py``): init, output, the
loss, the train step, fit and score.

The forward is a plain Python loop over the layers.  The JAX package
runs identical repeated blocks under ``lax.scan``; PyTorch runs eagerly
and needs no such fold.  Parameters live in one ``nn.ParameterDict`` per
layer, keyed ``layer_i`` and named as in the JAX package, so a JAX
checkpoint maps onto them one to one.  Layer state (BatchNormalization's
running statistics) lives in ``state``; every layer runs through
``forward(params, state, x, train)`` and each training step replaces
``state`` with the new one it returns.

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

from typing import Any, Dict, Tuple

import torch

from ._common import (Network, apply_constraints_all, backward_and_update,
                      batch_factory, refuse_unported_training)
from .conf.multi_layer import MultiLayerConfiguration


def _layer_confs(conf) -> Dict[str, Any]:
    return {f"layer_{i}": lc for i, lc in enumerate(conf.layers)}


def _stack_loss_state(conf, params, state, x, y, *, train: bool,
                      label_mask=None) -> Tuple[torch.Tensor, Dict]:
    """Forward to the last layer's loss, plus regularization (reference
    ``computeGradientAndScore``); returns ``(loss, new_state)``.  A free
    function over the configuration, a ``{layer_i: {name: tensor}}``
    params mapping and the layers' state."""
    layers = conf.layers
    n = len(layers)
    h = x
    new_state = dict(state)
    for i in range(n - 1):
        key = f"layer_{i}"
        h, new_state[key] = layers[i].forward(params[key], state.get(key, {}),
                                              h, train=train)
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
    return loss + reg, new_state


def _stack_loss(conf, params, x, y, *, train: bool,
                label_mask=None) -> torch.Tensor:
    """``_stack_loss_state``'s loss, for a stack whose layers keep no
    state."""
    return _stack_loss_state(conf, params, {}, x, y, train=train,
                              label_mask=label_mask)[0]


def _build_train_step(conf, tx):
    """``step(params, state, opt_state, x, y, label_mask) -> (loss,
    new_state, gstats)``: one SGD-path training step that updates
    ``params`` and ``opt_state`` in place.  Port of the reference's
    ``_build_train_step`` without its sparse-embedding, precision and
    tBPTT-carry branches."""
    refuse_unported_training(conf, conf.layers)
    gn_mode = conf.defaults.get("gradient_normalization")
    gn_thr = float(conf.defaults.get("gradient_normalization_threshold",
                                     1.0))
    confs = _layer_confs(conf)

    def step(params, state, opt_state, x, y, label_mask):
        # constraints are checked before anything moves: the reference
        # applies them after the update, and they are not ported
        apply_constraints_all(params, confs)
        loss, new_state = _stack_loss_state(conf, params, state, x, y,
                                            train=True,
                                            label_mask=label_mask)
        gstats = backward_and_update(loss, params, opt_state, tx, confs,
                                     gn_mode, gn_thr)
        return loss.detach(), new_state, gstats

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


class MultiLayerNetwork(Network):
    """``MultiLayerNetwork(conf, device="cuda").init()``, then ``fit``,
    ``output`` and ``score``."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        super().__init__(conf, device)
        self.layer_confs = conf.layers
        self._id_layer = None

    def _layers(self):
        return [(f"layer_{i}", lc, self.conf.layer_input_types[i])
                for i, lc in enumerate(self.layer_confs)]

    def _hyper_confs(self):
        return _layer_confs(self.conf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.params:
            raise RuntimeError("network has no params: call init() or "
                               "load_params() first")
        h = x
        for key, lc, _ in self._layers():
            h, _ = lc.forward(self.params[key], self.state.get(key, {}), h)
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
        one = (data, labels, mask, label_mask) if labels is not None \
            else None
        return self._fit_epochs(batch_factory(data, one, _normalize_batch),
                                epochs)

    def _fit_one(self, x, y, m, lm) -> torch.Tensor:
        """One train step; returns (and keeps in ``_score``) the loss as a
        device scalar, without waiting for the device."""
        self._validate_input_ids(x)
        if m is not None:
            raise NotImplementedError(
                "features masks in training are not ported yet")
        self.last_batch_size = int(getattr(x, "shape", (0,))[0])
        if self._step is None:
            if self.opt_state is None:
                self._init_updater()
            self._step = _build_train_step(self.conf, self._tx)
        loss, self.state, gstats = self._step(
            self._param_tree(), self.state, self.opt_state,
            self._on_device(x), self._on_device(y), self._on_device(lm))
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
            loss, _ = _stack_loss_state(self.conf, self.params, self.state,
                                        self._on_device(x),
                                        self._on_device(y), train=False)
        return float(loss)
