"""Sequential network (port of ``nn/multilayer.py``): init, output, the
loss, the train step, fit and score, tBPTT and streaming (``rnn_time_step``).

The forward is a plain Python loop over the layers.  The JAX package
runs identical repeated blocks under ``lax.scan``; PyTorch runs eagerly
and needs no such fold.  Parameters live in one ``nn.ParameterDict`` per
layer, keyed ``layer_i`` and named as in the JAX package, so a JAX
checkpoint maps onto them one to one.  Layer state (BatchNormalization's
running statistics) lives in ``state``; every layer runs through
``forward(params, state, x, train, mask)`` and each training step replaces
``state`` with the new one it returns (a captured step writes it into
``state``'s own tensors).  A ``[b, t]`` features mask goes
through the stack, each layer handing the next ``feed_forward_mask`` of
it; the loss's label mask defaults to the mask that reaches the output
layer.  Where the configuration has a preprocessor at layer i (the
reshape the JAX package inserts where layer families change), it runs
before the layer.

Dropout draws from the JAX package's threefry stream (``utils/_random``)
as the JAX package does: the network keeps ``_rng = PRNGKey(seed)``,
each training step (and ``output``/``feed_forward`` with ``train=True``)
splits it into the next ``_rng`` and the step's key, and layer i draws
from ``fold_in(key, i)``.

Recurrent layers carry state across calls as ``carries`` (``{layer_i:
carry}``): ``rnn_time_step`` keeps them between calls (reference
``rnnTimeStep``), and tBPTT (``backprop_type="tbptt"``) carries them from
one ``tbptt_fwd_length`` chunk of a sequence to the next with gradients
stopped at the boundary.  Attention stacks carry their KV cache and
stream position the same way.  ``generation_program`` hands the
generation engine its two programs, paged prefill and paged decode, as
plain functions over this configuration.

Training (``fit``) takes the JAX package's SGD path: forward to the
output layer's loss plus l1/l2, gradients by autograd (through the
kernels' autograd functions on CUDA), gradient normalization, then the
hand-written updater arithmetic of ``nn/conf/updaters.py``, then the
layers' constraints.  The step leaves the loss on the device:
``score()``/``get_score()`` materialise it on demand.  The step is the
shared one of the configuration's signature (``nn/compile_cache``); on a
CUDA device a plain step is one CUDA graph per input shapes
(``train_route``: tBPTT, loss-scaled, data-parallel and sparse-embedding
steps, ``fit_on_device`` and pretraining stay eager, ``EAGER_ROUTES``
says why), and ``fit`` runs at most ``DL4J_TPU_DISPATCH_DEPTH`` steps
ahead of the card (``nn/dispatch``).  Listeners fire at
the JAX package's points (``iteration_done`` after each step and tBPTT
chunk, ``on_epoch_start``/``on_epoch_end`` around ``fit``'s epochs);
``fit_on_device`` keeps the dataset on the device.

A precision policy (``nn/precision``) runs the step below f32: floating
inputs are cast to the compute dtype (integer ids never are), each
layer's activation and params to that layer's dtype (``layer_dtype``:
overrides, ``keep_f32`` classes), the params inside the autograd graph so
the gradients land on the f32 masters; the loss reductions run f32; a
loss scale multiplies the objective, and an overflow skips the step
(``_common.backward_and_update``, ``finish_precision_step``) and hands
the next tBPTT chunk its pre-step carries.  ``cache_mode("remat")``
checkpoints each layer (``torch.utils.checkpoint``): the backward replays
its forward, dropout from the same key.  ``optimization_algo`` other than
sgd trains through the legacy full-batch solvers (``train/solvers.py``).
A first-layer embedding with ``sparse_grad=True`` trains in row space
(``nn/sparse``).  ``pretrain``/``pretrain_layer`` train the pretrainable
layers (AutoEncoder, RBM, VAE) greedily, each on the features of the
layers below it, with its own updater (``_build_pretrain_step``).  Under a data-parallel wrapper the step is one rank's
(``parallel/exchange``).  The shape policy's padding is not ported.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import _random
from . import precision as _precision
from .compile_cache import (InstrumentedJit, StepGraphs, shared_jit,
                            topology_signature)
from ._common import (Network, UpdaterGroups, aux_term, backward_and_update,
                      batch_factory, cast_act, cast_params,
                      carry_thread_context, exchange_fetch,
                      finish_precision_step, fit_on_device_epochs,
                      hyperparam_conf, layer_scope, objective,
                      precision_cast_map, regularization)
from . import sparse as _sparse
from .conf.multi_layer import MultiLayerConfiguration
from .layers.base import draws

_SGD = ("sgd", "stochastic_gradient_descent")

# the steps that stay eager on a CUDA device, each with its reason
EAGER_ROUTES = {
    "device": "not on a CUDA device: a CUDA graph needs one",
    "tbptt": "tBPTT chunks carry the recurrent state from chunk to chunk "
             "of one batch; not captured yet (ROADMAP item 2)",
    "loss_scale": "a loss-scaled precision policy reads bool(finite) on the "
                  "host to skip an overflowed update",
    "exchange": "a data-parallel step runs collectives over the ranks' "
                "process group; not captured yet (ROADMAP item 2)",
    "sparse": "a sparse-embedding step coalesces its touched rows, a "
              "data-dependent shape",
    "fit_on_device": "fit_on_device steps with an explicit key each; its "
                     "epoch program is not captured yet (ROADMAP item 2)",
    "pretrain": "pretraining's steps are not captured yet (ROADMAP item 2)",
}


def _layer_confs(conf) -> Dict[str, Any]:
    return {f"layer_{i}": lc for i, lc in enumerate(conf.layers)}


def _layer_key(key, i: int, lc):
    """Layer i's key, ``fold_in(key, i)``, where the layer draws."""
    return None if key is None or not draws(lc) \
        else _random.fold_in(key, i)


def _preprocess(conf, i: int, h, mask):
    """Layer i's preprocessor (if any) on ``h`` and the mask."""
    pp = conf.preprocessor(i)
    if pp is None:
        return h, mask
    h = pp.pre_process(h, mask)
    if mask is not None:
        mask = pp.feed_forward_mask(mask, conf.layer_input_types[i])
    return h, mask


def _layer_forward(lc, params, state, h, key, mask, role=None):
    """One layer's training forward, the unit ``cache_mode("remat")``
    checkpoints."""
    return _forward_of(lc, role)(params, state, h, train=True, key=key,
                                 mask=mask)


def _forward_of(lc, role):
    """``lc.forward``, or ``role``: the forward a tensor-parallel step's
    exchange gives the layer (``parallel/exchange``'s ``roles``)."""
    if role is None:
        return lc.forward
    return lambda *a, **kw: role(lc, *a, **kw)


def _stack_forward(conf, params, state, x, *, train: bool, mask=None,
                   to_layer: Optional[int] = None,
                   carries: Optional[Dict[str, Any]] = None, key=None,
                   collect: bool = False, precision=None, roles=None,
                   fetch=None) -> Tuple[Any, Dict, Optional[torch.Tensor]]:
    """The layers ``[0, to_layer)`` (all by default); returns ``(h,
    new_state, mask)`` with the mask as the next layer would see it (with
    ``collect``, ``h`` is the list of every layer's activation).  Layer i
    draws its dropout from ``fold_in(key, i)``.  ``carries``
    (``{layer_i: carry}``), when given, runs every layer with
    ``HAS_CARRY`` from its carry (a zero one where it has none) and is
    updated in place with the carries it ends with.  ``precision`` (the
    train step's resolved policy) casts each layer's input to its compute
    dtype; in training under ``cache_mode("remat")`` every layer without
    a carry runs checkpointed.  ``roles`` (``{layer_i: forward}``, a
    tensor-parallel exchange's) replace those layers' own forward.
    ``fetch(layer_i, params)`` (a ZeRO-3 step's, ``layer_scope``) gives
    each layer the params it computes with, for its forward only."""
    layers = conf.layers
    n = len(layers) if to_layer is None else to_layer
    remat = train and conf.defaults.get("cache_mode") == "remat"
    new_state = dict(state)
    h = x
    acts = []
    for i in range(n):
        lc, name = layers[i], f"layer_{i}"
        h, mask = _preprocess(conf, i, h, mask)
        if precision is not None:
            h = cast_act(h, precision.layer_dtype(lc))
        lkey = _layer_key(key, i, lc)
        role = roles.get(name) if roles else None
        with layer_scope(fetch, name, params[name]) as lp:
            if carries is not None and lc.HAS_CARRY:
                h, carries[name] = lc.apply_with_carry(
                    lp, h, carries.get(name), train=train, key=lkey,
                    mask=mask)
            elif remat:
                # the layers draw from explicit keys, never from torch's
                # generators: no generator state to stash (a stash reads
                # it on the host, which a captured step cannot)
                h, new_state[name] = checkpoint(
                    carry_thread_context(_layer_forward), lc, lp,
                    state.get(name, {}), h, lkey, mask, role,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                h, new_state[name] = _forward_of(lc, role)(
                    lp, state.get(name, {}), h, train=train, key=lkey,
                    mask=mask)
        del lp
        if mask is not None:
            mask = lc.feed_forward_mask(mask, None)
        if collect:
            acts.append(h)
    return (acts if collect else h), new_state, mask


def _stack_loss_state(conf, params, state, x, y, *, train: bool, mask=None,
                      label_mask=None, carries=None, key=None,
                      precision=None, roles=None, fetch=None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Forward to the last layer's loss, plus regularization (reference
    ``computeGradientAndScore``); returns ``(loss, new_state)``.  A free
    function over the configuration, a ``{layer_i: {name: tensor}}``
    params mapping and the layers' state.  ``fetch``: as
    ``_stack_forward``'s, for the output layer and the l1/l2 terms too."""
    layers = conf.layers
    n = len(layers)
    h, new_state, pmask = _stack_forward(conf, params, state, x, train=train,
                                         mask=mask, to_layer=n - 1,
                                         carries=carries, key=key,
                                         precision=precision, roles=roles,
                                         fetch=fetch)
    out_conf = layers[-1]
    if not hasattr(out_conf, "compute_loss"):
        raise ValueError(
            f"last layer '{out_conf.name}' is not an output layer")
    # the preprocessor sees the features mask, as the reference's
    h, _ = _preprocess(conf, n - 1, h, None)
    if precision is not None:
        # the head's product runs in the compute dtype; the loss
        # reductions widen to f32 inside nn/losses
        h = cast_act(h, precision.layer_dtype(out_conf))
    # the label mask defaults to the PROPAGATED features mask (reference
    # per-step masking when labelsMask is absent; LastTimeStep or global
    # pooling consumes the time axis and nulls it)
    lm = label_mask if label_mask is not None else pmask
    name = f"layer_{n - 1}"
    with layer_scope(fetch, name, params[name]) as lp:
        loss = out_conf.compute_loss(lp, h, y, train=train,
                                     key=_layer_key(key, n - 1, out_conf),
                                     mask=lm)
    del lp
    reg = torch.zeros((), dtype=loss.dtype, device=loss.device)
    shares = []
    for i, lc in enumerate(layers):
        lp = params[f"layer_{i}"]
        if lp:
            reg = reg + regularization(fetch, f"layer_{i}", lc, lp)
        if getattr(lc, "AUX_LOSS", False):
            # a mixture-of-experts layer's load-balancing term (its state)
            aux = new_state.get(f"layer_{i}", {}).get("aux_loss")
            if aux is not None:
                reg = aux_term(reg, aux, shares)
    return objective(loss, reg, shares), new_state


def _stack_loss(conf, params, x, y, *, train: bool, mask=None,
                label_mask=None, key=None) -> torch.Tensor:
    """``_stack_loss_state``'s loss, for a stack whose layers keep no
    state."""
    return _stack_loss_state(conf, params, {}, x, y, train=train, mask=mask,
                              label_mask=label_mask, key=key)[0]


def _detached(carries: Dict[str, Any]) -> Dict[str, Any]:
    return {k: {n: t.detach() for n, t in c.items()}
            for k, c in carries.items()}


def _build_train_step(conf, tx, exchange=None):
    """``step(params, state, opt_state, x, y, mask, label_mask, carries=None,
    key=None, rng=None, staged=False) -> (loss, new_state, gstats,
    new_carries)``: one SGD-path training step that updates ``params`` and
    ``opt_state`` in place, drawing dropout from ``key`` (the caller's
    split of the network's stream) or, given the network's key buffer
    ``rng``, from the key it splits off first (``rng, key = split(rng)``,
    the new stream written into ``rng`` in place, as the JAX step's first
    traced op).  With ``carries`` (tBPTT) the recurrent layers start from
    them, gradients stopped at the chunk boundary, and the step returns
    the carries it ends with (its input carries when an overflow skipped
    it).  Port of the reference's ``_build_train_step``.

    ``staged=True``: the caller staged the updater's scalars before the
    step and advances its counts after it (``UpdaterGroups.stage`` and
    ``advance``), so the step itself makes no host read and no host
    write, which a captured CUDA graph needs; otherwise the update runs
    whole (``UpdaterGroups.step``).  Both run the same arithmetic.

    A first-layer embedding with ``sparse_grad=True`` trains in row space
    (``nn/sparse``): the table is substituted by the touched rows, its
    gradient is their coalesced block, and the lazy updater writes back
    only those rows and their slots.

    ``exchange`` (a ``parallel/exchange.GradientExchange``) makes this the
    step of one data-parallel rank: the forward runs in the global-batch
    context (global loss denominators, batch statistics and dropout
    rows), ZeRO-3 leaves are all-gathered first, the gradients are summed
    over the ranks before anything reads them, and the returned loss is
    the global one."""
    gn_mode = conf.defaults.get("gradient_normalization")
    gn_thr = float(conf.defaults.get("gradient_normalization_threshold",
                                     1.0))
    pol = _precision.resolve(conf.defaults)
    confs = _layer_confs(conf)
    cast_map = precision_cast_map(pol, confs)
    sparse_emb = _sparse.sparse_embedding_conf(conf)
    skip = ()
    if sparse_emb is not None and exchange is not None:
        exchange.rowspace = {_sparse.TABLE}
        skip = (_sparse.TABLE,)

    def step(params, state, opt_state, x, y, mask, label_mask,
             carries=None, key=None, rng=None, staged=False):
        if rng is not None:
            new_rng, key = _random.split(rng)
            rng.copy_(new_rng)
        # carry state flows INTO the chunk; gradients do not flow back
        # across the chunk boundary (tBPTT truncation)
        cs = None if carries is None else _detached(carries)
        fetch = None
        if exchange is not None:
            params = exchange.gather(params, skip)
            fetch = exchange_fetch(exchange, cast_map)
        if pol is not None:
            # floating inputs only: integer ids reach the embedding exact
            x = cast_act(x, pol.compute_dtype)
        ctx = None
        upd = tx.applier() if staged else tx
        params_in, params_fwd, x_in = params, params, x
        if sparse_emb is not None:
            # the table's leaf is the touched rows; the forward reads
            # them with a zero trash row after them, which the ids of
            # fill slots address
            ctx = _row_context(sparse_emb, params, x, exchange)
            params_in = _with_table(params, ctx.rows)
            params_fwd = _with_table(params, ctx.rows_ext)
            x_in = ctx.x_sub
            upd = ctx.updater(upd)
        ls = state.get(_precision.SCALE_STATE_KEY) \
            if pol is not None and pol.scaled else None
        with (nullcontext() if exchange is None
              else exchange.batch(int(x.shape[0]))):
            loss, new_state = _stack_loss_state(
                conf, params_fwd if fetch else cast_params(params_fwd,
                                                           cast_map),
                state, x_in, y, train=True, mask=mask,
                label_mask=label_mask, carries=cs, key=key, precision=pol,
                roles=None if exchange is None else exchange.roles,
                fetch=fetch)
            # the whole backward sees the scaled loss; the reported loss
            # stays unscaled
            obj = loss * ls["scale"] if ls is not None else loss
            gstats, updated = backward_and_update(
                obj, params_in, opt_state, upd, confs, gn_mode, gn_thr,
                scale=None if ls is None else ls["scale"],
                exchange=exchange)
        if ctx is not None:
            gstats["embedding_rows_touched"] = ctx.touched()
        new_state = finish_precision_step(pol, state, new_state, gstats,
                                          updated)
        if cs is not None:
            # a skipped chunk hands the next one its pre-step carries: the
            # overflowed forward poisoned the ones it made
            cs = _detached(cs if updated else carries)
        loss = loss.detach()
        if exchange is not None:
            loss = exchange.total(loss)
        return loss, new_state, gstats, cs

    return step


def _build_pretrain_step(conf, tx, i: int):
    """``step(params, state, opt_state, x, key) -> loss``: one pretraining
    step of layer ``i`` (JAX ``_build_pretrain_step``).  The layers below
    run in inference mode without gradients; layer i's ``pretrain_loss``
    draws from ``key`` and its gradient steps layer i's params in place
    through ``tx`` (the updater of that layer alone)."""
    lc = conf.layers[i]
    name = f"layer_{i}"

    def step(params, state, opt_state, x, key):
        feats = x
        if i > 0:
            with torch.no_grad():
                feats = _stack_forward(conf, params, state, x, train=False,
                                       to_layer=i)[0]
        group = params[name]
        loss = lc.pretrain_loss(group, feats, key=key, train=True)
        names = list(group)
        grads = torch.autograd.grad(loss, [group[n] for n in names])
        tx.step({name: group}, {name: dict(zip(names, grads))}, opt_state)
        return loss.detach()

    return step


def _row_context(lc, params, x, exchange) -> "_sparse.RowContext":
    """The sparse step's touched-row workspace for this batch."""
    ids = lc.decode_ids(x)
    if ids is None:
        # never a silent dense fallback
        raise ValueError(
            f"layer '{lc.name}': sparse_grad=True needs an integer id "
            f"batch for the densified pre-pass, but this input (shape "
            f"{tuple(x.shape)}, dtype {x.dtype}) rides the one-hot path — "
            "feed ids (argmax the one-hots upstream), or drop sparse_grad")
    table = params["layer_0"]["W"]
    pdim = odim = None
    shape = list(table.shape)
    if exchange is not None:
        pdim = exchange.param_plan.get("layer_0", {}).get("W")
        odim = exchange.odim("layer_0", "W")
        if pdim is not None:
            shape[pdim] *= exchange.dp
    others = {k: {n: p for n, p in g.items()
                  if (k, n) != _sparse.TABLE} for k, g in params.items()}
    others["layer_0"]["W"] = torch.empty(shape, device="meta")
    if not _sparse.table_is_unambiguous(others, shape):
        raise ValueError(
            f"layer '{lc.name}': another parameter leaf shares the table's "
            f"exact shape {tuple(shape)} — the row-space mirror walk is "
            "shape-keyed and cannot disambiguate the updater mirrors; "
            "resize/split the twin parameter or drop sparse_grad")
    return _sparse.RowContext(table, ids, lc.sparse_grad_capacity, exchange,
                              pdim, odim)


def _with_table(params, table):
    """``params`` with the sparse embedding's table replaced."""
    lk, pn = _sparse.TABLE
    return {**params, lk: {**params[lk], pn: table}}


def _write_state(state, new_state, strict: bool) -> None:
    """``new_state``'s leaves written into ``state``'s own tensors, in
    place, where a leaf of that shape and dtype exists; otherwise set.
    ``strict`` (during a capture) raises instead of setting: the graph
    reads the state's tensors where they were at capture."""
    for k, group in new_state.items():
        old = state.get(k)
        if not isinstance(group, dict) or not isinstance(old, dict):
            if strict and group is not old:
                raise RuntimeError(f"captured step: state '{k}' is not a "
                                   "group of tensors the step can write")
            state[k] = group
            continue
        for n, t in group.items():
            o = old.get(n)
            if o is t:
                continue
            if isinstance(o, torch.Tensor) and isinstance(t, torch.Tensor) \
                    and o.shape == t.shape and o.dtype == t.dtype:
                o.copy_(t)
            elif strict:
                raise RuntimeError(
                    f"captured step: state '{k}/{n}' changed its shape or "
                    "dtype, so the step cannot write it in place")
            else:
                old[n] = t


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
    ``output``, ``score`` and ``rnn_time_step``."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        super().__init__(conf, device)
        self.layer_confs = conf.layers
        self._id_layer = None
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._rnn_carry_batch = -1
        self._gen_programs: Dict[str, Any] = {}
        # the captured train steps (CUDA only), and how the latest step ran
        self._graphs: Optional[StepGraphs] = None
        self.last_route: Optional[str] = None

    def topology_sig(self) -> str:
        """Value signature of the layer stack: equal for two networks
        that differ only in their weights (a hot swap keeps the
        generation cache when it is equal)."""
        return repr((type(self).__name__, self.conf.layers))

    def generation_program(self, kind: str):
        """``"paged_prefill"`` or ``"paged_decode"`` over this network's
        configuration (``generation/programs.build_generation_fn``): the
        counterpart of the reference's ``_get_jitted`` for these kinds.
        Built once per network; the port runs them eagerly."""
        fn = self._gen_programs.get(kind)
        if fn is None:
            from ..generation.programs import build_generation_fn
            fn = self._gen_programs[kind] = build_generation_fn(self.conf,
                                                                kind)
        return fn

    def _layers(self):
        return [(f"layer_{i}", lc, self.conf.layer_input_types[i])
                for i, lc in enumerate(self.layer_confs)]

    def _hyper_confs(self):
        return _layer_confs(self.conf)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Activations of the last layer; ``train=True`` keeps dropout on
        with a fresh key from the network's stream."""
        if not self.params:
            raise RuntimeError("network has no params: call init() or "
                               "load_params() first")
        return _stack_forward(self.conf, self.params, self.state, x,
                              train=train,
                              key=self._next_key() if train else None)[0]

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

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Forward on a batch (numpy array or tensor); the result stays on
        the network's device.  ``train=True`` draws dropout as training
        does and advances the network's key stream."""
        self._validate_input_ids(x)
        with torch.inference_mode():
            return self(self._on_device(x), train=train)

    def feed_forward(self, x, train: bool = False):
        """Every layer's activation (reference ``feedForward``);
        ``train=True`` keeps dropout on with a fresh key."""
        self._validate_input_ids(x)
        with torch.inference_mode():
            return _stack_forward(
                self.conf, self.params, self.state, self._on_device(x),
                train=train, key=self._next_key() if train else None,
                collect=True)[0]

    # ------------------------------------------------------------ training
    def fit(self, data=None, labels=None, *, epochs: int = 1, mask=None,
            label_mask=None, checkpoint=None,
            resume_from=None) -> "MultiLayerNetwork":
        """Train.  ``data`` may be ``(x, y)`` arrays (or ``x`` with
        ``labels``), a ``DataSet``, or an iterable of batches with an
        optional ``reset()`` (the DataSetIterator role).  A 3-D batch
        longer than ``tbptt_fwd_length`` trains by tBPTT when the
        configuration asks for it.

        ``checkpoint``: a ``faulttolerance.CheckpointConfig`` — periodic
        crash-consistent saves (params + updater + key + data cursor),
        optionally with a SIGTERM save-on-preempt hook.  ``resume_from``:
        a checkpoint directory / store / ``CheckpointManager`` — restores
        the full training state and resumes mid-epoch at the saved batch
        cursor, reproducing the uninterrupted run (checkpointing leaves
        the key stream alone, so runs with and without it are equal)."""
        one = (data, labels, mask, label_mask) if labels is not None \
            else None
        factory = batch_factory(data, one, _normalize_batch)
        algo = self.conf.defaults.get("optimization_algo", "sgd")
        if algo not in _SGD:
            if checkpoint is not None or resume_from is not None:
                raise ValueError(
                    "checkpoint=/resume_from= are only supported on the SGD "
                    f"path; optimization_algo='{algo}' routes through the "
                    "legacy solvers")
            return self._fit_solver(algo, factory, epochs)
        return self._fit_epochs(factory, epochs, checkpoint, resume_from)

    def _fit_solver(self, algo: str, factory, epochs: int
                    ) -> "MultiLayerNetwork":
        """``fit`` through a legacy full-batch solver (reference Solver
        -> LBFGS / CG / line search): each batch is optimized for up to
        ``max_iterations`` iterations."""
        from ..train.solvers import Solver
        if not self.params:
            self.init()
        solver = Solver(self, algo, max_iterations=int(
            self.conf.defaults.get("max_iterations", 100)))
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self)
            for x, y, m, lm in factory():
                self.last_batch_size = int(getattr(x, "shape", (0,))[0])
                solver.optimize(x, y, mask=m, label_mask=lm)
            for lst in self.listeners:
                lst.on_epoch_end(self)
            self.epoch += 1
        return self

    def _fit_step(self, x, y, m, lm) -> None:
        if self.conf.backprop_type == "tbptt" and \
                getattr(x, "ndim", 2) == 3 and \
                x.shape[1] > self.conf.tbptt_fwd_length:
            self._fit_tbptt(x, y, m, lm)
        else:
            self._fit_one(x, y, m, lm)

    def _train_step(self):
        """The network's train step: the shared step of its signature
        (``nn/compile_cache.shared_jit``), or, under a data-parallel
        exchange, a step of its own (it holds the exchange)."""
        if self._step is None:
            if self.opt_state is None:
                self._init_updater()
            conf, tx, ex = self.conf, self._tx, self._exchange

            def build():
                return _build_train_step(conf, tx, ex)
            if ex is not None:
                self._step = InstrumentedJit(build(), "train_step")
            else:
                self._step = shared_jit(
                    (type(self).__name__, topology_signature(conf),
                     "train_step"), build, name="train_step")
        return self._step

    def train_route(self) -> Tuple[str, str]:
        """How ``fit`` runs a plain step here: ``("captured", "")`` (one
        CUDA graph per input shapes, ``nn/compile_cache.StepGraphs``) or
        ``("eager", reason)``.  tBPTT chunks, ``fit_on_device`` and
        pretraining run eagerly too (``EAGER_ROUTES``)."""
        if self.device.type != "cuda":
            return "eager", EAGER_ROUTES["device"]
        if self._exchange is not None:
            return "eager", EAGER_ROUTES["exchange"]
        pol = _precision.resolve(self.conf.defaults)
        if pol is not None and pol.scaled:
            return "eager", EAGER_ROUTES["loss_scale"]
        if _sparse.sparse_embedding_conf(self.conf) is not None:
            return "eager", EAGER_ROUTES["sparse"]
        return "captured", ""

    def _fit_one(self, x, y, m, lm) -> torch.Tensor:
        """One train step; returns (and keeps in ``_score``) the loss as a
        device scalar, without waiting for the device."""
        self._validate_input_ids(x)
        self.last_batch_size = int(getattr(x, "shape", (0,))[0])
        step = self._train_step()
        inputs = (self._on_device(x), self._on_device(y),
                  self._on_device(m), self._on_device(lm))
        route, reason = self.train_route()
        if route == "captured":
            loss, gstats = self._captured_step(step, inputs)
            self.last_route = route
        else:
            loss, self.state, gstats, _ = step(
                self._param_tree(), self.state, self.opt_state, *inputs,
                None, None, self._rng)
            self._last_step_compiled = getattr(step, "last_call_traced",
                                               False)
            self.last_route = f"eager: {reason}"
        self._score = loss
        self._last_grad_stats = gstats
        self.iteration += 1
        self._iteration_done()
        return loss

    def _captured_step(self, step: InstrumentedJit, inputs):
        """One step through the network's CUDA graphs: the updater's
        scalars staged on the host, the graph of these input shapes
        replayed (built at need), the updater's counts advanced.  The
        step writes the layer state into ``state``'s own tensors, which
        the graph reads back at the next replay."""
        tx = self._tx
        tx.stage(self.opt_state, self.device)
        if self._graphs is None:
            self._graphs = StepGraphs()

        def body(x, y, m, lm):
            # the step differentiates fresh leaves over the params'
            # storage: an autograd graph still alive from an earlier
            # computation on another stream holds the params' own
            # accumulators, and reaching one would join that stream into
            # the capture
            params = {k: {n: p.detach().requires_grad_(p.requires_grad)
                          for n, p in g.items()}
                      for k, g in self.params.items()}
            loss, new_state, gstats, _ = step.fn(
                params, self.state, self.opt_state, x, y, m, lm, None, None,
                self._rng, staged=True)
            _write_state(self.state, new_state,
                         strict=torch.cuda.is_current_stream_capturing())
            return loss, gstats

        def reads():
            out = [p for g in self.params.values() for p in g.values()]
            out += [t for g in self.opt_state["slots"].values()
                    for sl in g.values() for t in sl.values()]
            out += [t for g in self.state.values() if isinstance(g, dict)
                    for t in g.values() if isinstance(t, torch.Tensor)]
            return out + [self._rng, self.opt_state["scalars"]]
        (loss, gstats), built = self._graphs.run(step, body, inputs, reads)
        tx.advance(self.opt_state)
        self._last_step_compiled = built
        return loss, gstats

    def _device_step(self, xs, ys, key) -> torch.Tensor:
        """One train step on a minibatch already on the device, drawing
        from ``key`` (``fit_on_device``'s step); returns the loss."""
        loss, self.state, self._last_grad_stats, _ = self._train_step()(
            self._param_tree(), self.state, self.opt_state, xs[0], ys[0],
            None, None, None, key)
        self.last_route = f"eager: {EAGER_ROUTES['fit_on_device']}"
        return loss

    def fit_on_device(self, x, y, *, batch_size: int, epochs: int = 1,
                      shuffle: bool = True, checkpoint=None,
                      resume_from=None) -> "MultiLayerNetwork":
        """Device-resident epoch training (JAX ``fit_on_device``): the
        dataset moves to the device once and every step gathers its
        minibatch there; a ragged tail trains through ``fit``'s step, and
        listeners fire once per epoch.  The permutations and keys are the
        JAX package's (``nn/_common.fit_on_device_epochs``).
        ``checkpoint``/``resume_from``: epoch-boundary checkpoints and
        epoch-granular resume."""
        if not self.params:
            self.init()
        if self.conf.backprop_type == "tbptt":
            raise ValueError(
                "fit_on_device does not support tBPTT (the scanned step has "
                "no carry truncation); use fit()")
        algo = self.conf.defaults.get("optimization_algo", "sgd")
        if algo not in (None, *_SGD):
            raise ValueError(
                f"fit_on_device requires the SGD path; optimization_algo="
                f"'{algo}' routes through the legacy solvers — use fit()")
        self._validate_input_ids(x)
        ckpt = None
        if checkpoint is not None or resume_from is not None:
            from ..faulttolerance.checkpoint import FitCheckpointer
            ckpt = FitCheckpointer(self, checkpoint, resume_from)
        return fit_on_device_epochs(
            self, [self._on_device(x)], [self._on_device(y)], batch_size,
            epochs, shuffle,
            fit_tail=lambda xt, yt: self._fit_one(xt[0], yt[0], None, None),
            ckpt=ckpt)

    def _fit_tbptt(self, x, y, mask, label_mask) -> None:
        """Truncated BPTT (reference ``doTruncatedBPTT``): the time axis in
        ``tbptt_fwd_length`` chunks, one update each; recurrent state
        carries across chunk boundaries with gradients stopped there, so
        the backward window is the forward chunk (``tbptt_back_length``
        is accepted for configuration parity)."""
        self._validate_input_ids(x)
        self.last_batch_size = int(x.shape[0])
        step = self._train_step()
        L = self.conf.tbptt_fwd_length
        carries = self._init_carries(int(x.shape[0]))
        x, y = self._on_device(x), self._on_device(y)
        mask, label_mask = self._on_device(mask), self._on_device(label_mask)
        for t0 in range(0, x.shape[1], L):
            sl = slice(t0, t0 + L)
            loss, self.state, gstats, carries = step(
                self._param_tree(), self.state, self.opt_state, x[:, sl],
                y[:, sl] if y.ndim == 3 else y,
                None if mask is None else mask[:, sl],
                None if label_mask is None else label_mask[:, sl], carries,
                self._next_key())
            self._score = loss
            self._last_grad_stats = gstats
            self.iteration += 1
            self._iteration_done()
        self.last_route = f"eager: {EAGER_ROUTES['tbptt']}"

    def _init_carries(self, batch: int) -> Dict[str, Any]:
        """Zero carries (f32) for every layer with ``HAS_CARRY``, keyed
        ``layer_i``."""
        return {f"layer_{i}": lc.init_carry(batch, torch.float32,
                                            self.device)
                for i, lc in enumerate(self.layer_confs) if lc.HAS_CARRY}

    def fit_batch(self, batch) -> float:
        """One train step on one batch, without epoch bookkeeping (the
        early-stopping trainer owns the epoch loop); returns its loss."""
        if not self.params:
            self.init()
        return float(self._fit_one(*_normalize_batch(batch)))

    _normalize_batch = staticmethod(_normalize_batch)

    def _eval_output(self, x) -> torch.Tensor:
        return self.output(x)

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

    # ----------------------------------------------------------- pretrain
    def pretrain(self, data, epochs: int = 1) -> "MultiLayerNetwork":
        """Greedy layerwise unsupervised pretraining (reference
        ``MultiLayerNetwork.pretrain(DataSetIterator)``): every
        ``PRETRAINABLE`` layer (AutoEncoder, RBM, VAE), in order, trains
        on the features of the layers below it."""
        if not self.params:
            self.init()
        for i, lc in enumerate(self.layer_confs):
            if getattr(lc, "PRETRAINABLE", False):
                self.pretrain_layer(i, data, epochs=epochs)
        return self

    def pretrain_layer(self, i: int, data, epochs: int = 1) -> None:
        """Pretrain layer ``i`` (reference ``pretrainLayer``), with its
        own updater (the network's where it has none) from fresh updater
        state.  Each step splits the network's key stream (``_rng, key
        = split(_rng)``), updates layer i's params in place and counts an
        iteration for the listeners; the prefix 0..i-1 runs in inference
        mode.  Afterwards the network's updater state starts afresh, as
        in the JAX package, so fine-tuning starts clean."""
        lc = self.layer_confs[i]
        if not getattr(lc, "PRETRAINABLE", False):
            return
        if not self.params:
            self.init()
        hc = hyperparam_conf(lc)
        updater = hc.updater if hc is not None and hc.updater is not None \
            else self._default_updater()
        name = f"layer_{i}"
        tx = UpdaterGroups({"default": updater},
                           {name: {n: "default" for n in self.params[name]}})
        params = self._param_tree()
        opt = tx.init({name: params[name]})
        step = _build_pretrain_step(self.conf, tx, i)
        if epochs > 1 and not hasattr(data, "shape") and \
                not isinstance(data, (tuple, list)) and \
                not hasattr(data, "features") and \
                not hasattr(data, "reset") and \
                hasattr(data, "__iter__") and iter(data) is data:
            # a bare generator: kept for the later epochs (a list is a
            # sequence of batches; only a tuple is one (x, y) pair)
            data = list(data)
        for _ in range(epochs):
            for batch in self._pretrain_batches(data):
                self._score = step(params, self.state, opt,
                                   self._on_device(batch), self._next_key())
                self.iteration += 1
                self._iteration_done()
        self.last_route = f"eager: {EAGER_ROUTES['pretrain']}"
        self._score = float(self._score)
        if self._tx is None:
            self._init_updater()
        else:
            self.opt_state = self._tx.init(self._param_tree())

    def _pretrain_batches(self, data):
        """The feature batches of ``data``: an array, an ``(x, y)`` tuple
        or a ``DataSet`` (one batch each), or an iterable of batches
        (reset first where it can be)."""
        if hasattr(data, "shape"):
            yield data
            return
        if isinstance(data, tuple) and len(data) in (2, 4):
            yield _normalize_batch(data)[0]
            return
        if hasattr(data, "features"):
            yield _normalize_batch(data)[0]
            return
        if hasattr(data, "reset"):
            data.reset()
        for b in data:
            yield b if hasattr(b, "shape") else _normalize_batch(b)[0]

    # ---------------------------------------------------- stateful RNN API
    def rnn_time_step(self, x) -> torch.Tensor:
        """Streaming inference with state kept across calls (reference
        ``rnnTimeStep``): x is ``[b, t, f]``, or ``[b, f]`` for one step
        (then the result is ``[b, n_out]``).  State persists until
        ``rnn_clear_previous_state``, or until the batch size changes."""
        from .layers.feedforward import EmbeddingSequenceLayer
        from .layers.recurrent import Bidirectional
        if any(isinstance(lc, Bidirectional) for lc in self.layer_confs):
            raise ValueError(
                "rnn_time_step does not support bidirectional layers — the "
                "backward pass needs the full sequence (reference throws "
                "likewise)")
        self._validate_input_ids(x)
        x = self._on_device(x)
        # [b, f] is one feature step, made [b, 1, f]; except for an
        # embedding-first network, whose 2-D input is ids [b, t]
        squeeze = x.ndim == 2 and not (
            self.layer_confs and
            isinstance(self.layer_confs[0], EmbeddingSequenceLayer))
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None or self._rnn_carry_batch != x.shape[0]:
            self._rnn_carries = self._init_carries(int(x.shape[0]))
            self._rnn_carry_batch = int(x.shape[0])
        with torch.inference_mode():
            y = _stack_forward(self.conf, self.params, self.state, x,
                               train=False, carries=self._rnn_carries)[0]
        return y[:, 0] if squeeze and y.ndim == 3 else y

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None
        self._rnn_carry_batch = -1

    def rnn_get_previous_state(self, layer: int):
        c = self._rnn_carries
        return None if c is None else c.get(f"layer_{layer}")

    def rnn_set_previous_state(self, layer: int, state) -> None:
        if self._rnn_carries is None:
            raise ValueError("no rnn state yet — call rnn_time_step first")
        self._rnn_carries[f"layer_{layer}"] = state
