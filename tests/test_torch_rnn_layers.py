"""The port's recurrent stack against the JAX package: each recurrent layer
and wrapper on the same params (masked and unmasked), networks read from
the JAX package's configuration JSON with its params carried across by
``params_from_jax``: ``output``, streaming ``rnn_time_step``, feature-
masked training, tBPTT, and a ``Bidirectional`` checkpoint round trip
through ``load_reference_model`` and ``updater_state_from_jax``.

Inputs and params come from numpy seeds and are f32 on both sides.  The
JAX tests run with x64 on, so its streaming and tBPTT carries are f64
where the port's are f32 (the product of an f64 carry with f32 weights is
f64 there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                   INDArrayDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers.base import flatten_group, nest_group
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, params_from_jax, updater_state_from_jax)

# Layers: f32 on both sides, the same formulas; the sums of the input and
# recurrent products (<= 8 terms of order 1) run in another order, a few
# f32 ulps per step through <= 7 steps: 2e-6 abs at outputs of order 1.
ATOL_LAYER = 2e-6
# Networks: two or three layers deep, and the JAX side's streaming and
# tBPTT carries are f64 (see above): 1e-5 abs on outputs, 1e-5 relative on
# losses.
ATOL_NET, RTOL_LOSS = 1e-5, 1e-5
# Params after a few Sgd steps of lr 0.05 (|g| <~ 1): the gradients agree
# to ~1e-6, each step moves a param by lr·|g|: 1e-6 abs.
ATOL_PARAMS = 1e-6

B, T, F, H = 3, 7, 4, 5


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mask(rng, b, t):
    """A non-contiguous mask: holes inside rows, a row with its last step
    masked, and one fully valid row."""
    m = (rng.random((b, t)) > 0.3).astype(np.float32)
    m[0, :] = 1.0
    m[1, -1] = 0.0
    return m


def _lstm_params(rng, f, h, peepholes=False):
    p = {"W": _randn(rng, f, 4 * h, scale=0.5),
         "U": _randn(rng, h, 4 * h, scale=0.5),
         "b": _randn(rng, 4 * h, scale=0.2)}
    if peepholes:
        p["p"] = _randn(rng, 3 * h, scale=0.3)
    return p


def _jax(layer, params, x, mask=None):
    y, _ = layer.apply({"params": jax.tree_util.tree_map(jnp.asarray,
                                                        params),
                        "state": {}}, jnp.asarray(x),
                       mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(y)


def _torch(layer, params, x, mask=None):
    tp = {k: torch.from_numpy(v) for k, v in flatten_group(params).items()}
    y, _ = layer.forward(tp, {}, torch.from_numpy(x),
                         mask=None if mask is None else torch.from_numpy(mask))
    return y.numpy()


LAYERS = {
    "simple_rnn": (lambda m: m.SimpleRnn(n_in=F, n_out=H, activation="tanh"),
                   lambda rng: {"W": _randn(rng, F, H, scale=0.5),
                                "U": _randn(rng, H, H, scale=0.5),
                                "b": _randn(rng, H, scale=0.2)}),
    "lstm": (lambda m: m.LSTM(n_in=F, n_out=H, activation="tanh"),
             lambda rng: _lstm_params(rng, F, H)),
    "graves_lstm": (lambda m: m.GravesLSTM(n_in=F, n_out=H,
                                           activation="tanh"),
                    lambda rng: _lstm_params(rng, F, H, peepholes=True)),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(LAYERS))
def test_recurrent_layer_matches_jax(name, masked):
    make, params = LAYERS[name]
    rng = np.random.default_rng(len(name) + masked)
    p = params(rng)
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T) if masked else None
    want = _jax(make(jrec), p, x, mask)
    got = _torch(make(trec), p, x, mask)
    np.testing.assert_allclose(got, want, atol=ATOL_LAYER, rtol=0)
    if masked:       # masked steps are zeroed
        assert np.all(got[mask == 0] == 0)


def test_unported_gate_activation_raises():
    """The name stays from the slices that refused ``hardsigmoid``: it is
    ported now (Keras's default LSTM ``recurrent_activation``), and an
    LSTM with hardsigmoid gates matches the JAX layer, masked or not,
    with ``helper="pallas"`` too (``pallas_lstm.supports`` refuses the
    cell, so it takes the plain loop)."""
    rng = np.random.default_rng(30)
    p = _lstm_params(rng, F, H)
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T)
    for m in (None, mask):
        want = _jax(jrec.LSTM(n_in=F, n_out=H, activation="tanh",
                              gate_activation="hardsigmoid"), p, x, m)
        for helper in (None, "pallas"):
            got = _torch(trec.LSTM(n_in=F, n_out=H, activation="tanh",
                                   gate_activation="hardsigmoid",
                                   helper=helper), p, x, m)
            np.testing.assert_allclose(got, want, atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("name", ["simple_rnn", "lstm", "graves_lstm"])
def test_carry_from_a_given_state_and_masked_steps_hold_it(name):
    make, params = LAYERS[name]
    rng = np.random.default_rng(40 + len(name))
    p = params(rng)
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T)
    jl, tl = make(jrec), make(trec)
    carry = {k: _randn(rng, B, H, scale=0.5) for k in
             jl.init_carry(B, jnp.float32)}
    jp = {"params": jax.tree_util.tree_map(jnp.asarray, p), "state": {}}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for m in (None, mask):
        jy, jc = jl.apply_with_carry(
            jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in carry.items()},
            mask=None if m is None else jnp.asarray(m))
        ty, tc = tl.apply_with_carry(
            tp, torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in carry.items()},
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=ATOL_LAYER, rtol=0)
        assert set(tc) == set(jc)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL_LAYER, rtol=0)
    # a row masked from step 2 on ends with the state after 2 steps
    m2 = np.ones((B, T), np.float32)
    m2[:, 2:] = 0.0
    _, held = tl.apply_with_carry(tp, torch.from_numpy(x),
                                  tl.init_carry(B, torch.float32, "cpu"),
                                  mask=torch.from_numpy(m2))
    _, two = tl.apply_with_carry(tp, torch.from_numpy(x[:, :2]),
                                 tl.init_carry(B, torch.float32, "cpu"))
    for k in two:
        torch.testing.assert_close(held[k], two[k], atol=1e-7, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_matches_jax(mode, masked):
    rng = np.random.default_rng(60 + len(mode) + masked)
    p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T) if masked else None

    def make(m):
        return m.Bidirectional(fwd=m.LSTM(n_in=F, n_out=H,
                                          activation="tanh"), mode=mode)
    want = _jax(make(jrec), p, x, mask)
    got = _torch(make(trec), p, x, mask)
    assert got.shape == (B, T, 2 * H if mode == "concat" else H)
    np.testing.assert_allclose(got, want, atol=ATOL_LAYER, rtol=0)
    layer = make(trec)
    assert layer.name == "bi_LSTM"
    assert layer.output_type(JInputType.recurrent(F, T)).size == \
        make(jrec).output_type(JInputType.recurrent(F, T)).size


def test_graves_bidirectional_lstm_matches_jax():
    rng = np.random.default_rng(70)
    p = {"fwd": _lstm_params(rng, F, H, True),
         "bwd": _lstm_params(rng, F, H, True)}
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T)
    jl = jrec.GravesBidirectionalLSTM(n_in=F, n_out=H)
    tl = trec.GravesBidirectionalLSTM(n_in=F, n_out=H)
    jl.fwd.activation = tl.fwd.activation = "tanh"
    assert tl.mode == "add" and isinstance(tl.fwd, trec.GravesLSTM)
    for m in (None, mask):
        np.testing.assert_allclose(_torch(tl, p, x, m), _jax(jl, p, x, m),
                                   atol=ATOL_LAYER, rtol=0)
    # the wrapper's params are the JAX nested group, held flat
    made = tl.init(torch.Generator().manual_seed(0), None, "cpu")
    assert sorted(made) == sorted(flatten_group(p))
    assert nest_group(made).keys() == {"fwd", "bwd"}


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    rng = np.random.default_rng(80 + masked)
    p = _lstm_params(rng, F, H)
    x = _randn(rng, B, T, F)
    mask = _mask(rng, B, T) if masked else None
    jl = jrec.LastTimeStep(underlying=jrec.LSTM(n_in=F, n_out=H,
                                                activation="tanh"))
    tl = trec.LastTimeStep(underlying=trec.LSTM(n_in=F, n_out=H,
                                                activation="tanh"))
    got = _torch(tl, p, x, mask)
    assert got.shape == (B, H)
    np.testing.assert_allclose(got, _jax(jl, p, x, mask), atol=ATOL_LAYER,
                               rtol=0)
    assert tl.feed_forward_mask(torch.ones(B, T), None) is None
    assert tl.HAS_CARRY
    assert tl.output_type(JInputType.recurrent(F, T)).kind == "ff"


# ----------------------------------------------------------------- networks
def _jax_net(layers, n_in, t, seed=7, updater=None, tbptt=None):
    b = (NeuralNetConfiguration.builder().seed(seed).activation("tanh")
         .weight_init("xavier").updater(updater or JSgd(learning_rate=0.05)))
    lb = b.list()
    for lc in layers:
        lb.layer(lc)
    if tbptt:
        lb.backprop_type("tbptt", fwd=tbptt, back=tbptt)
    return JMultiLayerNetwork(
        lb.set_input_type(JInputType.recurrent(n_in, t)).build()).init()


def _port(jn):
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    return tn


def _assert_params_close(jn, tn, atol=ATOL_PARAMS):
    for k, group in jn.params.items():
        for n, a in flatten_group(jax.tree_util.tree_map(np.asarray,
                                                         group)).items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(), a,
                                       atol=atol, rtol=0, err_msg=f"{k}/{n}")


def _onehot(rng, classes, b, t):
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                           (b, t))]


def _stream_net():
    return _jax_net([jrec.LSTM(n_out=4), jrec.SimpleRnn(n_out=3),
                     jrec.RnnOutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent")], 2, 6)


def test_network_output_and_chunked_rnn_time_step_match_jax():
    jn = _stream_net()
    tn = _port(jn)
    x = _randn(np.random.default_rng(90), 2, 6, 2)
    full = tn.output(x).numpy()
    np.testing.assert_allclose(full, np.asarray(jn.output(x)),
                               atol=ATOL_NET, rtol=0)
    # in two chunks of three steps: the carries continue the sequence
    stream = np.concatenate([tn.rnn_time_step(x[:, :3]).numpy(),
                             tn.rnn_time_step(x[:, 3:]).numpy()], axis=1)
    np.testing.assert_allclose(stream, full, atol=1e-6, rtol=0)
    jstream = np.concatenate([np.asarray(jn.rnn_time_step(x[:, :3])),
                              np.asarray(jn.rnn_time_step(x[:, 3:]))], 1)
    np.testing.assert_allclose(stream, jstream, atol=ATOL_NET, rtol=0)
    # the kept state is JAX's
    for i in (0, 1):
        jc, tc = jn.rnn_get_previous_state(i), tn.rnn_get_previous_state(i)
        assert set(jc) == set(tc)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL_NET, rtol=0)
    assert tn.rnn_get_previous_state(2) is None     # the output layer


def test_rnn_time_step_single_steps_batch_change_and_state_api():
    tn = _port(_stream_net())
    x = _randn(np.random.default_rng(91), 2, 6, 2)
    full = tn.output(x).numpy()
    steps = [tn.rnn_time_step(x[:, s]) for s in range(6)]
    assert steps[0].shape == (2, 2)          # a [b, f] step gives [b, n_out]
    np.testing.assert_allclose(np.stack([s.numpy() for s in steps], 1), full,
                               atol=1e-6, rtol=0)
    # a new batch size starts from zero state
    one = tn.rnn_time_step(x[:1, :3]).numpy()
    np.testing.assert_allclose(one, full[:1, :3], atol=1e-6, rtol=0)
    # state set from outside continues from there
    saved = {k: v.clone() for k, v in tn.rnn_get_previous_state(0).items()}
    a = tn.rnn_time_step(x[:1, 3:]).numpy()
    tn.rnn_set_previous_state(0, saved)
    tn.rnn_set_previous_state(1, None)     # None: a zero carry
    b = tn.rnn_time_step(x[:1, 3:]).numpy()
    assert a.shape == b.shape and not np.allclose(a, b)
    tn.rnn_clear_previous_state()
    assert tn.rnn_get_previous_state(0) is None
    with pytest.raises(ValueError, match="no rnn state"):
        tn.rnn_set_previous_state(0, saved)
    np.testing.assert_allclose(tn.rnn_time_step(x).numpy(), full, atol=1e-6,
                               rtol=0)


def test_rnn_time_step_through_last_time_step_and_refusals():
    jn = _jax_net([jrec.LastTimeStep(underlying=jrec.LSTM(n_out=3)),
                   jff.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent")], 2, 4)
    tn = _port(jn)
    x = _randn(np.random.default_rng(92), 2, 4, 2)
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               atol=ATOL_NET, rtol=0)
    tn.rnn_time_step(x[:, :2])
    got = tn.rnn_time_step(x[:, 2:]).numpy()
    np.testing.assert_allclose(got, tn.output(x).numpy(), atol=1e-6, rtol=0)
    jn.rnn_time_step(x[:, :2])
    np.testing.assert_allclose(got, np.asarray(jn.rnn_time_step(x[:, 2:])),
                               atol=ATOL_NET, rtol=0)
    bi = _port(_jax_net([jrec.Bidirectional(fwd=jrec.LSTM(n_out=3)),
                         jrec.RnnOutputLayer(n_out=2, activation="softmax",
                                             loss="mcxent")], 2, 4))
    with pytest.raises(ValueError, match="bidirectional"):
        bi.rnn_time_step(x)


@pytest.mark.parametrize("label_mask", [False, True])
def test_feature_masked_training_matches_jax(label_mask):
    jn = _jax_net([jrec.LSTM(n_out=5), jrec.GravesLSTM(n_out=4),
                   jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent")], 4, 6, seed=11)
    tn = _port(jn)
    rng = np.random.default_rng(93)
    for _ in range(3):
        x = _randn(rng, 4, 6, 4)
        y = _onehot(rng, 3, 4, 6)
        m = _mask(rng, 4, 6)
        lm = _mask(rng, 4, 6) if label_mask else None
        jn.fit(x, y, mask=m, label_mask=lm)
        tn.fit(x, y, mask=m, label_mask=lm)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
    _assert_params_close(jn, tn)
    # the masks reach fit through a DataSet and through the iterator
    x, y, m = _randn(rng, 4, 6, 4), _onehot(rng, 3, 4, 6), _mask(rng, 4, 6)
    before = tn.iteration
    tn.fit(DataSet(x, y, features_mask=m))
    s_ds = tn.get_score()
    tn.fit(INDArrayDataSetIterator(x, y, batch_size=2,
                                   features_mask=m.tolist()))
    assert tn.iteration == before + 3
    jn.fit(x, y, mask=m)
    np.testing.assert_allclose(s_ds, float(jn.get_score()), rtol=RTOL_LOSS)


def test_masked_loss_defaults_to_the_propagated_mask():
    jn = _jax_net([jrec.LSTM(n_out=5),
                   jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent")], 4, 6, seed=12)
    tn = _port(jn)
    rng = np.random.default_rng(94)
    x, y, m = _randn(rng, 4, 6, 4), _onehot(rng, 3, 4, 6), _mask(rng, 4, 6)
    from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss
    params = tn._param_tree()
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, m))
    dflt = _stack_loss(tn.conf, params, tx, ty, train=False, mask=tm)
    same = _stack_loss(tn.conf, params, tx, ty, train=False, mask=tm,
                       label_mask=tm)
    unmasked = _stack_loss(tn.conf, params, tx, ty, train=False, mask=tm,
                           label_mask=torch.ones(4, 6))
    assert dflt.item() == same.item() != unmasked.item()


class _Losses:
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration, epoch):
        self.values.append(float(model._score))

    def __getattr__(self, name):      # the other listener hooks
        return lambda *a, **k: None


@pytest.mark.parametrize("t", [12, 10])
def test_tbptt_chunk_losses_match_jax(t):
    jn = _jax_net([jrec.LSTM(n_out=5), jrec.RnnOutputLayer(
        n_out=3, activation="softmax", loss="mcxent")], 4, t, seed=13,
        tbptt=4)
    tn = _port(jn)
    jl = _Losses()
    jn.add_listeners(jl)
    tl = []
    step = tn._train_step()
    tn._step = lambda *a: (lambda r: tl.append(float(r[0])) or r)(step(*a))
    rng = np.random.default_rng(95)
    for _ in range(3):
        x, y = _randn(rng, 3, t, 4), _onehot(rng, 3, 3, t)
        jn.fit(x, y)
        tn.fit(x, y)
    chunks = -(-t // 4)
    assert len(tl) == 3 * chunks and tn.iteration == 3 * chunks
    np.testing.assert_allclose(tl, jl.values[-len(tl):], rtol=RTOL_LOSS)
    _assert_params_close(jn, tn)
    # a batch no longer than the chunk is one ordinary step
    x, y = _randn(rng, 3, 4, 4), _onehot(rng, 3, 3, 4)
    jn.fit(x, y)
    tn.fit(x, y)
    assert tn.iteration == 3 * chunks + 1
    np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                               rtol=RTOL_LOSS)


def test_tbptt_carries_state_across_chunks():
    """At lr 0 the params never move, so the second chunk's loss depends
    on the first chunk's data only through the carry."""
    jn = _jax_net([jrec.LSTM(n_out=5), jrec.RnnOutputLayer(
        n_out=3, activation="softmax", loss="mcxent")], 4, 8, seed=14,
        tbptt=4, updater=JSgd(learning_rate=0.0))
    rng = np.random.default_rng(96)
    x, y = _randn(rng, 2, 8, 4), _onehot(rng, 3, 2, 8)
    losses = {}
    for name, xx in (("a", x), ("b", np.concatenate([-x[:, :4], x[:, 4:]],
                                                    axis=1))):
        tn = _port(jn)
        rec = []
        step = tn._train_step()
        tn._step = lambda *a, _s=step, _r=rec: \
            (lambda r: _r.append(float(r[0])) or r)(_s(*a))
        tn.fit(xx, y)
        losses[name] = rec
    assert losses["a"][1] != losses["b"][1]


def test_bidirectional_checkpoint_round_trip(tmp_path):
    jn = _jax_net([jrec.Bidirectional(fwd=jrec.LSTM(n_out=4), mode="concat"),
                   jrec.GravesBidirectionalLSTM(n_out=3),
                   jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent")], 4, 5, seed=15,
                  updater=JAdam(learning_rate=1e-2))
    rng = np.random.default_rng(97)
    for _ in range(2):
        jn.fit(_randn(rng, 3, 5, 4), _onehot(rng, 3, 3, 5))
    path = tmp_path / "bi.zip"
    write_model(jn, str(path))
    tn = load_reference_model(path, device="cpu")
    assert sorted(tn.params["layer_0"]) == sorted(
        f"{d}/{n}" for d in ("fwd", "bwd") for n in ("U", "W", "b"))
    _assert_params_close(jn, tn, atol=0)
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    # the wrapper's updater group is its inner layer's, as in JAX
    assert tn._tx.labels["layer_0"]["fwd/W"] == "layer_0/w"
    assert tn.opt_state["count"]["layer_0/w"] == 2
    x = _randn(rng, 3, 5, 4)
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               atol=ATOL_NET, rtol=0)
    for _ in range(2):
        x, y = _randn(rng, 3, 5, 4), _onehot(rng, 3, 3, 5)
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
    # Adam's first steps move params by ~lr whatever |g| is: 1e-5 abs
    _assert_params_close(jn, tn, atol=1e-5)
