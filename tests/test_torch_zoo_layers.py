"""The conv zoo slice's layers, vertices and preprocessors against the
JAX package: forward values and gradients (of the params and the input,
under one random cotangent) on the same numpy inputs, training forwards
with dropout on the same key.

Dropout masks come from the threefry stream with x64 off (the JAX
package's production setting, which the port reproduces): every JAX
call here runs under ``jax.enable_x64(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import misc as jmisc
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.nn.conf import computation_graph as tcg
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as TIT
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import misc as tmisc
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers import pooling as tpool
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

# f32 forward and gradients of small layers: sums of <= ~100 products of
# |x|, |w| <~ 3 in another order (XLA against torch's CPU kernels), and
# the pow/rsqrt of LRN and pnorm within a few ulps: 2e-5 abs plus 2e-5
# relative.  Dropout masks and reshapes are exact either way.
ATOL, RTOL = 2e-5, 2e-5
# Small networks trained 3 steps (Sgd/Nesterovs, f32): losses within
# 1e-5 relative, params within 1e-5 abs (moves of lr·|g| per step).
RTOL_LOSS, ATOL_PARAMS = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _check(jl, tl, params, x, *, train=False, seed=0, mask=None,
           int_input=False, state=None):
    """Forward and gradients of ``jl`` (JAX) and ``tl`` (port) on the
    same params, input, key and features mask."""
    rng = np.random.default_rng(seed + 100)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 4) if train \
        else None
    tkey = _random.fold_in(_random.prng_key(seed), 4) if train else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jf(p, a):
        return jl.apply({"params": p, "state": state or {}}, a, train=train,
                        key=jkey, mask=jm)[0]
    want = jf(jp, jnp.asarray(x))
    dy = _rand(rng, *want.shape)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=not int_input)
    got = tl.forward(tp, {k: torch.tensor(np.asarray(v)) for k, v in
                          (state or {}).items()}, tx, train=train, key=tkey,
                     mask=tm)[0]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    argn = (0,) if int_input else (0, 1)
    jg = jax.grad(lambda p, a: jnp.sum(jf(p, a) * dy), argnums=argn)(
        jp, jnp.asarray(x))
    leaves = list(tp.values()) + ([] if int_input else [tx])
    if not leaves:
        return got
    tg = torch.autograd.grad((got * torch.tensor(dy)).sum(), leaves,
                             allow_unused=True)
    for name, g in zip(list(tp) + ["x"], tg):
        want_g = np.asarray(jg[1] if name == "x" else jg[0][name])
        g = np.zeros_like(want_g) if g is None else g.numpy()
        np.testing.assert_allclose(g, want_g, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    return got


def _pair(jmod, tmod, cls, **kw):
    return getattr(jmod, cls)(**kw), getattr(tmod, cls)(**kw)


def _dense_params(rng, n_in, n_out):
    return {"W": _rand(rng, n_in, n_out, scale=0.5),
            "b": _rand(rng, n_out, scale=0.1)}


# ---------------------------------------------------------------- layers

LAYER_CASES = {
    "dropout_layer": lambda r: (
        *_pair(jff, tff, "DropoutLayer", dropout=0.6, activation="relu"),
        {}, _rand(r, 4, 9), True),
    "dropout_layer_object": lambda r: (
        jff.DropoutLayer(dropout=__import__(
            "deeplearning4j_tpu.nn.conf.dropout",
            fromlist=["x"]).AlphaDropout(0.9)),
        tff.DropoutLayer(dropout=__import__(
            "deeplearning4j_tpu_torch.nn.conf.dropout",
            fromlist=["x"]).AlphaDropout(0.9)),
        {}, _rand(r, 4, 9), True),
    "dense_dropout": lambda r: (
        *_pair(jff, tff, "DenseLayer", n_in=6, n_out=5, dropout=0.7,
               activation="tanh"),
        _dense_params(r, 6, 5), _rand(r, 4, 6), True),
    "conv_dropout": lambda r: (
        *_pair(jconv, tconv, "ConvolutionLayer", n_in=3, n_out=4,
               kernel_size=(3, 3), convolution_mode="same", dropout=0.5,
               activation="relu"),
        {"W": _rand(r, 3, 3, 3, 4, scale=0.3), "b": _rand(r, 4)},
        _rand(r, 2, 5, 5, 3), True),
    "loss_layer": lambda r: (
        *_pair(jff, tff, "LossLayer", loss="mse", activation="sigmoid"),
        {}, _rand(r, 4, 3), False),
    "activation_layer": lambda r: (
        *_pair(jff, tff, "ActivationLayer", activation="tanh"),
        {}, _rand(r, 4, 3), False),
    "lrn": lambda r: (
        *_pair(jnorm, tnorm, "LocalResponseNormalization"),
        {}, _rand(r, 2, 3, 3, 7, scale=3.0), False),
    "lrn_n4": lambda r: (
        *_pair(jnorm, tnorm, "LocalResponseNormalization", n=4, k=1.0,
               alpha=0.01, beta=0.5),
        {}, _rand(r, 2, 3, 3, 6, scale=3.0), False),
    "pnorm_same": lambda r: (
        *_pair(jconv, tconv, "SubsamplingLayer", pooling_type="pnorm",
               kernel_size=(3, 3), stride=(2, 2), convolution_mode="same",
               pnorm=3),
        {}, _rand(r, 2, 7, 7, 3), False),
    "pnorm_truncate": lambda r: (
        *_pair(jconv, tconv, "SubsamplingLayer", pooling_type="pnorm",
               kernel_size=(2, 2), stride=(2, 2)),
        {}, _rand(r, 2, 6, 6, 3), False),
    "conv1d_same": lambda r: (
        *_pair(jconv, tconv, "Convolution1DLayer", n_in=4, n_out=5,
               kernel_size=3, convolution_mode="same", activation="relu"),
        {"W": _rand(r, 3, 4, 5, scale=0.4), "b": _rand(r, 5)},
        _rand(r, 2, 9, 4), False),
    "conv1d_same_stride2": lambda r: (     # SAME pads (0, 1) at t = 8
        *_pair(jconv, tconv, "Convolution1DLayer", n_in=4, n_out=5,
               kernel_size=3, stride=2, convolution_mode="same"),
        {"W": _rand(r, 3, 4, 5, scale=0.4), "b": _rand(r, 5)},
        _rand(r, 2, 8, 4), False),
    "conv1d_truncate": lambda r: (
        *_pair(jconv, tconv, "Convolution1DLayer", n_in=4, n_out=2,
               kernel_size=3, padding=1, dilation=2, has_bias=False),
        {"W": _rand(r, 3, 4, 2, scale=0.4)}, _rand(r, 2, 11, 4), False),
    "subsampling1d_max_same": lambda r: (
        *_pair(jconv, tconv, "Subsampling1DLayer", kernel_size=3, stride=2,
               convolution_mode="same"),
        {}, _rand(r, 2, 8, 3), False),
    "subsampling1d_avg": lambda r: (
        *_pair(jconv, tconv, "Subsampling1DLayer", pooling_type="avg",
               kernel_size=3, stride=1, padding=1),
        {}, _rand(r, 2, 7, 3), False),
    "subsampling1d_sum": lambda r: (
        *_pair(jconv, tconv, "Subsampling1DLayer", pooling_type="sum"),
        {}, _rand(r, 2, 8, 3), False),
    "subsampling1d_pnorm": lambda r: (
        *_pair(jconv, tconv, "Subsampling1DLayer", pooling_type="pnorm",
               kernel_size=2, stride=1),
        {}, _rand(r, 2, 6, 3), False),
    "zero_padding_hw": lambda r: (
        *_pair(jconv, tconv, "ZeroPaddingLayer", padding=(1, 2)),
        {}, _rand(r, 2, 3, 4, 2), False),
    "zero_padding_tblr": lambda r: (
        *_pair(jconv, tconv, "ZeroPaddingLayer", padding=(0, 2, 3, 1)),
        {}, _rand(r, 2, 3, 4, 2), False),
    "upsampling2d": lambda r: (
        *_pair(jconv, tconv, "Upsampling2D", size=(2, 3)),
        {}, _rand(r, 2, 3, 2, 4), False),
    "upsampling1d": lambda r: (
        *_pair(jconv, tconv, "Upsampling1D", size=3),
        {}, _rand(r, 2, 4, 5), False),
    "reshape": lambda r: (
        *_pair(jmisc, tmisc, "ReshapeLayer", target_shape=(2, 6)),
        {}, _rand(r, 3, 12), False),
    "permute": lambda r: (
        *_pair(jmisc, tmisc, "PermuteLayer", dims=(2, 1)),
        {}, _rand(r, 3, 4, 5), False),
    "repeat_vector": lambda r: (
        *_pair(jmisc, tmisc, "RepeatVector", n=4),
        {}, _rand(r, 3, 5), False),
    "frozen_dense_ignores_dropout": lambda r: (
        jmisc.FrozenLayer(underlying=jff.DenseLayer(
            n_in=6, n_out=5, dropout=0.5, activation="relu")),
        tmisc.FrozenLayer(underlying=tff.DenseLayer(
            n_in=6, n_out=5, dropout=0.5, activation="relu")),
        _dense_params(r, 6, 5), _rand(r, 4, 6), True),
    "mha_attn_dropout": lambda r: (
        *_pair(jatt, tatt, "MultiHeadAttention", n_in=8, n_out=8, n_heads=2,
               causal=True, attn_impl="reference", attn_dropout=0.8,
               dropout=0.9, activation="identity"),
        {**{w: _rand(r, 8, 8, scale=0.4) for w in ("Wq", "Wk", "Wv",
                                                   "Wo")},
         **{b: _rand(r, 8, scale=0.1) for b in ("bq", "bk", "bv", "bo")}},
        _rand(r, 2, 5, 8), True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    jl, tl, params, x, train = LAYER_CASES[case](
        np.random.default_rng(len(case)))
    _check(jl, tl, params, x, train=train, seed=len(case))


def test_frozen_layer_ignores_dropout_and_detaches():
    r = np.random.default_rng(0)
    p = _dense_params(r, 6, 5)
    x = torch.tensor(_rand(r, 4, 6))
    fl = tmisc.FrozenLayer(underlying=tff.DenseLayer(n_in=6, n_out=5,
                                                     dropout=0.5))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y = fl.apply(tp, x, train=True, key=_random.prng_key(0))
    assert torch.equal(y, fl.underlying.apply(tp, x))
    assert not y.requires_grad
    assert float(fl.regularization_score(tp)) == 0.0


@pytest.mark.parametrize("ids", ["flat", "column", "one_hot"])
def test_embedding_layer_matches_jax(ids):
    r = np.random.default_rng(3)
    kw = dict(n_in=11, n_out=4, activation="identity")
    p = {"W": _rand(r, 11, 4), "b": _rand(r, 4)}
    idx = r.integers(0, 11, 6)
    x = {"flat": idx, "column": idx[:, None],
         "one_hot": np.eye(11, dtype=np.float32)[idx]}[ids]
    _check(*_pair(jff, tff, "EmbeddingLayer", **kw), p, x,
           int_input=ids != "one_hot")


@pytest.mark.parametrize("pt", ["max", "avg", "sum", "pnorm"])
def test_masked_global_pooling_over_time_matches_jax(pt):
    r = np.random.default_rng(5)
    x = _rand(r, 3, 6, 4)
    mask = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0],
                     [1, 0, 0, 0, 0, 0]], np.float32)
    _check(*_pair(jpool, tpool, "GlobalPoolingLayer", pooling_type=pt), {},
           x, mask=mask)


def test_center_loss_output_layer_matches_jax():
    """Loss value (the center term is value-neutral) and the gradients of
    W, b, the centers (its only gradient source) and the features."""
    r = np.random.default_rng(7)
    kw = dict(n_in=5, n_out=3, activation="softmax", loss="mcxent",
              alpha=0.9, lambda_=5e-3, l2=1e-2)
    jl, tl = _pair(jff, tff, "CenterLossOutputLayer", **kw)
    p = {**_dense_params(r, 5, 3), "centers": _rand(r, 3, 5)}
    x = _rand(r, 4, 5)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1, 2]]
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jloss(pp, a):
        return jl.compute_loss({"params": pp, "state": {}}, a,
                               jnp.asarray(y)) + jl.regularization_score(pp)
    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    tv = tl.compute_loss(tp, tx, torch.tensor(y)) + \
        tl.regularization_score(tp)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    init = tl.init(torch.Generator(), TIT.feed_forward(5), "cpu")
    assert init["centers"].shape == (3, 5) and \
        not init["centers"].any()
    grads = torch.autograd.grad(tv, list(tp.values()) + [tx])
    for name, g in zip(list(tp) + ["x"], grads):
        want = jgx if name == "x" else jgp[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


# -------------------------------------------------------- preprocessors

PRE_CASES = [
    ("CnnToFeedForwardPreProcessor", dict(height=2, width=3, channels=4),
     (5, 2, 3, 4), JIT.convolutional(2, 3, 4)),
    ("FeedForwardToCnnPreProcessor", dict(height=2, width=3, channels=4),
     (5, 24), JIT.feed_forward(24)),
    ("FeedForwardToRnnPreProcessor", dict(timesteps=3), (6, 4),
     JIT.feed_forward(4)),
    ("FeedForwardToRnnPreProcessor", {}, (6, 4), JIT.feed_forward(4)),
    ("RnnToFeedForwardPreProcessor", {}, (2, 3, 4), JIT.recurrent(4, 3)),
    ("CnnToRnnPreProcessor", dict(height=2, width=2, channels=3,
                                  timesteps=2), (4, 2, 2, 3),
     JIT.convolutional(2, 2, 3)),
    ("CnnToRnnPreProcessor", dict(height=2, width=2, channels=3),
     (4, 2, 2, 3), JIT.convolutional(2, 2, 3)),
    ("RnnToCnnPreProcessor", dict(height=2, width=2, channels=3),
     (2, 3, 12), JIT.recurrent(12, 3)),
    ("CnnFlatToCnnPreProcessor", dict(height=2, width=3, channels=2),
     (4, 12), JIT.convolutional_flat(2, 3, 2)),
]


@pytest.mark.parametrize("cls,kw,shape,itype", PRE_CASES)
def test_preprocessor_matches_jax(cls, kw, shape, itype):
    jp, tp = getattr(jpre, cls)(**kw), getattr(tpre, cls)(**kw)
    x = _rand(np.random.default_rng(1), *shape)
    want = np.asarray(jp.pre_process(jnp.asarray(x)))
    got = tp.pre_process(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    tit = TIT(**{k: getattr(itype, k) for k in ("kind", "size", "timesteps",
                                                "height", "width", "depth",
                                                "channels")})
    assert vars(tp.output_type(tit)) == vars(jp.output_type(itype))
    if cls == "RnnToFeedForwardPreProcessor":
        m = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
        np.testing.assert_array_equal(
            tp.feed_forward_mask(torch.tensor(m), None).numpy(),
            np.asarray(jp.feed_forward_mask(jnp.asarray(m), None)))


def test_auto_preprocessors_match_the_jax_builder():
    """The MLN configuration inserts the JAX builder's preprocessors:
    LeNet's flat input (cnnflat -> cnn), CNN -> dense, dense -> RNN."""
    from deeplearning4j_tpu.nn.conf.multi_layer import \
        MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration as TMLC
    conf = (NeuralNetConfiguration.builder().list()
            .layer(jconv.ConvolutionLayer(n_out=2, kernel_size=(3, 3)))
            .layer(jff.DenseLayer(n_out=4))
            .layer(jrec.LSTM(n_out=3))
            .layer(jrec.RnnOutputLayer(n_out=2, activation="softmax"))
            .set_input_type(JIT.convolutional_flat(5, 5, 1)).build())
    got = TMLC.from_json(conf.to_json())
    bare = JMLC.from_json(conf.to_json())
    bare.input_preprocessors = {}
    tbare = TMLC.from_json(bare.to_json())
    tbare.resolve()
    for t in (got, tbare):
        t.resolve()
        assert {k: type(v).__name__ for k, v in
                t.input_preprocessors.items()} == \
            {k: type(v).__name__ for k, v in
             conf.input_preprocessors.items()}
        assert [vars(i) for i in t.layer_input_types] == \
            [vars(i) for i in conf.layer_input_types]


# ------------------------------------------------------------- vertices

VERTEX_CASES = {
    "merge_cnn": (lambda: ({}, [(2, 3, 3, 2), (2, 3, 3, 4), (2, 3, 3, 1)]),
                  "MergeVertex", {}),
    "merge_ff": (lambda: ({}, [(3, 2), (3, 5)]), "MergeVertex", {}),
    "subset": (lambda: ({}, [(3, 7)]), "SubsetVertex",
               dict(from_idx=2, to_idx=4)),
    "stack": (lambda: ({}, [(2, 4), (3, 4)]), "StackVertex", {}),
    "unstack": (lambda: ({}, [(6, 4)]), "UnstackVertex",
                dict(from_idx=1, stack_size=3)),
    "scale": (lambda: ({}, [(3, 4)]), "ScaleVertex", dict(scale_factor=0.17)),
    "shift": (lambda: ({}, [(3, 4)]), "ShiftVertex", dict(shift_factor=-0.5)),
    "l2_normalize": (lambda: ({}, [(3, 2, 2, 3)]), "L2NormalizeVertex", {}),
    "l2": (lambda: ({}, [(3, 4), (3, 4)]), "L2Vertex", {}),
    "reshape": (lambda: ({}, [(3, 12)]), "ReshapeVertex",
                dict(shape=[2, 2, 3])),
    "pool_helper": (lambda: ({}, [(2, 4, 4, 3)]), "PoolHelperVertex", {}),
    "last_time_step": (lambda: ({}, [(2, 5, 3)]), "LastTimeStepVertex", {}),
    "duplicate_to_time_series": (lambda: ({}, [(2, 3), (2, 4, 1)]),
                                 "DuplicateToTimeSeriesVertex", {}),
    "elementwise_max": (lambda: ({}, [(3, 4), (3, 4), (3, 4)]),
                        "ElementWiseVertex", dict(op="max")),
}


@pytest.mark.parametrize("case", sorted(VERTEX_CASES))
def test_vertex_matches_jax(case):
    make, cls, kw = VERTEX_CASES[case]
    _, shapes = make()
    r = np.random.default_rng(len(case))
    xs = [_rand(r, *s) for s in shapes]
    jv, tv = getattr(jcg, cls)(**kw), getattr(tcg, cls)(**kw)

    def jf(*a):
        return jv.apply({"params": {}, "state": {}}, list(a))[0]
    want = jf(*[jnp.asarray(a) for a in xs])
    dy = _rand(r, *want.shape)
    txs = [torch.tensor(a, requires_grad=True) for a in xs]
    got, st = tv.forward({}, {}, txs)
    assert st == {}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    jg = jax.grad(lambda *a: jnp.sum(jf(*a) * dy),
                  argnums=tuple(range(len(xs))))(
        *[jnp.asarray(a) for a in xs])
    tg = torch.autograd.grad((got * torch.tensor(dy)).sum(), txs,
                             allow_unused=True)
    for a, g, w in zip(xs, tg, jg):
        g = np.zeros_like(a) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


def test_preprocessor_vertex_and_vertex_masks_match_jax():
    r = np.random.default_rng(2)
    x = _rand(r, 2, 3, 4)
    jv = jcg.PreprocessorVertex(
        preprocessor=jpre.RnnToFeedForwardPreProcessor())
    tv = tcg.PreprocessorVertex(
        preprocessor=tpre.RnnToFeedForwardPreProcessor())
    np.testing.assert_array_equal(
        tv.forward({}, {}, [torch.tensor(x)])[0].numpy(),
        np.asarray(jv.apply({"params": {}, "state": {}}, [jnp.asarray(x)])[0]))
    # masks: LastTimeStep picks each row's last unmasked step and consumes
    # the mask; Stack fills the unmasked input's rows with ones; Unstack
    # slices the mask with the activations
    m = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    for cls, kw, ins, ms in (
            ("LastTimeStepVertex", {}, [x], [m]),
            ("StackVertex", {}, [x, x], [m, None]),
            ("UnstackVertex", dict(from_idx=1, stack_size=2), [x], [m])):
        jv, tv = getattr(jcg, cls)(**kw), getattr(tcg, cls)(**kw)
        jms = [None if a is None else jnp.asarray(a) for a in ms]
        tms = [None if a is None else torch.tensor(a) for a in ms]
        want = jv.apply({"params": {}, "state": {}},
                        [jnp.asarray(a) for a in ins], masks=jms)[0]
        got = tv.forward({}, {}, [torch.tensor(a) for a in ins],
                         masks=tms)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        wm = jv.feed_forward_mask(jms, [jnp.asarray(a) for a in ins])
        gm = tv.feed_forward_mask(tms, [torch.tensor(a) for a in ins])
        assert (wm is None) == (gm is None)
        if wm is not None:
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


# ------------------------------------------- networks: masks, frozen, fit

def _graph_lstm_last_step():
    g = (NeuralNetConfiguration.builder().seed(3)
         .updater(JSgd(learning_rate=0.1)).weight_init("xavier")
         .graph_builder())
    g.add_inputs("in").set_input_types(JIT.recurrent(4, 6))
    g.add_layer("lstm", jrec.LSTM(n_out=5, activation="tanh"), "in")
    g.add_vertex("last", jcg.LastTimeStepVertex(mask_input="in"), "lstm")
    g.add_layer("dense", jff.DenseLayer(n_out=6, activation="relu",
                                        dropout=0.8), "last")
    g.add_vertex("dup", jcg.DuplicateToTimeSeriesVertex(ts_input="in"),
                 "dense", "in")
    g.add_layer("pool", jpool.GlobalPoolingLayer(pooling_type="avg"), "dup")
    g.add_layer("out", jff.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "pool")
    g.set_outputs("out")
    return JCG(g.build()).init()


def test_graph_masks_last_time_step_and_fit_match_jax(tmp_path):
    """Features masks through the graph walk: LastTimeStepVertex reads
    the named input's mask, DuplicateToTimeSeriesVertex takes the series
    length from its second input, the masked average pooling sees the
    propagated mask; ``output`` and three Sgd ``fit`` steps with dropout
    and masks agree with JAX."""
    jn = _graph_lstm_last_step()
    write_model(jn, str(tmp_path / "g.zip"))
    tn = load_reference_model(tmp_path / "g.zip", device="cpu")
    r = np.random.default_rng(4)
    x = _rand(r, 3, 6, 4)
    m = np.array([[1] * 6, [1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]],
                 np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    jacts, _, _ = jn._forward(jn.params, jn.state, [jnp.asarray(x)],
                              train=False, key=None, masks=[jnp.asarray(m)])
    want = np.asarray(jacts["out"])
    got = tn.output(x, masks=[m]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    acts = tn.feed_forward(x, masks=[m])
    np.testing.assert_allclose(acts["last"].numpy(),
                               np.asarray(jacts["last"]), atol=ATOL,
                               rtol=RTOL)
    for _ in range(3):
        jn.fit(([x], [y], [m], None))
        tn.fit(([x], [y], [m], None))
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
    for k, group in jn.params.items():
        for n, a in group.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), atol=ATOL_PARAMS,
                                       rtol=0, err_msg=f"{k}/{n}")


def _mln_frozen_center_loss():
    conf = (NeuralNetConfiguration.builder().seed(9)
            .updater(JNesterovs(learning_rate=0.05, momentum=0.9))
            .activation("relu").weight_init("xavier").l2(1e-3)
            .list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          convolution_mode="same"))
            .layer(jmisc.FrozenLayer(underlying=jnorm.BatchNormalization()))
            .layer(jmisc.FrozenLayer(underlying=jconv.ConvolutionLayer(
                n_out=3, kernel_size=(1, 1), dropout=0.5)))
            .layer(jconv.SubsamplingLayer(pooling_type="pnorm",
                                          kernel_size=(2, 2),
                                          stride=(2, 2)))
            .layer(jnorm.LocalResponseNormalization(n=3))
            .layer(jff.DenseLayer(n_out=5, dropout=0.6))
            .layer(jff.CenterLossOutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent", alpha=0.5,
                                             lambda_=1e-2))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    jn = JMLN(conf).init()
    # frozen BN with nontrivial running statistics
    jn.state["layer_1"] = {"mean": jnp.full((4,), 0.1),
                           "var": jnp.full((4,), 2.0)}
    return jn


def test_frozen_layers_stay_put_and_centers_move_like_jax(tmp_path):
    jn = _mln_frozen_center_loss()
    write_model(jn, str(tmp_path / "m.zip"))
    tn = load_reference_model(tmp_path / "m.zip", device="cpu")
    r = np.random.default_rng(8)
    x = _rand(r, 4, 6, 6, 2)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    frozen0 = {k: {n: p.detach().clone() for n, p in tn.params[k].items()}
               for k in ("layer_1", "layer_2")}
    state0 = {n: t.clone() for n, t in tn.state["layer_1"].items()}
    centers0 = tn.params["layer_6"]["centers"].detach().clone()
    assert tn.opt_state["slots"]["layer_2"] == {"W": {}, "b": {}}
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
    for k, group in jn.params.items():
        for n, a in group.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), atol=ATOL_PARAMS,
                                       rtol=0, err_msg=f"{k}/{n}")
    for k, group in frozen0.items():
        for n, p in group.items():
            assert torch.equal(tn.params[k][n], p), f"{k}/{n} moved"
    for n, t in state0.items():
        assert torch.equal(tn.state["layer_1"][n], t)
    assert not torch.equal(tn.params["layer_6"]["centers"], centers0)
    assert tn.opt_state["slots"]["layer_2"] == {"W": {}, "b": {}}


def test_output_and_feed_forward_train_advance_the_stream_like_jax(
        tmp_path):
    jn = _mln_frozen_center_loss()
    write_model(jn, str(tmp_path / "m.zip"))
    tn = load_reference_model(tmp_path / "m.zip", device="cpu")
    x = _rand(np.random.default_rng(0), 2, 6, 6, 2)
    for _ in range(2):
        want = np.asarray(jn.output(x, train=True))
        np.testing.assert_allclose(tn.output(x, train=True).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
    ja = jn.feed_forward(x, train=True)
    ta = tn.feed_forward(x, train=True)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_array_equal(tn._rng.numpy(),
                                  np.asarray(jn._rng).astype(np.int64))
    # inference draws nothing and leaves the stream alone
    rng0 = tn._rng.clone()
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x)), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(tn._rng, rng0)


@pytest.mark.parametrize("what", ["weight_noise", "constraints",
                                  "precision"])
def test_still_unported_training_options_raise(what, tmp_path):
    """Precision policies train since the precision and memory slice
    (f32 masters; the zoo's ``compute_dtype`` sets the policy knob).  Weight noise and
    constraints are ported since the rest-of-training slice: LeNet
    trains with DropConnect drawn from its key stream (the stored weights
    are not noised in place), and a MaxNorm step equals the free step
    with the constraint applied after it."""
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.nn.conf.constraints import \
        MaxNormConstraint
    from deeplearning4j_tpu_torch.nn.conf.dropout import DropConnect
    tn = LeNet(num_classes=3, input_shape=(8, 8, 1)).init(device="cpu")
    free = LeNet(num_classes=3, input_shape=(8, 8, 1)).init(device="cpu")
    x = _rand(np.random.default_rng(0), 2, 64)
    y = np.eye(3, dtype=np.float32)[[0, 1]]
    before = tn.params["layer_0"]["W"].detach().clone()
    if what == "precision":
        # ported since the precision and memory slice: a bf16 policy
        # trains, the masters stay f32, and the zoo takes compute_dtype
        tn.conf.defaults["precision"] = "bfloat16"
        tn.fit(x, y)
        assert np.isfinite(tn.get_score())
        assert not torch.equal(tn.params["layer_0"]["W"], before)
        assert all(p.dtype == torch.float32 for p in tn.params.parameters())
        zb = LeNet(num_classes=3, input_shape=(8, 8, 1),
                   compute_dtype="bfloat16")
        assert zb.conf().defaults["compute_dtype"] == "bfloat16"
        zn = zb.init(device="cpu")
        zn.fit(x, y)
        assert np.isfinite(zn.get_score())
        return
    if what == "weight_noise":
        tn.conf.layers[4].weight_noise = DropConnect(p=0.5)
        w4 = tn.params["layer_4"]["W"].detach().clone()
        rng0 = tn._rng.clone()
        tn.fit(x, y)
        assert np.isfinite(tn.get_score()) and \
            not torch.equal(tn._rng, rng0)
        assert not torch.equal(tn.params["layer_4"]["W"], w4)
        assert torch.count_nonzero(tn.params["layer_4"]["W"]) == \
            torch.count_nonzero(w4)
        return
    tn.conf.layers[0].constraints = [MaxNormConstraint(max_norm=0.05)]
    tn.fit(x, y)
    free.fit(x, y)
    w = tn.params["layer_0"]["W"].detach()
    norms = torch.sqrt((w * w).sum(dim=(0, 1, 2)))
    assert float(norms.max()) <= 0.05 + 1e-6
    want = MaxNormConstraint(max_norm=0.05).apply(
        free.params["layer_0"]["W"].detach())
    torch.testing.assert_close(w, want, rtol=0, atol=0)
