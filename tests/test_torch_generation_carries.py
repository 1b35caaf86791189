"""The KV-cache carries of the port's attention layers against the JAX
package's on the same params, inputs and carries: the dense carry (a
scalar position for a t-step chunk, a per-row vector for one-token
decode), the paged block pool (suffix prefill through a table row,
slot-batched decode through an [S, NB] table), the positional encoding's
vector offset, and ``rnn_time_step`` and tBPTT on a small TransformerLM.

Outputs and carries (pools included) agree within 1e-6; tBPTT losses
within 1e-5 relative.  The trash block 0 of a pool is left out of the
pool comparison: inactive lanes and padded steps write there in an
order neither library fixes, and nothing reads it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (
    params_from_jax, updater_state_from_jax)

ATOL = 1e-6
RTOL_LOSS = 1e-5
E, H = 16, 2
D = E // H
KW = dict(n_in=E, n_out=E, n_heads=H, causal=True, activation="identity")


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(rng):
    p = {w: _randn(rng, E, E, scale=E ** -0.5)
         for w in ("Wq", "Wk", "Wv", "Wo")}
    p.update({b: _randn(rng, E, scale=0.1) for b in ("bq", "bk", "bv",
                                                     "bo")})
    return p


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def _dense_carry(rng, b, L, pos):
    c = {"k": _randn(rng, b, H, L, D), "v": _randn(rng, b, H, L, D),
         "m": (rng.random((b, L)) > 0.2).astype(np.float32)}
    jc, tc = _both(c)
    jc["pos"] = jnp.asarray(pos, jnp.int32)
    tc["pos"] = torch.as_tensor(np.asarray(pos), dtype=torch.int32)
    return jc, tc


@pytest.mark.parametrize("masked", [False, True])
def test_dense_chunks_match_jax(masked):
    rng = np.random.default_rng(0)
    jp, tp = _both(_params(rng))
    x = _randn(rng, 2, 9, E)
    mask = np.ones((2, 9), np.float32)
    if masked:
        mask[1, 3:5] = 0.0
    jm, tm = jatt.MultiHeadAttention(**KW), tatt.MultiHeadAttention(**KW)
    jc = jm.init_carry(2, jnp.float32, max_len=12)
    tc = tm.init_carry(2, torch.float32, "cpu", max_len=12)
    for sl in (slice(0, 5), slice(5, 8), slice(8, 9)):
        jy, jc = jm.attend_cached(jp, jnp.asarray(x[:, sl]), jc,
                                  mask=jnp.asarray(mask[:, sl]))
        ty, tc = tm.attend_cached(tp, torch.from_numpy(x[:, sl]), tc,
                                  mask=torch.from_numpy(mask[:, sl]))
        _close(ty, jy, what="y")
        for key in ("k", "v", "m", "pos"):
            _close(tc[key], jc[key], what=key)
    assert int(tc["pos"]) == 9


def test_dense_vector_pos_decode_matches_jax():
    rng = np.random.default_rng(1)
    jp, tp = _both(_params(rng))
    jc, tc = _dense_carry(rng, 3, 10, [4, 0, 9])
    x = _randn(rng, 3, 1, E)
    jm, tm = jatt.MultiHeadAttention(**KW), tatt.MultiHeadAttention(**KW)
    jy, jn = jm.attend_cached(jp, jnp.asarray(x), jc)
    ty, tn = tm.attend_cached(tp, torch.from_numpy(x), tc)
    _close(ty, jy, what="y")
    for key in ("k", "v", "m", "pos"):
        _close(tn[key], jn[key], what=key)
    with pytest.raises(ValueError, match="single-token"):
        tm.attend_cached(tp, torch.from_numpy(_randn(rng, 3, 2, E)), tc)


def test_causal_mask_takes_a_device_offset():
    from deeplearning4j_tpu.ops.attention import causal_mask as jax_mask
    from deeplearning4j_tpu_torch.ops.attention import causal_mask
    for off in (0, 3, 7):
        want = np.asarray(jax_mask(4, 12, q_offset=off))
        np.testing.assert_array_equal(
            causal_mask(4, 12, q_offset=torch.tensor(off, dtype=torch.int32))
            .numpy(), want)
        np.testing.assert_array_equal(causal_mask(4, 12, q_offset=off)
                                      .numpy(), want)


def _pools(rng, nb, blk):
    pools = {"kp": _randn(rng, nb, H, blk, D),
             "vp": _randn(rng, nb, H, blk, D)}
    return pools


@pytest.mark.parametrize("start,length,bucket", [(0, 5, 8), (8, 3, 4),
                                                 (6, 7, 8)])
def test_paged_prefill_matches_jax(start, length, bucket):
    """A suffix of ``length`` real steps padded to ``bucket``, written
    from ``start`` through a table row of 4-token blocks."""
    rng = np.random.default_rng(2 + start)
    blk, nb_slot, n_blocks = 4, 5, 12
    jp, tp = _both(_params(rng))
    pools = _pools(rng, n_blocks, blk)
    row = np.asarray([3, 7, 1, 9, 0], np.int32)
    x = _randn(rng, 1, bucket, E)
    mask = np.zeros((1, bucket), np.float32)
    mask[0, :length] = 1.0
    jpool, tpool = _both(pools)
    jc = dict(jpool, table=jnp.asarray(row), pos=jnp.asarray(start,
                                                             jnp.int32))
    tc = dict(tpool, table=torch.from_numpy(row), pos=start)
    jm, tm = jatt.MultiHeadAttention(**KW), tatt.MultiHeadAttention(**KW)
    jy, jn = jm.attend_cached(jp, jnp.asarray(x), jc, mask=jnp.asarray(mask))
    ty, tn = tm.attend_cached(tp, torch.from_numpy(x), tc,
                              mask=torch.from_numpy(mask))
    _close(ty, jy, what="y")
    assert tn["kp"] is tpool["kp"]          # written in place
    for key in ("kp", "vp"):
        _close(tn[key][1:], np.asarray(jn[key])[1:], what=key)
    assert int(tn["pos"]) == int(jn["pos"]) == start + bucket


def test_paged_decode_matches_jax():
    rng = np.random.default_rng(3)
    blk, n_blocks = 4, 12
    jp, tp = _both(_params(rng))
    pools = _pools(rng, n_blocks, blk)
    tables = np.asarray([[3, 7, 1, 0], [0, 0, 0, 0], [2, 5, 0, 0]],
                        np.int32)
    pos = np.asarray([9, 0, 4], np.int32)      # lane 1 inactive
    x = _randn(rng, 3, 1, E)
    jpool, tpool = _both(pools)
    jc = dict(jpool, table=jnp.asarray(tables), pos=jnp.asarray(pos))
    tc = dict(tpool, table=torch.from_numpy(tables),
              pos=torch.from_numpy(pos))
    jm, tm = jatt.MultiHeadAttention(**KW), tatt.MultiHeadAttention(**KW)
    jy, jn = jm.attend_cached(jp, jnp.asarray(x), jc)
    ty, tn = tm.attend_cached(tp, torch.from_numpy(x), tc)
    _close(ty[[0, 2]], np.asarray(jy)[[0, 2]], what="y")
    for key in ("kp", "vp"):
        _close(tn[key][1:], np.asarray(jn[key])[1:], what=key)
    _close(tn["pos"], jn["pos"], what="pos")


@pytest.mark.parametrize("offset", [0, 3, [0, 5, 17]])
def test_positional_encoding_offsets_match_jax(offset):
    rng = np.random.default_rng(4)
    t = 1 if isinstance(offset, list) else 4
    x = _randn(rng, 3, t, E)
    jl, tl = jatt.PositionalEncodingLayer(), tatt.PositionalEncodingLayer()
    off = np.asarray(offset, np.int32)
    jy, jc = jl.apply_with_carry({"params": {}, "state": {}}, jnp.asarray(x),
                                 {"pos": jnp.asarray(off)})
    ty, tc = tl.apply_with_carry({}, torch.from_numpy(x),
                                 {"pos": torch.from_numpy(off)})
    _close(ty, jy)
    _close(tc["pos"], jc["pos"])


def test_transformer_block_carry_matches_jax():
    rng = np.random.default_rng(5)
    kw = dict(n_in=E, n_heads=H, causal=True)
    jb = jatt.TransformerBlock(**kw)
    p = {f"mha_{k}": v for k, v in _params(rng).items()}
    p.update(W1=_randn(rng, E, 4 * E, scale=0.25), b1=_randn(rng, 4 * E,
                                                             scale=0.1),
             W2=_randn(rng, 4 * E, E, scale=0.125), b2=_randn(rng, E,
                                                              scale=0.1),
             ln1_g=1 + _randn(rng, E, scale=0.1), ln1_b=_randn(rng, E,
                                                               scale=0.1),
             ln2_g=1 + _randn(rng, E, scale=0.1), ln2_b=_randn(rng, E,
                                                               scale=0.1))
    jp, tp = _both(p)
    tb = tatt.TransformerBlock(**kw)
    jc = jb.init_carry(2, jnp.float32, max_len=8)
    tc = tb.init_carry(2, torch.float32, "cpu", max_len=8)
    assert tc["k"].shape == (2, H, 8, D)
    x = _randn(rng, 2, 6, E)
    for sl in (slice(0, 4), slice(4, 6)):
        jy, jc = jb.apply_with_carry({"params": jp, "state": {}},
                                     jnp.asarray(x[:, sl]), jc)
        ty, tc = tb.apply_with_carry(tp, torch.from_numpy(x[:, sl]), tc)
        _close(ty, jy)
        for key in ("k", "v", "m", "pos"):
            _close(tc[key], jc[key], what=key)


# ------------------------------------------------------- attention stacks
SMALL = dict(vocab_size=17, seq_len=32, embed=16, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def lms():
    jn = JTransformerLM(**SMALL).init()
    tn = params_from_jax(TransformerLM(**SMALL).init(device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jn.params))
    return jn, tn


def test_rnn_time_step_on_an_attention_stack_matches_jax(lms):
    jn, tn = lms
    ids = np.random.default_rng(7).integers(0, 17, (2, 11))
    jn.rnn_clear_previous_state()
    tn.rnn_clear_previous_state()
    for sl in (slice(0, 6), slice(6, 7), slice(7, 11)):
        want = np.asarray(jn.rnn_time_step(ids[:, sl]))
        got = tn.rnn_time_step(ids[:, sl])
        _close(got, want)
    for layer in (1, 2, 3):
        jc, tc = jn.rnn_get_previous_state(layer), \
            tn.rnn_get_previous_state(layer)
        for key in jc:
            _close(tc[key], jc[key], what=f"layer {layer} {key}")
    assert int(tn.rnn_get_previous_state(1)["pos"]) == 11
    # the last chunk streamed equals the full forward at its positions
    _close(got, tn.output(ids).numpy()[:, 7:11])


def _tbptt_lm(seed):
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(JSgd(learning_rate=0.1)).weight_init("xavier"))
    lb = (b.list()
          .layer(jff.EmbeddingSequenceLayer(n_out=16))
          .layer(jatt.PositionalEncodingLayer())
          .layer(jatt.TransformerBlock(n_heads=2, causal=True))
          .layer(jatt.TransformerBlock(n_heads=2, causal=True))
          .layer(jrec.RnnOutputLayer(n_out=17, activation="softmax",
                                     loss="mcxent")))
    lb.backprop_type("tbptt", fwd=5, back=5)
    return JMultiLayerNetwork(
        lb.set_input_type(JInputType.recurrent(17, 10)).build()).init()


class _Losses:
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration, epoch):
        self.values.append(float(model._score))

    def __getattr__(self, name):      # the other listener hooks
        return lambda *a, **k: None


def test_tbptt_losses_on_an_attention_stack_match_jax():
    jn = _tbptt_lm(8)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    jl = _Losses()
    jn.add_listeners(jl)
    tl = []
    step = tn._train_step()
    tn._step = lambda *a: (lambda r: tl.append(float(r[0])) or r)(step(*a))
    rng = np.random.default_rng(9)
    eye = np.eye(17, dtype=np.float32)
    for _ in range(2):
        # one-hot [b, t, vocab]: tBPTT splits 3-D batches only
        x = eye[rng.integers(0, 17, (3, 10))]
        y = eye[rng.integers(0, 17, (3, 10))]
        jn.fit(x, y)
        tn.fit(x, y)
    assert len(tl) == 2 * 2 and tn.iteration == 4
    np.testing.assert_allclose(tl, jl.values[-len(tl):], rtol=RTOL_LOSS)
