"""Each ported layer against the JAX layer's ``apply`` on the same params
(inputs and params from numpy seeds; f32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.parallel.inference import InvalidInputError as JInvalid
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.parallel.inference import InvalidInputError

# Elementwise layers agree to a few f32 ulps; layers with matmuls and
# attention sum in another order: 1e-5 abs at activations of order 1-10.
ATOL_EW = 1e-6
ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_apply(layer, params, x):
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    y, _ = layer.apply({"params": jparams, "state": {}}, jnp.asarray(x))
    return np.asarray(y)


def _torch_apply(layer, params, x):
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    return layer.apply(tparams, torch.from_numpy(np.asarray(x))).numpy()


def test_layer_norm():
    rng = _rng(0)
    x = _randn(rng, 2, 5, 16, scale=3.0) + 1.0
    p = {"gamma": _randn(rng, 16), "beta": _randn(rng, 16)}
    want = _jax_apply(jatt.LayerNormLayer(n_out=16), p, x)
    got = _torch_apply(tatt.LayerNormLayer(n_out=16), p, x)
    np.testing.assert_allclose(got, want, atol=ATOL_EW, rtol=0)


@pytest.mark.parametrize("t,e", [(7, 16), (128, 64)])
def test_positional_encoding(t, e):
    x = _randn(_rng(1), 2, t, e)
    want = _jax_apply(jatt.PositionalEncodingLayer(), {}, x)
    got = _torch_apply(tatt.PositionalEncodingLayer(), {}, x)
    # sin/cos of angles up to t: f32 argument rounding dominates
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _mha_params(rng, e, prefix=""):
    p = {}
    for w in ("Wq", "Wk", "Wv", "Wo"):
        p[prefix + w] = _randn(rng, e, e, scale=e ** -0.5)
    for b in ("bq", "bk", "bv", "bo"):
        p[prefix + b] = _randn(rng, e, scale=0.1)
    return p


@pytest.mark.parametrize("impl", ["auto", "reference", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention(impl, causal):
    rng = _rng(2)
    e, t = 128, 128          # 2 heads of 64: the flash kernel's shapes
    x = _randn(rng, 2, t, e)
    p = _mha_params(rng, e)
    kw = dict(n_in=e, n_out=e, n_heads=2, causal=causal, attn_impl=impl,
              activation="identity")
    want = _jax_apply(jatt.MultiHeadAttention(**kw), p, x)
    got = _torch_apply(tatt.MultiHeadAttention(**kw), p, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _block_params(rng, e, f):
    p = _mha_params(rng, e, prefix="mha_")
    p.update(W1=_randn(rng, e, f, scale=e ** -0.5), b1=_randn(rng, f, scale=0.1),
             W2=_randn(rng, f, e, scale=f ** -0.5), b2=_randn(rng, e, scale=0.1),
             ln1_g=1 + _randn(rng, e, scale=0.1), ln1_b=_randn(rng, e, scale=0.1),
             ln2_g=1 + _randn(rng, e, scale=0.1), ln2_b=_randn(rng, e, scale=0.1))
    return p


@pytest.mark.parametrize("impl,t", [("auto", 128), ("auto", 16),
                                    ("reference", 128)])
def test_transformer_block(impl, t):
    rng = _rng(3)
    e = 128
    x = _randn(rng, 2, t, e)
    p = _block_params(rng, e, 4 * e)
    kw = dict(n_in=e, n_heads=2, causal=True, attn_impl=impl,
              activation="identity")
    want = _jax_apply(jatt.TransformerBlock(**kw), p, x)
    got = _torch_apply(tatt.TransformerBlock(**kw), p, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unported_attention_options_raise():
    """Ring and Ulysses attention are ported: outside a mesh with a
    ``seq`` axis they raise as an unbound JAX axis name does (inside one,
    ``tests/test_torch_sequence_parallel``); a key-padding mask is
    refused, as in JAX; an unknown impl names the choices; MoE blocks
    build."""
    q = torch.zeros(1, 1, 8, 4)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NameError, match="unbound axis name"):
            tatt._run_attention(q, q, q, impl=impl, causal=True)
        with pytest.raises(ValueError, match="key-padding"):
            tatt._run_attention(q, q, q, impl=impl, causal=True,
                                mask=torch.ones(1, 8))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tatt._run_attention(q, q, q, impl="bogus", causal=True)
    assert tatt.TransformerBlock(n_in=8, moe_experts=2).AUX_LOSS


def _embedding(cls):
    return cls(n_in=11, n_out=6, activation="identity")


def test_embedding_ids_and_one_hot():
    rng = _rng(4)
    p = {"W": _randn(rng, 11, 6)}
    ids = rng.integers(0, 11, (3, 9))
    one_hot = np.eye(11, dtype=np.float32)[ids]
    for x in (ids, ids.astype(np.int32), one_hot):
        want = _jax_apply(_embedding(jff.EmbeddingSequenceLayer), p, x)
        got = _torch_apply(_embedding(tff.EmbeddingSequenceLayer), p, x)
        np.testing.assert_array_equal(got, want)
    soft = _randn(rng, 3, 9, 11)
    kw = dict(n_in=11, n_out=6, activation="identity", one_hot_matmul=True)
    want = _jax_apply(jff.EmbeddingSequenceLayer(**kw), p, soft)
    got = _torch_apply(tff.EmbeddingSequenceLayer(**kw), p, soft)
    np.testing.assert_allclose(got, want, atol=ATOL_EW, rtol=0)


@pytest.mark.parametrize("bad", [
    np.zeros((2, 4), np.float32),                 # float ids
    np.full((2, 4), 11, np.int64),                # id == vocab
    np.full((2, 4), -1, np.int64),                # negative id
    np.zeros((2, 4, 7), np.float32),              # wrong one-hot width
    np.zeros((2, 4, 11, 1), np.float32),          # wrong rank
])
def test_embedding_input_errors(bad):
    p = {"W": np.zeros((11, 6), np.float32)}
    with pytest.raises(JInvalid):
        _jax_apply(_embedding(jff.EmbeddingSequenceLayer), p, bad)
    # the port checks the id range on the host batch at the network's
    # boundary (validate_host_ids), and dtype and shape in the layer
    layer = _embedding(tff.EmbeddingSequenceLayer)
    with pytest.raises(InvalidInputError):
        tff.validate_host_ids(layer, bad)
        _torch_apply(layer, p, bad)


@pytest.mark.parametrize("act", ["softmax", "identity"])
def test_rnn_output_head(act):
    rng = _rng(5)
    x = _randn(rng, 2, 5, 8)
    p = {"W": _randn(rng, 8, 13), "b": _randn(rng, 13)}
    kw = dict(n_in=8, n_out=13, activation=act)
    want = _jax_apply(jrec.RnnOutputLayer(**kw), p, x)
    got = _torch_apply(trec.RnnOutputLayer(**kw), p, x)
    np.testing.assert_allclose(got, want, atol=ATOL_EW, rtol=0)


def test_gelu_is_the_tanh_approximation():
    import jax
    from deeplearning4j_tpu_torch.nn import activations
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = activations.get("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_EW, rtol=0)
    # elu resolves since the activations slice, as jax.nn.elu
    np.testing.assert_allclose(
        activations.get("elu")(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.elu(jnp.asarray(x))), atol=ATOL_EW, rtol=0)


def test_decode_ids_reads_no_min_or_max_of_the_tensor(monkeypatch):
    # the range check would be a device-to-host sync in every forward
    def no_sync(self, *a, **k):
        raise AssertionError("decode_ids read the tensor's min/max")

    for name in ("min", "max", "amin", "amax", "aminmax"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    layer = _embedding(tff.EmbeddingSequenceLayer)
    ids = torch.tensor([[0, 3, 10], [11, -1, 2]])   # out of range: unchecked
    assert torch.equal(layer.decode_ids(ids), ids)


def test_validate_host_ids_passes_in_range_batches():
    layer = _embedding(tff.EmbeddingSequenceLayer)
    tff.validate_host_ids(layer, np.array([[0, 5], [10, 3]]))
    tff.validate_host_ids(layer, torch.tensor([[11, -1]]))  # tensors skip
    tff.validate_host_ids(layer, np.zeros((2, 3, 11), np.float32))
