"""Distributions, weight-init schemes, weight noise and constraints in the
port against the JAX package.

Draws compare with the same threefry key and the JAX side under
``jax.enable_x64(False)`` (the conftest turns x64 on, and then JAX draws
other Bernoulli masks): uniform, Bernoulli and constant draws are
bit-equal, the normal-based ones agree within float32 rounding of
``erfinv``/``exp``.  Init schemes draw from torch's generator, so they
compare by their moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu.nn.conf import constraints as jcons
from deeplearning4j_tpu.nn.conf import distribution as jdist
from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn import weights as tweights
from deeplearning4j_tpu_torch.nn.conf import constraints as tcons
from deeplearning4j_tpu_torch.nn.conf import distribution as tdist
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

# normal draws: torch's erfinv against XLA's erf_inv, then a scale
ATOL_NORMAL = 2e-6
# orthogonal: a Householder QR in each library of the same normal draw
ATOL_ORTHO = 1e-5

DISTS = [("NormalDistribution", dict(mean=0.5, std=2.0), "normal"),
         ("UniformDistribution", dict(lower=-0.3, upper=0.7), "exact"),
         ("BinomialDistribution", dict(trials=4, prob=0.3), "exact"),
         ("LogNormalDistribution", dict(mean=0.1, std=0.5), "normal"),
         ("TruncatedNormalDistribution", dict(mean=0.0, std=1.5), "normal"),
         ("OrthogonalDistribution", dict(gain=1.3), "ortho"),
         ("ConstantDistribution", dict(value=0.25), "exact")]


@pytest.mark.parametrize("shape", [(6, 9), (9, 6), (3, 3, 2, 5)])
@pytest.mark.parametrize("name,kw,kind", DISTS)
def test_distribution_sample_matches_jax(name, kw, kind, shape):
    with jax.enable_x64(False):
        want = np.asarray(getattr(jdist, name)(**kw).sample(
            jax.random.PRNGKey(17), shape))
    t = getattr(tdist, name)(**kw)
    got = t.sample(_random.prng_key(17), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    if kind == "exact":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        atol = ATOL_ORTHO if kind == "ortho" else \
            ATOL_NORMAL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    back = tdist.Distribution.from_dict(t.to_dict())
    assert back == t and t.to_dict() == getattr(jdist, name)(**kw).to_dict()


def test_truncated_normal_stays_inside():
    x = tdist.truncated_normal(_random.prng_key(3), -2.0, 2.0, (20000,))
    assert float(x.min()) > -2.0 and float(x.max()) < 2.0
    assert abs(float(x.std()) - 0.8796) < 0.02    # std of N(0,1) on [-2,2]


@pytest.mark.parametrize("scheme", [s for s in tweights.SCHEMES
                                    if s != "distribution"])
def test_init_scheme_moments_match_jax(scheme):
    shape = (48, 48) if scheme == "identity" else (3, 3, 24, 40)
    want = np.asarray(jweights.init_weights(jax.random.PRNGKey(0), shape,
                                            scheme))
    got = tweights.init_weights(torch.Generator().manual_seed(0), shape,
                                scheme).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if scheme in ("zero", "ones", "identity"):
        np.testing.assert_array_equal(got, want)
        return
    # 8640 draws: the sample std is within ~3% at 2 sigma
    assert abs(got.std() / want.std() - 1) < 0.05, scheme
    assert abs(got.mean()) < 0.05 * want.std()
    if "uniform" in scheme:
        r = np.abs(want).max()
        assert np.abs(got).max() <= r * 1.001


def test_distribution_scheme_draws_from_the_threefry_stream():
    layer = tff.DenseLayer(n_in=64, n_out=80, weight_init="distribution",
                           weight_dist=tdist.NormalDistribution(0.5, 0.1))
    w = layer.make_weight(torch.Generator().manual_seed(2), (64, 80), "cpu")
    assert abs(float(w.mean()) - 0.5) < 0.01
    assert abs(float(w.std()) - 0.1) < 0.01
    again = layer.make_weight(torch.Generator().manual_seed(2), (64, 80),
                              "cpu")
    assert torch.equal(w, again)
    with pytest.raises(ValueError, match="requires a Distribution"):
        tweights.init_weights(torch.Generator(), (2, 2), "distribution")


def _noised(kind, noise_j, noise_t, rng):
    """(JAX output, port output) of one layer in training with weight
    noise under the key ``PRNGKey(5)``."""
    if kind == "dense":
        j = jff.DenseLayer(n_in=6, n_out=4, activation="tanh",
                           weight_noise=noise_j)
        t = tff.DenseLayer(n_in=6, n_out=4, activation="tanh",
                           weight_noise=noise_t)
        x = rng.standard_normal((3, 6)).astype(np.float32)
        p = {"W": rng.standard_normal((6, 4)), "b": rng.standard_normal(4)}
    elif kind == "conv":
        j = jconv.ConvolutionLayer(n_in=2, n_out=3, kernel_size=(3, 3),
                                   activation="identity",
                                   weight_noise=noise_j)
        t = tconv.ConvolutionLayer(n_in=2, n_out=3, kernel_size=(3, 3),
                                   activation="identity",
                                   weight_noise=noise_t)
        x = rng.standard_normal((2, 5, 5, 2)).astype(np.float32)
        p = {"W": rng.standard_normal((3, 3, 2, 3)),
             "b": rng.standard_normal(3)}
    else:
        j = jrec.LSTM(n_in=3, n_out=4, activation="tanh",
                      weight_noise=noise_j)
        t = trec.LSTM(n_in=3, n_out=4, activation="tanh",
                      weight_noise=noise_t)
        x = rng.standard_normal((2, 5, 3)).astype(np.float32)
        p = {"W": rng.standard_normal((3, 16)),
             "U": rng.standard_normal((4, 16)), "b": rng.standard_normal(16)}
    p = {k: (v * 0.5).astype(np.float32) for k, v in p.items()}
    with jax.enable_x64(False):
        want = j.apply({"params": {k: jnp.asarray(v) for k, v in p.items()},
                        "state": {}}, jnp.asarray(x), train=True,
                       key=jax.random.PRNGKey(5))
        want = np.asarray(want[0] if isinstance(want, tuple) else want)
    got = t.apply({k: torch.tensor(v) for k, v in p.items()},
                  torch.tensor(x), train=True, key=_random.prng_key(5))
    plain = t.apply({k: torch.tensor(v) for k, v in p.items()},
                    torch.tensor(x))
    return want, got.numpy(), plain.numpy()


@pytest.mark.parametrize("kind", ["dense", "conv", "lstm"])
@pytest.mark.parametrize("noise", ["dropconnect", "weightnoise"])
def test_weight_noise_matches_jax(kind, noise):
    if noise == "dropconnect":
        nj, nt = jdrop.DropConnect(p=0.6), tdrop.DropConnect(p=0.6)
    else:
        nj = jdrop.WeightNoise(jdist.NormalDistribution(0.0, 0.2))
        nt = tdrop.WeightNoise(tdist.NormalDistribution(0.0, 0.2))
    want, got, plain = _noised(kind, nj, nt, np.random.default_rng(8))
    # DropConnect's mask is bit-equal; the products then round alike up
    # to summation order.  WeightNoise adds normal draws (ATOL_NORMAL
    # each) into the same products.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got, plain)      # the noise did something


def test_multiplicative_weight_noise_and_inference():
    p = {"W": torch.ones(3, 2), "b": torch.ones(2)}
    wn = tdrop.WeightNoise(tdist.ConstantDistribution(2.0), additive=False)
    layer = tff.DenseLayer(n_in=3, n_out=2, weight_noise=wn)
    got = layer.maybe_noise_weights(p, True, _random.prng_key(0))
    assert torch.equal(got["W"], torch.full((3, 2), 2.0))
    assert got["b"] is p["b"]
    assert layer.maybe_noise_weights(p, False, _random.prng_key(0)) is p
    assert layer.maybe_noise_weights(p, True, None) is p


CONSTRAINTS = {
    "max_norm": lambda m: [m.MaxNormConstraint(max_norm=0.3)],
    "min_max": lambda m: [m.MinMaxNormConstraint(min_norm=0.2, max_norm=0.4,
                                                  rate=0.7)],
    "non_negative_biases": lambda m: [m.NonNegativeConstraint(
        apply_to_weights=False, apply_to_biases=True)],
    "unit_norm_then_max": lambda m: [m.UnitNormConstraint(),
                                     m.MaxNormConstraint(max_norm=0.9)],
}


@pytest.mark.parametrize("which", sorted(CONSTRAINTS))
def test_constraints_over_three_steps_match_jax(which):
    def build(nnc, it, ff, u, m):
        return (nnc.builder().seed(4).updater(u.Sgd(learning_rate=0.5))
                .activation("tanh").list()
                .layer(ff.DenseLayer(n_out=5, constraints=CONSTRAINTS[which](m)))
                .layer(ff.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent",
                                      constraints=CONSTRAINTS[which](m)))
                .set_input_type(it.feed_forward(4)).build())
    jn = JMLN(build(JNNC, JIT, jff, jupd, jcons)).init()
    tn = params_from_jax(
        MultiLayerNetwork(build(NeuralNetConfiguration, InputType, tff, tupd,
                                tcons), device="cpu"),
        jax.tree_util.tree_map(np.asarray, jn.params))
    rng = np.random.default_rng(12)
    for _ in range(3):
        x = rng.standard_normal((6, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        jn.fit(x, y)
        tn.fit(x, y)
        for k, g in jn.params.items():
            for n, a in g.items():
                np.testing.assert_allclose(
                    tn.params[k][n].detach().numpy(), np.asarray(a),
                    rtol=1e-5, atol=1e-6, err_msg=f"{k}/{n}")
    if which == "non_negative_biases":
        assert float(tn.params["layer_0"]["b"].detach().min()) >= 0
    if which == "max_norm":
        w = tn.params["layer_0"]["W"].detach()
        assert float(torch.linalg.vector_norm(w, dim=0).max()) <= 0.3 + 1e-6


def test_noised_lstm_weights_enter_the_kernel(monkeypatch):
    """``LSTM(helper="pallas")`` with DropConnect hands the kernel's
    wrapper the noised W and U, never the stored parameters, and gives
    the plain recurrence's output under the same noise."""
    from deeplearning4j_tpu_torch.ops import pallas_lstm
    seen = {}
    inner = pallas_lstm.lstm_forward_fast

    def spy(x, W, U, b, h0, c0):
        seen["W"], seen["U"] = W.detach().clone(), U.detach().clone()
        return inner(x, W, U, b, h0, c0)

    monkeypatch.setattr(pallas_lstm, "kernel_plan_exists",
                        lambda *a, **k: True)
    monkeypatch.setattr(pallas_lstm, "lstm_forward_fast", spy)
    rng = np.random.default_rng(13)
    p = {"W": torch.tensor(rng.standard_normal((3, 16)), dtype=torch.float32),
         "U": torch.tensor(rng.standard_normal((4, 16)), dtype=torch.float32),
         "b": torch.tensor(rng.standard_normal(16), dtype=torch.float32)}
    x = torch.tensor(rng.standard_normal((2, 5, 3)), dtype=torch.float32)
    key = _random.prng_key(5)

    def lstm(helper):
        return trec.LSTM(n_in=3, n_out=4, activation="tanh", helper=helper,
                         weight_noise=tdrop.DropConnect(p=0.5))
    y = lstm("pallas").apply(p, x, train=True, key=key)
    want = lstm("pallas").maybe_noise_weights(p, True, key)
    assert torch.equal(seen["W"], want["W"]) and \
        torch.equal(seen["U"], want["U"])
    assert not torch.equal(seen["W"], p["W"])
    plain = lstm(None).apply(p, x, train=True, key=key)
    torch.testing.assert_close(y, plain, rtol=0, atol=1e-6)
