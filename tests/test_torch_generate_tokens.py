"""``models.generate_tokens`` of the port against the JAX package's, on
a JAX-written TransformerLM (vocab 11, seq 10, embed 32, 2 layers, 4
heads) and a JAX-written two-layer char-LSTM read by
``load_reference_model``: the probabilities first, then greedy tokens
and tokens sampled at temperature 0.8, seed 3, token for token."""
import numpy as np
import pytest

from deeplearning4j_tpu.models import generate_tokens as jax_generate
from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JaxCharLSTM
from deeplearning4j_tpu.models.zoo import TransformerLM as JaxTransformerLM
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models import generate_tokens
from deeplearning4j_tpu_torch.ops import pallas_lstm
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

LM = dict(vocab_size=11, seq_len=10, embed=32, n_layers=2, n_heads=4)
CHARS = dict(num_classes=7, timesteps=6, hidden=12)
# last-position softmax probabilities of two f32 stacks on the same
# weights, each package's own summation order
TOL_PROBS = 2e-5


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    jnet = JaxTransformerLM(**LM).init()
    path = tmp_path_factory.mktemp("gen_lm") / "lm.zip"
    write_model(jnet, str(path))
    return jnet, load_reference_model(path, device="cpu")


@pytest.fixture(scope="module")
def lstm_pair(tmp_path_factory):
    """The JAX net on its plain recurrence; the port's at
    ``helper="pallas"`` (the kernel's plain version on CPU tensors)."""
    jnet = JaxCharLSTM(**CHARS).init()
    path = tmp_path_factory.mktemp("gen_lstm") / "lstm.zip"
    write_model(jnet, str(path))
    net = load_reference_model(path, device="cpu")
    for lc in net.layer_confs[:2]:
        lc.helper = "pallas"
    return jnet, net


class _OneHotIds:
    """The JAX char-LSTM behind the ids interface its ``generate_tokens``
    assumes: each id fed as a one-hot row, the port's documented
    difference, so the JAX function itself samples."""

    def __init__(self, net, width):
        self.net, self.eye = net, np.eye(width, dtype=np.float32)
        self.layers = net.layers

    def rnn_clear_previous_state(self):
        self.net.rnn_clear_previous_state()

    def rnn_time_step(self, ids):
        return self.net.rnn_time_step(self.eye[np.asarray(ids)])


def _prompt(vocab, n=3, t=4):
    return np.random.default_rng(1).integers(0, vocab, (n, t))


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)],
                         ids=["greedy", "sampled"])
def test_lm_tokens_equal_jax(lm_pair, temperature, seed):
    jnet, net = lm_pair
    prompt = _prompt(LM["vocab_size"])
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    np.testing.assert_allclose(net.rnn_time_step(prompt)[:, -1].numpy(),
                               np.asarray(jnet.rnn_time_step(prompt))[:, -1],
                               atol=TOL_PROBS, rtol=0)
    got = generate_tokens(net, prompt, 6, temperature=temperature, seed=seed)
    want = jax_generate(jnet, prompt, 6, temperature=temperature, seed=seed)
    assert got.shape == (3, 10) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cache_overflow_raises_as_jax(lm_pair):
    jnet, net = lm_pair
    for layer in list(net.layer_confs) + list(jnet.layers):
        if getattr(layer, "max_cache_len", None):
            layer.max_cache_len = 9
    try:
        errors = []
        for fn, model in ((generate_tokens, net), (jax_generate, jnet)):
            with pytest.raises(ValueError, match="exceeds the smallest") as e:
                fn(model, _prompt(LM["vocab_size"]), 6)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    finally:
        for layer in list(net.layer_confs) + list(jnet.layers):
            if getattr(layer, "max_cache_len", None):
                layer.max_cache_len = 512


def test_jax_generate_tokens_fails_on_the_char_lstm(lstm_pair):
    """A fault of the reference: its ``generate_tokens`` hands token ids
    to a network whose first layer reads one-hot rows, and the LSTM's
    product fails on their width."""
    jnet, _ = lstm_pair
    with pytest.raises(TypeError, match="dot_general"):
        jax_generate(jnet, _prompt(CHARS["num_classes"]), 2)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)],
                         ids=["greedy", "sampled"])
def test_char_lstm_tokens_equal_jax(lstm_pair, monkeypatch, temperature,
                                    seed):
    jnet, net = lstm_pair
    calls = []
    real = pallas_lstm.lstm_forward

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pallas_lstm, "lstm_forward", counted)
    prompt = _prompt(CHARS["num_classes"])
    got = generate_tokens(net, prompt, 5, temperature=temperature, seed=seed)
    want = jax_generate(_OneHotIds(jnet, CHARS["num_classes"]), prompt, 5,
                        temperature=temperature, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 2 * 6         # 2 layers x (prompt + 5 steps)
    eye = np.eye(CHARS["num_classes"], dtype=np.float32)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    np.testing.assert_allclose(
        net.rnn_time_step(eye[got]).numpy(),
        np.asarray(jnet.rnn_time_step(eye[got])), atol=TOL_PROBS, rtol=0)
