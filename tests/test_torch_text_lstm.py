"""The char-LSTM slice as a whole: the zoo ``TextGenerationLSTM`` written
by the JAX package's ``write_model`` and read by ``load_reference_model``,
run on both sides with ``helper=None`` (the plain recurrence) and
``helper="pallas"`` (the Pallas kernel in interpret mode there; the
port's kernel path, which takes the plain version on CPU tensors, here):
``output``, ``rnn_time_step`` and 5 ``fit`` steps of Adam with gradient
clipping.  Small: 12 classes, 8 steps, 16 hidden units, f32.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import \
    TextGenerationLSTM as JaxTextGenerationLSTM
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models.zoo import (TextGenerationLSTM,
                                                 TransformerLM)
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
from deeplearning4j_tpu_torch.ops import pallas_lstm
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, updater_state_from_jax)

SMALL = dict(num_classes=12, timesteps=8, hidden=16)
V, T = SMALL["num_classes"], SMALL["timesteps"]
# Probabilities after two LSTM layers and a softmax, f32 on both sides
# with the same formulas in another summation order: a few ulps of
# logits of order 1: 2e-6 abs.  Streaming adds nothing: the port's
# carries are f32, the JAX side's f64 under x64 on the plain path (the
# Pallas path casts them to f32), which moves a probability by ~1e-7.
ATOL_OUT = 2e-6
# Losses: a sum over 8 steps of ~2.5 nats per row, averaged over rows;
# the same rounding noise: 1e-6 relative.  Adam with clipping at 10 moves
# every param by ~lr per step whatever |g| is, so the 5 steps' losses
# stay within the same bound.
RTOL_LOSS = 1e-6


@pytest.fixture(scope="module", params=[None, "pallas"],
                ids=["plain", "pallas"])
def nets(request, tmp_path_factory):
    helper = request.param
    jn = JaxTextGenerationLSTM(**SMALL).init()
    for lc in jn.conf.layers[:2]:
        lc.helper = helper
    jn.invalidate_compile_cache()
    path = tmp_path_factory.mktemp("textlstm") / "model.zip"
    write_model(jn, str(path))
    tn = load_reference_model(path, device="cpu")
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    return helper, jn, tn


def _onehot(rng, b, t):
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


class _CountCalls:
    """Counts calls of ``pallas_lstm.lstm_forward``, the function that
    launches the kernel on CUDA tensors."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = pallas_lstm.lstm_forward

        def counted(*a):
            self.calls += 1
            return inner(*a)
        monkeypatch.setattr(pallas_lstm, "lstm_forward", counted)


def test_configuration_reads_back(nets):
    helper, jn, tn = nets
    assert [type(lc).__name__ for lc in tn.conf.layers] == \
        ["LSTM", "LSTM", "RnnOutputLayer"]
    assert all(lc.helper == helper for lc in tn.conf.layers[:2])
    assert tn.conf.defaults["gradient_normalization"] == \
        "clipelementwiseabsolutevalue"
    # the port's zoo model builds the same configuration
    mine = TextGenerationLSTM(**SMALL).conf()
    mine.resolve()
    for a, b in zip(mine.layers, tn.conf.layers):
        assert (a.n_in, a.n_out, a.activation) == (b.n_in, b.n_out,
                                                   b.activation)
    assert mine.defaults["gradient_normalization_threshold"] == 10.0
    assert tn.num_params() == sum(
        np.asarray(a).size for g in jn.params.values() for a in g.values())


def test_output_and_rnn_time_step_match_jax(nets, monkeypatch):
    helper, jn, tn = nets
    count = _CountCalls(monkeypatch)
    x = _onehot(np.random.default_rng(0), 4, T)
    want = np.asarray(jn.output(x))
    got = tn.output(x).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    tn.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    parts, jparts = [], []
    for sl in (slice(0, 3), slice(3, 4), slice(4, T)):
        parts.append(tn.rnn_time_step(x[:, sl]).numpy())
        jparts.append(np.asarray(jn.rnn_time_step(x[:, sl])))
    step = tn.rnn_time_step(x[:, 0])          # one [b, f] step
    jstep = np.asarray(jn.rnn_time_step(x[:, 0]))
    stream = np.concatenate(parts, axis=1)
    np.testing.assert_allclose(stream, got, atol=1e-6, rtol=0)
    np.testing.assert_allclose(stream, np.concatenate(jparts, axis=1),
                               atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(step.numpy(), jstep, atol=ATOL_OUT, rtol=0)
    # two LSTM layers: two kernel calls per output and per streaming call
    # on the helper path (all on the CPU's plain version: no launch)
    assert count.calls == (2 * 5 if helper == "pallas" else 0)
    assert pallas_lstm.launches["lstm_fwd"] == 0


def test_five_adam_fit_steps_match_jax(nets, monkeypatch):
    helper, jn, tn = nets
    count = _CountCalls(monkeypatch)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(5):
        seq = rng.integers(0, V, (4, T + 1))
        x = np.eye(V, dtype=np.float32)[seq[:, :-1]]
        y = np.eye(V, dtype=np.float32)[seq[:, 1:]]
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
        losses.append(tn.get_score())
    assert all(np.isfinite(losses)) and tn.iteration == 5
    # 2 forward calls per step; the backward reruns the plain recurrence
    assert count.calls == (2 * 5 if helper == "pallas" else 0)
    assert tn.opt_state["count"] == {
        "default": 5, **{f"layer_{i}/w": 5 for i in range(3)}}


def test_helper_is_set_on_the_built_configuration():
    conf = TextGenerationLSTM(**SMALL).conf()
    lstms = [lc for lc in conf.layers if isinstance(lc, LSTM)]
    assert len(lstms) == 2 and all(lc.helper is None for lc in lstms)
    for lc in lstms:
        lc.helper = "pallas"
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert all(lc.helper == "pallas" for lc in net.conf.layers[:2])
    # a masked batch leaves the kernel (supports refuses masks) for the
    # plain loop, as in the reference
    count_before = pallas_lstm.launches["lstm_fwd"]
    x = torch.zeros(2, T, V)
    net.fit(x, x, mask=torch.ones(2, T))
    assert pallas_lstm.launches["lstm_fwd"] == count_before


def test_rnn_time_step_refuses_attention_stacks():
    """Attention stacks used to be refused here until their KV cache was
    ported; now they stream and train by tBPTT (the carries are held
    against the JAX package in ``test_torch_generation_carries.py``)."""
    lm = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                       n_heads=1).init(device="cpu")
    ids = np.arange(4, dtype=np.int64)[None] % 8
    y = lm.rnn_time_step(ids[:, :3])
    y = torch.cat([y, lm.rnn_time_step(ids[:, 3:])], dim=1)
    torch.testing.assert_close(y, lm.output(ids), atol=1e-6, rtol=0)
    assert int(lm.rnn_get_previous_state(1)["pos"]) == 4
    # tBPTT through the same stack takes one step per chunk
    lm.conf.backprop_type = "tbptt"
    lm.conf.tbptt_fwd_length = 2
    x = np.eye(8, dtype=np.float32)[np.zeros((1, 4), np.int64)]
    lm.fit(x, x)
    assert lm.iteration == 2
