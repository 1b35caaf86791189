"""The port's ``ParallelWrapper`` at 2 and 4 gloo ranks against the JAX
package's ``ParallelWrapper`` at the same dp (a mesh over the conftest's 8
virtual CPU devices), 3 steps from the same weights (``write_model`` +
``load_reference_model``) on the same batches:

* an MLP under Adam;
* a conv net with BatchNormalization (global batch statistics), and the
  same with ``helper="pallas"``: the fused apply takes the global
  statistics in every rank's step (on the CPU its plain twin);
* the TransformerLM at 2 layers, embed 128, seq 128, 2 heads of 64 (the
  port's flash dispatch, on the CPU its plain twin) with block dropout
  (the global batch's masks, bit-equal; x64 off on the JAX side);
* an LSTM with a label mask whose valid count differs per rank (global
  loss denominators);
* ``clipl2perlayer`` gradient normalization;
* an indivisible batch (11 rows: trimmed to 10 at dp 2, 8 at dp 4);
* ``shard_optimizer_state=True`` (ZeRO-1).

Then the port's 2-rank result against the port's own single-device
``fit`` on the whole (trimmed) batch.  All ranks of every scenario run in
ONE spawn of 4 processes (``helpers/torch_ranks.py``); a dp-2 scenario
runs on ranks 0-1.
"""
import os
import sys

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dp_scenarios as scen  # noqa: E402

WORLD = 4
STEPS = 3
# Losses: the port's global loss is the ranks' local sums over the
# global count, summed; JAX's is one mean over the global batch.  The
# two orders of summation differ by ~1e-7 relative: 1e-6.
RTOL_LOSS = 1e-6
# Params: within 1e-5 of each leaf's largest |value| (relative to the
# leaf's scale; per element, elements near 0 would make a pure rtol
# meaningless).  Gradient sums over ranks and the global batch reorder
# f32 additions; after 3 steps they stay ~1e-7 of the leaf scale.
RTOL_PARAMS = 1e-5
# ... plus 1e-7 absolute for a leaf whose gradient is 0 in exact
# arithmetic: the conv bias ahead of BatchNormalization (the norm removes
# any per-channel shift) moves only by f32 noise, ~4e-9 on both sides.
ATOL_PARAMS = 1e-7


def _mlp(updater, gn=None):
    b = NeuralNetConfiguration.builder().seed(3).updater(updater)
    if gn:
        b = b.gradient_normalization(gn, 0.5)
    conf = (b.list()
            .layer(jff.DenseLayer(n_out=16, activation="tanh"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _conv_bn(channels=4, helper=None):
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(jupd.Sgd(learning_rate=0.1)).list()
            .layer(jconv.ConvolutionLayer(n_out=channels, kernel_size=(3, 3),
                                          activation="identity"))
            .layer(jnorm.BatchNormalization(activation="relu",
                                            helper=helper))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    return JMLN(conf).init()


def _lstm():
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(jupd.Sgd(learning_rate=0.2)).list()
            .layer(jrec.LSTM(n_out=8, activation="tanh"))
            .layer(jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(JIT.recurrent(4, 6)).build())
    return JMLN(conf).init()


def _lm():
    jn = JTransformerLM(vocab_size=32, seq_len=128, embed=128, n_layers=2,
                        n_heads=2, sparse_labels=True,
                        updater=jupd.Sgd(learning_rate=1e-4)).init()
    for lc in jn.conf.layers[2:-1]:
        lc.dropout = 0.9
    jn.invalidate_compile_cache()
    return jn


def _one_hot(rng, n, k, shape=()):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, (n,) + shape)]


def _batches(name, rng):
    out = []
    for _ in range(STEPS):
        if name in ("mlp_adam", "clip", "zero1"):
            out.append((rng.standard_normal((16, 4)).astype(np.float32),
                        _one_hot(rng, 16, 3)))
        elif name == "indivisible":
            out.append((rng.standard_normal((11, 4)).astype(np.float32),
                        _one_hot(rng, 11, 3)))
        elif name in ("conv_bn", "conv_bn_pallas"):
            out.append((rng.standard_normal((8, 6, 6, 2)).astype(np.float32),
                        _one_hot(rng, 8, 3)))
        elif name == "lstm_mask":
            lm = (rng.random((8, 6)) < 0.7).astype(np.float32)
            lm[:4, 3:] = 0.0        # rank 0 of 2 keeps fewer steps
            lm[:, 0] = 1.0
            out.append((rng.standard_normal((8, 6, 4)).astype(np.float32),
                        _one_hot(rng, 8, 3, (6,)), None, lm))
        elif name == "lm_dropout":
            out.append((rng.integers(0, 32, (4, 128)),
                        rng.integers(0, 32, (4, 128))))
    return out


SCENARIOS = {
    "mlp_adam": (lambda: _mlp(jupd.Adam(learning_rate=0.01)), "pw", True),
    "conv_bn": (_conv_bn, "pw", True),
    # 8 channels: the fused kernel's support rule takes [*, 8], not [*, 4]
    "conv_bn_pallas": (lambda: _conv_bn(8, "pallas"), "pw", True),
    "lm_dropout": (_lm, "pw", False),
    "lstm_mask": (_lstm, "pw", True),
    "clip": (lambda: _mlp(jupd.Sgd(learning_rate=0.5), "clipl2perlayer"),
             "pw", True),
    "indivisible": (lambda: _mlp(jupd.Sgd(learning_rate=0.3)), "pw", True),
    "zero1": (lambda: _mlp(jupd.Adam(learning_rate=0.01)), "zero1", True),
}


def _jax_params(jn):
    return {k: {n: np.asarray(a) for n, a in g.items()}
            for k, g in jn.params.items()}


def _jax_fit(build, kind, dp, batches):
    jn = build()
    w = JPW(jn, jmake_mesh(dp=dp), shard_optimizer_state=(kind == "zero1"))
    losses = []
    for b in batches:
        x, y, m, lm = (list(b) + [None, None])[:4]
        w.fit(x, y, mask=m, label_mask=lm)
        losses.append(float(jn.get_score()))
    return losses, _jax_params(jn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pw")
    jax_out, jobs, data = {}, [], {}
    for name, (build, kind, x64) in SCENARIOS.items():
        batches = _batches(name, np.random.default_rng(len(name)))
        data[name] = batches
        with jax.enable_x64(x64):
            zpath = str(d / f"{name}.zip")
            write_model(build(), zpath)
            for dp in (2, 4):
                jax_out[(name, dp)] = _jax_fit(build, kind, dp, batches)
        for dp in (2, 4):
            jobs.append({"fn": "fit", "name": f"{name}@{dp}", "dp": dp,
                         "kind": kind, "zip": zpath, "batches": batches,
                         "count_fused_bn": name == "conv_bn_pallas"})
    port = scen.run(WORLD, jobs)
    return jax_out, port, data, d


def _close_params(got, want, rtol):
    for k, g in want.items():
        for n, a in g.items():
            scale = float(np.max(np.abs(a)))
            err = float(np.max(np.abs(got[k][n] - a)))
            assert err <= rtol * scale + ATOL_PARAMS, \
                f"{k}/{n}: {err} > {rtol} x {scale} + {ATOL_PARAMS}"


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_wrapper_matches_jax(runs, name, dp):
    jax_out, port, _, _ = runs
    j_losses, j_params = jax_out[(name, dp)]
    got = port[f"{name}@{dp}"]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=RTOL_LOSS)
    _close_params(got["params"], j_params, RTOL_PARAMS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_ranks_match_single_device(runs, name):
    """The port at 2 ranks against the port on one device over the whole
    (trimmed) batch: the same global objective, summed in another order."""
    _, port, data, d = runs
    net = load_reference_model(str(d / f"{name}.zip"), device="cpu")
    losses = []
    for b in data[name]:
        x, y, m, lm = (list(b) + [None, None])[:4]
        keep = (len(x) // 2) * 2
        cut = (lambda a: None if a is None else a[:keep])
        net.fit(cut(x), cut(y), mask=cut(m), label_mask=cut(lm))
        losses.append(net.get_score())
    got = port[f"{name}@2"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL_LOSS)
    want = {k: {n: p.detach().numpy() for n, p in g.items()}
            for k, g in net.params.items()}
    _close_params(got["params"], want, RTOL_PARAMS)


@pytest.mark.parametrize("dp", [2, 4])
def test_fused_bn_takes_global_statistics_in_a_multi_rank_step(runs, dp):
    """Each step of the ``helper="pallas"`` scenario goes through
    ``pallas_bn.bn_act_train`` on every rank, handed the step's global
    batch, and none through ``bn_train_norm``."""
    _, port, _, _ = runs
    got = port[f"conv_bn_pallas@{dp}"]["bn_calls"]
    assert got == {"fused_global": STEPS, "fused_local": 0, "unfused": 0}


def test_dropout_scenario_draws_masks(runs):
    """The LM's dropout is on: its step losses differ from a run of the
    same net without dropout on the same batches."""
    _, port, data, d = runs
    net = load_reference_model(str(d / "lm_dropout.zip"), device="cpu")
    for lc in net.conf.layers:
        if hasattr(lc, "dropout"):
            lc.dropout = None
    x, y = data["lm_dropout"][0]
    net.fit(x, y)
    assert abs(net.get_score() - port["lm_dropout@2"]["losses"][0]) > 1e-4


def test_param_rule_is_refused_naming_item_8():
    """Tensor parallelism is ported (``tests/test_torch_tensor_parallel``
    holds it against JAX).  What a wrapper still refuses: ZeRO-1 with a
    rule (the JAX package's refusal) and a leaf a rule splits over
    another axis than ``model``.  A mixture-of-experts net is no longer
    refused: the wrapper builds, and its step's
    global-batch context hands the layers the data axis to route over
    (``tests/test_torch_wrapper_routing.py`` holds the routing against the
    JAX package on two gloo ranks)."""
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   megatron_dense_rule)
    from deeplearning4j_tpu_torch.parallel.expert import routing_axis
    from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, P
    assert callable(megatron_dense_rule({}))
    with pytest.raises(ValueError, match="shard_optimizer_state"):
        ParallelWrapper(None, Mesh(1, 0), param_rule=lambda *a: None,
                        shard_optimizer_state=True)
    net = load_reference_model_mlp()
    with pytest.raises(NotImplementedError, match="'model' axis only"):
        ParallelWrapper(net, Mesh(1, 0, device="cpu"),
                        param_rule=lambda k, n, leaf: P("data"))
    moe = TransformerLM(vocab_size=7, seq_len=4, embed=8, n_layers=1,
                        n_heads=2, moe_experts=2).init(device="cpu")
    w = ParallelWrapper(moe, Mesh(1, 0, device="cpu"))
    with w.exchange.batch(4):
        assert routing_axis() is None          # one rank: local routing
    two = Mesh(2, 0, device="cpu")
    from deeplearning4j_tpu_torch.parallel.exchange import GradientExchange
    with GradientExchange(two).batch(4):
        assert routing_axis() is two.axes[DATA_AXIS]
    assert routing_axis() is None


def load_reference_model_mlp():
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayer, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer(n_out=4))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()
