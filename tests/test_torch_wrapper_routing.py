"""Routing the global batch under ``ParallelWrapper``, and ZeRO-3 that
gathers one layer at a time, on two gloo ranks of the port against the
JAX package.

* A float64 net with a ``MixtureOfExpertsLayer`` under the port's
  ``ParallelWrapper`` at world 2 matches the JAX package's fit on the
  global batch within 1e-10 (losses and params; f64 on both sides, the
  same sums in another order).  Its capacity is tight (factor 0.5: 2
  slots an expert for the 16 global tokens), so each rank routing only
  its own 8 tokens (1 slot an expert) would drop other tokens: that run
  is held to differ from the JAX fit by more than 1e-6.
* ``ShardedTrainer`` gathers a layer's leaves just before its forward
  and again in its backward: after every gather at most one layer has a
  whole leaf alive (weak references), and the params are bit for bit the
  replicated ``ParallelWrapper``'s at world 2, as they were when the
  step gathered every leaf at once.
* ``initialize_distributed`` with no device on a machine without a card
  raises; ``device="cpu"`` and ``backend="gloo"`` start gloo.

The ranks run in one spawn of 2 processes (``helpers/torch_ranks.py``).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import moe as jmoe
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils.model_serializer import write_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dp_scenarios as scen  # noqa: E402

WORLD = 2
STEPS = 3
TOL64 = 1e-10
# rank-local routing against the global one: the dropped tokens move the
# loss by O(1e-2); 1e-6 is far above the f64 noise and far below that
LOCAL_DIFF = 1e-6


def _moe_net():
    conf = (NeuralNetConfiguration.builder().seed(11).dtype("float64")
            .updater(jupd.Sgd(learning_rate=0.1)).list()
            .layer(jmoe.MixtureOfExpertsLayer(
                n_out=8, n_experts=4, hidden=16, activation="relu",
                capacity_factor=0.5))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(6)).build())
    return JMLN(conf).init()


def _mlp():
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(jupd.Adam(learning_rate=0.01)).list()
            .layer(jff.DenseLayer(n_out=16, activation="tanh"))
            .layer(jff.DenseLayer(n_out=16, activation="relu"))
            .layer(jff.DenseLayer(n_out=8, activation="relu"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _lm():
    return JTransformerLM(vocab_size=64, seq_len=16, embed=32, n_layers=2,
                          n_heads=2, sparse_labels=True,
                          updater=jupd.Adam(learning_rate=1e-3)).init()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("routing")
    rng = np.random.default_rng(5)
    moe_batches = [(rng.standard_normal((16, 6)),
                    np.eye(3)[rng.integers(0, 3, 16)]) for _ in range(STEPS)]
    mlp_batches = [(rng.standard_normal((16, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
                   for _ in range(STEPS)]
    lm_batches = []
    for _ in range(STEPS):
        x = rng.integers(0, 64, (8, 16))
        lm_batches.append((x, (x + 3) % 64))
    jmoe_net = _moe_net()
    paths = {}
    for name, make in (("moe", lambda: jmoe_net), ("mlp", _mlp),
                       ("lm", _lm)):
        paths[name] = str(d / f"{name}.zip")
        write_model(make(), paths[name])
    want = []
    for x, y in moe_batches:
        jmoe_net.fit(x, y)
        want.append(float(jmoe_net.get_score()))
    jax_moe = {"losses": want, "params": jax.tree_util.tree_map(
        np.asarray, jmoe_net.params)}
    payload = [
        {"fn": "fit", "name": "moe", "kind": "pw", "dp": 2,
         "zip": paths["moe"], "batches": moe_batches},
        {"fn": "fit", "name": "moe_local", "kind": "pw", "dp": 2,
         "zip": paths["moe"], "batches": moe_batches,
         "local_routing": True}]
    for name, batches in (("mlp", mlp_batches), ("lm", lm_batches)):
        payload += [
            {"fn": "fit", "name": f"{name}_pw", "kind": "pw", "dp": 2,
             "zip": paths[name], "batches": batches},
            {"fn": "zero3_gathers", "name": f"{name}_zero3", "dp": 2,
             "zip": paths[name], "batches": batches, "min_shard_size": 64}]
    return jax_moe, scen.run(WORLD, payload)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(a[k][n]) - np.asarray(b[k][n])).max())
               for k in b for n in b[k])


def test_moe_under_the_wrapper_routes_the_global_batch_as_jax(runs):
    want, port = runs
    got = port["moe"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL64,
                               atol=0)
    assert _max_diff(got["params"], want["params"]) <= TOL64


def test_rank_local_routing_would_differ(runs):
    """The case discriminates: routing each rank's tokens alone (the
    refused layout's step) lands measurably off the JAX fit."""
    want, port = runs
    local = port["moe_local"]
    assert max(abs(a - b) for a, b in zip(local["losses"],
                                          want["losses"])) > LOCAL_DIFF
    assert _max_diff(local["params"], want["params"]) > LOCAL_DIFF


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_zero3_gathers_one_layer_at_a_time(runs, name):
    z3 = runs[1][f"{name}_zero3"]
    assert z3["most_layers_alive"] == 1
    # every layer's sharded leaves gathered for its forward each step,
    # and again in the backward where an op needs them (the first
    # layer's weight gradient does not)
    assert len(z3["layers"]) >= 3
    assert z3["gathers"] > STEPS * len(z3["layers"])


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_zero3_per_layer_equals_the_wrapper_bitwise(runs, name):
    pw, z3 = runs[1][f"{name}_pw"], runs[1][f"{name}_zero3"]
    for k, g in pw["params"].items():
        for n, a in g.items():
            assert np.array_equal(z3["params"][k][n], a), f"{k}/{n}"


def test_initialize_distributed_needs_a_device_without_a_card(monkeypatch):
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import initialize_distributed
    from torch_ranks import free_port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device: pass "
                                           "device='cpu'"):
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    assert not dist.is_initialized()
    for kw in ({"device": "cpu"}, {"backend": "gloo"}):
        assert initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                      **kw)
        try:
            assert dist.get_backend() == "gloo"
        finally:
            dist.destroy_process_group()
