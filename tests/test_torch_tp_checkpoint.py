"""Tensor-parallel leaves in the sharded checkpoint, across the two
packages, on four gloo ranks of the port (dp 2 x tp 2).

The port's ``ParallelWrapper(param_rule=megatron_dense_rule)`` writes
each leaf the rule splits over ``model`` as its blocks along that dim,
replicas written once (the JAX package's ``_leaf_blocks``), with the
mesh description of the real layout.  Then:

* a fresh net restored in the same layout and trained on equals the
  uninterrupted run bit for bit (params after the last step);
* a dense restore's outputs equal the gathered net's at the save;
* the JAX package restores the port's directory, and the port the JAX
  package's (written from its own tensor-parallel wrapper on 4 of the
  test process's 8 host devices): the params bit for bit the writer's,
  and outputs within 1e-6 of the writer's for the MLP (f32 on both
  sides; the same weights, sums in another order).  The LM's outputs
  are softmax rows of up to ~0.5, whose f32 forward differs between the
  packages by up to 1.55e-6 (3.2e-6 relative) on the same weights: they
  are held at 1e-6 absolute plus 1e-5 relative
  (``test_torch_tensor_parallel``'s LM tolerance).

The ranks run in one spawn of 4 processes (``helpers/torch_ranks.py``).
"""
import json
import os
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.faulttolerance.checkpoint import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.models.zoo import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import megatron_dense_rule as jrule
from deeplearning4j_tpu.utils.model_serializer import write_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_model_axes as axes  # noqa: E402

WORLD = 4
SHAPE = (2, 2)
FIRST, STEPS = 2, 4
ATOL_OUT = 1e-6
RTOL_LM_OUT = 1e-5


def _close(got, want, kind):
    if kind == "lm":
        np.testing.assert_allclose(got, want, rtol=RTOL_LM_OUT,
                                   atol=ATOL_OUT)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_OUT, rtol=0)


def _mlp():
    conf = (NeuralNetConfiguration.builder()
            .seed(42).activation("relu").weight_init("xavier")
            .updater(jupd.Adam(learning_rate=1e-3)).list()
            .layer(jff.DenseLayer(n_out=32))
            .layer(jff.DenseLayer(n_out=32))
            .layer(jff.OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(48)).build())
    return JMLN(conf).init()


def _lm():
    return JLM(vocab_size=24, seq_len=16, embed=32, n_layers=2, n_heads=2,
               sparse_labels=True,
               updater=jupd.Sgd(learning_rate=0.05)).init()


def _batches(kind, rng):
    out = []
    for _ in range(STEPS):
        if kind == "mlp":
            out.append((rng.standard_normal((8, 48)).astype(np.float32),
                        np.eye(10, dtype=np.float32)[
                            rng.integers(0, 10, 8)]))
        else:
            x = rng.integers(0, 24, (8, 16))
            out.append((x, (x + 5) % 24))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpckpt")
    rng = np.random.default_rng(9)
    payload, jax_side = [], {}
    for kind, make in (("mlp", _mlp), ("lm", _lm)):
        zip_path = str(d / f"{kind}.zip")
        write_model(make(), zip_path)
        batches = _batches(kind, rng)
        probe = batches[0][0][:4]
        # the JAX package's save of its own tensor-parallel wrapper
        jn = make()
        w = JPW(jn, jmake_mesh(dp=SHAPE[0], tp=SHAPE[1]),
                param_rule=jrule(jn.params))
        for x, y in batches[:FIRST]:
            w.fit(x, y)
        jdir = str(d / f"jax_{kind}")
        jax_path = JCheckpointManager(jdir, background=False).save_sharded(
            jn)
        jax_side[kind] = {"output": np.asarray(jn.output(probe)),
                          "params": {k: {n: np.asarray(a)
                                         for n, a in g.items()}
                                     for k, g in jn.params.items()},
                          "make": make, "probe": probe, "path": jax_path}
        payload.append({"fn": "tp_checkpoint", "name": kind, "shape": SHAPE,
                        "zip": zip_path, "batches": batches, "first": FIRST,
                        "probe": probe, "dir": str(d / f"port_{kind}"),
                        "jax_dir": jdir, "jax_path": jax_path})
    return jax_side, axes.run(WORLD, payload)


KINDS = ["mlp", "lm"]


@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_tp_blocks_once_with_the_real_mesh(runs, kind):
    per_rank = runs[1]
    path = per_rank[0][kind]["path"]
    with open(os.path.join(path, "topology.json")) as f:
        topo = json.load(f)
    assert topo["mesh"] == {"axes": ["data", "model", "seq"],
                            "shape": [2, 2, 1]}
    assert topo["process_count"] == WORLD
    cut = {k: v["dim"] for k, v in topo["params"].items()
           if v["dim"] is not None}
    assert cut and set(cut.values()) <= {0, 1}
    blocks = {}
    for p in range(WORLD):
        with open(os.path.join(path, f"shards-p{p:02d}.json")) as f:
            for e in json.load(f):
                if e["kind"] == "param":
                    blocks.setdefault(e["leaf"], []).append((p, e["start"]))
    for leaf in cut:
        # tp blocks, each written once, by the ranks of data index 0
        assert sorted(p for p, _ in blocks[leaf]) == [0, 1], leaf
        assert len({s for _, s in blocks[leaf]}) == 2
    assert [per_rank[r][kind]["writer"] for r in range(WORLD)] == \
        list(range(WORLD))


@pytest.mark.parametrize("kind", KINDS)
def test_restore_in_the_same_layout_continues_bitwise(runs, kind):
    for r in range(WORLD):
        got = runs[1][r][kind]
        assert got["restored_iteration"] == FIRST
        for k, g in got["uninterrupted"].items():
            for n, a in g.items():
                assert np.array_equal(got["resumed"][k][n], a), \
                    (r, f"{k}/{n}")


@pytest.mark.parametrize("kind", KINDS)
def test_dense_restore_outputs_equal_the_gathered_net(runs, kind):
    got = runs[1][0][kind]
    assert np.array_equal(got["dense_output"], got["saved_output"])


@pytest.mark.parametrize("kind", KINDS)
def test_the_port_reads_the_jax_tp_directory(runs, kind):
    want = runs[0][kind]["output"]
    for r in range(WORLD):
        got = runs[1][r][kind]
        for k, g in runs[0][kind]["params"].items():
            for n, a in g.items():
                assert np.array_equal(got["jax_restored"][k][n], a), \
                    (r, f"{k}/{n}")
        _close(got["jax_restored_output"], want, kind)
    _close(runs[1][0][kind]["dense_jax_output"], want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_the_jax_package_reads_the_port_tp_directory(runs, kind):
    side = runs[0][kind]
    got = runs[1][0][kind]
    jn = side["make"]()
    path = got["path"]
    JCheckpointManager(os.path.dirname(path)).restore_sharded(path, net=jn)
    assert int(jn.iteration) == FIRST
    for k, g in got["saved"].items():
        for n, a in g.items():
            assert np.array_equal(np.asarray(jn.params[k][n]), a), f"{k}/{n}"
    _close(np.asarray(jn.output(side["probe"])), got["saved_output"], kind)
