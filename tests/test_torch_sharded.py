"""The port's ZeRO-3 ``ShardedTrainer`` and its sharded checkpoints.

* ``ShardedTrainer`` at 2 and 4 gloo ranks against the JAX package's
  ``ShardedTrainer`` at the same dp (3 steps from the same weights), and
  against the port's own ``ParallelWrapper``; the per-rank layout and
  bytes against the JAX trainer's.
* Cross-topology round trips, digests exact: the port writes at dp 4 and
  JAX restores at dp 2; JAX writes at dp 4 and the port restores at dp 2
  and at dp 3 (indivisible: leaves whose axes 3 does not divide
  replicate).  Updater slots and the key come back too.
* Corrupt and missing shards are refused; ``restore_sharded`` into an
  existing network brings its key back.

The ranks run in one spawn of 4 processes (``helpers/torch_ranks.py``).
"""
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.faulttolerance.checkpoint import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ShardedTrainer as JShardedTrainer
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.faulttolerance.checkpoint import (
    CheckpointManager, CorruptCheckpointError)
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dp_scenarios as scen  # noqa: E402

WORLD = 4
MIN_SHARD = 64
# Losses and params against JAX: as tests/test_torch_parallel_wrapper.py
# (the port sums the ranks' shares; JAX one global mean): 1e-6 relative
# on losses, 1e-5 of each leaf's scale on params.
RTOL_LOSS = 1e-6
RTOL_PARAMS = 1e-5
# ShardedTrainer against the port's ParallelWrapper: the same gradients,
# but a sharded leaf's norm sums its blocks' squares over the ranks and
# its gradient arrives by reduce-scatter instead of all-reduce — the
# reassociation class of any change of dp: 1e-6 of each leaf's scale.
RTOL_REASSOC = 1e-6


def _mlp():
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater(jupd.Adam(learning_rate=0.01)).list()
            .layer(jff.DenseLayer(n_out=16, activation="tanh"))
            .layer(jff.DenseLayer(n_out=8, activation="relu"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _lm():
    return JTransformerLM(vocab_size=64, seq_len=16, embed=32, n_layers=1,
                          n_heads=2, sparse_labels=True,
                          updater=jupd.Adam(learning_rate=1e-3)).init()


def _mlp_batches(rng, steps=3):
    return [(rng.standard_normal((16, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
            for _ in range(steps)]


def _lm_batches(rng, steps=2):
    return [(rng.integers(0, 64, (8, 16)), rng.integers(0, 64, (8, 16)))
            for _ in range(steps)]


def _np_tree(t):
    return {k: {n: np.asarray(a) for n, a in g.items()} for k, g in t.items()}


def _digest(tree):
    return scen.digest(_np_tree(tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    mlp_zip, lm_zip = str(d / "mlp.zip"), str(d / "lm.zip")
    write_model(_mlp(), mlp_zip)
    write_model(_lm(), lm_zip)
    mlp_b = _mlp_batches(np.random.default_rng(1))
    lm_b = _lm_batches(np.random.default_rng(2))
    jax_out = {}
    for dp in (2, 4):
        jn = _mlp()
        jt = JShardedTrainer(jn, jmake_mesh(dp=dp), min_shard_size=MIN_SHARD)
        losses = []
        for x, y in mlp_b:
            jt.fit(x, y)
            losses.append(float(jn.get_score()))
        jax_out[dp] = (losses, _np_tree(jn.params),
                       jt.per_device_param_bytes())
    # JAX writes the LM at dp 4 (one process: one shard file holding
    # every block)
    jn = _lm()
    jt = JShardedTrainer(jn, jmake_mesh(dp=4), min_shard_size=MIN_SHARD)
    for x, y in lm_b:
        jt.fit(x, y)
    jdir = str(d / "jax_store")
    jpath = jt.save_sharded(JCheckpointManager(jdir, background=False))
    jax_written = (_np_tree(jn.params), np.asarray(jn._rng), jn.iteration)
    jobs = []
    for dp in (2, 4):
        for kind in ("zero3", "pw"):
            jobs.append({"fn": "fit", "name": f"mlp_{kind}@{dp}", "dp": dp,
                         "kind": kind, "zip": mlp_zip, "batches": mlp_b,
                         "min_shard_size": MIN_SHARD, "bytes": kind == "zero3",
                         "output": kind == "zero3"})
    jobs.append({"fn": "save_sharded", "name": "port_write@4", "dp": 4,
                 "zip": lm_zip, "batches": lm_b, "dir": str(d / "port_store"),
                 "min_shard_size": MIN_SHARD})
    for dp in (2, 3):
        jobs.append({"fn": "restore_sharded", "name": f"port_read@{dp}",
                     "dp": dp, "zip": lm_zip, "path": jpath,
                     "min_shard_size": MIN_SHARD})
    port = scen.run(WORLD, jobs)
    return {"jax": jax_out, "port": port, "jax_written": jax_written,
            "jpath": jpath, "lm_b": lm_b, "lm_zip": lm_zip, "dir": d,
            "mlp_b": mlp_b}


def _close(got, want, rtol, atol=0.0):
    for k, g in want.items():
        for n, a in g.items():
            scale = float(np.max(np.abs(a)))
            err = float(np.max(np.abs(got[k][n] - a)))
            assert err <= rtol * scale + atol, f"{k}/{n}: {err}"


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_trainer_matches_jax(runs, dp):
    losses, params, _ = runs["jax"][dp]
    got = runs["port"][f"mlp_zero3@{dp}"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL_LOSS)
    _close(got["params"], params, RTOL_PARAMS)


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_trainer_matches_parallel_wrapper(runs, dp):
    z3, pw = runs["port"][f"mlp_zero3@{dp}"], runs["port"][f"mlp_pw@{dp}"]
    np.testing.assert_allclose(z3["losses"], pw["losses"], rtol=RTOL_LOSS)
    _close(z3["params"], pw["params"], RTOL_REASSOC)


@pytest.mark.parametrize("dp", [2, 4])
def test_bytes_per_rank_equal_jax(runs, dp):
    got = runs["port"][f"mlp_zero3@{dp}"]
    assert got["per_device_param_bytes"] == runs["jax"][dp][2]
    # the layout really shards: the first dense W is cut by dp
    assert got["layout"]["layer_0"]["W"] == 0
    assert got["layout"]["layer_0"]["b"] is None


@pytest.mark.parametrize("dp", [2, 4])
def test_output_gathers_then_shards_again_without_a_broadcast(runs, dp):
    """``ShardedTrainer.output`` after training: every leaf gathered for
    the forward, then each rank's blocks cut back locally, bit for bit
    the blocks it held, with no broadcast; the rows are the output of a
    one-device net holding the gathered params (1e-6 relative: the ranks
    run one intra-op thread, this process several)."""
    got = runs["port"][f"mlp_zero3@{dp}"]
    assert got["output"]["blocks_unchanged"]
    net = load_reference_model(str(runs["dir"] / "mlp.zip"), device="cpu")
    with torch.no_grad():
        for k, g in got["params"].items():
            for n, a in g.items():
                net.params[k][n].copy_(torch.as_tensor(a))
    want = net.output(runs["mlp_b"][0][0]).detach().numpy()
    np.testing.assert_allclose(got["output"]["rows"], want, rtol=1e-6)


def test_port_writes_at_dp4_jax_restores_at_dp2_digest_exact(runs):
    wrote = runs["port"]["port_write@4"]
    path = wrote["path"]
    names = sorted(os.listdir(path))
    assert "topology.json" in names and all(
        f"shards-p{r:02d}.npz" in names for r in range(4))
    jn = _lm()
    JCheckpointManager(os.path.dirname(path)).restore_sharded(
        path=path, net=jn, mesh=jmake_mesh(dp=2), min_shard_size=MIN_SHARD)
    assert _digest(jn.params) == wrote["digest"]
    assert np.array_equal(np.asarray(jn._rng).astype(np.int64),
                          np.asarray(wrote["rng"]))
    # the updater slots too: mu/nu of the embedding table
    mu = jn.opt_state
    leaves = jax.tree_util.tree_leaves(mu)
    emb = [np.asarray(a) for a in leaves if np.shape(a) == (64, 32)]
    want = [v for k, v in wrote["slots"].items()
            if k.startswith("layer_0/W/")]
    assert len(emb) == len(want) == 2
    assert any(np.array_equal(e, w) for e in emb for w in want)


@pytest.mark.parametrize("dp", [2, 3])
def test_jax_writes_at_dp4_port_restores_digest_exact(runs, dp):
    params, rng, iteration = runs["jax_written"]
    got = runs["port"][f"port_read@{dp}"]
    assert got["digest"] == scen.digest(params)
    assert got["iteration"] == iteration
    assert np.array_equal(np.asarray(got["rng"]),
                          rng.astype(np.int64))
    if dp == 3:
        # 3 divides neither axis of the table [64, 32]: it replicates
        assert got["layout"]["layer_0"]["W"] is None
    else:
        assert got["layout"]["layer_0"]["W"] == 0


def test_corrupt_and_missing_shards_are_refused(runs, tmp_path):
    src = runs["port"]["port_write@4"]["path"]
    store = tmp_path / "store"
    shutil.copytree(os.path.dirname(src), store)
    path = str(store / os.path.basename(src))
    mgr = CheckpointManager(str(store), background=False)
    net = load_reference_model(runs["lm_zip"], device="cpu")
    shard = os.path.join(path, "shards-p01.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(data))
    with pytest.raises(CorruptCheckpointError, match="shards-p01.npz"):
        mgr.restore_sharded(path=path, net=net, device="cpu")
    os.remove(shard)
    with pytest.raises(CorruptCheckpointError, match="shards-p01.npz"):
        mgr.restore_sharded(path=path, net=net, device="cpu")
    assert mgr.latest() is None


def test_restore_sharded_into_existing_net_brings_its_key_back(runs):
    params, rng, iteration = runs["jax_written"]
    net = load_reference_model(runs["lm_zip"], device="cpu")
    net._rng = torch.zeros_like(net._rng)
    before = {k: {n: p.detach().clone() for n, p in g.items()}
              for k, g in net.params.items()}
    got, state = CheckpointManager(os.path.dirname(runs["jpath"])) \
        .restore_sharded(path=runs["jpath"], net=net, device="cpu")
    assert got is net and state.get("sharded") is True
    assert np.array_equal(net._rng.numpy(), rng.astype(np.int64))
    assert net.iteration == iteration
    assert scen.digest({k: {n: p.detach().numpy() for n, p in g.items()}
                        for k, g in net.params.items()}) == \
        scen.digest(params)
    assert any(not torch.equal(before[k][n], net.params[k][n])
               for k in before for n in before[k])
    # restore() refuses a sharded directory with the JAX package's error
    with pytest.raises(ValueError, match="SHARDED checkpoint"):
        CheckpointManager(os.path.dirname(runs["jpath"])).restore(
            path=runs["jpath"], net=net, device="cpu")


def test_multi_writer_save_without_barrier_is_refused(runs, tmp_path):
    net = load_reference_model(runs["lm_zip"], device="cpu")
    with pytest.raises(NotImplementedError, match="barrier"):
        CheckpointManager(str(tmp_path)).save_sharded(
            net, process_index=1, process_count=2)
