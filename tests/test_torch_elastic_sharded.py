"""Elastic sharded training in the port: the multi-writer barrier of
``save_sharded`` and ``ElasticTrainer`` over the sharded layout.

* The ``ShardBarrier`` cases of ``tests/test_elastic_sharded.py``: a
  two-writer commit (restorable by either package), a late writer, an
  abort on eviction and on timeout (orphans swept), a stale generation,
  the chaos stages in order.  The writers are emulated in one process,
  as there: each posts its block into the round's shared staging dir.
* An ``ElasticTrainer`` crash and restart equal to the uninterrupted run
  (a network and a ``ShardedTrainer``), and the single-process
  membership loss: a peer's lease dies mid-run, its barrier round
  aborts, it is evicted and the survivor rebuilds its mesh from the
  boundary checkpoint.
* Survivor-mesh restore after a real loss: 2 gloo ranks train under
  ``ElasticTrainer`` with barrier saves, rank 1 is gone, rank 0 restores
  the newest complete checkpoint onto a one-rank mesh and finishes;
  its params equal a single-device run from that checkpoint.

The oracle is the port's own uninterrupted run (the JAX package's
one-trace and mesh-size tests do not hold on this rig's jax).
"""
import hashlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.faulttolerance.checkpoint import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.faulttolerance.checkpoint import (
    CheckpointManager, ShardBarrier, ShardBarrierError)
from deeplearning4j_tpu_torch.faulttolerance.cluster import (
    ClusterCoordinator, ClusterMember, ClusterView, FileLeaseStore,
    live_ranks)
from deeplearning4j_tpu_torch.observability.registry import default_registry
from deeplearning4j_tpu_torch.parallel import ElasticTrainer, ShardedTrainer
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dp_scenarios as scen  # noqa: E402


def _jax_mlp(seed=19, hidden=32):
    conf = (JNNC.builder().seed(seed).updater(jupd.Adam(learning_rate=0.02))
            .list().layer(jff.DenseLayer(n_out=hidden, activation="tanh"))
            .layer(jff.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(8)).build())
    return JMLN(conf).init()


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("elastic") / "mlp.zip")
    write_model(_jax_mlp(), path)
    return path


def mlp(zip_path):
    return load_reference_model(zip_path, device="cpu")


def sharded_net(zip_path):
    net = mlp(zip_path)
    return net, ShardedTrainer(net, Mesh(1, 0, device="cpu"),
                               min_shard_size=0)


def batches(n=12, seed=7, bs=8):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((bs, 8)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, bs)])
            for _ in range(n)]


def digests(net):
    return {f"{k}/{n}": hashlib.sha256(
        p.detach().numpy().tobytes()).hexdigest()
        for k, g in net.params.items() for n, p in g.items()}


def _two_writer_save(mgr, net, step, generation=1, timeout_s=10.0,
                     live=None):
    """Both writers of a 2-process world from one process: the
    non-primary stages its block + marker first, then the primary
    commits."""
    mgr.save_sharded(net, process_index=1, process_count=2, step=step,
                     barrier=ShardBarrier(generation=generation,
                                          timeout_s=timeout_s))
    return mgr.save_sharded(
        net, process_index=0, process_count=2, step=step,
        barrier=ShardBarrier(generation=generation, timeout_s=timeout_s,
                             live_fn=live))


# ------------------------------------------------ barrier protocol
def test_two_writer_barrier_commit_restores_in_both_packages(mlp_zip,
                                                             tmp_path):
    net, st = sharded_net(mlp_zip)
    for x, y in batches(3):
        st.fit(x, y)
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    path = _two_writer_save(mgr, net, step=3)
    names = set(os.listdir(path))
    assert {"shards-p00.npz", "shards-p01.npz", "block-p00.json",
            "block-p01.json", "topology.json", "manifest.json"} <= names
    with open(os.path.join(path, "topology.json")) as f:
        assert json.load(f)["process_count"] == 2
    want = digests(net)
    net2, state = mgr.restore_sharded(path, device="cpu")
    assert digests(net2) == want and state["sharded"] is True
    jn = _jax_mlp()
    JCheckpointManager(str(tmp_path / "store")).restore_sharded(
        path=path, net=jn, mesh=jmake_mesh(dp=2), min_shard_size=0)
    assert {f"{k}/{n}": hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
            for k, g in jn.params.items() for n, a in g.items()} == want


def test_barrier_primary_waits_for_late_writer(mlp_zip, tmp_path):
    net, _ = sharded_net(mlp_zip)
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    done = {}
    entered = threading.Event()

    class Probe:
        def on_commit_stage(self, step, stage):
            if stage == 2:
                entered.set()

    mgr.chaos = Probe()

    def primary():
        done["path"] = mgr.save_sharded(
            net, process_index=0, process_count=2, step=1,
            barrier=ShardBarrier(generation=7, timeout_s=30))

    th = threading.Thread(target=primary)
    th.start()
    assert entered.wait(30)
    assert th.is_alive()          # waiting on writer 1's marker
    CheckpointManager(mgr.directory, background=False).save_sharded(
        net, process_index=1, process_count=2, step=1,
        barrier=ShardBarrier(generation=7, timeout_s=30))
    th.join(timeout=30)
    assert not th.is_alive()
    assert mgr.latest() == done["path"]


def test_barrier_abort_on_eviction_and_orphan_sweep(mlp_zip, tmp_path):
    net, st = sharded_net(mlp_zip)
    x, y = batches(1, seed=3)[0]
    st.fit(x, y)
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    prev = _two_writer_save(mgr, net, step=1)
    st.fit(x, y)
    with pytest.raises(ShardBarrierError, match="evicted mid-barrier"):
        mgr.save_sharded(net, process_index=0, process_count=2, step=2,
                         barrier=ShardBarrier(generation=2, timeout_s=30,
                                              live_fn=lambda: {0}))
    names = os.listdir(mgr.directory)
    orphans = [n for n in names if n.startswith(".tmp-")]
    assert orphans and "ckpt-00000002" not in names
    assert mgr.latest() == prev
    net2, _ = mgr.restore_sharded(device="cpu")
    assert net2.iteration == 1
    assert mgr.sweep_orphans() == len(orphans)
    assert not any(n.startswith(".tmp-") for n in os.listdir(mgr.directory))
    c = default_registry().get("checkpoint_barrier_aborts_total")
    assert c is None or c.labels().value >= 1


def test_barrier_abort_on_timeout(mlp_zip, tmp_path):
    net, _ = sharded_net(mlp_zip)
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    t0 = time.monotonic()
    with pytest.raises(ShardBarrierError, match="never landed"):
        mgr.save_sharded(net, process_index=0, process_count=2, step=1,
                         barrier=ShardBarrier(generation=1, timeout_s=0.4))
    assert time.monotonic() - t0 < 10
    assert mgr.latest() is None


def test_stale_generation_writer_cannot_land_block(mlp_zip, tmp_path):
    net, _ = sharded_net(mlp_zip)
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    final = mgr.path_for(1)
    mgr.save_sharded(net, process_index=1, process_count=2, step=1,
                     barrier=ShardBarrier(generation=3, timeout_s=5))
    stale_dir = mgr.barrier_staging(final, 3)
    live_dir = mgr.barrier_staging(final, 4)
    assert os.path.isdir(stale_dir) and stale_dir != live_dir
    os.makedirs(live_dir, exist_ok=True)
    with open(os.path.join(live_dir, "block-p01.json"), "w") as f:
        json.dump({"process_index": 1, "generation": 3,
                   "complete": True}, f)
    assert mgr._scan_block_markers(live_dir, 4) == set()
    with pytest.raises(ShardBarrierError, match="never landed"):
        mgr.save_sharded(net, process_index=0, process_count=2, step=1,
                         barrier=ShardBarrier(generation=4, timeout_s=0.4))
    assert mgr.latest() is None
    assert mgr.sweep_orphans() >= 2


def test_barrier_chaos_stages_fire_in_order(mlp_zip, tmp_path):
    net, _ = sharded_net(mlp_zip)

    class Probe:
        def __init__(self):
            self.stages = []

        def on_commit_stage(self, step, stage):
            self.stages.append((step, stage))

    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    mgr.chaos = Probe()
    mgr.save_sharded(net, process_index=1, process_count=2, step=5,
                     barrier=ShardBarrier(generation=1, timeout_s=5))
    assert mgr.chaos.stages == [(5, 2)]
    mgr.chaos = Probe()
    mgr.save_sharded(net, process_index=0, process_count=2, step=5,
                     barrier=ShardBarrier(generation=1, timeout_s=5))
    assert mgr.chaos.stages == [(5, 1), (5, 2), (5, 3), (5, 4)]


def test_live_ranks_reads_leases_without_revoking(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    store.renew(3, ttl_s=10.0)
    store.renew(9, ttl_s=0.01)
    view = ClusterView(generation=1, members=(3, 7, 9))
    time.sleep(0.05)
    assert live_ranks(store, view) == {0}
    assert store.read(9) is not None


# ------------------------------------------------ ElasticTrainer
class _Crash(RuntimeError):
    pass


def _crashing(bs, after):
    def factory():
        for i, b in enumerate(bs):
            if i == after:
                raise _Crash(f"crash before batch {i}")
            yield b
    return factory


@pytest.mark.parametrize("wrapped", [False, True],
                         ids=["network", "sharded_trainer"])
def test_elastic_crash_and_restart_equals_uninterrupted(mlp_zip, tmp_path,
                                                        wrapped):
    bs = batches(8)

    def model():
        net = mlp(mlp_zip)
        if not wrapped:
            return net, net
        return net, ShardedTrainer(net, Mesh(1, 0, device="cpu"),
                                   min_shard_size=0)

    ref, m = model()
    assert ElasticTrainer(m, str(tmp_path / "ref"), save_freq=2).fit(
        lambda: iter(bs)) == 8
    net, m = model()
    with pytest.raises(_Crash):
        ElasticTrainer(m, str(tmp_path / "run"), save_freq=2).fit(
            _crashing(bs, 5))
    net, m = model()      # a fresh process's network
    et = ElasticTrainer(m, str(tmp_path / "run"), save_freq=2)
    assert et.fit(lambda: iter(bs)) == 8
    assert et.last_restored_step == 4 and et.trained_steps == 4
    assert digests(net) == digests(ref)
    assert torch.equal(net._rng, ref._rng)
    mgr = CheckpointManager(str(tmp_path / "run"))
    assert bool(mgr.checkpoints()[-1][2].get("sharded")) == wrapped


def test_elastic_sharded_membership_loss_rebuilds_survivor_mesh(mlp_zip,
                                                                tmp_path):
    """A peer's lease dies mid-run: its barrier round aborts (never a torn
    store), it is evicted at the next boundary, and the survivor rebuilds
    its mesh from the boundary checkpoint, then finishes every batch."""
    bs = batches()
    store = FileLeaseStore(str(tmp_path))
    coord = ClusterCoordinator(store, lease_ttl_s=0.4)
    m0 = ClusterMember(store, 0, lease_ttl_s=5.0)
    m0.renew_once()
    net, st = sharded_net(mlp_zip)
    meshes = []

    def survivor_mesh(world):
        meshes.append(Mesh(world, 0, device="cpu"))
        return meshes[-1]

    t = ElasticTrainer(st, str(tmp_path), save_freq=2, member=m0,
                       coordinator=coord, mesh_factory=survivor_mesh,
                       barrier_timeout_s=5.0)
    store.renew(1, ttl_s=0.45)            # dies silently mid-run
    coord.begin_round(0)

    def slow():
        for b in bs:
            time.sleep(0.06)
            yield b

    try:
        n = t.fit(slow)
    finally:
        m0.stop()
    assert n == len(bs) and t.trained_steps == len(bs)
    assert t.barrier_aborts >= 1
    assert t.last_view.members == (0,)
    assert len(t.reshard_events) == 1
    ev = t.reshard_events[0]
    assert ev["world_size"] == 1 and ev["via"] == "restore_sharded"
    assert ev["rewind_to"] is None
    assert st.mesh is meshes[-1]
    mgr = CheckpointManager(str(tmp_path), background=False)
    for _, path, manifest in mgr.checkpoints():
        assert manifest.get("sharded")
    net2, _ = mgr.restore_sharded(device="cpu")
    assert np.isfinite(net2.params["layer_0"]["W"].detach().numpy()).all()


def test_survivor_mesh_restore_after_a_rank_is_lost(mlp_zip, tmp_path):
    """2 gloo ranks, ZeRO-3 at dp 2, barrier saves every 2 steps through
    ElasticTrainer; after 4 steps rank 1 is gone.  Rank 0 restores the
    newest complete checkpoint (step 4, both ranks' blocks) onto a
    one-rank mesh and trains batches 4-7: equal to one device restoring
    the same checkpoint and training the same batches."""
    bs = batches(8)
    store = str(tmp_path / "store")
    got = scen.run(2, [{"fn": "elastic_survivor", "name": "s", "dp": 2,
                        "zip": mlp_zip, "batches": bs, "first": 4,
                        "save_freq": 2, "dir": store,
                        "min_shard_size": 0}])["s"]
    assert got["restored"] == 4 and got["steps"] == 8 and got["dp"] == 1
    # the single-device twin: restore step 4 and train the same batches
    mgr = CheckpointManager(store)
    step4 = [p for s, p, _ in mgr.checkpoints() if s == 4][0]
    with open(os.path.join(step4, "topology.json")) as f:
        assert json.load(f)["process_count"] == 2
    twin = mlp(mlp_zip)
    mgr.restore_sharded(path=step4, net=twin, device="cpu")
    for x, y in bs[4:]:
        twin.fit(x, y)
    for k, g in got["params"].items():
        for n, a in g.items():
            np.testing.assert_array_equal(
                a, twin.params[k][n].detach().numpy(), err_msg=f"{k}/{n}")
