"""The port's checkpoint store, fault harness and lease membership, as
``tests/test_faulttolerance.py`` and ``tests/test_cluster.py`` check the
JAX package's single-device parts: atomic commits and orphan sweeps,
retention, corrupt-directory skipping, a saver SIGKILLed mid-write, a
SIGTERM save-on-preempt, ``CheckpointListener`` and
``LocalFileModelSaver``, the seeded retry policy and fault injector, and
the lease store with its generation fence.  Lease files and checkpoint
directories are shared with the JAX package, so some checks read one
package's output with the other.

The two subprocess tests import only the port (no JAX) and each has its
own timeout.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.faulttolerance.cluster import \
    FileLeaseStore as JFileLeaseStore
from deeplearning4j_tpu.faulttolerance.faults import \
    RetryPolicy as JRetryPolicy
from deeplearning4j_tpu.observability import registry as jreg
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.earlystopping import LocalFileModelSaver
from deeplearning4j_tpu_torch.faulttolerance import (
    ChaosSchedule, CheckpointManager, ClusterCoordinator, ClusterMember,
    CorruptCheckpointError, FaultInjector, FileLeaseStore,
    InjectedWorkerFault, RetryPolicy, live_ranks, shard_owner)
from deeplearning4j_tpu_torch.faulttolerance.atomic import (
    atomic_file, atomic_write_bytes, discard_orphans)
from deeplearning4j_tpu_torch.observability import registry as treg
from deeplearning4j_tpu_torch.observability.exposition import render_text
from deeplearning4j_tpu_torch.train.listeners import CheckpointListener

REPO_ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120

# the port net of the subprocess tests, built by a child that imports
# only the port
NET_SRC = """
import numpy as np
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \\
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                            OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

def build_net():
    conf = (NeuralNetConfiguration.builder().seed(42)
            .updater(Adam(learning_rate=0.02)).list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()

def batch(rng):
    return (rng.standard_normal((8, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
"""
_ns = {}
exec(NET_SRC, _ns)
build_net, batch = _ns["build_net"], _ns["batch"]


@pytest.fixture
def live_registry():
    old = treg.set_default_registry(treg.MetricsRegistry())
    yield treg.default_registry()
    treg.set_default_registry(old)


def _child(code: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", NET_SRC + code],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)), cwd=str(REPO_ROOT))


# ------------------------------------------------------------ atomic layer
def test_atomic_write_commits_or_leaves_previous(tmp_path):
    path = str(tmp_path / "f.bin")
    atomic_write_bytes(path, b"one")
    with pytest.raises(RuntimeError):
        with atomic_file(path) as tmp:
            with open(tmp, "wb") as f:
                f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert open(path, "rb").read() == b"one"
    assert os.listdir(tmp_path) == ["f.bin"]
    (tmp_path / ".tmp-ckpt-1-dead").mkdir()
    (tmp_path / ".tmp-ckpt-1-dead" / "f").write_bytes(b"x")
    assert discard_orphans(str(tmp_path)) == 1
    assert os.listdir(tmp_path) == ["f.bin"]


# --------------------------------------------------------- checkpoint store
def test_manager_roundtrip_and_jax_reads_the_port_store(tmp_path,
                                                        live_registry):
    net = build_net()
    rng = np.random.default_rng(0)
    for _ in range(3):
        net.fit(*batch(rng))
    mgr = CheckpointManager(str(tmp_path), background=False)
    path = mgr.save(net, cursor={"fit_epoch": 0, "batch_seq": 3},
                    metric=net.get_score())
    assert mgr.latest() == path and path.endswith("ckpt-00000003")
    net2, state = mgr.restore(device="cpu")
    assert state["cursor"] == {"fit_epoch": 0, "batch_seq": 3}
    assert net2.iteration == 3 and torch.equal(net2._rng, net._rng)
    for k, g in net.params.items():
        for n, p in g.items():
            assert torch.equal(net2.params[k][n], p)
    # the JAX package validates the same directory and reads its model
    from deeplearning4j_tpu.faulttolerance.checkpoint import \
        CheckpointManager as JCheckpointManager
    jm = JCheckpointManager(str(tmp_path), background=False)
    assert JCheckpointManager.validate(path)["step"] == 3
    assert jm.latest() == path
    jn = jms.restore_model(path)
    assert jn.iteration == 3
    assert np.array_equal(np.asarray(np.load(os.path.join(path, "rng.npy"))),
                          net._rng.numpy().astype(np.uint32))
    assert live_registry.get("checkpoint_restore_total").labels(
        "ok").value == 1
    assert live_registry.get("checkpoint_write_seconds").labels(
        "sync").count == 1
    assert live_registry.get("checkpoint_bytes").labels().sum > 0


def test_retention_keep_last_every_n_and_best(tmp_path):
    net = build_net()
    rng = np.random.default_rng(1)
    mgr = CheckpointManager(str(tmp_path), keep_last=2, keep_every_n=5,
                            keep_best=1, background=False)
    metrics = {1: 5.0, 2: 4.0, 3: 0.5, 4: 3.0, 5: 2.0, 6: 1.9, 7: 1.8}
    for it in range(1, 8):
        net.fit(*batch(rng))
        assert net.iteration == it
        mgr.save(net, metric=metrics[it])
    # last two (6, 7), every 5th (5), best metric 0.5 (3)
    assert [s for s, _, _ in mgr.checkpoints()] == [3, 5, 6, 7]
    assert mgr.latest_complete(after_step=6) == (7, mgr.path_for(7))
    assert mgr.latest_complete(after_step=7) is None


def test_latest_skips_corrupt_and_restore_refuses(tmp_path, live_registry):
    net = build_net()
    rng = np.random.default_rng(2)
    mgr = CheckpointManager(str(tmp_path), background=False)
    for _ in range(2):
        net.fit(*batch(rng))
        mgr.save(net)
    newest = mgr.path_for(2)
    with open(os.path.join(newest, "model.zip"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")
    assert mgr.latest() == mgr.path_for(1)
    with pytest.raises(CorruptCheckpointError, match="model.zip"):
        mgr.restore(path=newest, device="cpu")
    c = live_registry.get("checkpoint_restore_total")
    assert c.labels("corrupt").value >= 1 and c.labels("skipped").value >= 1
    # the sharded layout is ported: an unwrapped network saves every
    # leaf whole as one writer's blocks, and restores from them
    sharded = mgr.save_sharded(net, step=9)
    assert os.path.isfile(os.path.join(sharded, "topology.json"))
    back, _ = mgr.restore_sharded(path=sharded, device="cpu")
    for k, g in net.params.items():
        for n, p in g.items():
            assert torch.equal(back.params[k][n], p)


def test_sigkill_mid_checkpoint_leaves_skippable_partial(tmp_path):
    """A saver SIGKILLed mid-stage leaves only a .tmp- orphan: discovery
    ignores it, restore refuses it, the sweep removes it."""
    store = str(tmp_path / "store")
    child = _child(f"""
import time
from deeplearning4j_tpu_torch.faulttolerance import CheckpointManager

class Stall:                       # the chaos hook between staged files
    def on_commit_stage(self, step, stage):
        time.sleep(60.0)

rng = np.random.default_rng(0)
net = build_net()
net.fit(*batch(rng))
mgr = CheckpointManager({store!r}, background=False)
mgr.save(net)                      # one good committed checkpoint
print("SAVED1", flush=True)
net.fit(*batch(rng))
mgr.chaos = Stall()
mgr.save(net)                      # the parent SIGKILLs us mid-stage
""")
    try:
        line = child.stdout.readline()
        assert "SAVED1" in line, line
        deadline = time.time() + CHILD_TIMEOUT_S
        orphan = None
        while orphan is None and time.time() < deadline:
            tmps = [n for n in os.listdir(store) if n.startswith(".tmp-")]
            orphan = os.path.join(store, tmps[0]) if tmps else None
            if orphan is None:
                time.sleep(0.02)
        assert orphan is not None, "staging dir never appeared"
        time.sleep(0.1)     # inside the stalled commit stage
        child.kill()
        child.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
    mgr = CheckpointManager(store, background=False)
    assert [s for s, _, _ in mgr.checkpoints()] == [1]
    with pytest.raises(CorruptCheckpointError):
        mgr.restore(path=orphan, device="cpu")
    assert mgr.sweep_orphans() == 1
    assert not [n for n in os.listdir(store) if n.startswith(".tmp-")]


def test_sigterm_triggers_final_save_and_clean_return(tmp_path):
    """save_on_preempt: a SIGTERM mid-fit takes one final synchronous
    checkpoint at the next iteration boundary, dumps the flight window
    beside it, and fit returns cleanly (exit 0)."""
    store = str(tmp_path / "store")
    child = _child(f"""
import json, time
from deeplearning4j_tpu_torch.faulttolerance import CheckpointConfig
from deeplearning4j_tpu_torch.train.listeners import TrainingListener

class Ready(TrainingListener):
    def iteration_done(self, model, iteration, epoch):
        if iteration == 1:
            print("READY", flush=True)
        time.sleep(0.01)           # keep the fit alive for the signal

def batches():
    rng = np.random.default_rng(0)
    for _ in range(100000):
        yield batch(rng)

net = build_net()
net.set_listeners(Ready())
net.fit(batches(), checkpoint=CheckpointConfig(
    directory={store!r}, save_on_preempt=True, background=False))
print(json.dumps({{"iteration": net.iteration}}), flush=True)
""")
    try:
        assert "READY" in child.stdout.readline()
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 0, out
    result = json.loads(out.strip().splitlines()[-1])
    mgr = CheckpointManager(store, background=False)
    net2, state = mgr.restore(device="cpu")
    assert net2.iteration == result["iteration"] >= 1
    assert state["cursor"]["batch_seq"] >= 1
    dumps = [n for n in os.listdir(store) if n.startswith("flightrec-")]
    assert len(dumps) == 1 and "preempt" in dumps[0]
    from deeplearning4j_tpu.observability.recorder import load_dump
    payload = load_dump(os.path.join(store, dumps[0]), verify=True)
    assert payload["channels"]["train"][-1]["type"] == "preempted"


# ------------------------------------------------- listener and saver
def test_checkpoint_listener_saves_and_restores(tmp_path):
    lst = CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                             keep_last=2)
    net = build_net()
    lst.iteration_done(net, 0, 0)
    assert lst.saved == []                 # never at iteration 0
    net.set_listeners(lst)
    rng = np.random.default_rng(3)
    for _ in range(5):
        net.fit(*batch(rng))
    assert [os.path.basename(p) for p in lst.saved] == [
        "ckpt-00000002", "ckpt-00000004"]
    from deeplearning4j_tpu_torch.utils.model_serializer import restore_model
    back = restore_model(lst.saved[-1], device="cpu")
    assert back.iteration == 4 and back.num_params() == net.num_params()
    assert jms.restore_model(lst.saved[-1]).iteration == 4


def test_local_file_model_saver_round_trip(tmp_path):
    saver = LocalFileModelSaver(str(tmp_path))
    net = build_net()
    net.fit(*batch(np.random.default_rng(4)))
    rng_before = net._rng.clone()
    saver.save_best_model(net, 0.5)
    saver.save_latest_model(net, 0.5)
    assert torch.equal(net._rng, rng_before)     # no clone, no split
    assert sorted(os.listdir(tmp_path)) == ["bestModel.zip",
                                            "latestModel.zip"]
    best = saver.get_best_model()
    assert best.device.type == "cpu" and best.iteration == 1
    for k, g in net.params.items():
        for n, p in g.items():
            assert torch.equal(best.params[k][n], p)
    assert LocalFileModelSaver(str(tmp_path / "empty")).get_best_model() \
        is None


# -------------------------------------------------- faults and retries
def test_retry_policy_matches_the_jax_package_and_is_bounded():
    a = RetryPolicy(max_retries=3, backoff_s=0.1, seed=5)
    j = JRetryPolicy(max_retries=3, backoff_s=0.1, seed=5)
    da = [a.backoff(k, worker=w) for w in (0, 3) for k in range(1, 5)]
    assert da == [j.backoff(k, worker=w) for w in (0, 3)
                  for k in range(1, 5)]
    for k, d in enumerate(da[:4], start=1):
        assert 0.05 * 2 ** (k - 1) <= d <= min(0.15 * 2 ** (k - 1), 5.0)
    assert RetryPolicy(backoff_s=10.0, max_backoff_s=1.0).backoff(5) == 1.0


def test_fault_injector_plans_and_chaos_commit_stage(tmp_path):
    inj = FaultInjector(seed=1).fail(0, 2, times=2).drop(1, 0)
    inj.on_batch(0, 1, 0)
    for _ in range(2):
        with pytest.raises(InjectedWorkerFault):
            inj.on_batch(0, 2, 0)
    inj.on_batch(0, 2, 0)                 # the plan is used up
    assert inj.should_drop(1, 0) and not inj.should_drop(1, 0)
    assert inj.events == [("fail", 0, 2), ("fail", 0, 2), ("drop", 1, 0)]
    # a chaos plan without a crash for this step leaves the commit alone
    mgr = CheckpointManager(str(tmp_path), background=False)
    mgr.chaos = ChaosSchedule(seed=0).crash_in_commit(step=99, stage=1)
    net = build_net()
    net.fit(*batch(np.random.default_rng(5)))
    assert mgr.save(net).endswith("ckpt-00000001")
    assert mgr.latest() is not None


# -------------------------------------------------------------- leases
def test_shard_owner_and_live_ranks():
    for world in (1, 2, 3, 5):
        assert [shard_owner(i, world) for i in range(20)] == \
            [i % world for i in range(20)]
    with pytest.raises(ValueError):
        shard_owner(3, 0)


def test_lease_renew_expire_evict_and_jax_reads_them(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    coord = ClusterCoordinator(store, lease_ttl_s=10.0)
    store.renew(0, ttl_s=10.0)
    store.renew(1, ttl_s=0.05)
    live, evicted = coord.sweep()
    assert set(live) == {0, 1} and evicted == []
    # the JAX package reads the port's lease files
    assert set(JFileLeaseStore(str(tmp_path)).all_leases()) == {0, 1}
    time.sleep(0.1)
    live, evicted = coord.sweep()
    assert set(live) == {0} and evicted == [1]
    view = coord.begin_round(0)
    assert live_ranks(store, view) == {0}
    _, evicted = coord.sweep()
    assert evicted == [] and coord.evicted_total == 1


def test_member_heartbeat_keeps_lease_alive(tmp_path):
    store = FileLeaseStore(str(tmp_path))
    coord = ClusterCoordinator(store, lease_ttl_s=0.4)
    with ClusterMember(store, 7, lease_ttl_s=0.4) as m:
        time.sleep(1.0)
        live, evicted = coord.sweep()
        assert 7 in live and evicted == []
        assert m.renew_count >= 3
    live, _ = coord.sweep()
    assert 7 not in live


def test_generation_bumps_and_fences_stale_worker(tmp_path, live_registry):
    store = FileLeaseStore(str(tmp_path))
    coord = ClusterCoordinator(store, lease_ttl_s=0.3)
    store.renew(0, ttl_s=10.0)
    store.renew(1, ttl_s=0.15)
    view1 = coord.begin_round(0)
    assert view1.members == (0, 1) and coord.accept(view1.generation)
    time.sleep(0.25)
    view2 = coord.begin_round(1)
    assert view2.members == (0,)
    assert view2.generation == view1.generation + 1
    assert not coord.accept(view1.generation)
    store.renew(1, ttl_s=10.0, incarnation=1)
    view3 = coord.begin_round(2)
    assert view3.members == (0, 1) and coord.rejoined_total == 1
    assert store.read_view().generation == view3.generation
    assert coord.begin_round(3).generation == view3.generation
    text = render_text(live_registry)
    for name in ("cluster_generation", "cluster_members",
                 "cluster_evictions_total", "cluster_rejoins_total"):
        assert name in text
    assert jreg.default_registry() is not live_registry
