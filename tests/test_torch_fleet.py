"""The port's serving fleet against the JAX package's: the five scenarios
of ``tests/test_fleet.py`` (least-loaded skew, tenant shed isolation, a
replica killed mid-decode whose session migrates bit-exact, canary
rollback on the error rate, canary auto-promote with monotonic versions)
and ``CanaryController`` verdicts equal to JAX's for one note sequence.

The decode oracle is the JAX network's greedy re-forward
(``naive_greedy`` of ``tests/test_fleet.py``, fed a fixed-length padded
history so one compiled shape serves every step; the LM is causal, so
positions past the history do not reach the one read).  Predict outputs
are held against the JAX network's within 2e-5.  The kill waits on
relayed token events, never on a sleep; every wait has its own timeout
of at most 30 s.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.generation import GenerationConfig
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.observability import MetricsRegistry
from deeplearning4j_tpu_torch.serving import (CanaryConfig, ServingFleet,
                                              ShedError, TenantAdmission,
                                              TenantQuota)
from deeplearning4j_tpu_torch.serving import fleet as tfleet
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, params_from_jax)

WAIT_S = 30.0
TOL = 2e-5
VOCAB, SEQ = 17, 32
LM = dict(vocab_size=VOCAB, seq_len=SEQ, embed=16, n_layers=2, n_heads=2)
GEN = dict(max_slots=2, max_seq=SEQ, block_size=4)


@pytest.fixture(scope="module")
def lms():
    """The JAX LM (embedding table scaled up so positions differ at width
    16) and its port twin."""
    jn = JTransformerLM(**LM).init()
    tree = jax.tree_util.tree_map(np.asarray, jn.params)
    tree["layer_0"]["W"] = tree["layer_0"]["W"] * 6.0
    jn.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jn, params_from_jax(TransformerLM(**LM).init(device="cpu"), tree)


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    conf = (JNNC.builder().seed(3).list()
            .layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    jn = JMLN(conf).init()
    path = tmp_path_factory.mktemp("fleet") / "mlp.zip"
    jms.write_model(jn, str(path))
    return jn, load_reference_model(str(path), device="cpu")


def naive_greedy(jnet, history, n):
    """The solo oracle on the JAX network: full greedy re-forward."""
    hist = [int(t) for t in history]
    out = []
    for _ in range(n):
        ids = np.zeros((1, SEQ), np.int32)
        ids[0, :len(hist)] = hist
        probs = np.asarray(jnet.output(ids))
        tok = int(probs[0, len(hist) - 1].argmax())
        out.append(tok)
        hist.append(tok)
    return out


def gen_fleet(tn, reg, **kw):
    return ServingFleet(tn, n_replicas=2, device="cpu",
                        generation=GenerationConfig(**GEN), registry=reg,
                        **kw)


def test_least_loaded_skew_routes_around_busy_replica(mlp):
    jn, tn = mlp
    reg = MetricsRegistry()
    fleet = ServingFleet(tn, n_replicas=2, device="cpu", registry=reg)
    try:
        x = np.random.default_rng(0).standard_normal((3, 4)).astype(
            np.float32)
        np.testing.assert_allclose(fleet.predict(x, timeout=WAIT_S),
                                   np.asarray(jn.output(x)), rtol=0,
                                   atol=TOL)
        busy = fleet.replicas[0]
        for _ in range(8):
            busy.begin()                        # 8 phantom inflight
        for _ in range(5):
            fleet.predict(x[0], timeout=WAIT_S)
        routed = reg.get("fleet_routed_total")
        assert routed.labels("predict", "1").value == 5
        tail = [t for t in fleet.router.trail if t["route"] == "predict"]
        assert all(t["replica"] == 1 for t in tail[-5:])
        for _ in range(8):
            busy.end()
        fleet.predict(x[0], timeout=WAIT_S)     # balance restored: 0 wins
        assert routed.labels("predict", "0").value >= 2
        h = fleet.health()
        assert h["ready"] is True and h["live_replicas"] == 2
        assert set(h) == {"ready", "replicas", "live_replicas", "sessions",
                          "tenants", "canary"}
    finally:
        fleet.shutdown()


def test_tenant_quota_shed_isolation(lms):
    jn, tn = lms
    reg = MetricsRegistry()
    tenants = TenantAdmission({"noisy": TenantQuota(rate=0.01, burst=2.0)},
                              registry=reg)
    fleet = gen_fleet(tn, reg, tenants=tenants)
    want = naive_greedy(jn, [1, 2], 2)
    try:
        shed, retry_after = 0, None
        for _ in range(5):
            try:
                fleet.generate([1, 2], max_new_tokens=2, tenant="noisy",
                               timeout=WAIT_S)
            except ShedError as e:
                assert e.status == 429
                retry_after = e.retry_after_s
                shed += 1
        assert shed >= 3 and retry_after > 0
        for _ in range(3):
            res = fleet.generate([1, 2], max_new_tokens=2, tenant="polite",
                                 timeout=WAIT_S)
            assert res.tokens == want
        c = reg.get("serving_shed_total")
        assert c.labels("tenant_quota", "noisy").value == shed
        assert fleet.health()["tenants"]["noisy"]["shed"] == shed
    finally:
        fleet.shutdown()


def test_replica_kill_mid_decode_migrates_bit_exact(lms):
    jn, tn = lms
    reg = MetricsRegistry()
    fleet = gen_fleet(tn, reg)
    relayed, killed = threading.Event(), threading.Event()
    done = {}

    def run_stream(prompt, n):
        toks = []
        for ev in fleet.stream(prompt, max_new_tokens=n, timeout=WAIT_S):
            if "error" in ev:
                done["s"] = ("error", ev["error"])
                return
            if "token" in ev:
                toks.append(ev["token"])
                if len(toks) == 4:
                    relayed.set()
                    killed.wait(WAIT_S)   # the kill lands mid-stream
        done["s"] = ("ok", toks)

    t = threading.Thread(target=run_stream, args=([7, 8, 9], 25))
    try:
        t.start()
        assert relayed.wait(WAIT_S), "never relayed a token"
        (sess,) = fleet.router._sessions.values()
        assert len(sess.mirror["tokens"]) == 4
        victim = sess.replica.id
        fleet.kill(victim)
        killed.set()
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "stream hung after replica kill"
        status, toks = done["s"]
        assert status == "ok", done["s"]
        assert toks == naive_greedy(jn, [7, 8, 9], 25)
        assert reg.get("fleet_migrations_total").labels("killed").value == 1
        assert fleet.health()["live_replicas"] == 1
        r = fleet.rejoin(victim)
        assert r.state == "live" and fleet.health()["live_replicas"] == 2
        res = fleet.generate([4, 5], max_new_tokens=4, timeout=WAIT_S)
        assert res.tokens == naive_greedy(jn, [4, 5], 4)
    finally:
        killed.set()
        fleet.shutdown()


class _Broken:
    """Candidate that fails every request."""

    def output(self, x):
        raise RuntimeError("broken candidate")


def test_canary_auto_rollback_on_error_rate(mlp):
    jn, tn = mlp
    fleet = ServingFleet(
        tn, n_replicas=2, device="cpu", registry=MetricsRegistry(),
        canary_config=CanaryConfig(min_samples=50, max_error_rate=0.1))
    try:
        x = np.ones(4, np.float32)
        want = np.asarray(jn.output(x[None]))[0]
        before = {r.id: r.engine.model_version for r in fleet.replicas}
        ids = fleet.canary(_Broken(), fraction=0.5, n_replicas=1)
        for _ in range(30):
            # every request succeeds: canary-arm failures retry stable
            np.testing.assert_allclose(fleet.predict(x, timeout=WAIT_S),
                                       want, rtol=0, atol=TOL)
            if fleet._canary is None:
                break
        assert fleet._canary is None, "canary never resolved"
        assert fleet.canary_controller.status()["decision"] == "rollback"
        after = {r.id: r.engine.model_version for r in fleet.replicas}
        assert all(after[i] >= before[i] for i in before)
        assert after[ids[0]] == before[ids[0]] + 2   # canary + rollback
        assert all(r.arm == "stable" for r in fleet.replicas)
        np.testing.assert_allclose(fleet.predict(x, timeout=WAIT_S), want,
                                   rtol=0, atol=TOL)
    finally:
        fleet.shutdown()


def test_canary_auto_promote_fleet_wide(lms):
    jn, tn = lms
    fleet = gen_fleet(tn, MetricsRegistry(),
                      canary_config=CanaryConfig(min_samples=8))
    want = naive_greedy(jn, [1, 2], 2)
    try:
        before = {r.id: r.engine.model_version for r in fleet.replicas}
        fleet.canary(tn, fraction=0.5, n_replicas=1)
        for _ in range(30):
            res = fleet.generate([1, 2], max_new_tokens=2, timeout=WAIT_S)
            assert res.tokens == want
            if fleet._canary is None:
                break
        assert fleet._canary is None, "canary never resolved"
        assert fleet.canary_controller.status()["decision"] == "promote"
        after = {r.id: r.engine.model_version for r in fleet.replicas}
        assert all(after[i] > before[i] for i in before)
        assert all(r.arm == "stable" for r in fleet.replicas)
    finally:
        fleet.shutdown()


NOTES = ([("stable", 0.010, False), ("canary", 0.012, False)] * 6
         + [("canary", None, True), ("stable", 0.011, False),
            ("canary", 0.2, False), ("canary", None, True)] * 3
         + [("canary", 0.5, False)] * 10)


@pytest.mark.parametrize("cfg", [dict(min_samples=8),
                                 dict(min_samples=20, max_error_rate=0.5,
                                      p99_ratio=2.0),
                                 dict(min_samples=200, max_error_rate=0.05)])
def test_canary_verdicts_equal_the_jax_controller(cfg):
    mine = tfleet.CanaryController(tfleet.CanaryConfig(**cfg))
    ref = jfleet.CanaryController(jfleet.CanaryConfig(**cfg))
    got, want = [], []
    for arm, seconds, error in NOTES:
        for ctl, out in ((mine, got), (ref, want)):
            ctl.note(arm, seconds=seconds, error=error)
            out.append(ctl.evaluate())
    assert got == want
    assert mine.status() == ref.status()
