"""The port's serving engine and its HTTP tier against the JAX package's.

- ``/predict`` bodies equal the JAX ``ServingServer``'s for the same model
  and body (2e-5), and status codes and error bodies match: 400 for a bad
  shape or body, 404 for a route or a disabled ``/generate``, 503 with no
  model; a queue-limited engine sheds 429 with ``Retry-After``.
- ``/health`` and its admission block carry the JAX server's keys.
- One latency sequence fed to both ``AdmissionController``s gives the
  same ``slo_ok()`` sequence (exact); the port's breach edge counts,
  emits its event, dumps once and turns ``/health`` degraded.
- Hot swap under load: zero failed requests, each response from exactly
  the weights of the version it reports, versions never backwards.
- ``promote_latest`` skips a corrupt checkpoint and ``watch`` promotes;
  a directory the JAX ``CheckpointManager`` wrote promotes; a torn
  sharded one (a topology without its shard files) is refused as
  corrupt (a complete sharded one serves:
  ``tests/test_torch_serving_sharded.py``).
- ``/generate`` greedy and seeded-sampled token streams equal the JAX
  server's token for token, streamed equal to non-streamed, and a client
  that disconnects cancels its request.

Small models: the two-layer MLN of ``tests/test_serving.py``'s
``_small_net`` and the VOCAB 17 TransformerLM of ``tests/test_fleet.py``.
Every wait has its own timeout of at most 30 s; no test sleeps to order
threads.
"""
import os
import threading
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.faulttolerance import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.generation import GenerationConfig as JGenConfig
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.faulttolerance import (
    CheckpointManager, CorruptCheckpointError)
from deeplearning4j_tpu_torch.generation import GenerationConfig
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.observability import (
    EventLog, FlightRecorder, HealthMonitor, MetricsRegistry,
    configure_event_log, load_dump, set_flight_recorder, set_health_monitor)
from deeplearning4j_tpu_torch.serving import engine as teng
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, params_from_jax)

WAIT_S = 30.0
TOL = 2e-5
VOCAB = 17
LM = dict(vocab_size=VOCAB, seq_len=32, embed=16, n_layers=2, n_heads=2)
GEN = dict(max_slots=2, max_seq=32, block_size=4)


def _jnet(seed):
    conf = (JNNC.builder().seed(seed)
            .updater(JAdam(learning_rate=0.05)).list()
            .layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _twin(jn, tmp_path, name):
    path = tmp_path / name
    jms.write_model(jn, str(path))
    return load_reference_model(str(path), device="cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two small MLNs from the JAX DSL and their port twins."""
    tmp = tmp_path_factory.mktemp("nets")
    jn_a, jn_b = _jnet(1), _jnet(99)
    return (jn_a, _twin(jn_a, tmp, "a.zip")), (jn_b, _twin(jn_b, tmp,
                                                           "b.zip"))


@pytest.fixture(scope="module")
def lms():
    """The JAX LM with its embedding table scaled up (at width 16 the
    positional encoding otherwise makes every position predict the same
    token) and its port twin."""
    jn = JTransformerLM(**LM).init()
    tree = jax.tree_util.tree_map(np.asarray, jn.params)
    tree["layer_0"]["W"] = tree["layer_0"]["W"] * 6.0
    jn.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tn = params_from_jax(TransformerLM(**LM).init(device="cpu"), tree)
    return jn, tn


def _wait_for(pred):
    tick = threading.Event()
    for _ in range(int(WAIT_S / 0.01)):
        if pred():
            return True
        tick.wait(0.01)
    return False


def _url(server):
    return f"http://127.0.0.1:{server.port}"


def _code_and_body(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value.code, ei.value.read(), ei.value.headers


class _BlockingModel:
    """Forward blocks until released: drives the queue to its limit."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()

    def output(self, x):
        self.entered.set()
        self.gate.wait(timeout=WAIT_S)
        return np.zeros((len(np.atleast_2d(x)), 2), np.float32)


# ---------------------------------------------------------------- predict
def test_predict_bodies_and_errors_match_the_jax_server(pair):
    (jn, tn), _ = pair
    tsrv = teng.ServingServer(tn, device="cpu", max_batch_size=8,
                              registry=MetricsRegistry()).start()
    jsrv = jeng.ServingServer(jn, max_batch_size=8, warmup=False).start()
    try:
        tc = teng.ServingClient(_url(tsrv), timeout=WAIT_S)
        jc = jeng.ServingClient(_url(jsrv), timeout=WAIT_S)
        rng = np.random.default_rng(0)
        for n in (1, 3, 8):
            x = rng.standard_normal((n, 4)).astype(np.float32)
            tb = tc.post("/predict", {"data": x.tolist()})
            jb = jc.post("/predict", {"data": x.tolist()})
            assert tb["model_version"] == jb["model_version"] == 1
            np.testing.assert_allclose(tb["output"], jb["output"],
                                       rtol=0, atol=TOL)
        single = tc.post("/predict", {"data": x[0].tolist()})
        assert np.shape(single["output"]) == (3,)
        for route, body in (("/predict", {"data": [[1.0, 2.0, 3.0]]}),
                            ("/predict", {"wrong_key": 1}),
                            ("/generate", {"tokens": [1, 2]}),
                            ("/nowhere", {})):
            tcode, tbody, _ = _code_and_body(lambda: tc.post(route, body))
            jcode, jbody, _ = _code_and_body(lambda: jc.post(route, body))
            assert (tcode, tbody) == (jcode, jbody), route
        assert tcode == 404
        h_t, h_j = tc.get("/health"), jc.get("/health")
        assert set(h_t) == set(h_j)
        assert set(h_t["admission"]) == set(h_j["admission"])
        assert h_t["platform"] == "cpu" and h_t["ready"] is True
        assert h_t["model"].startswith("MultiLayerNetwork[params=")
    finally:
        tsrv.stop()
        jsrv.stop()


def test_no_model_is_503_like_the_jax_server():
    tsrv = teng.ServingServer(device="cpu").start()
    jsrv = jeng.ServingServer().start()
    try:
        got = [_code_and_body(lambda: cls(_url(s), timeout=WAIT_S).post(
                   "/predict", {"data": [1.0, 2.0]}))
               for cls, s in ((teng.ServingClient, tsrv),
                              (jeng.ServingClient, jsrv))]
        assert got[0][:2] == got[1][:2]
        assert got[0][0] == 503 and int(got[0][2]["Retry-After"]) >= 1
        h = teng.ServingClient(_url(tsrv), timeout=WAIT_S).get("/health")
        assert h["ready"] is False and h["model"] is None
    finally:
        tsrv.stop()
        jsrv.stop()


def test_queue_limit_sheds_429_with_retry_after():
    reg = MetricsRegistry()
    model = _BlockingModel()
    eng = teng.ServingEngine(model, device="cpu", max_batch_size=1,
                             queue_limit=1, registry=reg)
    server = teng.ServingServer(engine=eng, warmup=False,
                                registry=reg).start()
    client = teng.ServingClient(_url(server), timeout=WAIT_S)
    row = np.zeros(4, np.float32).tolist()
    done = []

    def call():
        # a background caller can itself be shed while the other one
        # races the dispatcher's dequeue: retry until admitted
        bg = teng.ServingClient(_url(server), timeout=WAIT_S)
        for _ in range(500):
            try:
                done.append(bg.post("/predict", {"data": row}))
                return
            except urllib.error.HTTPError as e:
                if e.code != 429:
                    done.append(e)
                    return
                threading.Event().wait(0.01)
        done.append(RuntimeError("never admitted"))

    threads = [threading.Thread(target=call) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        # steady state: one request blocked in the forward, one queued
        assert _wait_for(lambda: model.entered.is_set()
                         and eng.queue_depth >= 1)
        code, _, headers = _code_and_body(
            lambda: client.post("/predict", {"data": row}))
        assert code == 429 and int(headers["Retry-After"]) >= 1
        assert reg.get("serving_shed_total").labels(
            "queue_full", "-").value >= 1
        h = client.get("/health")
        assert h["ready"] is False and h["admission"]["saturated"] is True
        model.gate.set()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert all(isinstance(d, dict) for d in done), done
        assert client.get("/health")["ready"] is True
    finally:
        model.gate.set()
        server.stop()


# -------------------------------------------------------------------- SLO
LATENCIES_MS = [1, 2, 1, 3, 2, 40, 60, 80, 90, 70, 2, 1, 2, 1, 1, 2, 1, 1,
                1, 2, 1, 1, 2, 1, 1, 1, 120, 150, 130, 140, 2, 1, 1, 1,
                2, 1, 1, 1, 1, 1]


def test_slo_verdicts_equal_the_jax_controller_and_the_edge_reports(
        tmp_path):
    slo = dict(p50_target_ms=10.0, p99_target_ms=50.0, window=8,
               min_samples=4)
    reg = MetricsRegistry()
    rec = FlightRecorder(directory=str(tmp_path / "dumps"), registry=reg)
    mon = HealthMonitor(registry=reg)
    events = str(tmp_path / "events.jsonl")
    saved_rec, saved_mon = set_flight_recorder(rec), set_health_monitor(mon)
    configure_event_log(events)
    try:
        mine = teng.AdmissionController(slo=teng.SLOConfig(**slo),
                                        registry=reg)
        ref = jeng.AdmissionController(slo=jeng.SLOConfig(**slo),
                                       registry=jax_registry())
        got, want = [], []
        for ms in LATENCIES_MS:
            mine.observe(ms / 1e3)
            ref.observe(ms / 1e3)
            got.append(mine.slo_ok())
            want.append(ref.slo_ok())
            # a second poll of the same window is no new edge
            assert mine.slo_ok() == got[-1]
        assert got == want
        edges = sum(1 for a, b in zip([True] + got, got) if a and not b)
        assert edges == 2 and mine.slo_breaches == ref.slo_breaches == 2
        assert reg.get("serving_slo_breaches_total").value == 2
        kinds = [e["type"] for e in EventLog.read(events)
                 if e["type"].startswith("slo_")]
        assert kinds == ["slo_breach", "slo_recovered", "slo_breach",
                         "slo_recovered"]
        # one dump: the second breach falls inside the rate limit
        dumps = sorted(os.listdir(tmp_path / "dumps"))
        assert len(dumps) == 1
        dump = load_dump(str(tmp_path / "dumps" / dumps[0]))
        assert dump["reason"] == "slo_breach"
        assert [r["type"] for r in rec.channel("serving").items()] == kinds
        # the monitor notes the breach (its own cooldown folds the second)
        assert any(d["kind"] == "slo_breach"
                   for d in mon.status()["detections"])
        assert mon.status()["state"] == "degraded"
        assert "slo_breach" in mon.status()["reasons"][0]
    finally:
        configure_event_log(None)
        set_flight_recorder(saved_rec)
        set_health_monitor(saved_mon)


def jax_registry():
    from deeplearning4j_tpu.observability import MetricsRegistry as JReg
    return JReg()


def test_recovered_slo_with_a_recent_breach_reads_degraded(pair):
    (_, tn), _ = pair
    mon = HealthMonitor(registry=MetricsRegistry())
    saved = set_health_monitor(mon)
    srv = teng.ServingServer(
        tn, device="cpu", max_batch_size=4, registry=MetricsRegistry(),
        slo=teng.SLOConfig(p99_target_ms=50.0, window=4, min_samples=4))
    try:
        adm = srv.engine.admission
        for _ in range(4):
            adm.observe(0.2)
        h = srv.health()
        assert h["status"] == "unready" and h["admission"]["slo_ok"] is False
        for _ in range(4):
            adm.observe(0.001)
        h = srv.health()
        assert h["ready"] is True and h["status"] == "degraded"
        assert h["health"]["state"] == "degraded"
    finally:
        srv.stop()
        set_health_monitor(saved)


# --------------------------------------------------------------- hot swap
def test_hot_swap_under_load_zero_failures_no_mixed_weights(pair, tmp_path):
    (_, net_a), (_, net_b) = pair
    mgr = CheckpointManager(str(tmp_path), background=False)
    mgr.save(net_a, step=1)
    server = teng.ServingServer(checkpoint_dir=str(tmp_path), device="cpu",
                                max_batch_size=8,
                                registry=MetricsRegistry()).start()
    x = np.ones((1, 4), np.float32)
    expected = {1: net_a.output(x).numpy()[0], 2: net_b.output(x).numpy()[0]}
    records = [[] for _ in range(4)]
    failures = []
    stop = threading.Event()
    progress = threading.Condition()

    def client_loop(mine):
        client = teng.ServingClient(_url(server), timeout=WAIT_S)
        while not stop.is_set():
            try:
                out, version = client.predict_versioned(x)
            except urllib.error.HTTPError as e:
                failures.append(e.code)
                continue
            with progress:
                mine.append((int(version), out[0]))
                progress.notify_all()

    def each_has(n, version):
        return all(sum(1 for v, _ in r if v == version) >= n
                   for r in records)

    threads = [threading.Thread(target=client_loop, args=(r,))
               for r in records]
    try:
        for t in threads:
            t.start()
        with progress:
            assert progress.wait_for(lambda: each_has(3, 1), WAIT_S)
        mgr.save(net_b, step=2)
        res = teng.ServingClient(_url(server), timeout=WAIT_S).reload()
        assert res["promoted"] is True and res["step"] == 2
        with progress:
            assert progress.wait_for(lambda: each_has(3, 2), WAIT_S)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert failures == []
        for mine in records:
            last = 0
            for version, out in mine:
                np.testing.assert_allclose(out, expected[version],
                                           rtol=0, atol=1e-6)
                assert version >= last
                last = version
        h = teng.ServingClient(_url(server), timeout=WAIT_S).get("/health")
        assert h["ready"] is True and h["model_version"] == 2
        assert h["serving_step"] == 2
    finally:
        stop.set()
        server.stop()


def test_promote_latest_skips_corrupt_and_watch_promotes(pair, tmp_path):
    (_, net_a), (_, net_b) = pair
    mgr = CheckpointManager(str(tmp_path), background=False)
    mgr.save(net_a, step=1)
    p2 = mgr.save(net_b, step=2)
    with open(os.path.join(p2, "model.zip"), "r+b") as f:
        f.write(b"\x00\x00garbage")
    eng = teng.ServingEngine(checkpoint_dir=str(tmp_path), device="cpu",
                             max_batch_size=4)
    try:
        assert eng.slot.step == 1
        x = np.ones((2, 4), np.float32)
        np.testing.assert_allclose(eng.predict(x, timeout=WAIT_S),
                                   net_a.output(x).numpy(), rtol=0,
                                   atol=1e-6)
        assert eng.promote_latest() is None
        eng.watch(interval_s=0.05)
        assert eng.watching
        mgr.save(net_b, step=3)
        assert _wait_for(lambda: eng.model_version >= 2)
        assert eng.slot.step == 3
        np.testing.assert_allclose(eng.predict(x, timeout=WAIT_S),
                                   net_b.output(x).numpy(), rtol=0,
                                   atol=1e-6)
        # a slot restores without updater state, on the engine's device
        assert eng.slot.model.opt_state is None
        assert eng.slot.model.device == eng.device
        eng.stop_watch()
        assert not eng.watching
    finally:
        eng.shutdown()


def test_promotes_from_a_directory_the_jax_manager_wrote(pair, tmp_path):
    (jn_a, _), (jn_b, _) = pair
    jmgr = JCheckpointManager(str(tmp_path), background=False)
    jmgr.save(jn_a, step=4)
    eng = teng.ServingEngine(device="cpu", max_batch_size=4)
    try:
        with pytest.raises(teng.ShedError) as ei:
            eng.predict(np.ones(4, np.float32), timeout=WAIT_S)
        assert ei.value.status == 503
        assert eng.promote_latest(str(tmp_path)) == 4
        jmgr.save(jn_b, step=9)
        assert eng.promote_latest() == 9
        x = np.random.default_rng(3).standard_normal((5, 4)).astype(
            np.float32)
        out, versions = eng.predict_versioned(x, timeout=WAIT_S)
        assert versions == [2] * 5
        np.testing.assert_allclose(out, np.asarray(jn_b.output(x)),
                                   rtol=0, atol=TOL)
    finally:
        eng.shutdown()


def test_a_sharded_checkpoint_is_refused_with_item_8(pair, tmp_path):
    (_, net_a), _ = pair
    mgr = CheckpointManager(str(tmp_path), background=False)
    mgr.save(net_a, step=1)
    p2 = mgr.save(net_a, step=2)
    # the sharded layout's marker beside a manifest-complete checkpoint:
    # since the sharded layout is ported it reads as a sharded directory
    # whose shard files are missing, which promotion refuses as corrupt
    with open(os.path.join(p2, "topology.json"), "w") as f:
        f.write("{}")
    with pytest.raises(CorruptCheckpointError, match="shard file"):
        teng.ServingEngine(checkpoint_dir=str(tmp_path), device="cpu")
    server = teng.ServingServer(device="cpu").start()
    try:
        code, body, _ = _code_and_body(lambda: teng.ServingClient(
            _url(server), timeout=WAIT_S).reload(directory=str(tmp_path)))
        assert code == 400 and b"shard file" in body
    finally:
        server.stop()


# ------------------------------------------------------------- generation
GEN_REQUESTS = [([3, 1, 4, 1, 5], dict(max_new_tokens=8)),
                ([9, 2, 6], dict(max_new_tokens=6, temperature=0.7,
                                 top_k=5, seed=42)),
                ([2, 7, 1], dict(max_new_tokens=8, temperature=1.1,
                                 top_p=0.8, seed=7))]


def test_generate_streams_equal_the_jax_server(lms):
    jn, tn = lms
    tsrv = teng.ServingServer(tn, device="cpu", max_batch_size=2,
                              warmup=False, registry=MetricsRegistry(),
                              generation=GenerationConfig(**GEN)).start()
    jsrv = jeng.ServingServer(jn, max_batch_size=2, warmup=False,
                              generation=JGenConfig(**GEN)).start()
    try:
        tc = teng.GenerationClient(_url(tsrv), timeout=WAIT_S)
        jc = jeng.GenerationClient(_url(jsrv), timeout=WAIT_S)
        for prompt, kw in GEN_REQUESTS:
            mine = tc.generate(prompt, **kw)
            ref = jc.generate(prompt, **kw)
            assert mine["tokens"] == ref["tokens"]
            assert mine["model_versions"] == ref["model_versions"]
            assert mine["finish"] == ref["finish"] == "length"
            events = list(tc.stream(prompt, **kw))
            assert [e["token"] for e in events[:-1]] == mine["tokens"]
            assert [e["index"] for e in events[:-1]] == list(
                range(len(mine["tokens"])))
            done = events[-1]
            assert done["done"] is True and done["tokens"] == mine["tokens"]
            assert list(jc.stream(prompt, **kw)) == events
        # a bad prompt is a 400 on both
        for c in (tc, jc):
            code, _, _ = _code_and_body(lambda: c.generate([]))
            assert code == 400
    finally:
        tsrv.stop()
        jsrv.stop()


def test_a_client_that_disconnects_cancels_its_request(lms):
    _, tn = lms
    srv = teng.ServingServer(tn, device="cpu", max_batch_size=2,
                             warmup=False, registry=MetricsRegistry(),
                             generation=GenerationConfig(**GEN)).start()
    gen = srv.engine.generation
    two_out, closed, seen = threading.Event(), threading.Event(), {}
    real_emit = gen._emit

    def paced_emit(req, tok, version, slot):
        finished = real_emit(req, tok, version, slot)
        seen["req"] = req
        if len(req.out_tokens) == 2:
            two_out.set()
            closed.wait(WAIT_S)     # decoding waits for the client to go
        elif len(req.out_tokens) > 2:
            # give the handler's failing write time to land
            req.cancelled.wait(1.0)
        return finished

    gen._emit = paced_emit
    try:
        client = teng.GenerationClient(_url(srv), timeout=WAIT_S)
        stream = client.stream([1, 2], max_new_tokens=28)
        assert next(stream)["index"] == 0
        assert two_out.wait(WAIT_S)
        stream.close()              # the client goes away mid-stream
        closed.set()
        res = seen["req"].future.result(timeout=WAIT_S)
        assert res.finish == "cancelled" and len(res.tokens) < 28
        assert _wait_for(lambda: gen.ring.active_slots == 0)
        del gen._emit
        # the server serves the next request normally
        assert client.generate([1, 2], max_new_tokens=3)["finish"] == \
            "length"
    finally:
        closed.set()
        srv.stop()
