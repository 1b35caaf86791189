"""The port's observability layer against the JAX package's: the metrics
registry and its Prometheus text (byte for byte for the same operations),
the tracer and its ``torch.profiler`` bridge, the event log, the flight
recorder and the step profiler's Chrome traces (each package loads the
other's artifacts with checksums verified), the health monitor, and the
metric names and label sets that a fit, a served request and a generation
leave behind in both packages.

Every test that touches a process-global (default registry, tracer,
flight recorder, health monitor) or a ``DL4J_TPU_*`` variable swaps it
through a fixture or ``monkeypatch`` and restores it: the JAX tests share
these workers.
"""
import json
import re
import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation.engine import \
    GenerationConfig as JGenerationConfig
from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.observability import exposition as jexpo
from deeplearning4j_tpu.observability import health as jhealth
from deeplearning4j_tpu.observability import profiler as jprof
from deeplearning4j_tpu.observability import recorder as jrec
from deeplearning4j_tpu.observability import registry as jreg
from deeplearning4j_tpu.serving.engine import ServingEngine as JServingEngine
from deeplearning4j_tpu_torch.faulttolerance.faults import FaultInjector
from deeplearning4j_tpu_torch.generation.engine import GenerationConfig
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.observability import (
    EventLog, FlightRecorder, HealthConfig, HealthMonitor, MetricsListener,
    MetricsRegistry, Tracer, bucket_quantile, chrome_trace,
    dump_chrome_trace, load_chrome_trace, load_dump, phase_summary,
    render_text)
from deeplearning4j_tpu_torch.observability import health as thealth
from deeplearning4j_tpu_torch.observability import profiler as tprof
from deeplearning4j_tpu_torch.observability import recorder as trec
from deeplearning4j_tpu_torch.observability import registry as treg
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? \S+$')

# metrics the JAX package records that the port does not, each with the
# ROADMAP item that brings it: the shape policy's padding (item 2: the
# port pads nothing yet)
JAX_ONLY = {"training_padding_ratio": "item 2",
            "training_shape_buckets": "item 2"}
# metrics whose label values are a subset of the JAX package's: the port
# compiles its train step only; serving and generation run eagerly (the
# JAX package jits them; ROADMAP item 2)
PORT_FEWER_VALUES = {"training_compile_seconds", "training_compile_total"}


# the variables a test elsewhere in the worker may leave set (the stepprof
# CLI sets three of them for good)
_ENV = ("DL4J_TPU_STEPPROF", "DL4J_TPU_STEPPROF_SAMPLE",
        "DL4J_TPU_STEPPROF_PROGRAM", "DL4J_TPU_CARDS_DIR",
        "DL4J_TPU_PEAK_FLOPS", "DL4J_TPU_FLIGHTREC_DIR")


@pytest.fixture
def iso(tmp_path, monkeypatch):
    """Fresh default registries and flight recorders in both packages
    (the recorders dump under ``tmp_path``), no health monitor, the step
    profiler's variables unset; all restored afterwards."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    regs = (jreg.MetricsRegistry(), treg.MetricsRegistry())
    old_regs = (jreg.set_default_registry(regs[0]),
                treg.set_default_registry(regs[1]))
    recs = (jrec.FlightRecorder(directory=str(tmp_path)),
            trec.FlightRecorder(directory=str(tmp_path)))
    old_recs = (jrec.set_flight_recorder(recs[0]),
                trec.set_flight_recorder(recs[1]))
    old_mons = (jhealth.set_health_monitor(None),
                thealth.set_health_monitor(None))
    yield regs, recs
    jreg.set_default_registry(old_regs[0])
    treg.set_default_registry(old_regs[1])
    jrec.set_flight_recorder(old_recs[0])
    trec.set_flight_recorder(old_recs[1])
    jhealth.set_health_monitor(old_mons[0])
    thealth.set_health_monitor(old_mons[1])


def _operations(reg):
    """One sequence of instrument writes: labels that need escaping, help
    text with a newline and a backslash, histogram values on bucket edges,
    integral and fractional values, a gauge that goes down."""
    c = reg.counter("requests_total", "HTTP requests\nby route \\ code",
                    ("route", "code"))
    c.labels("/predict", "200").inc(3)
    c.labels('a"b\\c\nd', "500").inc(0.25)
    reg.counter("plain_total").inc()
    g = reg.gauge("queue_depth", "depth")
    g.set(7)
    g.dec(2.5)
    h = reg.histogram("latency_seconds", "latency", ("route",),
                      buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.1, 1.0, 2.0, 2.5, 7.0):
        h.labels("/predict").observe(v)
    reg.histogram("empty_seconds", "never observed")
    reg.gauge("big", "a large value").set(1e16)
    reg.gauge("nan_gauge").set(float("nan"))


def test_render_text_is_byte_equal_to_the_jax_package():
    jr, tr = jreg.MetricsRegistry(), MetricsRegistry()
    _operations(jr)
    _operations(tr)
    text = render_text(tr)
    assert text == jexpo.render_text(jr)
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            assert _SAMPLE_RE.match(line), line
    assert 'code="500",route="a\\"b\\\\c\\nd"' in text
    assert 'latency_seconds_bucket{route="/predict",le="0.1"} 2' in text
    assert render_text(tr) == text          # deterministic
    # the JSON snapshot (with bucket_quantile p50/p99) as well
    assert json.dumps(tr.snapshot(), sort_keys=True, default=str) == \
        json.dumps(jr.snapshot(), sort_keys=True, default=str)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.99, 1.0])
def test_bucket_quantile_matches_the_jax_package(q):
    from deeplearning4j_tpu.observability.quantiles import \
        bucket_quantile as jbq
    cum = [(0.1, 2), (1.0, 3), (2.5, 5), (float("inf"), 6)]
    assert bucket_quantile(cum, q) == jbq(cum, q)
    assert bucket_quantile([(float("inf"), 0)], q) is None


def test_counter_and_histogram_threaded_counts_are_exact():
    reg = MetricsRegistry()
    c = reg.counter("hits_total", "", ("worker",))
    h = reg.histogram("obs_seconds", buckets=(0.5,))

    def work(i):
        for _ in range(2000):
            c.labels(str(i % 2)).inc()
            h.observe(0.25)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.labels("0").value + c.labels("1").value == 16000
    assert h._unlabeled().count == 16000
    assert h._unlabeled().cumulative_buckets()[0] == (0.5, 16000)


def test_registry_identity_mismatch_and_disabled_noop():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "", ("a",))
    assert reg.counter("x_total", "", ("a",)) is c
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", "", ("b",))
    with pytest.raises(ValueError):
        reg.counter("y_total").inc(-1)
    reg.disable()
    c.labels("1").inc(5)
    reg.gauge("g").set(3)
    reg.histogram("h").observe(1.0)
    assert c.labels("1").value == 0
    assert reg.get("g").value == 0
    assert reg.get("h")._unlabeled().count == 0


def test_tracer_nesting_propagation_and_registry():
    reg = MetricsRegistry()
    tr = Tracer(enabled=True, registry=reg)
    with tr.span("outer", k=1) as outer:
        with tr.span("inner") as inner:
            ctx = tr.current_context()
        seen = {}

        def child():
            with tr.attach(ctx):
                with tr.span("remote") as sp:
                    seen["span"] = sp
        t = threading.Thread(target=child)
        t.start()
        t.join(timeout=30)
    assert inner.parent_id == outer.span_id
    assert inner.trace_id == outer.trace_id == seen["span"].trace_id
    assert seen["span"].parent_id == inner.span_id
    assert outer.attributes == {"k": 1}
    names = [s.name for s in tr.finished_spans]
    assert names == ["inner", "remote", "outer"]
    hist = reg.get("span_seconds")
    assert hist.labels("outer").count == 1
    off = Tracer(enabled=False, registry=reg)
    with off.span("never") as sp:
        assert sp is None
    assert off.finished_spans == []


def test_tracer_bridge_names_land_in_a_torch_profiler_trace():
    tr = Tracer(enabled=True, registry=MetricsRegistry(),
                bridge_profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with tr.span("obs.bridge_probe"):
            torch.ones(4).sum()
    assert "obs.bridge_probe" in {e.key for e in p.key_averages()}


def test_event_log_rotates_and_reads_in_order(tmp_path, iso):
    path = str(tmp_path / "events.jsonl")
    with EventLog(path, max_bytes=200, max_files=3) as log:
        for i in range(20):
            log.emit("tick", i=i)
    got = [r["i"] for r in EventLog.read(path)]
    assert got == sorted(got) and got[-1] == 19
    assert len(EventLog.segments(path)) == 3
    _, (_, trec_) = iso
    from deeplearning4j_tpu_torch.observability import emit_event
    emit_event("probe", x=1)
    assert trec_.channel("events").items()[-1]["type"] == "probe"


def _fill(rec):
    rec.record("train", "step", iteration=1, score=0.5)
    rec.record("serving", "dispatch", rows=3, note='q"uote\n')
    rec.record_span({"name": "s", "duration_s": 0.1})


def test_flight_dumps_load_across_the_packages(tmp_path):
    treg_ = MetricsRegistry()
    port = FlightRecorder(directory=str(tmp_path), registry=treg_)
    ref = jrec.FlightRecorder(directory=str(tmp_path),
                              registry=jreg.MetricsRegistry())
    _fill(port)
    _fill(ref)
    p_path = port.dump("decode exception!")
    j_path = ref.dump("decode exception!")
    for path in (p_path, j_path):
        for load in (load_dump, jrec.load_dump):
            payload = load(path, verify=True)
            assert payload["format"] == "dl4j-tpu-flightrec-v1"
            assert payload["channels"]["train"][0]["score"] == 0.5
            assert payload["spans"][0]["name"] == "s"
    assert treg_.get("flightrecorder_dumps_total").labels(
        "decode-exception-").value == 1
    # a flipped byte fails verification on both sides
    blob = bytearray(open(p_path, "rb").read())
    blob[blob.index(b'"rows": 3') + 8] = ord("4")
    bad = tmp_path / "bad.json"
    bad.write_bytes(bytes(blob))
    for load in (load_dump, jrec.load_dump):
        with pytest.raises(ValueError, match="checksum"):
            load(str(bad), verify=True)
    # maybe_dump: rate-limited per reason, never without a directory
    port.min_dump_interval_s = 60.0
    assert port.maybe_dump("decode exception!") is None
    assert FlightRecorder().maybe_dump("x") is None


def _profile_records():
    return [
        {"ts": 100.0, "type": "step", "program": "train_step",
         "iteration": 1, "wall_s": 0.02, "sampled": True, "compile": False,
         "depth": 1, "mfu": 0.25, "phases": {
             "etl_wait": 0.001, "h2d": 0.0, "dispatch": 0.004,
             "device": 0.012, "listener": 0.001, "forensics": 0.001,
             "checkpoint": 0.0}},
        {"ts": 100.1, "type": "step", "program": "train_step",
         "iteration": 2, "wall_s": 0.01, "sampled": False, "compile": False,
         "depth": 2, "phases": {
             "etl_wait": 0.0, "h2d": 0.0, "dispatch": 0.008, "device": None,
             "listener": 0.0, "forensics": 0.001, "checkpoint": 0.0}},
        {"ts": 100.2, "type": "decode", "batch_form_s": 0.001,
         "execute_s": 0.004, "active": 2},
        {"ts": 100.3, "type": "serve", "queue_wait_s": 0.002,
         "batch_form_s": 0.001, "execute_s": 0.01, "batch": 3}]


def test_chrome_traces_and_summaries_load_across_the_packages(tmp_path):
    records = _profile_records()
    assert chrome_trace(records) == jprof.chrome_trace(records)
    assert phase_summary(records) == jprof.phase_summary(records)
    p_path = dump_chrome_trace(str(tmp_path / "port"), records=records)
    j_path = jprof.dump_chrome_trace(str(tmp_path / "jax"), records=records)
    for path in (p_path, j_path):
        for load in (load_chrome_trace, jprof.load_chrome_trace):
            doc = load(path, verify=True)
            assert doc["otherData"]["records"] == 4
    doc = json.loads(open(p_path).read())
    doc["traceEvents"][-1]["dur"] += 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    for load in (load_chrome_trace, jprof.load_chrome_trace):
        with pytest.raises(ValueError, match="checksum"):
            load(str(bad), verify=True)


def test_health_monitor_detects_as_the_jax_package():
    cfg = dict(warmup_steps=5, mfu_warmup=3, serving_min_samples=4,
               ttft_p99_target_ms=50.0)
    mons = (HealthMonitor(HealthConfig(**cfg), registry=MetricsRegistry(),
                          recorder=FlightRecorder()),
            jhealth.HealthMonitor(jhealth.HealthConfig(**cfg),
                                  registry=jreg.MetricsRegistry(),
                                  recorder=jrec.FlightRecorder()))
    kinds = []
    for mon in mons:
        seen = []
        for i in range(10):
            seen += mon.observe_step(loss=1.0 + 0.01 * (i % 2),
                                     grad_norm=1.0, step=i)
        seen += mon.observe_step(loss=50.0, step=10)
        seen += mon.observe_step(loss=float("nan"), step=11)
        for v in [1.0] * 4 + [0.1] * 20:
            seen += mon.observe_mfu(v)
        for _ in range(5):
            seen += mon.observe_generation(ttft_s=0.2, itl_s=0.001)
        kinds.append([d.kind for d in seen])
        assert mon.state() == "degraded"
        assert mon._reg().get("health_detections_total").labels(
            "nan_loss").value == 1
    assert kinds[0] == kinds[1] == ["loss_spike", "nan_loss",
                                    "mfu_regression",
                                    "generation_ttft_p99"]


def _lm(pkg_lm, **kw):
    return pkg_lm(vocab_size=16, seq_len=8, embed=16, n_layers=1,
                  n_heads=2, sparse_labels=True, **kw)


def test_metric_names_after_fit_serve_generate_match(iso):
    """The same small fit, served request and generation in both
    packages leave the same metric names with the same label sets, but
    for ``JAX_ONLY``."""
    (jr, tr), _ = iso
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 16, (3, 4, 9))
    jn = _lm(JTransformerLM).init()
    tn = params_from_jax(_lm(TransformerLM).init(device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jn.params))
    for b in toks:
        jn.fit(b[:, :-1], b[:, 1:])
        tn.fit(b[:, :-1], b[:, 1:])
    gen = dict(max_slots=2, max_seq=16, block_size=4)
    je = JServingEngine(jn, max_batch_size=4,
                        generation=JGenerationConfig(**gen))
    te = ServingEngine(tn, device="cpu", max_batch_size=4,
                       generation=GenerationConfig(**gen))
    try:
        x = np.eye(16, dtype=np.float32)[rng.integers(0, 16, (2, 8))]
        je.predict(x)
        te.predict(x)
        want = je.generation.generate([1, 2, 3], max_new_tokens=4)
        got = te.generation.generate([1, 2, 3], max_new_tokens=4)
    finally:
        je.shutdown()
        te.shutdown()
    assert got.tokens == want.tokens

    def names(reg):
        return {m.name: (m.kind, m.labelnames,
                         sorted(v for v, _ in m.samples()))
                for m in reg.collect()}
    jn_, tn_ = names(jr), names(tr)
    assert set(jn_) - set(tn_) == set(JAX_ONLY)
    assert set(tn_) <= set(jn_)
    for name in tn_:
        if name in PORT_FEWER_VALUES:
            assert tn_[name][:2] == jn_[name][:2], name
            assert set(tn_[name][2]) <= set(jn_[name][2]), name
            continue
        assert tn_[name] == jn_[name], name
    assert tr.get("training_steps_total").value == 3
    assert tr.get("training_examples_total").value == 12
    assert tr.get("generation_tokens_total").value == 4
    assert tr.get("serving_batches_total").value == 1


def test_step_profiler_mfu_and_records_on_the_cpu(iso, tmp_path,
                                                  monkeypatch):
    """Every step sampled, the card FLOPs from a card file and the peak
    from the environment: MFU = flops / (device slice x peak)."""
    _, (_, rec) = iso
    cards = tmp_path / "cards"
    cards.mkdir()
    (cards / "lm_probe.json").write_text(json.dumps({"flops": 2.0e9}))
    monkeypatch.setenv("DL4J_TPU_CARDS_DIR", str(cards))
    monkeypatch.setenv("DL4J_TPU_STEPPROF_PROGRAM", "lm_probe")
    monkeypatch.setenv("DL4J_TPU_STEPPROF_SAMPLE", "1")
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    net = _lm(TransformerLM).init(device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 16, (3, 4, 9))
    net.fit([(b[:, :-1], b[:, 1:]) for b in toks])
    steps = [r for r in rec.channel("profile").items()
             if r["type"] == "step"]
    assert [r["iteration"] for r in steps] == [1, 2, 3]
    for r in steps:
        dev = r["phases"]["device"]
        assert r["sampled"] and dev is not None and dev <= r["wall_s"]
        # the record rounds the slice to 1e-7 s; the MFU uses it whole
        assert r["mfu"] == r["achieved_flops"] / 1e12
        assert abs(2.0e9 / r["achieved_flops"] - dev) <= 5e-8
    assert [r["compile"] for r in steps] == [True, False, False]
    summary = phase_summary(steps)
    assert summary["steps"] == 2 and summary["sampled_steps"] == 2
    train = rec.channel("train").items()
    assert [r["iteration"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["score"]) for r in train)
    monkeypatch.setenv("DL4J_TPU_STEPPROF", "0")
    assert tprof.step_profiler_for("train_step") is None


def test_metrics_listener_publishes_on_a_port_fit(iso):
    (_, tr), _ = iso
    net = _lm(TransformerLM).init(device="cpu")
    net.set_listeners(MetricsListener(force_device_sync=True))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 16, (3, 4, 9))
    net.fit([(b[:, :-1], b[:, 1:]) for b in toks])
    assert tr.get("model_iterations_total").value == 3
    assert tr.get("model_examples_total").value == 12
    assert tr.get("model_epochs_total").value == 1
    assert tr.get("model_score").value == pytest.approx(net.get_score())
    assert tr.get("model_grad_norm").value > 0


def test_decode_crash_dumps_the_decode_channel(iso, tmp_path):
    """A FaultInjector makes the third decode step raise: the engine
    records the failure, dumps its ``decode`` channel (read back with
    checksums by both packages) and fails the request."""
    _, (_, rec) = iso
    net = _lm(TransformerLM).init(device="cpu")
    inj = FaultInjector().fail(0, 2)
    eng = ServingEngine(net, device="cpu", max_batch_size=2,
                        generation=GenerationConfig(max_slots=2, max_seq=16,
                                                    block_size=4))
    gen = eng.generation
    step = gen._decode_step

    def faulty(slot_obj):
        inj.on_batch(0, gen.decode_steps, 0)
        return step(slot_obj)
    gen._decode_step = faulty
    try:
        with pytest.raises(Exception, match="injected failure"):
            gen.generate([1, 2, 3], max_new_tokens=8)
    finally:
        eng.shutdown()
    assert inj.events == [("fail", 0, 2)]
    assert gen.last_decode_failure["error"].startswith(
        "InjectedWorkerFault")
    assert len(rec.dumps) == 1
    for load in (load_dump, jrec.load_dump):
        payload = load(rec.dumps[0], verify=True)
        assert payload["reason"] == "decode_exception"
        kinds = [r["type"] for r in payload["channels"]["decode"]]
        assert kinds == ["step", "step", "decode_error"]
        assert payload["channels"]["cluster"][0]["type"] == "injected_fail"
