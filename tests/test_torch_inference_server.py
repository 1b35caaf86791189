"""The port's ``InferenceServer`` (``/predict`` over ``ParallelInference``)
against the JAX package's: the predict round trip in both modes (2e-5
against the JAX server's body), ``/metrics`` after a predict, liveness
against readiness with the failure circuit, ``/reload`` from a model zip
and from a checkpoint directory (one the JAX ``CheckpointManager`` wrote),
a bad reload that leaves the server serving, the circuit's lossless
count under concurrent failures, and an attached generation engine in
``/health``.  Every wait has its own timeout of at most 30 s.
"""
import threading
import urllib.error

import numpy as np
import pytest

from deeplearning4j_tpu.faulttolerance import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.serving import inference_server as jis
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                 GenerationEngine)
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.observability import MetricsRegistry
from deeplearning4j_tpu_torch.serving import inference_server as tis
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

WAIT_S = 30.0
TOL = 2e-5


def _jnet(seed):
    conf = (JNNC.builder().seed(seed)
            .updater(JAdam(learning_rate=0.05)).list()
            .layer(JDense(n_out=8, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("is")
    out = {}
    for name, seed in (("a", 1), ("b", 99)):
        jn = _jnet(seed)
        path = tmp / f"{name}.zip"
        jms.write_model(jn, str(path))
        out[name] = (jn, str(path))
    return out


def _url(server):
    return f"http://127.0.0.1:{server.port}"


@pytest.mark.parametrize("mode", ["BATCHED", "INPLACE"])
def test_predict_round_trip_matches_the_jax_server(zips, mode):
    jn, path = zips["a"]
    tsrv = tis.InferenceServer(load_reference_model(path, device="cpu"),
                               inference_mode=mode, device="cpu",
                               registry=MetricsRegistry()).start()
    jsrv = jis.InferenceServer(jn, inference_mode=mode).start()
    try:
        x = np.random.default_rng(4).standard_normal((4, 4)).astype(
            np.float32)
        mine = tis.InferenceClient(_url(tsrv), timeout=WAIT_S).predict(x)
        ref = jis.InferenceClient(_url(jsrv), timeout=WAIT_S).predict(x)
        assert mine.shape == ref.shape == (4, 3)
        np.testing.assert_allclose(mine, ref, rtol=0, atol=TOL)
    finally:
        tsrv.stop()
        jsrv.stop()


def test_metrics_after_a_predict(zips):
    reg = MetricsRegistry()
    server = tis.InferenceServer(load_reference_model(zips["a"][1],
                                                      device="cpu"),
                                 device="cpu", registry=reg).start()
    try:
        client = tis.InferenceClient(_url(server), timeout=WAIT_S)
        client.predict(np.zeros((3, 4), np.float32))
        text = client.metrics_text()
        assert ('http_request_seconds_bucket{route="/predict",le="+Inf"} 1'
                in text)
        assert ('http_requests_total{code="200",method="POST",'
                'route="/predict"} 1') in text
        assert "inference_examples_total 3" in text
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.post("/predict", {"wrong_key": 1})
        assert ei.value.code == 400
        assert ('http_errors_total{error_class="client_error",'
                'route="/predict"} 1') in client.metrics_text()
    finally:
        server.stop()


def test_liveness_readiness_and_the_failure_circuit(zips):
    server = tis.InferenceServer(load_reference_model(zips["a"][1],
                                                      device="cpu"),
                                 device="cpu",
                                 registry=MetricsRegistry()).start()
    jsrv = jis.InferenceServer(zips["a"][0])
    try:
        client = tis.InferenceClient(_url(server), timeout=WAIT_S)
        h = client.get("/health")
        assert set(h) == set(jsrv.health())
        assert h["live"] is True and h["ready"] is True
        assert h["status"] == "ok" and h["platform"] == "cpu"
        assert h["model"].startswith("MultiLayerNetwork[")
        assert h["seconds_since_last_predict"] is None
        client.predict(np.zeros((1, 4), np.float32))
        assert client.get("/health")["seconds_since_last_predict"] >= 0
        server.consecutive_failures = server.FAILURE_THRESHOLD
        h = client.get("/health")
        assert h["live"] is True and h["ready"] is False
        assert h["status"] == "unready"
        client.predict(np.zeros((1, 4), np.float32))
        assert client.get("/health")["ready"] is True
    finally:
        server.stop()
        jsrv.stop()


def test_reload_from_a_zip_and_from_checkpoint_dirs(zips, tmp_path):
    (jn_a, path_a), (jn_b, path_b) = zips["a"], zips["b"]
    reg = MetricsRegistry()
    server = tis.InferenceServer(load_reference_model(path_a, device="cpu"),
                                 inference_mode="INPLACE", device="cpu",
                                 registry=reg).start()
    try:
        client = tis.InferenceClient(_url(server), timeout=WAIT_S)
        x = np.ones((2, 4), np.float32)
        before = client.predict(x)
        client.post("/reload", {"path": path_b})
        after = client.predict(x)
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, np.asarray(jn_b.output(x)),
                                   rtol=0, atol=TOL)
        assert server.inference.model.opt_state is None
        # a bad path is a 400, and the server keeps serving
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.post("/reload", {"path": str(tmp_path / "none.zip")})
        assert ei.value.code == 400
        np.testing.assert_allclose(client.predict(x), after, rtol=0,
                                   atol=0)
        # an empty store is refused too
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.post("/reload", {"path": str(tmp_path)})
        assert ei.value.code == 400
        # the newest complete checkpoint of a store the JAX package wrote
        JCheckpointManager(str(tmp_path), background=False).save(jn_a,
                                                                 step=5)
        client.post("/reload", {"path": str(tmp_path)})
        np.testing.assert_allclose(client.predict(x),
                                   np.asarray(jn_a.output(x)), rtol=0,
                                   atol=TOL)
        assert reg.get("inference_model_reloads_total").value == 2
        assert client.get("/health")["model"].endswith(
            f"from={tmp_path}]")
    finally:
        server.stop()


def test_failure_circuit_is_lossless_under_concurrency(zips):
    server = tis.InferenceServer(load_reference_model(zips["a"][1],
                                                      device="cpu"),
                                 device="cpu", registry=MetricsRegistry())
    try:
        threads_n, per_thread = 8, 250

        def fail_hammer():
            for _ in range(per_thread):
                server.note_predict_result(False)

        ts = [threading.Thread(target=fail_hammer) for _ in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert server.consecutive_failures == threads_n * per_thread
        assert server.health()["ready"] is False
        server.note_predict_result(True)
        assert server.consecutive_failures == 0
        assert server.health()["ready"] is True
    finally:
        server.stop()


def test_attached_generation_reports_in_health(zips, monkeypatch):
    lm = TransformerLM(vocab_size=11, seq_len=16, embed=16, n_layers=1,
                       n_heads=2).init(device="cpu")
    gen = GenerationEngine.for_model(
        lm, GenerationConfig(max_slots=1, max_seq=16, block_size=4))
    server = tis.InferenceServer(load_reference_model(zips["a"][1],
                                                      device="cpu"),
                                 device="cpu", registry=MetricsRegistry())
    try:
        assert server.attach_generation(gen) is server
        h = server.health()
        assert h["ready"] is True and h["generation"]["max_slots"] == 1
        # generation unreadiness flips the server's readiness
        monkeypatch.setattr(gen, "ready", lambda: False)
        h = server.health()
        assert h["ready"] is False and h["status"] == "unready"
    finally:
        gen.shutdown()
        server.stop()


def test_model_and_server_devices_must_agree(zips):
    net = load_reference_model(zips["a"][1], device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        tis.InferenceServer(net, device="meta")
