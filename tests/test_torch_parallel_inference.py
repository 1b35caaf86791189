"""The port's ``ParallelInference`` against the JAX package's: the cases of
``tests/test_serving.py::TestParallelInference`` (INPLACE, BATCHED, many
concurrent callers, an oversize batch split across dispatches or
rejected, and a coalesced group rejected future by future), each output
held against the JAX ``ParallelInference``'s on the same inputs (2e-5:
one float32 forward of the same weights in another summation order).
Every wait has its own timeout of at most 30 s.
"""
import threading
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import inference as jpi
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.parallel import inference as tpi
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

WAIT_S = 30.0
TOL = 2e-5


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    conf = (JNNC.builder().seed(7).activation("tanh").weight_init("xavier")
            .list()
            .layer(JDense(n_out=8))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    jn = JMLN(conf).init()
    path = tmp_path_factory.mktemp("pi") / "net.zip"
    jms.write_model(jn, str(path))
    return jn, load_reference_model(str(path), device="cpu")


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)


def _both(nets, x, **kw):
    """The same call through the port's and the JAX package's front-end."""
    jn, tn = nets
    outs = []
    for mod, net in ((tpi, tn), (jpi, jn)):
        pi = mod.ParallelInference(net, **kw)
        try:
            outs.append(np.asarray(pi.output(x)))
        finally:
            pi.shutdown()
    return outs


@pytest.mark.parametrize("mode", ["INPLACE", "BATCHED"])
def test_outputs_match_the_jax_front_end(nets, mode):
    x = _x(1, 6)
    mine, ref = _both(nets, x, inference_mode=mode, max_batch_size=8)
    assert mine.shape == ref.shape == (6, 3)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=TOL)
    one, ref_one = _both(nets, x[0], inference_mode=mode, max_batch_size=8)
    assert one.shape == ref_one.shape == (3,)
    np.testing.assert_allclose(one, ref_one, rtol=0, atol=TOL)


def test_batched_concurrent_callers(nets):
    jn, tn = nets
    x = _x(2, 32)
    expected = np.asarray(jpi.ParallelInference(
        jn, jpi.InferenceMode.INPLACE).output(x))
    pi = tpi.ParallelInference(tn, tpi.InferenceMode.BATCHED,
                               max_batch_size=16)
    results = {}

    def call(i):
        results[i] = pi.output(x[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        for i in range(32):
            np.testing.assert_allclose(results[i], expected[i], rtol=0,
                                       atol=TOL)
    finally:
        pi.shutdown()


def test_oversize_batch_split_across_dispatches(nets, monkeypatch):
    """Explicit buckets below a coalesced group: the group goes in
    top-bucket chunks, never at an unpadded novel size."""
    x = _x(5, 10)
    _, tn = nets
    sizes = []
    real = tn.output
    monkeypatch.setattr(tn, "output",
                        lambda b: (sizes.append(len(b)), real(b))[1])
    mine, ref = _both(nets, x, inference_mode="BATCHED", max_batch_size=16,
                      batch_buckets=[2, 4], nano_wait=0.05)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=TOL)
    assert sizes and set(sizes) <= {2, 4}
    for mod in (tpi, jpi):
        with pytest.raises(mod.InvalidInputError,
                           match="exceeds the top bucket"):
            mod._bucket(10, [2, 4])


def test_oversize_batch_rejected(nets):
    _, tn = nets
    x = _x(6, 10)
    pi = tpi.ParallelInference(tn, "BATCHED", max_batch_size=16,
                               batch_buckets=[2, 4],
                               oversize_policy="reject")
    try:
        with pytest.raises(tpi.InvalidInputError,
                           match="exceeds the top bucket"):
            pi.output(x)
        small = pi.output(x[:3])
    finally:
        pi.shutdown()
    _, ref = _both(nets, x[:3], inference_mode="BATCHED",
                   max_batch_size=16, batch_buckets=[2, 4],
                   oversize_policy="reject")
    np.testing.assert_allclose(small, ref, rtol=0, atol=TOL)


def test_oversize_dispatcher_group_rejected_future_by_future(nets):
    _, tn = nets
    x = _x(7, 6)
    pi = tpi.ParallelInference(tn, "BATCHED", max_batch_size=16,
                               batch_buckets=[2, 4],
                               oversize_policy="reject")
    try:
        pending = [(x[i], Future()) for i in range(6)]
        pi._run_batch(pending)
        for _, fut in pending:
            with pytest.raises(tpi.InvalidInputError):
                fut.result(timeout=WAIT_S)
    finally:
        pi.shutdown()


def test_bad_inputs_and_options_are_refused(nets):
    _, tn = nets
    with pytest.raises(ValueError, match="unknown inference_mode"):
        tpi.ParallelInference(tn, "SIDEWAYS")
    with pytest.raises(ValueError, match="unknown oversize_policy"):
        tpi.ParallelInference(tn, oversize_policy="drop")
    pi = tpi.ParallelInference(tn, "BATCHED", max_batch_size=4)
    try:
        with pytest.raises(tpi.InvalidInputError,
                           match="expected feature shape"):
            pi.output(np.zeros((2, 5), np.float32))
    finally:
        pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi._submit(np.zeros(4, np.float32))
