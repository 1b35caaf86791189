"""The port's ``streaming`` routes and clients against the JAX package's:
``ServeRoute`` over ``LocalMessageBroker`` and ``TcpMessageBroker``
serving a JAX-written MLN read into the port, its published predictions
held against the JAX ``ServeRoute``'s on the same frames, and the
``NDArrayPublisher``/``NDArrayConsumer`` round trips."""
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.streaming as jst
import deeplearning4j_tpu_torch.streaming as tst
from deeplearning4j_tpu.nn.conf.input_type import InputType
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

# softmax rows of a two-layer f32 MLN on the same weights
TOL_ROWS = 2e-5


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    conf = (NeuralNetConfiguration.builder().seed(5).activation("tanh")
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    jnet = MultiLayerNetwork(conf).init()
    path = tmp_path_factory.mktemp("route_mln") / "mln.zip"
    write_model(jnet, str(path))
    return jnet, load_reference_model(path, device="cpu")


def _frames():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((n, 6)).astype(np.float32) for n in (1, 4, 7)]


def _serve(mod, broker, model, frames):
    route = mod.ServeRoute(broker, model, "in", "out").start()
    out = broker.subscribe("out")
    try:
        time.sleep(0.1)                # let a TCP subscription register
        pub = mod.NDArrayPublisher(broker, "in")
        got = []
        for x in frames:
            pub.publish(x)
            payload = out.poll(timeout=10.0)
            assert payload is not None
            got.append(mod.deserialize_array(payload)[0])
        assert route.processed == len(frames)
        return got
    finally:
        route.stop()
        if hasattr(out, "close"):
            out.close()


@pytest.mark.parametrize("transport", ["local", "tcp"])
def test_serve_route_predictions_equal_jax(nets, transport):
    jnet, net = nets
    frames = _frames()
    want = _serve(jst, jst.LocalMessageBroker(), jnet, frames)
    if transport == "local":
        got = _serve(tst, tst.LocalMessageBroker(), net, frames)
    else:
        hub = tst.TcpMessageBroker().serve()
        try:
            got = _serve(tst, hub, net, frames)
        finally:
            hub.shutdown()
    for g, w, x in zip(got, want, frames):
        assert g.dtype == np.float32 and g.shape == (len(x), 3)
        np.testing.assert_allclose(g, w, atol=TOL_ROWS, rtol=0)


def test_route_copies_each_prediction_to_the_host_once():
    copies = []

    class Counted(torch.Tensor):
        def cpu(self, *a, **k):
            copies.append(1)
            return super().cpu(*a, **k)

    def model(x):
        y = torch.from_numpy(x.copy()).sum(1, keepdim=True)
        return y.as_subclass(Counted)

    broker = tst.LocalMessageBroker()
    got = _serve(tst, broker, model, _frames())
    assert len(copies) == 3
    np.testing.assert_allclose(got[1], _frames()[1].sum(1, keepdims=True),
                               rtol=1e-6)


def test_ndarray_clients_round_trip_across_packages():
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal((2, 3)).astype(np.float32),
              np.arange(5, dtype=np.int64), np.array(True)]
    b = tst.LocalMessageBroker()
    consumer = tst.NDArrayConsumer(b, "a")
    tst.NDArrayPublisher(b, "a").publish_all(
        [torch.from_numpy(arrays[0])] + arrays[1:])
    got = consumer.get_arrays(3, timeout=1.0)
    assert consumer.get_array(timeout=0.05) is None
    consumer.close()
    for g, w in zip(got, arrays):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the frames are the JAX package's: its consumer reads the port's
    hub = tst.TcpMessageBroker().serve()
    try:
        jb = jst.TcpMessageBroker(port=hub.port)
        jconsumer = jst.NDArrayConsumer(jb, "t")
        time.sleep(0.1)
        tst.NDArrayPublisher(hub, "t").publish_all(arrays)
        for g, w in zip(jconsumer.get_arrays(3, timeout=5.0), arrays):
            np.testing.assert_array_equal(g, w)
        jconsumer.close()
    finally:
        hub.shutdown()
    assert tst.serialize_dataset is not None and \
        tst.deserialize_dataset is not None
