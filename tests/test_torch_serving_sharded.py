"""Serving a sharded checkpoint: the JAX package's ``ShardedTrainer``
writes a ZeRO-3 directory at dp 4 (one process, every block in
``shards-p00.npz``); the port's ``ServingEngine.promote_latest`` and
``InferenceServer.reload`` gather it into a serving slot (params only)
and serve rows within 2e-5 of the JAX network's ``output``."""
import numpy as np
import pytest

from deeplearning4j_tpu.faulttolerance.checkpoint import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ShardedTrainer as JShardedTrainer
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.faulttolerance.checkpoint import \
    CheckpointManager
from deeplearning4j_tpu_torch.parallel.inference import InferenceMode
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.inference_server import \
    InferenceServer

# Softmax rows of a 2-layer MLP (f32): the port and XLA sum the products
# in other orders; outputs agree to ~1e-7: 2e-5.
ATOL = 2e-5
WAIT_S = 60.0


@pytest.fixture(scope="module")
def sharded_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded")
    conf = (JNNC.builder().seed(11).updater(jupd.Adam(learning_rate=0.01))
            .list().layer(jff.DenseLayer(n_out=64, activation="relu"))
            .layer(jff.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(16)).build())
    jn = JMLN(conf).init()
    jt = JShardedTrainer(jn, jmake_mesh(dp=4), min_shard_size=64)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal((32, 16)).astype(np.float32)
        jt.fit(x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, 32)])
    store = str(d / "store")
    path = jt.save_sharded(JCheckpointManager(store, background=False))
    x = rng.standard_normal((7, 16)).astype(np.float32)
    return store, path, x, np.asarray(jn.output(x))


def test_the_store_holds_a_sharded_checkpoint(sharded_store):
    store, path, _, _ = sharded_store
    mgr = CheckpointManager(store)
    step, got = mgr.latest_complete(kind="sharded")
    assert got == path and mgr.latest_complete(kind="dense") is None
    with pytest.raises(ValueError, match="SHARDED"):
        mgr.restore(path=path, device="cpu")


def test_promote_latest_serves_a_sharded_directory(sharded_store):
    store, path, x, want = sharded_store
    eng = ServingEngine(device="cpu")
    try:
        assert eng.promote_latest(store) == 3
        out = eng.predict(x, timeout=WAIT_S)
        np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
        # a slot serves: no updater state rides along
        assert eng._slot.model.opt_state is None
    finally:
        eng.shutdown()


def test_engine_constructed_on_a_sharded_store_promotes_it(sharded_store):
    store, _, x, want = sharded_store
    eng = ServingEngine(checkpoint_dir=store, device="cpu")
    try:
        np.testing.assert_allclose(eng.predict(x, timeout=WAIT_S), want,
                                   rtol=0, atol=ATOL)
    finally:
        eng.shutdown()


def test_inference_server_reload_of_a_sharded_directory(sharded_store,
                                                        tmp_path):
    store, _, x, want = sharded_store
    # start from an unrelated model, then hot-swap to the sharded store
    first = CheckpointManager(store).restore_sharded(device="cpu")[0]
    first.params["layer_1"]["W"].data.zero_()
    srv = InferenceServer(first, device="cpu",
                          inference_mode=InferenceMode.INPLACE)
    try:
        assert not np.allclose(srv.inference.output(x), want, atol=ATOL)
        srv.reload(store)
        np.testing.assert_allclose(srv.inference.output(x), want, rtol=0,
                                   atol=ATOL)
        assert f"from={store}" in srv.model_id
    finally:
        srv.inference.shutdown()
