"""The port's gradient codec, wire format and in-process training masters
against the JAX package's.

* threshold and bitmap messages (indices, signs, packed bytes) and their
  residuals bit-equal to the JAX package's for the same gradient, with
  the top-k cap and the adaptive handler over several rounds;
* the g++ host codec against its NumPy twin (``utils/native``);
* wire frames decode across the packages in both directions;
* ``EncodedGradientsAccumulator`` fan-out; ``tree_average``;
* ``ParameterAveragingTrainingMaster`` against the JAX master from the
  same weights (averaging is deterministic whatever the thread
  schedule), both masters learning the iris set as the JAX tests do;
* ``ElasticTrainer`` resume skips done steps; ``DistributedLayerTrainer``;
  ``EarlyStoppingMasterTrainer``; the distributed evaluation and score.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.mnist import IrisDataSetIterator
from deeplearning4j_tpu.data.dataset import \
    INDArrayDataSetIterator as JIterator
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import master as jmaster
from deeplearning4j_tpu.parallel import remote as jremote
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.data.dataset import INDArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.parallel import accumulation as tacc
from deeplearning4j_tpu_torch.parallel import (DistributedLayerTrainer,
                                               ElasticTrainer,
                                               ParameterAveragingTrainingMaster,
                                               SharedGradientsTrainingMaster,
                                               remote as tremote,
                                               tree_average)
from deeplearning4j_tpu_torch.utils import native
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

# Averaging master against JAX's (Sgd): the replicas' steps agree to f32
# rounding (~1e-7 of a leaf's scale per step) and averaging is exact
# arithmetic on equal inputs: 1e-6 of each leaf's scale after 2 fits.
RTOL_MASTER = 1e-6


def _iris():
    ds = next(iter(IrisDataSetIterator(batch_size=150)))
    return np.asarray(ds.features, np.float32), \
        np.asarray(ds.labels, np.float32)


def _jnet(updater=None, seed=7):
    conf = (JNNC.builder().seed(seed).activation("tanh")
            .weight_init("xavier")
            .updater(updater or jupd.Adam(learning_rate=0.02)).list()
            .layer(jff.DenseLayer(n_out=8))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _tnet(tmp_path, updater=None, seed=7, name="net"):
    jn = _jnet(updater, seed)
    path = str(tmp_path / f"{name}.zip")
    write_model(jn, path)
    return load_reference_model(path, device="cpu"), jn


def _grad(seed=0, n=512):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32) * 0.01
    g[10], g[100], g[300] = 0.5, -0.7, 0.9
    return g


# ------------------------------------------------------------ codec
@pytest.mark.parametrize("case", ["plain", "topk_cap", "ties"])
def test_threshold_message_and_residual_bit_equal_jax(case):
    if case == "plain":
        g, kw = _grad(), dict(threshold=0.1)
    elif case == "topk_cap":
        g = np.zeros(64, np.float32)
        g[:8] = [1, -2, 3, 4, -5, 6, 7, 8]
        kw = dict(threshold=0.5, max_elements=3)
    else:       # equal magnitudes: the lower index wins the cap
        g = np.zeros(40, np.float32)
        g[[3, 9, 17, 30]] = [0.5, -0.5, 0.5, 0.5]
        kw = dict(threshold=0.2, max_elements=2)
    jm, jr = jacc.threshold_encode(g, **kw)
    tm, tr = tacc.threshold_encode(g, **kw)
    for k in ("kind", "size", "threshold"):
        assert tm[k] == jm[k]
    np.testing.assert_array_equal(tm["idx"], np.asarray(jm["idx"]))
    np.testing.assert_array_equal(tm["signs"], np.asarray(jm["signs"]))
    assert tm["idx"].dtype == np.int32 and tm["signs"].dtype == np.int8
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tacc.threshold_decode(tm).numpy(),
                                  np.asarray(jacc.threshold_decode(jm)))


def test_bitmap_message_and_residual_bit_equal_jax():
    g = np.random.default_rng(1).standard_normal(1001).astype(np.float32)
    jm, jr = jacc.bitmap_encode(g, threshold=0.5)
    tm, tr = tacc.bitmap_encode(g, threshold=0.5)
    np.testing.assert_array_equal(tm["packed"], np.asarray(jm["packed"]))
    assert tm["packed"].dtype == np.uint8
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tacc.bitmap_decode(tm).numpy(),
                                  np.asarray(jacc.bitmap_decode(jm)))


@pytest.mark.parametrize("backend", ["device", "host"])
def test_adaptive_handler_rounds_bit_equal_jax(backend):
    jh = jacc.EncodingHandler(initial_threshold=0.05, backend=backend)
    th = tacc.EncodingHandler(initial_threshold=0.05, backend=backend)
    rng = np.random.default_rng(3)
    kinds = set()
    for r in range(8):
        scale = 0.001 if r < 3 else (1.0 if r < 5 else 0.02)
        g = (rng.standard_normal(256) * scale).astype(np.float32)
        jm, tm = jh.encode_update(g), th.encode_update(g)
        kinds.add(tm["kind"])
        assert tm["kind"] == jm["kind"] and tm["threshold"] == jm["threshold"]
        for k in ("idx", "signs", "packed"):
            if k in jm:
                np.testing.assert_array_equal(tm[k], np.asarray(jm[k]))
        assert th.threshold == jh.threshold
        np.testing.assert_array_equal(np.asarray(th.residual),
                                      np.asarray(jh.residual))
    assert kinds == {"threshold", "bitmap"}


def test_native_codec_equals_numpy_twin():
    if not native.available():
        pytest.skip("no g++ to build the host codec")
    g = _grad(5, 4097)
    for max_k in (None, 2):
        a = native.threshold_encode_native(g, 0.1, max_k)
        b = native.threshold_encode_native(g, 0.1, max_k, use_native=False)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        dec = native.threshold_decode_native(a[0], a[1], 0.1, g.size)
        np.testing.assert_array_equal(dec, native.threshold_decode_native(
            a[0], a[1], 0.1, g.size, use_native=False))
    p, r = native.bitmap_encode_native(g, 0.02)
    p2, r2 = native.bitmap_encode_native(g, 0.02, use_native=False)
    np.testing.assert_array_equal(p, p2)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(
        native.bitmap_decode_native(p, 0.02, g.size),
        native.bitmap_decode_native(p, 0.02, g.size, use_native=False))


def test_wire_frames_decode_across_packages():
    msgs = [{"kind": "threshold", "size": 10, "threshold": 0.5,
             "idx": np.array([1, 7], np.int32),
             "signs": np.array([1, -1], np.int8)},
            {"kind": "bitmap", "size": 8, "threshold": 0.25,
             "packed": np.array([0b01100001, 0b10], np.uint8)}]
    for msg in msgs:
        jb = jremote.encode_message_bytes(3, msg, seq=17)
        tb = tremote.encode_message_bytes(3, msg, seq=17)
        assert jb == tb
        for data, dec in ((jb, tremote.decode_message_bytes),
                          (tb, jremote.decode_message_bytes)):
            wid, seq, back = dec(data)
            assert (wid, seq, back["kind"], back["size"]) == \
                (3, 17, msg["kind"], msg["size"])
            for k in ("idx", "signs", "packed"):
                if k in msg:
                    np.testing.assert_array_equal(back[k], msg[k])


def test_remote_sharing_over_the_local_broker():
    from deeplearning4j_tpu_torch.streaming import LocalMessageBroker
    broker = LocalMessageBroker()
    mk = lambda w: tremote.RemoteGradientSharing(  # noqa: E731
        broker, w, handler=tacc.EncodingHandler(initial_threshold=0.1,
                                                decay=1.0, boost=1.0))
    w0, w1 = mk(0), mk(1)
    g = np.zeros(16, np.float32)
    g[3], g[8] = 0.7, -0.9
    w0.publish_update(g)
    params = w1.apply_updates(np.zeros(16, np.float32), timeout=3.0)
    assert params[3] > 0 and params[8] < 0
    assert w0.apply_updates(np.zeros(16, np.float32),
                            timeout=0.05).abs().sum() == 0
    assert w0.messages_sent == 1 and w1.messages_applied == 1
    w0.close()
    w1.close()


def test_accumulator_fans_out_to_peers_only():
    acc = tacc.EncodedGradientsAccumulator(
        3, lambda: tacc.EncodingHandler(initial_threshold=0.1))
    g = np.zeros(32, np.float32)
    g[4] = 1.0
    acc.store_update(0, g)
    p = np.zeros(32, np.float32)
    assert acc.apply_updates(1, p)[4].item() == pytest.approx(0.1)
    assert acc.apply_updates(0, p)[4].item() == 0.0
    assert acc.has_anything(2) and not acc.has_anything(1)
    assert acc.messages_sent == 1 and acc.bytes_sent > 0


def test_tree_average_equals_jax():
    rng = np.random.default_rng(2)
    trees = [{"a": rng.standard_normal((3, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(5)]
    for depth in (1, 2, 3):
        j = jmaster.tree_average(trees, depth=depth)
        t = tree_average([{"a": torch.tensor(x["a"]),
                           "b": {"c": torch.tensor(x["b"]["c"])}}
                          for x in trees], depth=depth)
        np.testing.assert_array_equal(t["a"].numpy(), np.asarray(j["a"]))
        np.testing.assert_array_equal(t["b"]["c"].numpy(),
                                      np.asarray(j["b"]["c"]))


# ------------------------------------------------------------ masters
def test_parameter_averaging_equals_jax_master(tmp_path):
    x, y = _iris()
    tn, jn = _tnet(tmp_path, jupd.Sgd(learning_rate=0.1))
    jm = jmaster.ParameterAveragingTrainingMaster(num_workers=2,
                                                  averaging_frequency=2)
    tm = ParameterAveragingTrainingMaster(num_workers=2,
                                          averaging_frequency=2)
    for _ in range(2):
        jm.fit(jn, JIterator(x, y, batch_size=15))
        tm.fit(tn, INDArrayDataSetIterator(x, y, batch_size=15))
    for k, g in jn.params.items():
        for n, a in g.items():
            a = np.asarray(a)
            err = np.max(np.abs(tn.params[k][n].detach().numpy() - a))
            assert err <= RTOL_MASTER * np.max(np.abs(a)), f"{k}/{n}"
    assert {"split", "broadcast", "fit", "aggregation"} <= \
        set(tm.stats.as_dict())


def test_parameter_averaging_learns_iris(tmp_path):
    x, y = _iris()
    net, _ = _tnet(tmp_path, jupd.Adam(learning_rate=0.05))
    master = ParameterAveragingTrainingMaster(num_workers=3,
                                              averaging_frequency=2)
    for _ in range(15):
        master.fit(net, INDArrayDataSetIterator(x, y, batch_size=10))
    assert net.evaluate(x, y).accuracy() > 0.9


def test_shared_gradients_learns_iris(tmp_path):
    """Asynchronous threshold-encoded sharing is schedule-dependent by
    design: one retry absorbs a pathological schedule (as the JAX test)."""
    x, y = _iris()
    for attempt in range(2):
        net, _ = _tnet(tmp_path, jupd.Sgd(learning_rate=0.05),
                       name=f"sh{attempt}")
        master = SharedGradientsTrainingMaster(
            num_workers=3, handler_factory=lambda: tacc.EncodingHandler(
                initial_threshold=0.01, decay=1.0, boost=1.0))
        for _ in range(25):
            master.fit(net, INDArrayDataSetIterator(x, y, batch_size=10))
        acc = net.evaluate(x, y).accuracy()
        if acc > 0.75:
            break
    assert acc > 0.75, acc
    assert master.accumulator.messages_sent > 0


def test_distributed_evaluate_and_score_match_local(tmp_path):
    x, y = _iris()
    net, _ = _tnet(tmp_path, jupd.Adam(learning_rate=0.05))
    for _ in range(30):
        net.fit(INDArrayDataSetIterator(x, y, batch_size=25))
    master = ParameterAveragingTrainingMaster(num_workers=3)
    ev = master.evaluate(net, INDArrayDataSetIterator(x, y, batch_size=15))
    assert ev.accuracy() == pytest.approx(net.evaluate(x, y).accuracy())
    dist = master.score(net, INDArrayDataSetIterator(x, y, batch_size=15))
    assert dist == pytest.approx(net.score(x=x, y=y), rel=1e-3)


def test_elastic_resume_skips_done_steps(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 300)]
    batches = lambda: iter(INDArrayDataSetIterator(x, y, batch_size=10))  # noqa: E731,E501
    net, _ = _tnet(tmp_path)
    trainer = ElasticTrainer(net, str(tmp_path / "ck"), save_freq=7)
    assert trainer.fit(batches, max_steps=20) == 20
    assert trainer.latest_step() == 20
    after = {k: {n: p.detach().clone() for n, p in g.items()}
             for k, g in net.params.items()}
    net2, _ = _tnet(tmp_path, seed=99, name="other")
    trainer2 = ElasticTrainer(net2, str(tmp_path / "ck"), save_freq=7)
    assert trainer2.restore_latest() == 20
    for k, g in after.items():
        for n, t in g.items():
            assert torch.equal(net2.params[k][n], t)
    assert trainer2.fit(batches, max_steps=30) == 30
    assert trainer2.trained_steps == 10


def test_distributed_layer_trainer_learns_iris():
    x, y = _iris()
    trainer = DistributedLayerTrainer(
        jff_output(), input_size=4, seed=3,
        updater=tupd.Adam(learning_rate=0.05), device="cpu",
        master=ParameterAveragingTrainingMaster(num_workers=2,
                                                averaging_frequency=2))
    trainer.fit(INDArrayDataSetIterator(x, y, batch_size=10), epochs=20)
    pred = trainer.predict(x)
    assert pred.shape == (150, 3)
    assert np.mean(pred.argmax(1) == y.argmax(1)) > 0.85


def jff_output():
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    return OutputLayer(n_out=3, activation="softmax", loss="mcxent")


def test_early_stopping_master_trainer_stops_and_returns_best(tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingMasterTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    x, y = _iris()
    net, _ = _tnet(tmp_path, jupd.Adam(learning_rate=0.05))
    master = ParameterAveragingTrainingMaster(num_workers=2,
                                              averaging_frequency=2)
    conf = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            INDArrayDataSetIterator(x, y, batch_size=50)),
        epoch_terminations=[MaxEpochsTerminationCondition(8)],
        model_saver=InMemoryModelSaver())
    result = EarlyStoppingMasterTrainer(
        conf, net, master, INDArrayDataSetIterator(x, y, batch_size=15)).fit()
    assert result.termination_reason == "EpochTerminationCondition"
    assert result.total_epochs <= 8
    assert result.best_model is not None
    assert result.best_model_score < 1.0
