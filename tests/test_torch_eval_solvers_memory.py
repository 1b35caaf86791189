"""The rest of evaluation (``evaluation/binary.py``, ``calibration.py``,
``tools.py``), the legacy solvers (``train/solvers.py``), the memory
report (``nn/conf/memory.py``) and ``ZooModel.pretrained``, each against
the JAX package on the CPU, mirroring ``tests/test_eval_extras.py`` and
``tests/test_solvers.py``.

Tolerances:
- Evaluation counts, bins and histograms: exact; derived metrics 1e-12
  (the same float64 numpy arithmetic on the same counts).
- Memory reports: every field equal as integers.
- Solver score histories: 1e-5 relative for the first three scores
  (the same f32 arithmetic: the loss and gradient sums differ in order
  only, ~1e-7, and the line search's tests agree), and the final score
  no worse than the JAX package's plus 1e-4 (after a few iterations a
  line search can take one halving more or less on either side).
"""
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import evaluation as jev
from deeplearning4j_tpu.models.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JTextLSTM
from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf import memory as jmem
from deeplearning4j_tpu.nn.conf.computation_graph import (
    ElementWiseVertex as JEW, GraphBuilder as JGB)
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers.convolution import (
    ConvolutionLayer as JConv, SubsamplingLayer as JSub)
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import solvers as jsolvers
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch import evaluation as tev
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import memory as tmem
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import solvers as tsolvers
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

RTOL_SCORES = 1e-5
FINAL_SLACK = 1e-4


# ------------------------------------------------------------- evaluation
def _binary_cases():
    rng = np.random.default_rng(3)
    labels = (rng.uniform(size=(50, 3)) < 0.5).astype(float)
    preds = rng.uniform(size=(50, 3))
    ts_labels = (rng.uniform(size=(4, 6, 2)) < 0.5).astype(float)
    ts_preds = rng.uniform(size=(4, 6, 2))
    return [
        (dict(), (labels, preds), {}),
        (dict(thresholds=[0.3, 0.5, 0.7]), (labels, preds), {}),
        (dict(), (labels, preds),
         {"mask": (rng.uniform(size=50) < 0.7).astype(float)}),
        (dict(), (labels, preds),
         {"mask": (rng.uniform(size=(50, 3)) < 0.7).astype(float)}),
        (dict(), (ts_labels, ts_preds),
         {"mask": (rng.uniform(size=(4, 6)) < 0.7).astype(float)}),
        (dict(decision_threshold=0.25), (ts_labels, ts_preds),
         {"mask": (rng.uniform(size=(4, 6, 2)) < 0.7).astype(float)}),
    ]


@pytest.mark.parametrize("case", range(6))
def test_evaluation_binary_matches_jax(case):
    """``TestEvaluationBinary``: counts, metrics, stats text and merge,
    with numpy and tensor inputs."""
    kw, (labels, preds), mask = _binary_cases()[case]
    j = jev.EvaluationBinary(**kw).eval(labels, preds, **mask)
    t = tev.EvaluationBinary(**kw).eval(
        torch.tensor(labels), torch.tensor(preds),
        **{k: torch.tensor(v) for k, v in mask.items()})
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for i in range(labels.shape[-1]):
        for m in ("precision", "recall", "f1", "accuracy"):
            assert getattr(t, m)(i) == pytest.approx(getattr(j, m)(i),
                                                     abs=1e-12)
    assert t.average_f1() == pytest.approx(j.average_f1(), abs=1e-12)
    assert t.stats() == j.stats()
    t.merge(tev.EvaluationBinary(**kw).eval(labels, preds, **mask))
    j.merge(jev.EvaluationBinary(**kw).eval(labels, preds, **mask))
    np.testing.assert_array_equal(t.tp, j.tp)


def test_evaluation_binary_examples_of_the_jax_tests():
    labels = np.array([[1, 0], [1, 1], [0, 1], [0, 0]], dtype=float)
    preds = np.array([[0.9, 0.2], [0.8, 0.4], [0.3, 0.9], [0.6, 0.1]])
    ev = tev.EvaluationBinary().eval(labels, preds)
    assert ev.tp[0] == 2 and ev.fp[0] == 1 and ev.tn[0] == 1 and \
        ev.fn[0] == 0
    assert ev.precision(0) == pytest.approx(2 / 3)
    assert "label_0" in ev.stats()
    labels = np.ones((1, 2, 2))
    mask = np.zeros((1, 2, 2))
    mask[0, 0, 0] = 1
    ev = tev.EvaluationBinary().eval(labels, np.full((1, 2, 2), 0.9),
                                     mask=mask)
    assert list(ev.tp) == [1, 0]


@pytest.mark.parametrize("bins", [(10, 10), (7, 13)])
def test_evaluation_calibration_matches_jax(bins):
    """``TestCalibration``: reliability diagrams, histograms and the ECE
    of the JAX package, from numpy and from tensors."""
    rb, hb = bins
    rng = np.random.default_rng(4)
    p = rng.uniform(0.05, 0.95, size=3000)
    y = (rng.uniform(size=p.size) < p).astype(float)
    labels, preds = np.stack([1 - y, y], 1), np.stack([1 - p, p], 1)
    j = jev.EvaluationCalibration(reliability_bins=rb, histogram_bins=hb)
    t = tev.EvaluationCalibration(reliability_bins=rb, histogram_bins=hb)
    for lo in range(0, 3000, 1000):          # streamed in three batches
        j.eval(labels[lo:lo + 1000], preds[lo:lo + 1000])
        t.eval(torch.tensor(labels[lo:lo + 1000]),
               torch.tensor(preds[lo:lo + 1000]))
    for c in (0, 1):
        jd, td = j.reliability_diagram(c), t.reliability_diagram(c)
        for f in ("mean_predicted_value", "fraction_positives"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
        for h in ("probability_histogram", "residual_histogram"):
            np.testing.assert_array_equal(getattr(t, h)(c).bin_counts,
                                          getattr(j, h)(c).bin_counts)
        assert t.expected_calibration_error(c) == \
            j.expected_calibration_error(c)
    assert t.expected_calibration_error(1) < 0.05


def test_html_export_matches_jax(tmp_path):
    """``TestHtmlExport``: the ROC and calibration pages are the JAX
    package's, byte for byte, and the exporters write them."""
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, 500).astype(float)
    p = np.clip(y * 0.6 + rng.uniform(size=500) * 0.4, 0, 1)
    jroc, troc = jev.ROC(), tev.ROC()
    jroc.eval(y.reshape(-1, 1), p.reshape(-1, 1))
    troc.eval(y.reshape(-1, 1), p.reshape(-1, 1))
    html = tev.rocs_to_html(troc)
    assert "<svg" in html and "AUC=" in html
    assert html == jev.rocs_to_html(jroc)
    jcal = jev.EvaluationCalibration().eval(np.stack([1 - y, y], 1),
                                            np.stack([1 - p, p], 1))
    tcal = tev.EvaluationCalibration().eval(np.stack([1 - y, y], 1),
                                            np.stack([1 - p, p], 1))
    html2 = tev.calibration_to_html(tcal)
    assert "Reliability" in html2 and "ECE=" in html2
    assert html2 == jev.calibration_to_html(jcal)
    out = tmp_path / "cal.html"
    tev.export_calibration_to_html(tcal, str(out))
    assert out.read_text() == html2
    out = tmp_path / "roc.html"
    tev.export_roc_charts_to_html([troc], str(out))
    assert "AUC=" in out.read_text()


# ---------------------------------------------------------- memory report
def _mem_conf(**kw):
    b = (JNNC.builder().seed(1).activation("relu").weight_init("xavier")
         .updater(JAdam(learning_rate=1e-3)))
    for k, v in kw.items():
        getattr(b, k)(v)
    return (b.list()
            .layer(JConv(n_out=8, kernel_size=(3, 3),
                         convolution_mode="same"))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JDense(n_out=32))
            .layer(JOut(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.convolutional(8, 8, 1)).build())


def _report_fields(rep):
    out = {f: getattr(rep, f) for f in ("model_class", "param_bytes",
                                        "activation_bytes",
                                        "mixed_precision", "remat",
                                        "total_params",
                                        "total_updater_elems",
                                        "activation_elems_per_example")}
    out["layers"] = [(r.layer_name, r.layer_type, r.n_params,
                      r.activation_elems_per_example, r.updater_state_elems)
                     for r in rep.layer_reports]
    for batch in (1, 32, 512):
        for mode in (jmem.MemoryUseMode.TRAINING,
                     jmem.MemoryUseMode.INFERENCE):
            out[(batch, mode)] = int(rep.total_memory_bytes(batch, mode))
    return out


def _mln_pair(jconf):
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _graph_pair(jconf):
    return jconf, ComputationGraphConfiguration.from_json(jconf.to_json())


def _mem_cases():
    g = (JGB(defaults={"updater": JAdam(learning_rate=1e-3),
                       "activation": "relu", "weight_init": "xavier"})
         .add_inputs("in")
         .add_layer("d1", JDense(n_out=16), "in")
         .add_layer("d2", JDense(n_out=16), "d1")
         .add_vertex("add", JEW(op="add"), "d1", "d2")
         .add_layer("out", JOut(n_out=3, activation="softmax",
                                loss="mcxent"), "add")
         .set_outputs("out").set_input_types(JIT.feed_forward(8)).build())
    return {
        "conv_mln": lambda: _mln_pair(_mem_conf()),
        "conv_mln_bf16": lambda: _mln_pair(_mem_conf(
            compute_dtype="bfloat16")),
        "conv_mln_remat_f16": lambda: _mln_pair(_mem_conf(
            cache_mode="remat", precision="float16")),
        "graph": lambda: _graph_pair(g),
        "transformer_lm_bf16": lambda: _mln_pair(JTransformerLM(
            vocab_size=64, seq_len=32, embed=32, n_layers=2, n_heads=2,
            compute_dtype="bfloat16").init().conf),
        "char_lstm": lambda: _mln_pair(JTextLSTM(
            num_classes=12, timesteps=8, hidden=16).init().conf),
        "resnet50_bf16": lambda: _graph_pair(JResNet50(
            num_classes=10, input_shape=(32, 32, 3),
            compute_dtype="bfloat16").init().conf),
    }


@pytest.mark.parametrize("name", list(_mem_cases()))
def test_memory_report_fields_equal_jax_as_integers(name):
    """Every field of the analytic report (``test_param_counts_match_model``,
    ``test_mixed_precision_and_remat_terms``, the graph report) equals the
    JAX package's, and its params are the port network's."""
    jconf, tconf = _mem_cases()[name]()
    graph = isinstance(tconf, ComputationGraphConfiguration)
    if graph:
        j, t = jmem.memory_report_graph(jconf), \
            tmem.memory_report_graph(tconf)
        net = ComputationGraph(tconf, device="cpu")
    else:
        j, t = jmem.memory_report(jconf), tmem.memory_report(tconf)
        net = MultiLayerNetwork(tconf, device="cpu")
    assert _report_fields(t) == _report_fields(j)
    assert t.to_string(32) == j.to_string(32)
    assert t.total_params == net.init().num_params()
    assert t.static_bytes() == (t.total_params + t.total_updater_elems) * 4


def test_memory_report_terms_and_refusals():
    """``test_mixed_precision_and_remat_terms`` and
    ``test_unbuilt_conf_raises`` on the port's own builder."""
    base = tmem.memory_report(_mln_pair(_mem_conf())[1])
    bf16 = tmem.memory_report(_mln_pair(_mem_conf(
        compute_dtype="bfloat16"))[1])
    remat = tmem.memory_report(_mln_pair(_mem_conf(cache_mode="remat"))[1])
    assert bf16.mixed_precision and bf16.activation_bytes == 2
    assert remat.remat
    b, bb, br = (r.total_memory_bytes(512) for r in (base, bf16, remat))
    assert bb < b and br == b
    assert base.total_updater_elems == 2 * base.total_params
    with pytest.raises(ValueError, match="input types"):
        tmem.memory_report(MultiLayerConfiguration())
    # the device tier counts the card's allocator only
    net = MultiLayerNetwork(_mln_pair(_mem_conf())[1], device="cpu").init()
    assert tmem.device_memory_report(net, np.zeros((2, 8, 8, 1),
                                                   np.float32),
                                     np.eye(10, dtype=np.float32)[:2]) \
        is None


# ---------------------------------------------------------------- solvers
def _toy(seed=3, n_in=4, n_out=3, hidden=8):
    conf = (JNNC.builder().seed(seed).updater(JSgd(learning_rate=0.1))
            .list()
            .layer(JDense(n_out=hidden, activation="tanh"))
            .layer(JOut(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(n_in)).build())
    jn = JMLN(conf).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                           device="cpu").init()
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    return jn, tn


def _toy_data(seed=0, n=60, n_in=4, n_cls=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    labels = (np.abs(x[:, 0]) + x[:, 1] > x[:, 2]).astype(int) + \
        (x[:, 3] > 0.5).astype(int)
    return x, np.eye(n_cls, dtype=np.float32)[labels]


@pytest.mark.parametrize("cls", ["LineGradientDescent", "ConjugateGradient",
                                 "LBFGS"])
def test_solver_score_histories_match_jax(cls):
    """``test_full_batch_solvers_reduce_loss``: 40 iterations on the toy
    net from the same params; the histories agree, fall monotonically
    and end under 0.6 of the start."""
    jn, tn = _toy()
    x, y = _toy_data()
    j = getattr(jsolvers, cls)(max_iterations=40)
    t = getattr(tsolvers, cls)(max_iterations=40)
    js, ts = j.optimize(jn, x, y), t.optimize(tn, x, y)
    jh, th = j.score_history, t.score_history
    np.testing.assert_allclose(th[:3], jh[:3], rtol=RTOL_SCORES)
    assert ts <= js + FINAL_SLACK
    assert ts < 0.6 * th[0]
    assert all(th[i + 1] <= th[i] + 1e-6 for i in range(len(th) - 1))
    assert tn._score == ts == th[-1]


def test_lbfgs_beats_steepest_descent_and_terminations():
    """``test_lbfgs_beats_steepest_descent`` and the termination
    conditions."""
    xs, ys = _toy_data(seed=1)
    _, a = _toy(seed=5)
    _, b = _toy(seed=5)
    s_lgd = tsolvers.LineGradientDescent(max_iterations=25).optimize(
        a, xs, ys)
    s_lbfgs = tsolvers.LBFGS(max_iterations=25).optimize(b, xs, ys)
    assert s_lbfgs < s_lgd + 1e-6
    assert tsolvers.EpsTermination(1e-3).terminate(1.0, 1.0005, 5.0)
    assert not tsolvers.EpsTermination(1e-3).terminate(1.0, 0.9, 5.0)
    assert tsolvers.Norm2Termination(1e-3).terminate(1.0, 0.5, 1e-4)
    assert tsolvers.ZeroDirectionTermination().terminate(1.0, 1.0, 0.0)
    # a max of 1 iteration with a loose Eps stops after the first step
    opt = tsolvers.ConjugateGradient(
        max_iterations=1, terminations=[tsolvers.EpsTermination(1e9)])
    opt.optimize(_toy()[1], xs, ys)
    assert len(opt.score_history) == 2
    with pytest.raises(ValueError, match="unknown optimization"):
        tsolvers.Solver(b, "newton")


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_fit_dispatches_on_optimization_algo_as_jax(algo):
    """``fit`` routes a non-sgd ``optimization_algo`` through the Solver
    façade with ``max_iterations`` from the defaults, one optimize per
    batch, listeners fired per solver run; ``fit_on_device`` refuses it;
    a graph ignores it and trains by SGD, as in the JAX package."""
    conf = (JNNC.builder().seed(3).updater(JSgd(learning_rate=0.1))
            .optimization_algo(algo, max_iterations=5).list()
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    jn = JMLN(conf).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                           device="cpu").init()
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    x, y = _toy_data()
    jn.fit(x, y, epochs=2)
    tn.fit(x, y, epochs=2)
    assert tn.epoch == jn.epoch == 2
    np.testing.assert_allclose(tn.get_score(), jn.get_score(), rtol=1e-4)
    with pytest.raises(ValueError, match="legacy solvers"):
        tn.fit_on_device(x, y, batch_size=20)


# ------------------------------------------------------------- pretrained
def test_zoo_pretrained_reads_a_jax_zip_three_ways(tmp_path, monkeypatch):
    """``ZooModel.pretrained``: the JAX package's ``write_model`` zip of a
    zoo model loads from a path, from a directory holding
    ``<class>.zip`` and from ``DL4J_TPU_PRETRAINED_DIR``, with the JAX
    params and outputs; the JAX package reads the same zip back.  A Keras
    HDF5 file (item 9 d, ported) goes through ``import_pretrained``: a
    JAX-written one loads with the JAX outputs, and bytes that are not
    HDF5 beyond the signature raise the reader's ``Hdf5FormatError``, as
    in the JAX package."""
    from deeplearning4j_tpu.utils.model_serializer import restore_model
    jnet = JTextLSTM(num_classes=6, timesteps=5, hidden=8).init()
    path = tmp_path / "textgenerationlstm.zip"
    write_model(jnet, str(path))
    x = np.eye(6, dtype=np.float32)[np.random.default_rng(0).integers(
        0, 6, (2, 5))]
    want = np.asarray(jnet.output(x))
    model = tzoo.TextGenerationLSTM(num_classes=6, timesteps=5, hidden=8)
    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    for net in (model.pretrained(str(path), device="cpu"),
                model.pretrained(str(tmp_path), device="cpu"),
                model.pretrained(device="cpu")):
        np.testing.assert_allclose(net.output(x).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(restore_model(str(path)).output(
        x)), want, atol=0)
    monkeypatch.delenv("DL4J_TPU_PRETRAINED_DIR")
    with pytest.raises(FileNotFoundError, match="DL4J_TPU_PRETRAINED_DIR"):
        model.pretrained(device="cpu")
    from deeplearning4j_tpu.modelimport import (
        Hdf5FormatError as JHdf5FormatError, export_keras_sequential)
    from deeplearning4j_tpu_torch.modelimport import Hdf5FormatError
    h5 = tmp_path / "weights.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(8))
    with pytest.raises(Hdf5FormatError, match="8-byte offsets"):
        tzoo.LeNet().pretrained(str(h5), device="cpu")
    with pytest.raises(JHdf5FormatError, match="8-byte offsets"):
        from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
        JLeNet().pretrained(str(h5))
    keras = tmp_path / "textgenerationlstm.h5"
    export_keras_sequential(jnet, str(keras))
    np.testing.assert_allclose(
        model.pretrained(str(keras), device="cpu").output(x).numpy(), want,
        atol=1e-6)
    assert os.path.exists(path)
