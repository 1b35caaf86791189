"""The port's process masters (``parallel/master_mp.py``) against the JAX
package's.

Two CPU worker processes (``device="cpu"``) train a small net that the
JAX package wrote with ``write_model`` and the port loaded with
``load_reference_model``, coordinated through the port's
``TcpMessageBroker`` hub:

* averaging: the JAX ``MultiprocessMaster`` runs once on the same file
  and batches; the port's params match within 1e-5 of each leaf's
  largest |value| (f32 on both sides; the same Adam steps and means,
  summed in another order);
* shared mode: every worker applies exactly the updates its peer
  declared, and the final tables agree within ``agreement_tol``;
* the averaging retry (the respawn resumes from the last averaged
  frame) and the shared retry (the RESYNC seed from the master's
  mirror); an exhausted budget raises with the JAX package's words;
* ``evaluate``/``score`` fanned out: the JAX net's accuracy exactly and
  its score within 1e-6 relative (f32 sums of 6 batches);
* ``EarlyStoppingMasterTrainer`` over the process master;
* a worker that cannot reach its device fails the job, and the worker
  entry imports no JAX.
"""
import os
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.evaluation.classification import \
    Evaluation as JEvaluation
from deeplearning4j_tpu.nn.conf.input_type import InputType
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Adam
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.master_mp import \
    MultiprocessMaster as JMaster
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.parallel import master_mp
from deeplearning4j_tpu_torch.parallel.master_mp import MultiprocessMaster
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

RTOL_PARAMS = 1e-5
RTOL_SCORE = 1e-6
JAX_WORKER_ENV = {"JAX_PLATFORMS": "cpu"}
# how long a dead worker's in-flight message may lag before the respawn
# (the master's _DEAD_GRACE, 2 s): local loopback lands it in far less
DEAD_GRACE_S = 0.25


def _jax_model(seed=7):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).activation("tanh").weight_init("xavier")
            .updater(Adam(learning_rate=0.05))
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return JMLN(conf).init()


def _batches(n_batches=8, bs=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.standard_normal((bs, 4)).astype(np.float32)
        yc = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)
        out.append((x, np.eye(3, dtype=np.float32)[yc]))
    return out


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mp") / "model.zip")
    write_model(_jax_model(), path)
    return path


def _net(zip_path):
    return load_reference_model(zip_path, device="cpu")


def _master(**kw):
    kw.setdefault("timeout", 120.0)
    kw.setdefault("retry_backoff_s", 0.01)
    m = MultiprocessMaster(num_workers=2, device="cpu", **kw)
    m._DEAD_GRACE = DEAD_GRACE_S
    return m


@pytest.fixture(scope="module")
def scored(zip_path, tmp_path_factory):
    """One ``score`` fan-out over 6 batches, the workers' import log on
    (``PYTHONPROFILEIMPORTTIME``, into each worker's log)."""
    jobdir = tmp_path_factory.mktemp("score")
    m = _master(worker_env={"PYTHONPROFILEIMPORTTIME": "1"})
    got = m.score(_net(zip_path), iter(_batches(n_batches=6)),
                  jobdir=str(jobdir))
    return got, jobdir


def test_averaging_matches_the_jax_process_master(zip_path, tmp_path):
    batches = _batches()
    jnet = _jax_model()
    # the JAX job runs beside the port's (both masters mostly wait on
    # their worker processes)
    jax_job = threading.Thread(target=JMaster(
        num_workers=2, mode="averaging", averaging_frequency=2,
        worker_env=JAX_WORKER_ENV, timeout=120.0).fit,
        args=(jnet, iter(batches)), kwargs={"jobdir": str(tmp_path / "jax")})
    jax_job.start()
    net = _net(zip_path)
    m = _master(mode="averaging", averaging_frequency=2)
    try:
        m.fit(net, iter(batches), jobdir=str(tmp_path / "port"))
    finally:
        jax_job.join(180)
    assert not jax_job.is_alive()
    assert [r["steps"] for r in m.last_results] == [4, 4]
    assert all(r["device"] == "cpu" for r in m.last_results)
    for k, g in jnet.params.items():
        for n, a in g.items():
            want = np.asarray(a)
            got = net.params[k][n].detach().numpy()
            assert np.abs(got - want).max() <= \
                RTOL_PARAMS * np.abs(want).max(), f"{k}/{n}"
    # the installed params are the last averaged frame (params + slots)
    vec, _ = master_mp._ravel(net, True)
    assert vec.dtype == np.float32 and np.isfinite(vec).all()


def test_shared_mode_applies_exactly_the_declared_updates(zip_path,
                                                          tmp_path):
    net = _net(zip_path)
    x0, y0 = _batches()[0]
    before = net.score(x=x0, y=y0)
    m = _master(mode="shared", threshold=1e-4)
    m.fit(net, iter(_batches(n_batches=10)), jobdir=str(tmp_path))
    r0, r1 = m.last_results
    assert r0["applied_per_peer"] == {"1": r1["messages_sent"]}
    assert r1["applied_per_peer"] == {"0": r0["messages_sent"]}
    assert r0["messages_sent"] == r1["messages_sent"] == 5
    assert m.last_table_spread is not None and \
        m.last_table_spread <= m.agreement_tol
    assert net.score(x=x0, y=y0) < before


def test_averaging_retry_resumes_from_the_last_frame(zip_path, tmp_path):
    net = _net(zip_path)
    m = _master(mode="averaging", averaging_frequency=2,
                fault_injection={"die_before_publish": {"1": 1}})
    m.fit(net, iter(_batches()), jobdir=str(tmp_path))
    assert m.retried_workers == {1}
    r0, r1 = m.last_results
    assert r1["resumed"] is True and r1["steps"] == 2 and r0["steps"] == 4
    assert all(np.isfinite(p.detach().numpy()).all()
               for g in net.params.values() for p in g.values())


def test_shared_retry_resyncs_from_the_mirror(zip_path, tmp_path):
    net = _net(zip_path)
    m = _master(mode="shared", threshold=1e-4,
                fault_injection={"die_after_batches": {"0": 2}})
    m.fit(net, iter(_batches(n_batches=10)), jobdir=str(tmp_path))
    assert m.retried_workers == {0}
    assert m.last_table_spread is None
    assert m.last_results[0]["resumed"] is True
    assert m.last_results[0]["steps"] == 5


def test_exhausted_retries_raise_with_the_jax_words(zip_path, tmp_path):
    m = _master(max_task_retries=0, fault_injection={"die_at_start": [1]},
                timeout=60.0)
    with pytest.raises(RuntimeError, match="worker 1 failed after 0 "
                                           "retries: "):
        m.evaluate(_net(zip_path), iter(_batches(n_batches=4)),
                   jobdir=str(tmp_path))


def test_evaluate_and_score_fan_out_to_the_jax_values(zip_path, scored,
                                                      tmp_path):
    batches = _batches(n_batches=6)
    jnet = _jax_model()
    local = JEvaluation()
    for x, y in batches:
        local.eval(y, np.asarray(jnet.output(x)))
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    want_score = float(jnet.score(x=xs, y=ys))
    net = _net(zip_path)
    m = _master()
    merged = m.evaluate(net, iter(batches), jobdir=str(tmp_path))
    assert merged.accuracy() == local.accuracy()
    assert merged.confusion.total() == local.confusion.total() == 96
    assert scored[0] == pytest.approx(want_score, rel=RTOL_SCORE)


def test_early_stopping_trainer_drives_the_process_master(zip_path,
                                                          tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingMasterTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)

    class _Iter:
        def __init__(self, batches):
            self._batches, self._i = batches, 0

        def reset(self):
            self._i = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self._i >= len(self._batches):
                raise StopIteration
            self._i += 1
            return self._batches[self._i - 1]

    data = _batches(n_batches=4)
    xs = np.concatenate([b[0] for b in data])
    ys = np.concatenate([b[1] for b in data])
    net = _net(zip_path)
    master = _master(mode="averaging", averaging_frequency=2,
                     workdir=str(tmp_path))
    conf = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(_Iter([(xs, ys)])),
        epoch_terminations=[MaxEpochsTerminationCondition(1)],
        model_saver=InMemoryModelSaver())
    result = EarlyStoppingMasterTrainer(conf, net, master,
                                        _Iter(data)).fit()
    assert result.termination_reason == "EpochTerminationCondition"
    assert result.total_epochs == 1
    assert result.best_model is not None
    assert np.isfinite(result.best_model_score)
    assert len(os.listdir(tmp_path)) == 1     # one job directory an epoch


def test_a_worker_without_its_device_fails_the_job(zip_path, tmp_path):
    """The default device is CUDA; on a machine without a card the
    workers cannot reach it, and the job fails with their log tail: it
    never trains on the CPU instead."""
    assert not torch.cuda.is_available()
    m = MultiprocessMaster(num_workers=2, max_task_retries=0, timeout=60.0)
    m._DEAD_GRACE = DEAD_GRACE_S
    assert m.device == "cuda"
    with pytest.raises(RuntimeError, match="failed after 0 retries: "
                                           r"(.|\n)*device='cpu'"):
        m.score(_net(zip_path), iter(_batches(n_batches=2)),
                jobdir=str(tmp_path))


def test_the_worker_entry_imports_no_jax(scored):
    """``python -m deeplearning4j_tpu_torch.parallel.master_mp`` as the
    master spawns it: its import log names no JAX module."""
    assert master_mp.MultiprocessMaster._WORKER_MODULE == \
        "deeplearning4j_tpu_torch.parallel.master_mp"
    for w in range(2):
        log = (scored[1] / f"worker_{w}.log").read_text()
        mods = {line.rsplit("|", 1)[-1].strip()
                for line in log.splitlines() if line.startswith("import time")}
        assert {"torch", "deeplearning4j_tpu_torch.streaming.broker"} <= mods
        bad = {n for n in mods if n.split(".")[0] in
               ("jax", "jaxlib", "deeplearning4j_tpu")}
        assert not bad, sorted(bad)[:5]


def test_kernel_sources_of_the_model_layers():
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    lm = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                       n_heads=1).init(device="cpu")
    assert master_mp.kernel_sources(lm) == sorted([fa.SOURCE,
                                                   fa.BWD_SOURCE])
    ref = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                        n_heads=1, attn_impl="reference").init(device="cpu")
    assert master_mp.kernel_sources(ref) == []
