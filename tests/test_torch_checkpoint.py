"""The port's model container and checkpoints against the JAX package's.

- Containers: a container the JAX package wrote restores in the port with
  its updater state, and one the port wrote restores in the JAX package,
  for each of the 12 updaters (with a schedule, so the step count is in
  the state) and for a network with a frozen layer and per-layer ``w`` /
  ``b`` updater groups; the next step agrees on both sides.  A corrupt or
  truncated container raises ``CorruptModelError`` on both sides.
- Resume: the JAX package resumes from a checkpoint directory the port
  wrote, and the port from one the JAX package wrote, both mid-epoch with
  dropout, each reproducing the uninterrupted JAX run.  The port's own
  interrupt-and-resume, and its run with checkpoints against one without,
  are bitwise equal; a loss-scale state resumes too.

Tolerance: "trained nets 2e-5" (``PERF.md`` §6): a few Sgd-family steps of
the same float32 arithmetic in another summation order.  The JAX side of
the dropout runs has x64 off, its production setting, so its masks are
the port's bits (``tests/test_torch_random.py``).
"""
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.faulttolerance.checkpoint import \
    CheckpointConfig as JCheckpointConfig
from deeplearning4j_tpu.nn.conf import schedules as jsched
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import misc as jmisc
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.faulttolerance import (CheckpointConfig,
                                                     CheckpointManager)
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.precision import named_policy
from deeplearning4j_tpu_torch.utils import model_serializer as tms

TOL = 2e-5

UPDATERS = ("Sgd", "Nesterovs", "Adam", "AdaMax", "Nadam", "AmsGrad",
            "AdaDelta", "AdaGrad", "RmsProp", "NoOp", "AdamW", "Lion")


def _batches(n, batch=8, n_in=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, n_in)).astype(np.float32),
             np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                            batch)])
            for _ in range(n)]


def _port_twin(jn):
    """The port's network from the JAX network's configuration JSON and
    params, on the CPU."""
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    return tms.params_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                          jn.params))


def _assert_params_close(tn, jn, tol=TOL):
    for k, g in jn.params.items():
        for n, a in tms.flatten_group(dict(g)).items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), rtol=tol, atol=tol,
                                       err_msg=f"{k}/{n}")


def _leaves(jn):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(jn.opt_state)]


def _updater_net(name):
    """A 4 -> 8 -> 3 MLN whose updater runs on an exponential schedule
    (every updater but NoOp then counts its steps in the state)."""
    u = getattr(jupd, name)(learning_rate=jsched.ExponentialSchedule(
        initial_value=1e-2, gamma=0.9))
    conf = (JNNC.builder().seed(7).updater(u).activation("tanh").list()
            .layer(jff.DenseLayer(n_out=8))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _multi_group_net():
    """A frozen layer, a layer with its own updater, one with a bias
    updater: ``multi_transform`` over default / frozen / layer_1/w /
    layer_2/w / layer_2/b."""
    conf = (JNNC.builder().seed(5).updater(jupd.Nesterovs(learning_rate=0.05))
            .activation("tanh").list()
            .layer(jmisc.FrozenLayer(underlying=jff.DenseLayer(n_out=6)))
            .layer(jff.DenseLayer(n_out=6,
                                  updater=jupd.Adam(learning_rate=1e-2)))
            .layer(jff.DenseLayer(n_out=5,
                                  bias_updater=jupd.Sgd(learning_rate=0.1)))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _cross_load(jn, tmp_path):
    """JAX -> port -> JAX through containers, one step on each side after
    each crossing."""
    batches = _batches(4, seed=3)
    for x, y in batches[:2]:
        jn.fit(x, y)
    jzip = str(tmp_path / "jax.zip")
    jms.write_model(jn, jzip)
    tn = tms.restore_model(jzip, device="cpu")
    assert tn.iteration == jn.iteration == 2
    # the port re-writes the JAX state leaf for leaf
    tzip = str(tmp_path / "port.zip")
    tms.write_model(tn, tzip)
    back = jms.restore_model(tzip)
    assert len(_leaves(back)) == len(_leaves(jn))
    for a, b in zip(_leaves(back), _leaves(jn)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # next step on both sides from the JAX-written container
    x, y = batches[2]
    jn.fit(x, y)
    tn.fit(x, y)
    _assert_params_close(tn, jn)
    # and from the port-written one: the JAX package continues the port
    tms.write_model(tn, tzip)
    j2 = jms.restore_model(tzip)
    x, y = batches[3]
    j2.fit(x, y)
    tn.fit(x, y)
    _assert_params_close(tn, j2)
    return tn


@pytest.mark.parametrize("name", UPDATERS)
def test_containers_cross_load_with_each_updater(name, tmp_path):
    tn = _cross_load(_updater_net(name), tmp_path)
    # two JAX steps restored, two port steps on top; NoOp's optax state
    # holds no count, so the port's restarts at 0
    assert tn.opt_state["count"]["default"] == (2 if name == "NoOp" else 4)


def test_containers_cross_load_with_frozen_and_w_b_groups(tmp_path):
    jn = _multi_group_net()
    tn = _cross_load(jn, tmp_path)
    assert {"default", "frozen", "layer_1/w", "layer_2/b",
            "layer_2/w"} <= set(tn._tx.transforms)
    layout = tms.updater_layout(tn._tx, tn._param_tree())
    # multi_transform's inner states in sorted label order
    labels = [d[1] for d in layout]
    assert labels == sorted(labels)
    assert ("slot", "layer_1/w", "layer_1", "W", "mu") in layout
    assert not any(d[1] == "frozen" for d in layout)


def test_corrupt_or_truncated_containers_raise_on_both_sides(tmp_path):
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _updater_net("Adam").conf.to_json()), device="cpu").init()
    good = str(tmp_path / "good.zip")
    tms.write_model(tn, good)
    blob = open(good, "rb").read()
    trunc = tmp_path / "trunc.zip"
    trunc.write_bytes(blob[:len(blob) // 2])
    flipped = bytearray(blob)
    at = blob.index(b"params.npz") + 200   # inside the params member
    flipped[at] ^= 0xFF
    flip = tmp_path / "flip.zip"
    flip.write_bytes(bytes(flipped))
    for path in (str(trunc), str(flip)):
        with pytest.raises(tms.CorruptModelError):
            tms.restore_model(path, device="cpu")
        with pytest.raises(jms.CorruptModelError):
            jms.restore_model(path)
    with pytest.raises(tms.CorruptModelError, match="model.zip"):
        tms.restore_model(str(tmp_path), device="cpu")


# ------------------------------------------------------------ resume
STEPS, CUT = 6, 3


def _dropout_net():
    conf = (JNNC.builder().seed(42).updater(jupd.Nesterovs(learning_rate=0.05))
            .list()
            .layer(jff.DenseLayer(n_out=16, activation="relu", dropout=0.8))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def test_resume_across_the_packages_mid_epoch_with_dropout(tmp_path):
    batches = _batches(STEPS, seed=11)
    with jax.enable_x64(False):
        ref = _dropout_net()
        init = jax.tree_util.tree_map(np.asarray, ref.params)
        ref.fit(batches)                                  # uninterrupted
        # JAX writes, the port resumes
        jcut = _dropout_net()
        jcut.fit(batches, checkpoint=JCheckpointConfig(
            directory=str(tmp_path / "jax"), save_every_n_iterations=CUT,
            background=False))
        tn = _port_twin(_dropout_net())
        tn.fit(batches, resume_from=str(tmp_path / "jax" / "ckpt-00000003"))
        assert tn.iteration == STEPS
        _assert_params_close(tn, ref)
        # the port writes, the JAX package resumes
        tcut = _port_twin(_dropout_net())
        tms.params_from_jax(tcut, init)
        tcut.fit(batches, checkpoint=CheckpointConfig(
            directory=str(tmp_path / "port"), save_every_n_iterations=CUT,
            background=True))
        resumed = _dropout_net()
        resumed.fit(batches,
                    resume_from=str(tmp_path / "port" / "ckpt-00000003"))
        assert resumed.iteration == STEPS
        _assert_params_close(tcut, resumed)
        for k, g in ref.params.items():
            for n, a in g.items():
                np.testing.assert_allclose(np.asarray(resumed.params[k][n]),
                                           np.asarray(a), rtol=TOL, atol=TOL)
    with open(tmp_path / "port" / "ckpt-00000003" / "training_state.json") \
            as f:
        assert '"shape_policy": null' in f.read()


def _lm(**defaults):
    conf = TransformerLM(vocab_size=16, seq_len=8, embed=16, n_layers=2,
                         n_heads=2, sparse_labels=True, seed=3).conf()
    for lc in conf.layers:
        if type(lc).__name__ == "TransformerBlock":
            lc.dropout = 0.9
    conf.defaults.update(defaults)
    return MultiLayerNetwork(conf, device="cpu").init()


def _same_training_state(a, b, counts=True) -> bool:
    """Params, updater slots (and step counts), key, layer state and
    iteration bitwise equal.  ``counts=False`` for updaters whose optax
    state holds no count (a fixed-rate Nesterovs): a restore leaves the
    count 0, and nothing reads it."""
    return ((not counts or a.opt_state["count"] == b.opt_state["count"])
            and all(torch.equal(a.params[k][n], b.params[k][n])
                for k in a.params for n in a.params[k])
            and all(torch.equal(t, b.opt_state["slots"][k][n][s])
                    for k, g in a.opt_state["slots"].items()
                    for n, sl in g.items() for s, t in sl.items())
            and torch.equal(a._rng, b._rng)
            and all(torch.equal(t, b.state[k][n])
                    for k, g in a.state.items() for n, t in g.items())
            and a.iteration == b.iteration)


@pytest.mark.parametrize("policy", [None, "float16"],
                         ids=["f32_adam", "f16_dynamic_loss_scale"])
def test_port_resume_is_bitwise_and_checkpoints_observe(policy, tmp_path):
    defaults = {} if policy is None else {
        "precision": named_policy(policy)}
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 16, (STEPS, 4, 9))
    batches = [(b[:, :-1], b[:, 1:]) for b in toks]
    plain = _lm(**defaults)
    plain.fit(batches)
    cut = _lm(**defaults)
    cut.fit(batches, checkpoint=CheckpointConfig(
        directory=str(tmp_path), save_every_n_iterations=CUT))
    resumed = _lm(**defaults)
    resumed.fit(batches, resume_from=str(tmp_path / "ckpt-00000003"))
    assert _same_training_state(cut, plain)        # an observer
    assert _same_training_state(resumed, plain)    # exact resume
    if policy is not None:
        ls = resumed.state["__precision__"]
        assert set(ls) == {"scale", "good_steps", "overflow_steps"}
        mgr = CheckpointManager(str(tmp_path), background=False)
        net, state = mgr.restore(path=str(tmp_path / "ckpt-00000003"),
                                 device="cpu")
        assert state["cursor"] == {"fit_epoch": 0, "batch_seq": CUT}
        assert net.state["__precision__"]["good_steps"].dtype == torch.int32


def test_fit_on_device_epoch_checkpoints_resume(tmp_path):
    x, y = (np.concatenate(a) for a in zip(*_batches(4, seed=8)))
    jn = _dropout_net()
    plain = _port_twin(jn)
    plain.fit_on_device(x, y, batch_size=8, epochs=3)
    cut = _port_twin(jn)
    cut.fit_on_device(x, y, batch_size=8, epochs=3,
                      checkpoint=CheckpointConfig(directory=str(tmp_path),
                                                  save_every_n_epochs=1))
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt-00000004", "ckpt-00000008", "ckpt-00000012"]
    resumed = _port_twin(jn)
    resumed.fit_on_device(x, y, batch_size=8, epochs=3,
                          resume_from=str(tmp_path / "ckpt-00000004"))
    # a checkpoint config pins the per-epoch key plumbing (the fused
    # chain has no epoch boundary), as in the JAX package: the resumed
    # run equals the checkpointed one
    assert _same_training_state(resumed, cut, counts=False)
    assert resumed.epoch == cut.epoch == plain.epoch == 3


def test_restore_entry_points_refuse_a_silent_cpu_default(monkeypatch,
                                                          tmp_path):
    """``restore_*`` and ``CheckpointManager.restore`` place the network
    on CUDA unless the caller passes a CPU device; ``resume_network``
    (``fit(resume_from=)``) restores onto the network's own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tn = _port_twin(_dropout_net())
    tn.fit(_batches(1)[0])
    tms.write_model(tn, str(tmp_path / "m.zip"))
    mgr = CheckpointManager(str(tmp_path / "store"), background=False)
    mgr.save(tn)
    for restore in (lambda: tms.restore_model(str(tmp_path / "m.zip")),
                    lambda: tms.restore_multi_layer_network(
                        str(tmp_path / "m.zip")),
                    lambda: mgr.restore()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore()
    net, _ = mgr.restore(device="cpu")
    assert all(p.device.type == "cpu" for p in net.params.parameters())
    fresh = _port_twin(_dropout_net())
    fresh.fit(_batches(2), resume_from=str(tmp_path / "store"))
    # a save without a cursor resumes at the start of the data
    assert fresh.iteration == 3 and fresh._rng.device.type == "cpu"
