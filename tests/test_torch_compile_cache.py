"""The port's compile layer (``nn/compile_cache.py``) and the in-place
updaters a captured step needs, on the CPU, against the JAX package's.

* ``topology_signature`` is stable under ``deepcopy``, changes under the
  edits ``tests/test_compile_cache.py`` makes, and agrees with the JAX
  signature on which configurations are equal;
* compile counts: a ``clone`` adds no compile (it shares the built
  step), a ragged last batch adds one, as the JAX package counts;
* ``wire_persistent_cache`` changes nothing without
  ``DL4J_TPU_COMPILE_CACHE`` and points the kernels' build cache at it
  with it, also when the package is imported;
* every updater writes its slots in place: params, slots, the key buffer
  and the updater's scalar vector keep their ``data_ptr`` over 3 steps,
  the step body makes no host read, and the state equals optax's
  (read through ``updater_state_from_jax``);
* a schedule's learning rate through the device-scalar path equals
  optax's.
"""
import copy
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from deeplearning4j_tpu.nn.compile_cache import \
    topology_signature as jax_signature
from deeplearning4j_tpu.nn.conf import schedules as jsched
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOutput
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn import _common as tcommon
from deeplearning4j_tpu_torch.nn import compile_cache as cc
from deeplearning4j_tpu_torch.nn.conf import schedules as tsched
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.registry import default_registry
from deeplearning4j_tpu_torch.utils import kernel_build
from deeplearning4j_tpu_torch.utils.model_serializer import \
    updater_state_from_jax

REPO = Path(__file__).resolve().parents[1]
# the updater arithmetic against optax, f32 (as
# tests/test_torch_schedules_updaters.py holds it)
RTOL_UPD, ATOL_UPD = 1e-6, 1e-8
UPDATERS = ["Sgd", "Nesterovs", "Adam", "AdaMax", "Nadam", "AmsGrad",
            "AdaDelta", "AdaGrad", "RmsProp", "NoOp", "AdamW", "Lion"]
SCHEDULES = [("StepSchedule", dict(initial_value=1e-2, decay_rate=0.5,
                                   step=2)),
             ("ExponentialSchedule", dict(initial_value=1e-2, gamma=0.8)),
             ("PolySchedule", dict(initial_value=1e-2, power=2.0,
                                   max_iter=4)),
             ("CycleSchedule", dict(initial_value=1e-3, max_value=1e-2,
                                    cycle_length=4)),
             ("WarmupSchedule", dict(warmup_iters=3, target=1e-2))]


def _jax_conf(hidden=16, lr=0.02, dropout=None, updater=None, seed=42):
    u = updater if updater is not None else jupd.Adam(learning_rate=lr)
    return (JNNC.builder().seed(seed).updater(u).list()
            .layer(JDense(n_out=hidden, activation="tanh", dropout=dropout))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())


def _port(jconf):
    return MultiLayerConfiguration.from_json(jconf.to_json())


def _net(**kw):
    return MultiLayerNetwork(_port(_jax_conf(**kw)), device="cpu").init()


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _compiles():
    c = default_registry().get("training_compile_total")
    return 0.0 if c is None else c.labels("train_step").value


# ------------------------------------------------------------- signature
def _edited(conf, edit):
    conf = copy.deepcopy(conf)
    if edit == "gradient_normalization":
        conf.defaults["gradient_normalization"] = "clipl2perlayer"
    return conf


PAIRS = [  # (a's builder kwargs, b's builder kwargs, edit of b)
    (dict(hidden=22), dict(hidden=22), None),
    (dict(hidden=22), dict(hidden=22), "gradient_normalization"),
    (dict(hidden=22), dict(hidden=22, lr=0.5), None),
    (dict(hidden=22), dict(hidden=23), None),
    (dict(hidden=22), dict(hidden=22, dropout=0.5), None),
    (dict(hidden=22), dict(hidden=22, seed=7), None),
]


@pytest.mark.parametrize("a, b, edit", PAIRS)
def test_signature_agrees_with_jax_on_equal_pairs(a, b, edit):
    ja, jb = _jax_conf(**a), _edited(_jax_conf(**b), edit)
    ta, tb = _port(_jax_conf(**a)), _edited(_port(_jax_conf(**b)), edit)
    assert cc.topology_signature(ta) == \
        cc.topology_signature(copy.deepcopy(ta))
    assert (cc.topology_signature(ta) == cc.topology_signature(tb)) == \
        (jax_signature(ja) == jax_signature(jb))


# -------------------------------------------------------- compile counts
def test_clone_adds_no_compile_and_a_ragged_batch_one():
    net = _net(hidden=24)
    x, y = _batch(32)
    net.fit(x, y)
    base = _compiles()
    for r in [net.clone() for _ in range(3)]:
        assert r._train_step() is net._train_step()
        r.fit_batch((x, y))
    assert _compiles() == base
    fresh = _net(hidden=26, seed=7)
    before = _compiles()
    xs, ys = _batch(48, seed=1)
    fresh.fit(iter([(xs, ys), (xs, ys), (xs[:17], ys[:17])]))
    # the full batch, then the ragged tail: the JAX package's "at most 2"
    assert _compiles() - before == 2.0
    assert fresh.last_route.startswith("eager: not on a CUDA device")
    assert cc.trace_cache_size() >= 1 and all(
        k[2] == "train_step" for k, _ in cc.iter_trace_cache())


# ------------------------------------------------------ persistent cache
def test_persistent_cache_wiring(tmp_path, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
    before = kernel_build.BUILD_DIR
    assert cc.wire_persistent_cache() == {"enabled": False}
    assert kernel_build.BUILD_DIR == before
    for name in ("flash_attn_fwd-0.so", "bn_apply-1.so", "bn_apply-1.log"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setenv("DL4J_TPU_COMPILE_CACHE", str(tmp_path))
    try:
        status = cc.wire_persistent_cache()
        assert status["enabled"] and status["existing_entries"] == 2
        assert cc.persistent_cache_status() == status
        assert kernel_build.library_path("bn_apply.cu").parent == \
            tmp_path.resolve()
    finally:
        cc.wire_persistent_cache("")
    assert cc.persistent_cache_status() == {"enabled": False}
    # importing the package wires it, and loads no torch for that
    code = ("import sys, deeplearning4j_tpu_torch as d\n"
            "print(d.persistent_cache_status()['existing_entries'],"
            " 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.stdout.split() == ["2", "False"], out.stderr


# ------------------------------------------------------ in-place updaters
class HostReads(TorchFunctionMode):
    """Records every call that would read the device on the host (or copy
    from host memory) if the tensors were on a card: what a captured CUDA
    graph cannot hold."""

    READS = {"item", "tolist", "__bool__", "__float__", "__int__",
             "__index__", "nonzero", "cpu", "numpy", "tensor"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS or (name == "as_tensor" and not isinstance(
                args[0], torch.Tensor)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _captured_body_steps(net, x, y, n):
    """``n`` steps the way the captured route runs them (staged scalars,
    the step body, advanced counts) with the body under ``HostReads``."""
    step = net._train_step()
    reads = HostReads()
    for _ in range(n):
        net._tx.stage(net.opt_state, net.device)
        with reads:
            step.fn(net._param_tree(), net.state, net.opt_state, x, y, None,
                    None, None, None, net._rng, staged=True)
        net._tx.advance(net.opt_state)
    return reads.seen


def _ptrs(net):
    return ([p.data_ptr() for g in net.params.values() for p in g.values()]
            + [t.data_ptr() for g in net.opt_state["slots"].values()
               for sl in g.values() for t in sl.values()]
            + [net._rng.data_ptr(), net.opt_state["scalars"].data_ptr()])


@pytest.mark.parametrize("name", UPDATERS)
def test_updaters_write_in_place_and_match_optax(name):
    ju = getattr(jupd, name)(learning_rate=1e-2) if name != "NoOp" \
        else jupd.NoOp()
    tu = getattr(tupd, name)(learning_rate=1e-2) if name != "NoOp" \
        else tupd.NoOp()
    net = MultiLayerNetwork(_port(_jax_conf(hidden=3, updater=ju)),
                            device="cpu").init()
    x, y = (torch.from_numpy(a) for a in _batch(5, seed=3))
    # the network's own step: nothing it reads moves, and no host read
    net._tx.stage(net.opt_state, net.device)
    before = _ptrs(net)
    assert _captured_body_steps(net, x, y, 3) == []
    assert _ptrs(net) == before
    net.fit(x, y)
    assert _ptrs(net) == before
    # the update arithmetic: fixed gradients through the groups, as optax
    tp = {k: {n: p.detach().clone() for n, p in g.items()}
          for k, g in net.params.items()}
    groups = tcommon.build_tx(tu, {k: None for k in tp}, tp)
    tstate = groups.init(tp)
    tx = ju.to_optax()
    jp = {k: {n: jnp.asarray(p.numpy()) for n, p in g.items()}
          for k, g in tp.items()}
    jstate = tx.init(jp)
    rng = np.random.default_rng(UPDATERS.index(name))
    groups.stage(tstate, "cpu")
    ptrs = [t.data_ptr() for g in tstate["slots"].values()
            for sl in g.values() for t in sl.values()] + \
        [p.data_ptr() for g in tp.values() for p in g.values()] + \
        [tstate["scalars"].data_ptr()]
    for _ in range(3):
        g = {k: {n: (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
                 for n, p in grp.items()} for k, grp in tp.items()}
        upd, jstate = tx.update({k: {n: jnp.asarray(a) for n, a in v.items()}
                                 for k, v in g.items()}, jstate, jp)
        jp = {k: {n: jp[k][n] + upd[k][n] for n in jp[k]} for k in jp}
        groups.step(tp, {k: {n: torch.from_numpy(a) for n, a in v.items()}
                         for k, v in g.items()}, tstate)
    assert ptrs == [t.data_ptr() for g in tstate["slots"].values()
                    for sl in g.values() for t in sl.values()] + \
        [p.data_ptr() for g in tp.values() for p in g.values()] + \
        [tstate["scalars"].data_ptr()]
    for k in tp:
        for n in tp[k]:
            np.testing.assert_allclose(tp[k][n].numpy(),
                                       np.asarray(jp[k][n]),
                                       rtol=RTOL_UPD, atol=ATOL_UPD)
    twin = MultiLayerNetwork(_port(_jax_conf(hidden=3, updater=ju)),
                             device="cpu").init()
    # one updater group, as the optax transform above
    twin._tx = tcommon.build_tx(tu, {k: None for k in tp},
                                twin._param_tree())
    twin.opt_state = twin._tx.init(twin._param_tree())
    updater_state_from_jax(twin, jstate)
    # the host count stays the one the checkpoints read
    assert tstate["count"] == {"default": 3}
    for k, g in twin.opt_state["slots"].items():
        for n, sl in g.items():
            for s, t in sl.items():
                np.testing.assert_allclose(
                    tstate["slots"][k][n][s].numpy(), t.numpy(),
                    rtol=RTOL_UPD, atol=ATOL_UPD)


def test_lm_step_body_has_no_host_read():
    """The TransformerLM step with block dropout, as the captured route
    runs it: no host read anywhere on its path (on the CPU it takes the
    flash kernels' plain twins)."""
    net = TransformerLM(vocab_size=32, seq_len=128, embed=64, n_layers=1,
                        n_heads=1, sparse_labels=True,
                        updater=tupd.Adam(learning_rate=1e-3)
                        ).init(device="cpu")
    for lc in net.conf.layers[2:-1]:
        lc.dropout = 0.9
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 32, (2, 128)))
    y = torch.from_numpy(rng.integers(0, 32, (2, 128)))
    net._tx.stage(net.opt_state, net.device)
    before = _ptrs(net)
    assert _captured_body_steps(net, x, y, 2) == []
    assert _ptrs(net) == before


@pytest.mark.parametrize("sched, kw", SCHEDULES)
def test_schedule_through_the_device_scalars_matches_optax(sched, kw):
    ju = jupd.Sgd(learning_rate=getattr(jsched, sched)(**kw))
    tu = tupd.Sgd(learning_rate=getattr(tsched, sched)(**kw))
    p0 = np.linspace(-1.0, 1.0, 6, dtype=np.float32)
    tp = {"layer_0": {"W": torch.tensor(p0)}}
    groups = tcommon.build_tx(tu, {"layer_0": None}, tp)
    tstate = groups.init(tp)
    tx = ju.to_optax()
    jp = {"layer_0": {"W": jnp.asarray(p0)}}
    jstate = tx.init(jp)
    g = np.ones(6, np.float32)
    for _ in range(6):
        upd, jstate = tx.update({"layer_0": {"W": jnp.asarray(g)}}, jstate,
                                jp)
        jp = {"layer_0": {"W": jp["layer_0"]["W"] + upd["layer_0"]["W"]}}
        groups.step(tp, {"layer_0": {"W": torch.from_numpy(g)}}, tstate)
        np.testing.assert_allclose(tp["layer_0"]["W"].numpy(),
                                   np.asarray(jp["layer_0"]["W"]),
                                   rtol=RTOL_UPD, atol=ATOL_UPD)
    assert tstate["scalars"].dtype == torch.float64
