"""The port's learning-rate schedules and updaters against the JAX
package: every schedule's value at the iterations around its breaks,
each of the 12 updaters for 5 steps against optax with a float learning
rate and with a schedule, and a mid-run resume from the JAX package's
optax state (``updater_state_from_jax``).

The conftest turns ``jax_enable_x64`` on: optax then computes schedule
values and bias corrections in float64, as the port does on the host,
and both round them to float32 where they scale a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import schedules as jsched
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn import _common as tcommon
from deeplearning4j_tpu_torch.nn.conf import schedules as tsched
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (
    params_from_jax, updater_state_from_jax)

# the port's value is the float64 formula.  The JAX package's, even under
# x64, divides its int32 count in float32 (jnp's true_divide of an int32
# array is float32: Poly, Cycle, Warmup), so one float32 rounding of
# iter/max_iter apart: 2e-7 relative, or 2e-7 of the initial value 0.01
# where Poly's (1 - frac)^2 cancels near max_iter
RTOL_SCHED, ATOL_SCHED = 2e-7, 2e-9
# 5 steps of the same float32 arithmetic in the same order; XLA's rsqrt
# (AdaGrad, RmsProp) may differ from torch's by an ulp
RTOL_UPD, ATOL_UPD = 1e-6, 1e-8

SCHEDULES = {
    "FixedSchedule": dict(value_=0.01),
    "StepSchedule": dict(initial_value=0.01, decay_rate=0.5, step=1000.0),
    "ExponentialSchedule": dict(initial_value=0.01, gamma=0.999),
    "InverseSchedule": dict(initial_value=0.01, gamma=0.01, power=2.0),
    "PolySchedule": dict(initial_value=0.01, power=2.0, max_iter=1000),
    "SigmoidSchedule": dict(initial_value=0.01, gamma=0.01, step_size=1000),
    "MapSchedule": dict(values={0: 0.01, 7: 0.005, 1000: 0.001}),
    "CycleSchedule": dict(initial_value=1e-4, max_value=1e-2,
                          cycle_length=1000),
    "WarmupSchedule": dict(warmup_iters=1000, target=0.01),
}
ITERS = (0, 1, 7, 999, 1000, 1001)

UPDATERS = ("Sgd", "Nesterovs", "Adam", "AdaMax", "Nadam", "AmsGrad",
            "AdaDelta", "AdaGrad", "RmsProp", "NoOp", "AdamW", "Lion")
# short schedules so 5 steps cross their breaks
SHORT = [("StepSchedule", dict(initial_value=1e-2, decay_rate=0.5, step=2)),
         ("ExponentialSchedule", dict(initial_value=1e-2, gamma=0.8)),
         ("InverseSchedule", dict(initial_value=1e-2, gamma=0.5, power=2.0)),
         ("PolySchedule", dict(initial_value=1e-2, power=2.0, max_iter=4)),
         ("SigmoidSchedule", dict(initial_value=1e-2, gamma=0.5,
                                  step_size=2)),
         ("MapSchedule", dict(values={0: 1e-2, 2: 5e-3})),
         ("CycleSchedule", dict(initial_value=1e-3, max_value=1e-2,
                                cycle_length=4)),
         ("WarmupSchedule", dict(warmup_iters=3, target=1e-2)),
         ("FixedSchedule", dict(value_=1e-2))]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_match_reference(name):
    kw = SCHEDULES[name]
    j, t = getattr(jsched, name)(**kw), getattr(tsched, name)(**kw)
    for it in ITERS:
        want = float(np.asarray(j.value(jnp.asarray(it, jnp.int32))))
        got = t.value(it)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=RTOL_SCHED, atol=ATOL_SCHED,
                                   err_msg=f"{name} at {it}")


def _pair(name, sched, **kw):
    """The same updater in both packages: lr 1e-2, or short schedule i."""
    if sched is None:
        jl = tl = 1e-2
    else:
        sn, skw = SHORT[sched % len(SHORT)]
        jl, tl = getattr(jsched, sn)(**skw), getattr(tsched, sn)(**skw)
    return (getattr(jupd, name)(learning_rate=jl, **kw),
            getattr(tupd, name)(learning_rate=tl, **kw))


@pytest.mark.parametrize("lr", ["float", "schedule"])
@pytest.mark.parametrize("name", UPDATERS)
def test_every_updater_matches_optax(name, lr):
    ju, tu = _pair(name, None if lr == "float" else UPDATERS.index(name))
    shapes = {"W": (4, 3), "b": (3,)}
    rng = np.random.default_rng(UPDATERS.index(name))
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    tx = ju.to_optax()
    jp = {"layer_0": {k: jnp.asarray(v) for k, v in p0.items()}}
    jstate = tx.init(jp)
    tp = {"layer_0": {k: torch.tensor(v) for k, v in p0.items()}}
    groups = tcommon.build_tx(tu, {"layer_0": None}, tp)
    tstate = groups.init(tp)
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        upd, jstate = tx.update(
            {"layer_0": {k: jnp.asarray(v) for k, v in g.items()}}, jstate,
            jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        groups.step(tp, {"layer_0": {k: torch.tensor(v)
                                     for k, v in g.items()}}, tstate)
        for k in shapes:
            np.testing.assert_allclose(tp["layer_0"][k].numpy(),
                                       np.asarray(jp["layer_0"][k]),
                                       rtol=RTOL_UPD, atol=ATOL_UPD)
    assert tstate["count"] == {"default": 5}


def test_updater_by_name_and_traps():
    assert isinstance(tupd.by_name("AMSGRAD", 0.1), tupd.AmsGrad)
    assert tupd.by_name("none").learning_rate is None
    with pytest.raises(ValueError, match="unknown updater"):
        tupd.by_name("bogus")
    assert sorted(tupd._BY_NAME) == sorted(
        ["sgd", "adam", "adamax", "adadelta", "nesterovs", "nadam",
         "adagrad", "rmsprop", "none", "amsgrad", "adamw", "lion"])
    # AdaGrad's accumulator starts at 0.1; AdaDelta's lr defaults to 1
    assert torch.equal(tupd.AdaGrad().init_slots(torch.zeros(2))
                       ["sum_of_squares"], torch.full((2,), 0.1))
    assert tupd.AdaDelta()._lr(0) == 1.0
    # Lion: sign(0) is 0, so a zero gradient on a zero moment moves nothing
    u = tupd.Lion(learning_rate=1.0).update(
        torch.zeros(3), {"mu": torch.zeros(3)}, 0, torch.ones(3))
    assert torch.equal(u, torch.zeros(3))


def _nets(ju, tu):
    """A 3 -> 4 -> 2 MLN in both packages, the port holding the JAX
    package's params."""
    def build(nnc, it, ff, u):
        return (nnc.builder().seed(11).updater(u).activation("tanh")
                .list().layer(ff.DenseLayer(n_out=4))
                .layer(ff.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(it.feed_forward(3)).build())
    jn = JMLN(build(JNNC, JIT, jff, ju)).init()
    tn = MultiLayerNetwork(build(NeuralNetConfiguration, InputType, tff, tu),
                           device="cpu")
    return jn, tn


@pytest.mark.parametrize("name", UPDATERS)
def test_mid_run_resume_from_jax_state(name):
    """Two JAX steps, then the port takes the params and the optax state
    (with a schedule, so the count matters) and both take three more."""
    ju, tu = _pair(name, UPDATERS.index(name))
    jn, tn = _nets(ju, tu)
    rng = np.random.default_rng(40 + UPDATERS.index(name))
    x = rng.standard_normal((8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    for _ in range(2):
        jn.fit(x, y)
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    # the count comes from the chain's first counted state; RmsProp (here
    # at a FixedSchedule, a plain scale) and NoOp keep none
    assert tn.opt_state["count"]["default"] == \
        (0 if name in ("RmsProp", "NoOp") else 2)
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=1e-5)
    for k, g in jn.params.items():
        for n, a in g.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), rtol=1e-5, atol=1e-6)
