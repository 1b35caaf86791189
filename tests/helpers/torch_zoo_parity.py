"""Shared by ``tests/test_torch_zoo_*.py``: one zoo model built by the
JAX package at a miniature size, written with ``write_model``, read by
the port's loader and held against the JAX network: the port's own zoo
configuration, ``output``, step-0 loss and gradients with dropout on the
first fit step's key, and three ``fit`` steps.

Everything runs with x64 off, the JAX package's production setting: the
port reproduces that stream's dropout masks (under the test conftest's
x64, ``jax.random.bernoulli`` draws float64 uniforms and other masks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.computation_graph import _graph_loss as jgraph
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.multilayer import _stack_loss as jstack
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.computation_graph import _graph_loss
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss_state
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

BATCH = 4
# output (softmax probabilities <= 1, f32): the conv and matmul sums of
# up to 22 layers in another order (XLA against oneDNN); measured
# <= 6e-7: 1e-5 abs.
ATOL_OUT = 1e-5
# step-0 loss (f32, a mean over 4 rows of -log p): 1e-5 relative
# (measured <= 1e-6).
RTOL_LOSS0 = 1e-5
# step-0 gradients, per parameter: 1e-4 of its largest |g| plus 1e-6 of
# the net's largest |g| (measured <= 3e-6 of the leaf's largest); the
# dropout masks are bit-equal, so any mask difference shows as O(1).
RTOL_GRAD, ATOL_GRAD_NET = 1e-4, 1e-6
# three Nesterovs fit steps: each loss within 1e-5 relative; params
# within 1e-5 abs plus 1e-5 relative (AlexNet's lr 1e-2 steps grow its
# weights; measured <= 2e-6).
RTOL_FIT_LOSS, ATOL_PARAMS, RTOL_PARAMS = 1e-5, 1e-5, 1e-5
# three Adam fit steps, compared by losses only: Adam moves every entry
# by about lr whatever |g| is, so entries whose gradient is f32 noise
# (relu units dead on one side's rounding, or a sum that cancels) step
# with either sign on the two sides; and with x64 off optax rounds the
# bias correction's betas to f32 (ROADMAP queue 3, "Not faults"), which
# the port does not.  GoogLeNet at 32x32, whose loss moves by 10 % a
# step, measured 1e-3 relative at step 3: 5e-3.
RTOL_ADAM_LOSS = 5e-3


def _spec(net):
    return {k: {n: tuple(s) for n, (s, _) in g.items()}
            for k, g in net.param_spec().items()}


def _as_port_updater(u):
    """The port's counterpart of a JAX updater conf."""
    if u is None:
        return None
    kw = {k: v for k, v in vars(u).items()}
    return getattr(tupd, type(u).__name__)(**kw)


def check_zoo_model(name, kw, tmp_path, updater=None):
    """Build ``name`` with ``kw`` on both sides (``updater``: a JAX
    updater conf overriding the zoo default) and hold the port against
    the JAX package.  Returns the two networks."""
    with jax.enable_x64(False):
        return _check(name, kw, tmp_path, updater)


def _check(name, kw, tmp_path, updater):
    jkw = dict(kw, updater=updater) if updater is not None else dict(kw)
    jn = getattr(jzoo, name)(**jkw).init()
    path = tmp_path / f"{name}.zip"
    write_model(jn, str(path))
    tn = load_reference_model(path, device="cpu")
    graph = hasattr(jn.conf, "vertices")

    # the port's own zoo model builds the same network
    tkw = dict(kw, updater=_as_port_updater(updater))
    own = getattr(tzoo, name)(**tkw).init(device="cpu")
    assert _spec(own) == _spec(tn)
    if graph:
        assert own.conf.topological_order == tn.conf.topological_order
    else:
        assert {k: type(v).__name__ for k, v in
                own.conf.input_preprocessors.items()} == \
            {k: type(v).__name__ for k, v in
             tn.conf.input_preprocessors.items()}
    assert type(own._default_updater()) is type(tn._default_updater())

    h, w, c = kw["input_shape"]
    classes = kw["num_classes"]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((BATCH, h, w, c)).astype(np.float32)
    if name == "LeNet":
        x = x.reshape(BATCH, -1)        # LeNet takes flat images
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, BATCH)]

    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               atol=ATOL_OUT, rtol=0)

    # step 0: the loss and gradients of the first fit step, on its key
    jkey = jax.random.split(jn._rng)[1]
    tkey = _random.split(tn._rng)[1]
    np.testing.assert_array_equal(tkey.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if graph:
        jv, jg = jax.value_and_grad(lambda p: jgraph(
            jn.conf, p, jn.state, [jx], [jy], train=True, key=jkey)[0])(
            jn.params)
    else:
        jv, jg = jax.value_and_grad(lambda p: jstack(
            jn.conf, p, jn.state, jx, jy, train=True, key=jkey)[0])(
            jn.params)
    params = tn._param_tree()
    tx, ty = torch.tensor(x), torch.tensor(y)
    if graph:
        tv, _ = _graph_loss(tn.conf, params, tn.state, [tx], [ty],
                            train=True, key=tkey)
    else:
        tv, _ = _stack_loss_state(tn.conf, params, tn.state, tx, ty,
                                  train=True, key=tkey)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL_LOSS0)
    keys = [(k, n) for k in params for n in params[k]]
    tg = torch.autograd.grad(tv, [params[k][n] for k, n in keys],
                             allow_unused=True)
    net_max = max(float(jnp.abs(g).max())
                  for g in jax.tree_util.tree_leaves(jg))
    for (k, n), g in zip(keys, tg):
        want = np.asarray(jg[k][n])
        got = np.zeros_like(want) if g is None else g.numpy()
        tol = RTOL_GRAD * np.abs(want).max() + ATOL_GRAD_NET * net_max
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=f"{name} step-0 grad {k}/{n}")

    # three fit steps with dropout on
    adam = isinstance(jn._default_updater(), jupd.Adam)
    for step in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(
            tn.get_score(), float(jn.get_score()),
            rtol=RTOL_ADAM_LOSS if adam else RTOL_FIT_LOSS,
            err_msg=f"{name} fit step {step}")
    np.testing.assert_array_equal(tn._rng.numpy(),
                                  np.asarray(jn._rng).astype(np.int64))
    if not adam:
        for k, group in jn.params.items():
            for n, a in group.items():
                np.testing.assert_allclose(
                    tn.params[k][n].detach().numpy(), np.asarray(a),
                    atol=ATOL_PARAMS, rtol=RTOL_PARAMS,
                    err_msg=f"{name} params {k}/{n}")
    return jn, tn
