"""The zoo ResNet50 built and initialised by the JAX package, written with
``write_model``, read by the port, and run on both sides.

Size: 10 classes at 32x32x3, batch 4 (the full 50-layer bottleneck graph
at the published widths).  Every BatchNormalization sets
``helper="pallas"``, as a user of the JAX package does on the built
configuration.  At this size the kernel rule accepts the 43 BN layers of
the stem and stages 0-2 and refuses the 10 of stage 3 (4 rows per
channel: no multiple-of-8 tile), which take the unfused path on both
sides; the port's fused path on the CPU is the kernel's plain version.

Gradients and training are compared in float64.  With 4 samples per
channel in stage 3, the batch statistics make the net very sensitive:
the same float32 gradients differ from float64 by up to ~20% on both
sides (JAX's and the port's alike), so a float32 comparison could only
hold them to each other loosely.  In float64 the same amplification
leaves ~1e-10.  The three Nesterovs steps start each step from the JAX
package's params of the step before (teacher forcing), so that this
sensitivity cannot compound rounding across steps, while the BN running
statistics and the Nesterovs traces are carried by each side on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn.computation_graph import \
    _build_graph_train_step as jax_train_step
from deeplearning4j_tpu.nn.computation_graph import _graph_loss as jax_loss
from deeplearning4j_tpu.ops import pallas_bn as jax_pallas_bn
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, _build_graph_train_step, _graph_loss)
from deeplearning4j_tpu_torch.nn.layers import normalization
from deeplearning4j_tpu_torch.ops import pallas_bn
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, updater_state_from_jax)

BATCH, SIZE, CLASSES = 4, 32, 10
N_BN, N_FUSED = 53, 43
STEPS = 3
# Eval output (f32): softmax probabilities <= 1 through 53 conv/BN
# layers whose f32 sums run in another order (XLA's conv against
# oneDNN's); BN in eval is a fixed affine map and does not amplify: a few
# ulps at 1, 1e-6 abs.
ATOL_OUT = 1e-6
# f64 loss: measured ~1e-12 relative apart: 1e-10.
RTOL_LOSS = 1e-10
# f64 gradients, per parameter: 1e-8 of its largest |g| (measured
# ~2e-10, the f64 rounding amplified through the 4-sample batch norms)
# plus 1e-12 of the net's largest |g| for the conv biases, whose
# gradient is 0 in exact arithmetic (the next BN subtracts the mean):
# their entries are f64 noise of ~1e-15 on both sides.
RTOL_GRAD, ATOL_GRAD_NET = 1e-8, 1e-12
# f64 after each teacher-forced step: params within 1e-8 of the step's
# largest move on that parameter plus 1e-12 of the largest move in the
# net (the conv biases again: their moves are lr times f64 noise); the
# running statistics and the Nesterovs traces, carried across all three
# steps, within 1e-8 of their largest entry (plus, for the traces,
# 1e-12 of the largest trace in the net, for the conv biases).
RTOL_STEP, ATOL_STEP_NET, RTOL_CARRIED = 1e-8, 1e-12, 1e-8
# f32 fit: its first loss against the f64 loss of the same batch and
# params (the 4-sample batch norms amplify f32 rounding to ~1e-4).
RTOL_FIT_LOSS = 1e-3


def _bn_names(conf):
    return [n for n, v in conf.vertices.items()
            if type(getattr(v, "layer", None)).__name__ ==
            "BatchNormalization"]


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jn = JaxResNet50(num_classes=CLASSES,
                     input_shape=(SIZE, SIZE, 3)).init()
    for name in _bn_names(jn.conf):
        jn.conf.vertices[name].layer.helper = "pallas"
    jn.invalidate_compile_cache()
    path = tmp_path_factory.mktemp("torch_resnet50") / "resnet50.zip"
    write_model(jn, str(path))
    return jn, path


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((BATCH, SIZE, SIZE, 3)),
             np.eye(CLASSES)[rng.integers(0, CLASSES, BATCH)])
            for _ in range(STEPS)]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _torch64(tree, conf, grad=False):
    """A JAX-layout tree as f64 tensors, with an empty group for every
    vertex (the port's param tree has one per vertex)."""
    out = {name: {} for name in conf.topological_order}
    for k, group in tree.items():
        out[k] = {n: torch.tensor(np.asarray(a), dtype=torch.float64,
                                  requires_grad=grad)
                  for n, a in group.items()}
    return out


def test_loaded_graph_is_the_jax_graph(nets):
    jn, path = nets
    tn = load_reference_model(path, device="cpu")
    assert isinstance(tn, ComputationGraph)
    assert tn.conf.topological_order == jn.conf.topological_order
    built = ResNet50(num_classes=CLASSES, input_shape=(SIZE, SIZE, 3))
    mine = built.init(device="cpu")
    assert mine.conf.topological_order == jn.conf.topological_order
    assert mine.param_spec() == tn.param_spec()
    assert mine.state_spec() == tn.state_spec()
    assert tn.num_params() == jn.num_params()
    for k, group in jn.state.items():
        for n, a in group.items():
            np.testing.assert_array_equal(tn.state[k][n].numpy(),
                                          np.asarray(a))
    # the kernel rule splits the BN layers alike on both sides
    itypes = tn.conf.vertex_input_types
    names = _bn_names(tn.conf)
    assert len(names) == N_BN
    for itemsize in (4, 8):
        fused = [n for n in names
                 if pallas_bn.supports(activation="relu",
                                       shape=itypes[n][0].shape(BATCH),
                                       itemsize=itemsize)]
        assert fused == [n for n in names if jax_pallas_bn.supports(
            activation="relu", shape=itypes[n][0].shape(BATCH),
            itemsize=itemsize)]
        assert len(fused) == N_FUSED
        assert all(n.startswith("s3") for n in set(names) - set(fused))


def test_output_matches_jax(nets, batches):
    jn, path = nets
    tn = load_reference_model(path, device="cpu")
    x = batches[0][0].astype(np.float32)
    got = tn.output(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jn.output(x)), atol=ATOL_OUT,
                               rtol=0)
    assert got.shape == (BATCH, CLASSES)


def test_step0_loss_and_every_gradient_match_jax_f64(nets, batches):
    jn, path = nets
    tn = load_reference_model(path, device="cpu")
    x, y = batches[0]
    state = _f64(jn.state)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss(
        jn.conf, p, state, [jnp.asarray(x)], [jnp.asarray(y)], train=True,
        key=jax.random.PRNGKey(0))[0]))(_f64(jn.params))
    params = _torch64(jn.params, tn.conf, grad=True)
    keys = [(k, n) for k in params for n in params[k]]
    tv, _ = _graph_loss(tn.conf, params, _torch64(jn.state, tn.conf),
                        [torch.tensor(x)], [torch.tensor(y)], train=True)
    tg = torch.autograd.grad(tv, [params[k][n] for k, n in keys])
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL_LOSS)
    assert len(keys) == sum(len(g) for g in jn.params.values())
    net_max = max(float(jnp.abs(g).max())
                  for g in jax.tree_util.tree_leaves(jg))
    for (k, n), g in zip(keys, tg):
        want = np.asarray(jg[k][n])
        tol = RTOL_GRAD * np.abs(want).max() + ATOL_GRAD_NET * net_max
        np.testing.assert_allclose(g.numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"{k}/{n}")


def test_three_nesterovs_steps_match_jax_f64(nets, batches):
    """The graph train step of each side, f64: losses, params, running
    statistics and the updater state carried across three steps."""
    jn, path = nets
    tn = load_reference_model(path, device="cpu")
    jp, js, key = _f64(jn.params), _f64(jn.state), jax.random.PRNGKey(0)
    jo = jn._tx.init(jp)
    jstep = jax.jit(jax_train_step(jn.conf, jn._tx))
    tstep = _build_graph_train_step(tn.conf, tn._tx)
    ts = _torch64(jn.state, tn.conf)
    to = tn._tx.init(_torch64(jn.params, tn.conf))
    for x, y in batches:
        tp = _torch64(jp, tn.conf, grad=True)       # teacher forcing
        before = jax.tree_util.tree_map(np.asarray, jp)
        jp, js, jo, key, jl, _ = jstep(jp, js, jo, key, [jnp.asarray(x)],
                                       [jnp.asarray(y)], None, None)
        tl, ts, _ = tstep(tp, ts, to, [torch.tensor(x)], [torch.tensor(y)],
                          None)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL_LOSS)
        moves = {k: {n: np.abs(np.asarray(a) - before[k][n]).max()
                     for n, a in group.items()} for k, group in jp.items()}
        net_move = max(m for group in moves.values() for m in group.values())
        for k, group in jp.items():
            for n, a in group.items():
                tol = RTOL_STEP * moves[k][n] + ATOL_STEP_NET * net_move
                np.testing.assert_allclose(tp[k][n].detach().numpy(),
                                           np.asarray(a), atol=tol, rtol=0,
                                           err_msg=f"{k}/{n}")
    for k, group in js.items():
        for n, a in group.items():
            a = np.asarray(a)
            np.testing.assert_allclose(
                ts[k][n].numpy(), a, atol=RTOL_CARRIED * np.abs(a).max(),
                rtol=0, err_msg=f"state {k}/{n}")
    # the JAX package's traces, installed by vertex name, are the port's
    tn.opt_state = to
    carried = {k: {n: s["trace"].clone() for n, s in g.items()}
               for k, g in to["slots"].items()}
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray, jo))
    net_trace = max(t.abs().max().item() for group in carried.values()
                    for t in group.values())
    for k, group in carried.items():
        for n, t in group.items():
            got = to["slots"][k][n]["trace"].numpy()
            tol = RTOL_CARRIED * np.abs(got).max() + \
                ATOL_STEP_NET * net_trace    # conv biases: noise
            np.testing.assert_allclose(t.numpy(), got, atol=tol, rtol=0,
                                       err_msg=f"trace {k}/{n}")


def test_fit_runs_43_fused_and_10_unfused_bn_layers(nets, batches,
                                                   monkeypatch):
    """``fit`` (f32) on the loaded net: 43 BN layers take
    ``bn_act_train`` and 10 ``bn_train_norm`` in each step; the first
    loss is the f64 loss of the same batch within f32's sensitivity here,
    and the running statistics move."""
    jn, path = nets
    tn = load_reference_model(path, device="cpu")
    calls = {"fused": 0, "unfused": 0}
    for mod, fn, tag in ((pallas_bn, "bn_act_train", "fused"),
                         (normalization, "bn_train_norm", "unfused")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _tag=tag, **k):
            calls[_tag] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    x, y = batches[0]
    want = float(jax_loss(jn.conf, _f64(jn.params), _f64(jn.state),
                          [jnp.asarray(x)], [jnp.asarray(y)], train=True,
                          key=jax.random.PRNGKey(0))[0])
    mean0 = tn.state["conv1_bn"]["mean"].clone()
    losses = []
    for xb, yb in batches:
        tn.fit(xb.astype(np.float32), yb.astype(np.float32))
        losses.append(tn.get_score())
    assert calls == {"fused": N_FUSED * STEPS,
                     "unfused": (N_BN - N_FUSED) * STEPS}
    np.testing.assert_allclose(losses[0], want, rtol=RTOL_FIT_LOSS)
    assert np.isfinite(losses).all() and tn.iteration == STEPS
    assert not torch.equal(tn.state["conv1_bn"]["mean"], mean0)
    assert tn.opt_state["slots"]["conv1"]["W"]["trace"].abs().max() > 0
