"""The YOLOv2 output layer of the port against the JAX package: the loss
and its gradient in float64 (alone, in a MultiLayerNetwork and in a
ComputationGraph), ties of the responsible-box argmax, the ``twh`` clip,
decoding and NMS, the graph gradient check, and a JAX-written container.

Tolerances: float64 losses and gradients within 1e-10 (the same
formulas, rounded in another order); float32 served activations within
1e-6 abs + 1e-6 relative (exp, sigmoid and softmax rounded by two
libraries); decoding and NMS of the same activations equal JAX's arrays
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.computation_graph import _graph_loss as j_graph_loss
from deeplearning4j_tpu.nn.computation_graph import \
    check_graph_gradients as jcheck_graph
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import objdetect as jod
from deeplearning4j_tpu.nn.multilayer import _stack_loss as j_stack_loss
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, _graph_loss, check_graph_gradients)
from deeplearning4j_tpu_torch.nn.conf import computation_graph as tcg
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import objdetect as tod
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    _stack_loss_state)
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

TOL64 = 1e-10
H = W = 4
B, C = 2, 3
BOXES = [[1.0, 1.5], [2.0, 1.0]]
SMALL_BOXES = [[0.2, 0.2], [0.3, 0.25]]


def _labels(rng, n=2):
    labels = np.zeros((n, H, W, 4 + C))
    for img in range(n):
        r, c = rng.integers(0, H), rng.integers(0, W)
        cx, cy, w, h = c + 0.5, r + 0.3, 1.2, 0.8
        labels[img, r, c, 0:4] = [cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2]
        labels[img, r, c, 4 + rng.integers(0, C)] = 1.0
    return labels


def _corner_labels(rng, n=2):
    """One object per image, a 0.1-cell square in the top-left corner of
    its cell: small untrained predictors (centres near the middle of
    their cell) do not overlap it, so every IoU is 0.  The detached IoU
    target and the responsible box (the first of equal IoUs) are then
    locally constant, and central differences see the function autograd
    differentiates."""
    labels = np.zeros((n, H, W, 4 + C))
    for img in range(n):
        r, c = rng.integers(0, H), rng.integers(0, W)
        labels[img, r, c, 0:4] = [c + 0.02, r + 0.02, c + 0.12, r + 0.12]
        labels[img, r, c, 4 + rng.integers(0, C)] = 1.0
    return labels


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, H, W, B * (5 + C))), _labels(rng)


def _loss_grad(x, labels, boxes=BOXES):
    """Loss and d(loss)/dx of both packages' layers, float64."""
    jl = jod.Yolo2OutputLayer(boxes=boxes)
    jloss, jg = jax.jit(jax.value_and_grad(lambda a: jl.compute_loss(
        {"params": {}, "state": {}}, a, jnp.asarray(labels))))(
            jnp.asarray(x))
    tl = tod.Yolo2OutputLayer(boxes=boxes)
    tx = torch.tensor(x, requires_grad=True)
    tloss = tl.compute_loss({}, tx, torch.tensor(labels))
    tg, = torch.autograd.grad(tloss, tx)
    return float(jloss), tloss.item(), np.asarray(jg), tg.numpy()


def _assert_loss_grad(x, labels, boxes=BOXES):
    jloss, tloss, jg, tg = _loss_grad(x, labels, boxes)
    assert abs(jloss - tloss) <= TOL64 * max(1.0, abs(jloss))
    np.testing.assert_allclose(tg, jg, atol=TOL64, rtol=0)
    return tloss, tg


def test_loss_and_input_gradient_f64():
    x, labels = _setup()
    _assert_loss_grad(x, labels)
    # average=False: the batch sum
    tl = tod.Yolo2OutputLayer(boxes=BOXES)
    jl = jod.Yolo2OutputLayer(boxes=BOXES)
    want = float(jax.jit(lambda a, b: jl.compute_loss(
        {"params": {}}, a, b, average=False))(jnp.asarray(x),
                                              jnp.asarray(labels)))
    got = tl.compute_loss({}, torch.tensor(x), torch.tensor(labels),
                          average=False).item()
    assert abs(want - got) <= TOL64 * abs(want)
    assert tl.SUPPORTS_LOSS_MASK is False


def test_equal_iou_boxes_take_the_first():
    """Two predictors of one cell with the same prior and the same raw
    outputs have equal IoUs: the first is responsible (argmax's first
    maximum), in the loss and in its gradient."""
    x, labels = _setup(1)
    boxes = [[1.5, 1.5], [1.5, 1.5]]
    xr = x.reshape(2, H, W, B, 5 + C)
    xr[:, :, :, 1, :4] = xr[:, :, :, 0, :4]
    x = xr.reshape(x.shape)
    loss, g = _assert_loss_grad(x, labels, boxes)
    g = g.reshape(2, H, W, B, 5 + C)
    obj = labels[..., 4:].sum(-1) > 0
    # coordinates train on the first predictor only
    assert np.abs(g[obj][:, 0, :4]).max() > 0
    assert np.abs(g[obj][:, 1, :4]).max() == 0


@pytest.mark.parametrize("bound", [10.0, -10.0])
def test_twh_at_the_clip(bound):
    """A raw width/height exactly on the ±10 clip: jnp.clip's gradient
    there (half the gradient passes, as minimum/maximum split ties) is
    the port's, where torch.clamp would pass all of it."""
    x, labels = _setup(2)
    xr = x.reshape(2, H, W, B, 5 + C)
    xr[..., 2:4] = bound
    x = xr.reshape(x.shape)
    _, g = _assert_loss_grad(x, labels)
    assert np.abs(g.reshape(xr.shape)[..., 2:4]).max() > 0


def _mln_confs():
    jconf = (NeuralNetConfiguration.builder().seed(0)
             .updater(JSgd(learning_rate=0.05)).list()
             .layer(jconv.ConvolutionLayer(n_out=B * (5 + C),
                                           kernel_size=(1, 1),
                                           activation="identity"))
             .layer(jod.Yolo2OutputLayer(boxes=BOXES))
             .set_input_type(JIT.convolutional(H, W, 6)).build())
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _graph_confs(helper=None, boxes=SMALL_BOXES):
    def build(cgc, conv, norm, od, itype, sgd):
        g = cgc.GraphBuilder({"activation": "identity",
                              "updater": sgd(learning_rate=0.05)}, seed=3)
        g.add_inputs("in").set_input_types(itype.convolutional(H, W, 6))
        g.add_layer("c1", conv.ConvolutionLayer(
            n_out=8, kernel_size=(3, 3), convolution_mode="same",
            activation="leakyrelu:0.1"), "in")
        g.add_layer("bn", norm.BatchNormalization(helper=helper), "c1")
        g.add_layer("c2", conv.ConvolutionLayer(
            n_out=B * (5 + C), kernel_size=(1, 1)), "bn")
        g.add_layer("yolo", od.Yolo2OutputLayer(boxes=boxes), "c2")
        g.set_outputs("yolo")
        return g.build()
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
    from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
    jconf = build(jcg, jconv, jnorm, jod, JIT, JSgd)
    tconf = build(tcg, tconv, tnorm, tod, InputType, Sgd)
    assert tconf.to_json() == jconf.to_json()
    return jconf, tconf


def _f64_tree(net):
    return {k: {n: p.detach().double().numpy() for n, p in g.items()}
            for k, g in net.params.items()}


def _f64_state(net):
    return {k: {n: t.double().numpy() for n, t in g.items()}
            for k, g in net.state.items()}


def _net_loss_grads(jloss_fn, tloss_fn, tree):
    """Loss and every param's gradient of both packages, float64."""
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(
        {k: {n: jnp.asarray(v) for n, v in g.items()}
         for k, g in tree.items()})
    tp = {k: {n: torch.tensor(v, requires_grad=True) for n, v in g.items()}
          for k, g in tree.items()}
    tl = tloss_fn(tp)
    names = [(k, n) for k in tp for n in tp[k]]
    tg = torch.autograd.grad(tl, [tp[k][n] for k, n in names])
    assert abs(float(jl) - tl.item()) <= TOL64 * max(1.0, abs(float(jl)))
    for (k, n), g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k][n]),
                                   atol=TOL64, rtol=0, err_msg=f"{k}/{n}")


def test_mln_loss_and_gradients_f64():
    jconf, tconf = _mln_confs()
    net = MultiLayerNetwork(tconf, device="cpu").init()
    tree = _f64_tree(net)
    x, labels = _setup(3)
    x = x[..., :6]
    _net_loss_grads(
        lambda p: j_stack_loss(jconf, p, {}, jnp.asarray(x),
                               jnp.asarray(labels), train=False,
                               key=None)[0],
        lambda p: _stack_loss_state(tconf, p, {}, torch.tensor(x),
                                    torch.tensor(labels), train=False)[0],
        tree)


def test_graph_loss_and_gradients_f64():
    jconf, tconf = _graph_confs()
    net = ComputationGraph(tconf, device="cpu").init()
    tree, state = _f64_tree(net), _f64_state(net)
    x, labels = _setup(4)
    x = x[..., :6]
    jstate = {k: {n: jnp.asarray(v) for n, v in g.items()}
              for k, g in state.items()}
    tstate = {k: {n: torch.tensor(v) for n, v in g.items()}
              for k, g in state.items()}
    _net_loss_grads(
        lambda p: j_graph_loss(jconf, p, jstate, [jnp.asarray(x)],
                               [jnp.asarray(labels)], train=True,
                               key=None)[0],
        lambda p: _graph_loss(tconf, p, tstate, [torch.tensor(x)],
                              [torch.tensor(labels)], train=True)[0],
        tree)


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    """A JAX-written container of the YOLO graph (weights made by the
    port from its seed), the JAX graph and the port's graph read back."""
    jconf, tconf = _graph_confs(helper="pallas")
    src = ComputationGraph(tconf, device="cpu").init()
    jn = JCG(jconf)
    jn.params = {k: {n: jnp.asarray(p.detach().numpy()) for n, p in
                     g.items()} for k, g in src.params.items()}
    jn.state = {k: {n: jnp.asarray(t.numpy()) for n, t in g.items()}
                for k, g in src.state.items()}
    path = str(tmp_path_factory.mktemp("yolo") / "yolo.zip")
    write_model(jn, path, save_updater=False)
    return jn, load_reference_model(path, device="cpu")


def test_reference_container_output_and_decode(graph_pair):
    """The container reads back as a Yolo2OutputLayer graph; served
    activations agree; decoded detections and NMS equal JAX's arrays."""
    jn, tn = graph_pair
    assert type(tn.conf.vertices["yolo"].layer).__name__ == \
        "Yolo2OutputLayer"
    x = np.random.default_rng(5).standard_normal((3, H, W, 6)) \
        .astype(np.float32)
    jact = np.asarray(jn.output(x)[0] if isinstance(jn.output(x), list)
                      else jn.output(x))
    tact = tn.output(x)
    tact = (tact[0] if isinstance(tact, list) else tact).numpy()
    assert tact.shape == (3, H, W, B, 5 + C)
    # float32 exp/sigmoid/softmax rounded by two libraries: a few ulps
    np.testing.assert_allclose(tact, jact, atol=1e-6, rtol=1e-6)
    for thr in (0.0, 0.3):
        jd = jod.get_predicted_objects(jact, threshold=thr)
        td = tod.get_predicted_objects(torch.tensor(jact), threshold=thr)
        assert len(td) == len(jd) == 3
        for a, b in zip(td, jd):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            for iou in (0.2, 0.45):
                np.testing.assert_array_equal(
                    tod.non_max_suppression(a, iou),
                    jod.non_max_suppression(b, iou))
    assert tod.non_max_suppression(np.zeros((0, 6))).shape == (0, 6)


def test_check_graph_gradients_matches_jax(graph_pair, capsys):
    """``check_graph_gradients`` on the YOLO graph, float64, objects the
    predictors do not overlap (``_corner_labels``): both pass, checking
    the same elements."""
    jn, tn = graph_pair
    rng = np.random.default_rng(6)
    x = 0.3 * rng.standard_normal((2, H, W, 6))
    labels = _corner_labels(rng)
    want = jcheck_graph(jn, x, labels, subset=5, print_results=True)
    jout = capsys.readouterr().out
    got = check_graph_gradients(tn, x, labels, subset=5,
                                print_results=True)
    tout = capsys.readouterr().out

    def checked(out):
        return [line.split(":")[0].split("param ")[1]
                for line in out.splitlines() if "param " in line]

    assert got == want is True
    assert checked(tout) == checked(jout) and len(checked(tout)) >= 20


def test_graph_fit_step_matches_jax(graph_pair):
    """One Sgd training step of the YOLO graph (BatchNormalization with
    the kernel helper: its plain version on CPU tensors): loss, params
    and running statistics as the JAX package's (float32, 1e-5)."""
    jn, tn = graph_pair
    x, labels = _setup(7)
    x = x[..., :6].astype(np.float32)
    labels = labels.astype(np.float32)
    with jax.enable_x64(False):
        jn2 = JCG(jn.conf)
        # fresh buffers: the JAX step donates its params
        jn2.params, jn2.state = (
            jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), t)
            for t in (jn.params, jn.state))
        jn2._tx = jn2._build_tx()
        jn2.opt_state = jn2._tx.init(jn2.params)
        jn2.fit(x, labels)
    tn2 = tn.clone()
    tn2.fit(x, labels)
    assert abs(tn2.get_score() - jn2.get_score()) <= \
        1e-5 * abs(jn2.get_score())
    for k, g in jn2.params.items():
        for n, v in g.items():
            np.testing.assert_allclose(tn2.params[k][n].detach().numpy(),
                                       np.asarray(v), atol=1e-5, rtol=1e-5)
    for n, v in jn2.state["bn"].items():
        np.testing.assert_allclose(tn2.state["bn"][n].numpy(),
                                   np.asarray(v), atol=1e-5, rtol=1e-5)
