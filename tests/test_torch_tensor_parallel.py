"""Tensor parallelism of the port against the JAX package's:
``ParallelWrapper(param_rule=megatron_dense_rule)`` at (dp 1, tp 2) and
(dp 2, tp 2) on gloo ranks against the JAX wrapper on the same mesh
shape over the conftest's virtual CPU devices, from the same weights
(``write_model`` + ``load_reference_model``) on the same batches:

* the dry run's MLP (784 -> 64 -> 64 -> 10) under Adam, whose first two
  dense layers run as a Megatron pair (column split, then row split with
  one all-reduce);
* a small TransformerLM under Sgd, whose embedding and output layers the
  rule splits and the step all-gathers;

losses, the gathered params, and the output through the wrapper.  Then
the mesh's shapes and the layout plan, the refusal of ZeRO-1 with a
rule, and ``dryrun.run(4)`` and ``dryrun.run(8)`` (each its own spawn)
against the JAX package's dry-run steps on the same inputs.

Losses within 1e-5 relative; params within 1e-5 of each leaf's largest
|value| (the all-reduce of the pair's partial sums and the ranks' loss
shares reorder f32 sums, as in the data-parallel tests).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as JP
try:
    from jax import shard_map
except ImportError:  # jax < 0.5 keeps it in experimental
    from jax.experimental.shard_map import shard_map

from deeplearning4j_tpu.models.zoo import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import megatron_dense_rule as jrule
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, make_mesh,
                                               megatron_dense_rule)
from deeplearning4j_tpu_torch.parallel import dryrun
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS, P

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_model_axes as axes  # noqa: E402

WORLD = 4
STEPS = 3
RTOL_LOSS = 1e-5
RTOL_PARAMS = 1e-5
# ... plus 1e-6 absolute for a leaf whose gradient is 0 in exact
# arithmetic: the LM's mha_bk (the softmax ignores a per-row shift) moves
# by f32 noise only, 3 steps of lr 0.05 times a gradient of ~1e-6 that
# each side rounds differently (up to 2.5e-7 apart at dp 2)
ATOL_PARAMS = 1e-6
SHAPES = [(1, 2), (2, 2)]


def _mlp(seed=42):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).activation("relu").weight_init("xavier")
            .updater(jupd.Adam(learning_rate=1e-3))
            .list()
            .layer(jff.DenseLayer(n_out=64))
            .layer(jff.DenseLayer(n_out=64))
            .layer(jff.OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(784))
            .build())
    return JMLN(conf).init()


def _lm():
    return JLM(vocab_size=24, seq_len=16, embed=32, n_layers=2, n_heads=2,
               sparse_labels=True,
               updater=jupd.Sgd(learning_rate=0.05)).init()


def _batches(kind, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if kind == "mlp":
            out.append((rng.standard_normal((16, 784)).astype(np.float32),
                        np.eye(10, dtype=np.float32)[
                            rng.integers(0, 10, 16)]))
        else:
            x = rng.integers(0, 24, (8, 16))
            out.append((x, (x + 5) % 24))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    payload, want = [], {}
    for kind, make in (("mlp", _mlp), ("lm", _lm)):
        path = str(d / f"{kind}.zip")
        write_model(make(), path)
        for dp, tp in SHAPES:
            name = f"{kind}/{dp}x{tp}"
            batches = _batches(kind, dp)
            probe = batches[0][0][:4]
            payload.append({"fn": "tensor_parallel", "name": name,
                            "shape": (dp, tp), "zip": path,
                            "batches": batches, "output": probe})
            jn = make()
            w = JPW(jn, jmake_mesh(dp=dp, tp=tp),
                    param_rule=jrule(jn.params))
            losses = []
            for x, y in batches:
                w.fit(x, y)
                losses.append(float(jn.get_score()))
            want[name] = {"losses": losses,
                          "params": jax.tree_util.tree_map(np.asarray,
                                                           jn.params),
                          "output": np.asarray(jn.output(probe))}
    return want, axes.run(WORLD, payload)


@pytest.mark.parametrize("kind", ["mlp", "lm"])
@pytest.mark.parametrize("dp,tp", SHAPES)
def test_tensor_parallel_wrapper_matches_jax(runs, kind, dp, tp):
    want, results = runs
    name = f"{kind}/{dp}x{tp}"
    got = [r[name] for r in results if name in r]
    assert len(got) == dp * tp
    w = want[name]
    for r in got:
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=RTOL_LOSS)
        for k, g in w["params"].items():
            for n, a in g.items():
                scale = max(np.abs(a).max(), 1e-30)
                np.testing.assert_allclose(
                    r["params"][k][n], a, rtol=0,
                    atol=RTOL_PARAMS * scale + ATOL_PARAMS,
                    err_msg=f"{name}: {k}/{n}")
        np.testing.assert_allclose(r["output"], w["output"], rtol=1e-5,
                                   atol=1e-6)
    # the rule's layout: the MLP's first two dense layers are a pair;
    # the LM's split leaves (embedding, output) are gathered
    r0 = got[0]
    if kind == "mlp":
        assert r0["local"] == ["layer_0/W", "layer_0/b", "layer_1/W"]
        assert r0["plan"] == {"layer_0": {"W": 1, "b": 0},
                              "layer_1": {"W": 0},
                              "layer_2": {"W": 1, "b": 0}}
    else:
        assert r0["local"] == []
        assert r0["plan"]["layer_0"] == {"W": 1}
    full = sum(a.size * 4 for g in w["params"].values() for a in g.values())
    assert r0["per_device_param_bytes"] < full


def test_megatron_rule_and_mesh_shapes():
    jn = _mlp()
    rule, jr = megatron_dense_rule(jn.params), jrule(jn.params)
    for k, g in jn.params.items():
        for n, a in g.items():
            assert tuple(rule(k, n, a)) == tuple(jr(k, n, a)), (k, n)
    assert rule("layer_0", "W", np.zeros((2, 2))) == P(None, MODEL_AXIS)
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1, "seq": 1}
    assert (m.dp, m.tp, m.sp) == (1, 1, 1)
    with pytest.raises(ValueError, match="oversubscribes the 1 available"):
        make_mesh(dp=1, tp=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by tp\\*sp=2"):
        make_mesh(tp=2, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without CUDA, ``make_grid``/``make_mesh`` with no device and
    ``dryrun.run`` on its default device raise; nothing carries on on the
    CPU unless the caller names it."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_grid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make_grid(("seq",), (1,))
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="needs 4 CUDA card\\(s\\), "
                                           "found 0"):
        dryrun.run(4)
    assert make_grid(("seq",), (1,), device="cpu").device.type == "cpu"


def test_tensor_parallel_layout_is_refused_by_save_sharded(tmp_path):
    """The sharded checkpoint format indexes one data-axis block per
    writer; a leaf a rule splits over ``model`` refuses at save time (the
    JAX package refuses a leaf cut over two axes there), and the dense
    path saves the gathered net."""
    from deeplearning4j_tpu_torch.faulttolerance.checkpoint import \
        CheckpointManager
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _mlp().conf.to_json()), device="cpu").init()
    w = ParallelWrapper(net, make_mesh(tp=1, device="cpu"),
                        param_rule=megatron_dense_rule(net.params))
    mgr = CheckpointManager(str(tmp_path), background=False)
    with pytest.raises(NotImplementedError, match="'model' axis"):
        mgr.save_sharded(net)
    with w.gathered() as m:
        mgr.save(m, blocking=True)


def test_checkpointed_forward_carries_the_step_contexts_to_another_thread():
    """``cache_mode("remat")`` replays a layer's forward in the backward,
    on autograd's device thread on CUDA: the replay runs in the global
    batch and the mesh of the step that made it."""
    import threading
    from deeplearning4j_tpu_torch.nn._common import carry_thread_context
    from deeplearning4j_tpu_torch.parallel.mesh import (Axis, Grid,
                                                        current_grid)
    from deeplearning4j_tpu_torch.utils import global_batch
    grid = Grid([Axis("seq", 1, 0)])
    with global_batch.global_batch(None, 2, 1, 3) as gb, grid:
        fn = carry_thread_context(lambda: (global_batch.current(),
                                           current_grid()))
    seen = {}
    th = threading.Thread(target=lambda: seen.update(
        bare=(global_batch.current(), current_grid()), carried=fn()))
    th.start()
    th.join(30)
    assert seen["bare"] == (None, None)
    assert seen["carried"][0] is gb and seen["carried"][1] is grid
    assert global_batch.current() is None and current_grid() is None


@pytest.mark.parametrize("remat", [False, True])
def test_megatron_roles_ride_on_the_exchange(remat):
    """The pairs' forwards are the exchange's ``roles``, which the train
    step hands to the layer walk; under remat the checkpointed replay
    runs them again (no thread-local state).  At tp 1 the pair's
    collectives are the identity and the step equals plain ``fit``."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.exchange import GradientExchange

    def make():
        conf = MultiLayerConfiguration.from_json(_mlp().conf.to_json())
        if remat:
            conf.defaults["cache_mode"] = "remat"
        return MultiLayerNetwork(conf, device="cpu").init()

    net, plain = make(), make()
    plain.load_params({k: {n: t.detach().clone() for n, t in g.items()}
                       for k, g in net.params.items()})
    w = ParallelWrapper(net, make_mesh(tp=1, device="cpu"),
                        param_rule=megatron_dense_rule(net.params))
    assert GradientExchange(make_mesh(device="cpu")).roles == {}
    roles = w.exchange.roles
    assert sorted(roles) == ["layer_0", "layer_1"]
    calls = {k: 0 for k in roles}

    def counted(k, f):
        def run(*a, **kw):
            calls[k] += 1
            return f(*a, **kw)
        return run

    for k in list(roles):
        roles[k] = counted(k, roles[k])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    w.fit(x, y)
    plain.fit(x, y)
    assert calls == {k: 2 if remat else 1 for k in roles}
    assert net.get_score() == plain.get_score()
    for k, g in w.full_params().items():
        for n, t in g.items():
            assert torch.equal(t, plain.params[k][n]), (k, n)


def test_zero1_with_a_param_rule_is_refused():
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="shard_optimizer_state=True is "
                                         "only supported with replicated"):
        ParallelWrapper(None, Mesh(1, 0), param_rule=lambda *a: P(),
                        shard_optimizer_state=True)
    jn = _mlp()
    with pytest.raises(ValueError, match="shard_optimizer_state=True"):
        JPW(jn, jmake_mesh(dp=2), param_rule=jrule(jn.params),
            shard_optimizer_state=True)


def _jax_pipeline_loss(n):
    from deeplearning4j_tpu.parallel.demo import (build_demo_inputs,
                                                  make_pipelined_train_step)
    dp, pp, sp = 2, 2, n // 4
    stacked, xs, ys = build_demo_inputs(
        n_stages=pp, embed=8, n_heads=2, seq_len=4 * sp, microbatch=2 * dp,
        n_micro=pp)
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(dp, pp, sp),
                 ("data", "pipe", "seq"))
    fn = jax.jit(shard_map(
        make_pipelined_train_step(n_heads=2), mesh=mesh,
        in_specs=(JP("pipe"), JP(None, "data", "seq"),
                  JP(None, "data", "seq")),
        out_specs=(JP(), JP("pipe"))))
    return float(fn(stacked, xs, ys)[0])


def _jax_expert_loss(n):
    from deeplearning4j_tpu.parallel.expert import (init_moe_params,
                                                    make_moe_train_step)
    dp, ep = 2, n // 2
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(dp, ep),
                 ("data", "expert"))
    params = init_moe_params(jax.random.PRNGKey(0), ep, 8, 16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n * 4, 8)).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((8, 8)).astype(np.float32))
    pspec = {"router": JP(None, None), "w1": JP("expert"),
             "w2": JP("expert")}
    bspec = JP(("data", "expert"), None)
    params = {k: jax.device_put(v, NamedSharding(mesh, pspec[k]))
              for k, v in params.items()}
    fn = jax.jit(shard_map(make_moe_train_step(capacity=4), mesh=mesh,
                           in_specs=(pspec, bspec, bspec),
                           out_specs=(pspec, JP())))
    return float(fn(params, jnp.asarray(x), jnp.asarray(y))[1])


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_matches_the_jax_dry_run_steps(n):
    jn = _mlp()
    init = jax.tree_util.tree_map(np.asarray, jn.params)
    rec = dryrun.run(n, init_params=init, device="cpu", timeout_s=240)
    # the JAX dry run's TP step on the same weights and batch
    tp = 2
    rng = np.random.default_rng(0)
    batch = (n // tp) * 8
    x = rng.standard_normal((batch, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    JPW(jn, jmake_mesh(n, tp=tp), param_rule=jrule(jn.params)).fit(x, y)
    assert (rec["backend"], rec["device"]) == ("gloo", "cpu")
    assert (rec["tp"]["dp"], rec["tp"]["tp"]) == (n // 2, 2)
    assert rec["tp"]["pairs"] == ["layer_0/W", "layer_0/b", "layer_1/W"]
    np.testing.assert_allclose(rec["tp"]["loss"], jn.get_score(),
                               rtol=RTOL_LOSS)
    for k, g in jn.params.items():
        for nm, a in g.items():
            a = np.asarray(a)
            np.testing.assert_allclose(rec["tp"]["params"][k][nm], a,
                                       rtol=0,
                                       atol=RTOL_PARAMS * np.abs(a).max(),
                                       err_msg=f"{k}/{nm}")
    if n % 8:
        assert "pipeline" not in rec and "expert" not in rec
        return
    np.testing.assert_allclose(rec["pipeline"]["loss"],
                               _jax_pipeline_loss(n), rtol=RTOL_LOSS)
    np.testing.assert_allclose(rec["expert"]["loss"], _jax_expert_loss(n),
                               rtol=RTOL_LOSS)
