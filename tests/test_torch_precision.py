"""Mixed precision in the port (``nn/precision``, the policy paths of
``nn/multilayer``) against the JAX package on the CPU, mirroring
``tests/test_step_engine.py``'s precision tests and
``tests/test_multilayer.py``'s compute_dtype and remat tests: the same
JAX-initialised params go through both sides.

Tolerances:
- Step-0 loss of a bf16/f16 policy MLN: 1e-6 relative.  Both sides cast
  the same f32 masters and inputs once and run the same bf16 products;
  measured 1e-7.  That holds while the biases are 0 (at init): later,
  XLA adds a bias in the product's f32 epilogue and rounds once where
  torch rounds twice, so later losses get the looser bounds below.
- Step-0 gradients: 2**-4 (bf16) or 2**-7 (f16) of each leaf's largest
  |g| plus 1e-6.  The backward's intermediates are rounded to the compute
  dtype at different points by XLA's fused kernels and torch's per-op
  kernels, a ulp (bf16 2**-9, f16 2**-12 relative) apart at a time, and
  a bias gradient sums 64 such rows: measured 2.4e-2 (bf16) and 2.5e-3
  (f16) of the leaf's largest entry over three seeds.
- Params after one Sgd step at lr 0.1: lr times the gradient tolerance.
- Later losses of a trained policy net: 2e-3 relative (bf16) and 1e-4
  (f16): per-step bf16 rounding differences grow through the steps;
  measured 1.5e-4 / 1.1e-5 after 5 steps.
- The loss-scale state (scale, good_steps, overflow_steps): exact.
- The small TransformerLM's step-0 loss under bf16: 1e-3 relative; its
  LayerNorm, GELU and softmax round in bf16 at other points on the two
  sides (measured 1e-4; the JAX package's own bf16-vs-f32 gap there is
  ~2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn import precision as jprec
from deeplearning4j_tpu.nn._common import _cast_floats as j_cast_floats
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.nn.layers.recurrent import \
    RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.multilayer import _stack_loss as j_stack_loss
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.nn import precision as tprec
from deeplearning4j_tpu_torch.nn._common import cast_params, \
    precision_cast_map
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                            OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    _stack_loss_state)
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, params_from_jax, state_from_jax,
    updater_state_from_jax)

KEY = tprec.SCALE_STATE_KEY
RTOL_LOSS0 = 1e-6
GRAD_REL = {"bfloat16": 2.0 ** -4, "float16": 2.0 ** -7}
GRAD_ABS = 1e-6
RTOL_LOSS_LATER = {"bfloat16": 2e-3, "float16": 1e-4}
RTOL_LM_BF16 = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmlp(precision=None, updater=None, seed=3, depth=2, hidden=16,
          **kw):
    b = JNNC.builder().seed(seed).updater(updater or JAdam(
        learning_rate=0.02))
    if precision is not None:
        b = b.precision(precision)
    for k, v in kw.items():
        b = getattr(b, k)(v)
    lb = b.list()
    for _ in range(depth):
        lb = lb.layer(JDense(n_out=hidden, activation="tanh"))
    conf = (lb.layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _twin(jn):
    """The port's network from the JAX net's conf JSON, params, state and
    updater state."""
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu").init()
    params_from_jax(tn, _np_tree(jn.params))
    state_from_jax(tn, _np_tree(jn.state))
    updater_state_from_jax(tn, _np_tree(jn.opt_state))
    return tn


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _jax_grads(jn, x, y):
    pol = jprec.resolve(jn.conf.defaults)

    def loss_fn(p):
        pc = {k: j_cast_floats(v, pol.layer_dtype(jn.conf.layers[int(
            k.split("_")[1])])) for k, v in p.items()}
        xc = jnp.asarray(x).astype(pol.compute_dtype)
        return j_stack_loss(jn.conf, pc, jn.state, xc, jnp.asarray(y),
                            train=True, key=None, precision=pol)[0]
    loss, g = jax.value_and_grad(loss_fn)(jn.params)
    return float(loss), _np_tree(g)


def _port_grads(tn, x, y):
    pol = tprec.resolve(tn.conf.defaults)
    params = tn._param_tree()
    cm = precision_cast_map(pol, {f"layer_{i}": lc for i, lc in
                                  enumerate(tn.conf.layers)})
    xc = torch.tensor(x).to(tprec.torch_dtype(pol.compute_dtype))
    loss, _ = _stack_loss_state(tn.conf, cast_params(params, cm), tn.state,
                                xc, torch.tensor(y), train=True,
                                precision=pol)
    gs = torch.autograd.grad(loss, [params[k][n] for k, n in
                                    [(k, n) for k in params
                                     for n in params[k]]])
    loss = loss.detach()
    keys = [(k, n) for k in params for n in params[k]]
    return float(loss), {k: {n: g.numpy() for (kk, n), g in zip(keys, gs)
                             if kk == k} for k in params}


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_policy_step0_loss_gradients_and_one_sgd_step_match_jax(dt):
    x, y = _batch(64, seed=1)
    jn = _jmlp(dt, JSgd(learning_rate=0.1), seed=7)
    tn = _twin(jn)
    jl, jg = _jax_grads(jn, x, y)
    tl, tg = _port_grads(tn, x, y)
    np.testing.assert_allclose(tl, jl, rtol=RTOL_LOSS0)
    for k in jg:
        for n, g in jg[k].items():
            assert tg[k][n].dtype == np.float32     # lands on the master
            tol = GRAD_REL[dt] * np.abs(g).max() + GRAD_ABS
            np.testing.assert_allclose(tg[k][n], g, rtol=0, atol=tol,
                                       err_msg=f"{k}/{n}")
    jn.fit(x, y)
    tn.fit(x, y)
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS0)
    for k in jg:
        for n, g in jg[k].items():
            tol = 0.1 * (GRAD_REL[dt] * np.abs(g).max() + GRAD_ABS)
            np.testing.assert_allclose(
                tn.params[k][n].detach().numpy(), np.asarray(jn.params[k][n]),
                rtol=0, atol=tol, err_msg=f"{k}/{n}")


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_policy_masters_and_updater_state_stay_f32(dt):
    """``test_bf16_policy_parity_and_f32_updater_state``: 15 Adam steps
    on both sides; the port's losses track the JAX package's, master
    params and every updater slot stay f32."""
    x, y = _batch(64, seed=1)
    jn = _jmlp(dt, seed=7)
    tn = _twin(jn)
    for _ in range(15):
        jn.fit(x, y)
        tn.fit(x, y)
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS_LATER[dt] * 10)
    assert all(p.dtype == torch.float32 for p in tn.params.parameters())
    for group in tn.opt_state["slots"].values():
        for slots in group.values():
            assert all(t.dtype == torch.float32 for t in slots.values())


def test_f16_overflow_skips_the_step_exactly_as_jax():
    """``test_f16_dynamic_loss_scaling_overflow_skips_step``: one good
    step, then an input of 1e30 (inf in the f16 forward): the port skips
    the step wholesale (params, updater slots AND step counts bit-equal),
    the scale halves, ``overflow_steps`` ticks; the next clean step
    trains.  The scale sequence equals the JAX package's exactly."""
    x, y = _batch(32, seed=2)
    jn = _jmlp("float16", JAdam(learning_rate=0.02))
    tn = _twin(jn)
    assert float(tn.state[KEY]["scale"]) == 2.0 ** 15
    x_bad = x.copy()
    x_bad[0, 0] = 1e30
    for xi in (x, x_bad, x, x):
        if xi is x_bad:
            p_before = {k: {n: t.detach().clone() for n, t in g.items()}
                        for k, g in tn.params.items()}
            s_before = {k: {n: {s: t.clone() for s, t in sl.items()}
                            for n, sl in g.items()}
                        for k, g in tn.opt_state["slots"].items()}
            c_before = dict(tn.opt_state["count"])
        jn.fit(xi, y)
        tn.fit(xi, y)
        if xi is x_bad:
            for k, g in p_before.items():
                for n, t in g.items():
                    assert torch.equal(tn.params[k][n], t), (k, n)
                    for s, v in s_before[k][n].items():
                        assert torch.equal(
                            tn.opt_state["slots"][k][n][s], v)
            assert tn.opt_state["count"] == c_before
            assert int(tn._last_grad_stats["overflow"]) == 1
        ls, jls = tn.state[KEY], jn.state[jprec.SCALE_STATE_KEY]
        for name in ("scale", "good_steps", "overflow_steps"):
            assert float(ls[name]) == float(jls[name]), name
        assert ls["scale"].dtype == torch.float32
        assert ls["good_steps"].dtype == ls["overflow_steps"].dtype == \
            torch.int32
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL_LOSS_LATER["float16"])
    assert float(tn.state[KEY]["scale"]) == 2.0 ** 14
    assert int(tn.state[KEY]["overflow_steps"]) == 1
    assert int(tn.state[KEY]["good_steps"]) == 2


@pytest.mark.parametrize("helper", [None, "pallas"])
def test_f16_tbptt_overflow_does_not_poison_carries(helper):
    """``test_f16_tbptt_overflow_does_not_poison_carries``: chunk 1 of 3
    overflows; only it is skipped (the next chunk starts from the
    pre-step carries), so ``overflow_steps`` is 1 on both sides, and the
    losses and params agree.  ``helper="pallas"`` runs the LSTM kernel's
    plain twin here, upcast to f32 as the JAX layer does before its
    kernel."""
    b = (JNNC.builder().seed(2).updater(JAdam(learning_rate=0.01))
         .precision("float16"))
    lb = b.list()
    lb.layer(JLSTM(n_out=6, helper=helper))
    lb.layer(JRnnOut(n_out=2, activation="softmax", loss="mcxent"))
    lb.backprop_type("tbptt", fwd=4, back=4)
    jn = JMLN(lb.set_input_type(JIT.recurrent(3, 12)).build()).init()
    tn = _twin(jn)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 3)).astype(np.float32)
    x[:, 0, :] = 1e30
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 12))]
    jn.fit(x, y)
    tn.fit(x, y)
    assert int(tn.state[KEY]["overflow_steps"]) == int(
        jn.state[jprec.SCALE_STATE_KEY]["overflow_steps"]) == 1
    assert float(tn.state[KEY]["scale"]) == float(
        jn.state[jprec.SCALE_STATE_KEY]["scale"])
    assert tn.iteration == 3
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS_LATER["float16"])
    for k, g in jn.params.items():
        for n, a in g.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), rtol=0, atol=1e-4,
                                       err_msg=f"{k}/{n}")


def test_policy_object_with_overrides_and_layer_dtypes():
    """``test_precision_policy_object_knobs``: a ``PrecisionPolicy`` with
    a per-name override round-trips through the builder and JSON, each
    layer resolves to the JAX package's dtype, and the net trains with
    the overridden layer's params never cast."""
    jpol = jprec.PrecisionPolicy(compute_dtype="bfloat16",
                                 overrides={"layer0": "float32"})
    jn = _jmlp(jpol, JSgd(learning_rate=0.1))
    tpol = tprec.PrecisionPolicy(compute_dtype="bfloat16",
                                 overrides={"layer0": "float32"})
    b = NeuralNetConfiguration.builder().seed(3).precision(tpol)
    assert b._defaults["precision"] == tpol
    assert b._defaults["compute_dtype"] == "bfloat16"
    tn = _twin(jn)
    assert isinstance(tn.conf.defaults["precision"], tprec.PrecisionPolicy)
    assert tn.conf.to_json() == jn.conf.to_json()
    for lc, jlc in zip(tn.conf.layers, jn.conf.layers):
        assert tprec.resolve(tn.conf.defaults).layer_dtype(lc) == \
            jprec.resolve(jn.conf.defaults).layer_dtype(jlc)
    cm = precision_cast_map(tprec.resolve(tn.conf.defaults),
                            {f"layer_{i}": lc
                             for i, lc in enumerate(tn.conf.layers)})
    assert set(cm) == {"layer_1", "layer_2"}
    x, y = _batch(16, seed=5)
    jn.fit(x, y)
    tn.fit(x, y)
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS0)
    # named policies and resolve() as the JAX package's
    for name in ("bf16", "mixed_float16", "f32", "float16"):
        assert tprec.named_policy(name).__dict__ == \
            jprec.named_policy(name).__dict__
    for d in ({}, {"compute_dtype": "bfloat16"}, {"precision": "float16"},
              {"precision": "float32"}):
        t, j = tprec.resolve(d), jprec.resolve(d)
        assert (t is None) == (j is None)
        if t is not None:
            assert t.__dict__ == j.__dict__
    with pytest.raises(ValueError, match="unknown precision"):
        tprec.named_policy("int4")
    with pytest.raises(ValueError, match="PrecisionPolicy"):
        NeuralNetConfiguration.builder().precision(3)


def test_mixed_precision_compute_dtype_converges():
    """``test_mixed_precision_compute_dtype``: the builder's
    ``compute_dtype("bfloat16")`` trains to under 0.3 of its start; the
    masters and the state stay f32."""
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(Adam(learning_rate=0.05)).compute_dtype("bfloat16")
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    y_cls = rng.integers(0, 3, 90)
    x = (rng.standard_normal((90, 4)) * 0.3).astype(np.float32)
    x[:, :3] += np.eye(3, dtype=np.float32)[y_cls] * 2
    y = np.eye(3, dtype=np.float32)[y_cls]
    s0 = net.score(x=x, y=y)
    for _ in range(40):
        net.fit(x, y)
    assert net.score() < 0.3 * s0
    assert all(p.dtype == torch.float32 for p in net.params.parameters())


def test_cache_mode_remat_numerics_parity_with_jax():
    """``test_cache_mode_remat_numerics_parity``: remat is a memory
    policy, never a numerics change: the port's remat net and its plain
    twin give the same scores (f32 tolerance), and both track the JAX
    remat net."""
    x, y = _batch(60, seed=0)
    jn = _jmlp(None, JAdam(learning_rate=0.05), seed=4, cache_mode="remat")
    tn = _twin(jn)
    plain = _twin(jn)
    plain.conf.defaults["cache_mode"] = "none"
    for _ in range(8):
        jn.fit(x, y)
        tn.fit(x, y)
        plain.fit(x, y)
    assert abs(tn.get_score() - plain.get_score()) < 1e-6
    np.testing.assert_allclose(tn.get_score(), jn.get_score(), rtol=1e-5)
    with pytest.raises(ValueError, match="cache_mode"):
        NeuralNetConfiguration.builder().cache_mode("everything")


def test_remat_replays_dropout_from_the_same_key():
    """Remat replays each layer's forward in the backward; dropout draws
    from the layer's threefry key, so the replay draws the same mask: a
    dropout net's remat step equals its plain step."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]

    def make(cache):
        b = NeuralNetConfiguration.builder().seed(4).updater(
            Adam(learning_rate=0.05)).cache_mode(cache)
        conf = (b.list()
                .layer(DenseLayer(n_out=16, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        return MultiLayerNetwork(conf, device="cpu").init()
    a, b = make("none"), make("remat")
    for _ in range(3):
        a.fit(x, y)
        b.fit(x, y)
        assert a.get_score() == b.get_score()
    for k, g in a.params.items():
        for n, t in g.items():
            assert torch.equal(t, b.params[k][n])


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_small_transformer_lm_policy_matches_jax(dt):
    """A small TransformerLM under the zoo's ``compute_dtype``: the step-0
    loss against the JAX package's, three Sgd steps (f16's 2**15 scale
    overflows this loss's backward, so both sides skip the same steps and
    keep the same scale state)."""
    kw = dict(vocab_size=64, seq_len=32, embed=32, n_layers=2, n_heads=2,
              sparse_labels=True, compute_dtype=dt)
    jn = JTransformerLM(**kw, updater=JSgd(learning_rate=1e-3)).init()
    tn = _twin(jn)
    assert tn.conf.defaults["compute_dtype"] == dt
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, (4, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    for i in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        tol = RTOL_LM_BF16 if i == 0 else 2 * RTOL_LM_BF16
        np.testing.assert_allclose(tn.get_score(), jn.get_score(), rtol=tol)
    if dt == "float16":
        for name in ("scale", "good_steps", "overflow_steps"):
            assert float(tn.state[KEY][name]) == float(
                jn.state[jprec.SCALE_STATE_KEY][name])
    assert all(p.dtype == torch.float32 for p in tn.params.parameters())


def test_policy_checkpoint_from_jax_continues_the_scale_sequence(tmp_path):
    """A JAX checkpoint of an f16 policy net (``write_model``) carries the
    ``__precision__`` scale state in ``state.npz`` and the policy's
    ``@class`` in its conf JSON; ``load_reference_model`` loads both, so
    the port's next steps continue the JAX package's scale sequence."""
    x, y = _batch(32, seed=2)
    pol = jprec.PrecisionPolicy(compute_dtype="float16",
                                loss_scale="dynamic", growth_interval=2)
    jn = _jmlp(pol, JSgd(learning_rate=0.05))
    x_bad = x.copy()
    x_bad[0, 0] = 1e30
    jn.fit(x, y)
    jn.fit(x_bad, y)
    path = str(tmp_path / "f16.zip")
    write_model(jn, path)
    tn = load_reference_model(path, device="cpu")
    assert isinstance(tn.conf.defaults["precision"], tprec.PrecisionPolicy)
    assert tn.conf.defaults["precision"].growth_interval == 2
    for name in ("scale", "good_steps", "overflow_steps"):
        assert float(tn.state[KEY][name]) == float(
            jn.state[jprec.SCALE_STATE_KEY][name])
    for _ in range(3):       # two clean steps grow the scale once
        jn.fit(x, y)
        tn.fit(x, y)
        for name in ("scale", "good_steps", "overflow_steps"):
            assert float(tn.state[KEY][name]) == float(
                jn.state[jprec.SCALE_STATE_KEY][name]), name
    assert float(tn.state[KEY]["scale"]) == 2.0 ** 15

