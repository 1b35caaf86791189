"""The port's mixture-of-experts pieces against the JAX package's on the
CPU: ``_dispatch_tensors`` with dropped tokens, ``init_moe_params`` from
the same threefry key, ``moe_ffn`` on one device (output, aux loss and
gradients), ``MixtureOfExpertsLayer`` on feed-forward, recurrent and
convolutional input, ``TransformerBlock(moe_experts=4)``, and the slice as
a whole: a small ``TransformerLM(moe_experts=4)`` loaded from the JAX
package's ``write_model`` zip (output, loss with the aux term, every
gradient, Adam steps), the configuration's JSON both ways, the aux term
under remat and bf16, and the generation engine's refusal.

Routing is compared in float64 where gradients are held (a near-tie in
the router can flip a token's expert between two f32 summation orders);
the f32 runs compare losses and outputs within 1e-5 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import moe as jmoe_layer
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.multilayer import _stack_loss as j_stack_loss
from deeplearning4j_tpu.parallel import expert as jexp
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.generation.engine import (GenerationConfig,
                                                        GenerationEngine)
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import moe as tmoe_layer
from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss_state
from deeplearning4j_tpu_torch.parallel import expert as texp
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

# f64 on both sides: the same ops in another order, ~1e-15 relative
TOL64 = 1e-10
# ... except through the LM's positional encoding, whose sinusoid table
# both packages compute in f32 (XLA's and torch's sin differ by an ulp:
# ~1e-9 of the loss)
TOL64_LM = 1e-7
# f32 outputs and losses: 1e-5 relative; gradients 1e-4 of the leaf's
# largest |g|
RTOL32, GTOL32 = 1e-5, 1e-4


def _f64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _tree64(tree, grad=False):
    return {k: {n: _f64(a).requires_grad_(grad) for n, a in g.items()}
            for k, g in tree.items()}


def _load(jnet, tmp_path, name="m.zip"):
    path = os.path.join(str(tmp_path), name)
    write_model(jnet, path)
    return load_reference_model(path, device="cpu")


# ------------------------------------------------------------- expert core

@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_dispatch_tensors_drop_tokens_as_jax(capacity):
    rng = np.random.default_rng(capacity)
    logits = rng.standard_normal((40, 4))
    logits[:, 1] += 1.5          # one crowded expert: drops at small C
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jd, jc = jexp._dispatch_tensors(jnp.asarray(probs), capacity)
    td, tc = texp._dispatch_tensors(_f64(probs), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=TOL64)
    kept = int(td.sum())
    assert (kept < 40) == (capacity < 40), kept


def test_init_moe_params_same_key_same_weights():
    jp = jexp.init_moe_params(jax.random.PRNGKey(7), 4, 8, 16,
                              dtype=jnp.float32)
    tp = texp.init_moe_params(_random.prng_key(7), 4, 8, 16)
    for k in ("router", "w1", "w2"):
        want = np.asarray(jp[k], np.float32)
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("capacity", [3, 32])
def test_moe_ffn_single_device_value_aux_and_grads(capacity):
    rng = np.random.default_rng(3)
    params = {"router": rng.standard_normal((8, 4)) * 0.5,
              "w1": rng.standard_normal((4, 8, 16)) * 0.3,
              "b1": rng.standard_normal((4, 1, 16)) * 0.1,
              "w2": rng.standard_normal((4, 16, 8)) * 0.3,
              "b2": rng.standard_normal((4, 1, 8)) * 0.1}
    x = rng.standard_normal((32, 8))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jloss(p, xx):
        y, aux = jexp.moe_ffn(p, xx, capacity, act=jax.nn.gelu)
        return jnp.sum(jnp.sin(y)) + 3.0 * aux, (y, aux)

    (jv, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jparams, jnp.asarray(x))
    tparams = {k: _f64(v).requires_grad_(True) for k, v in params.items()}
    tx = _f64(x).requires_grad_(True)
    from deeplearning4j_tpu_torch.nn.activations import gelu
    ty, taux = texp.moe_ffn(tparams, tx, capacity, act=gelu)
    tv = torch.sum(torch.sin(ty)) + 3.0 * taux
    names = sorted(params)
    grads = torch.autograd.grad(tv, [tparams[k] for k in names] + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=TOL64, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=TOL64)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]),
                                   atol=TOL64, rtol=0, err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[1]),
                               atol=TOL64, rtol=0)


# --------------------------------------------------------------- the layer

def _moe_net(itype, out, seed):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(jupd.Adam(learning_rate=0.02)).list()
            .layer(jmoe_layer.MixtureOfExpertsLayer(
                n_out=8, n_experts=4, hidden=16, activation="relu"))
            .layer(out)
            .set_input_type(itype).build())
    return JMLN(conf).init()


def _moe_case(kind):
    rng = np.random.default_rng(4)
    if kind == "ff":
        jn = _moe_net(JIT.feed_forward(6), jff.OutputLayer(
            n_out=3, activation="softmax", loss="mcxent"), 11)
        x = rng.standard_normal((24, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    elif kind == "rnn":
        jn = _moe_net(JIT.recurrent(5, 7), jrec.RnnOutputLayer(
            n_out=3, activation="softmax", loss="mcxent"), 2)
        x = rng.standard_normal((4, 7, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))]
    else:
        jn = _moe_net(JIT.convolutional(3, 3, 2), jff.OutputLayer(
            n_out=3, activation="softmax", loss="mcxent"), 5)
        x = rng.standard_normal((12, 3, 3, 2)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    return jn, x, y


@pytest.mark.parametrize("kind", ["ff", "rnn", "cnn"])
def test_moe_layer_trains_as_jax(kind, tmp_path):
    jn, x, y = _moe_case(kind)
    tn = _load(jn, tmp_path)
    assert type(tn.conf.layers[0]).__name__ == "MixtureOfExpertsLayer"
    np.testing.assert_allclose(tn.output(x).detach().numpy(),
                               np.asarray(jn.output(x)), rtol=RTOL32,
                               atol=1e-6)
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL32)
    np.testing.assert_allclose(
        float(tn.state["layer_0"]["aux_loss"]),
        float(np.asarray(jn.state["layer_0"]["aux_loss"])), rtol=RTOL32)


def test_transformer_block_moe_forward_and_state():
    rng = np.random.default_rng(5)
    kw = dict(n_in=16, n_heads=2, causal=True, attn_impl="reference",
              moe_experts=4, moe_capacity_factor=1.0)
    jb = jatt.TransformerBlock(**kw)
    jb.apply_global_defaults({})
    jvars = jb.init(jax.random.PRNGKey(0), JIT.recurrent(16, 12))
    x = rng.standard_normal((3, 12, 16))
    jy, jst = jb.apply({"params": jvars["params"], "state": jvars["state"]},
                       jnp.asarray(x))
    tb = tatt.TransformerBlock(**kw)
    tb.apply_global_defaults({})
    assert tb.AUX_LOSS and not tatt.TransformerBlock(n_in=16).AUX_LOSS
    tp = {n: _f64(a) for n, a in jvars["params"].items()}
    ty, tst = tb.forward(tp, tb.init_state(None, "cpu"), _f64(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL64,
                               rtol=0)
    np.testing.assert_allclose(float(tst["aux_loss"]),
                               float(jst["aux_loss"]), rtol=TOL64)
    shapes = {n: tuple(t.shape) for n, t in
              tb.init(torch.Generator(), JIT.recurrent(16, 12),
                      "meta").items()}
    assert shapes == {n: tuple(np.shape(a))
                      for n, a in jvars["params"].items()}


# ---------------------------------------------------- the slice as a whole

LM = dict(vocab_size=13, seq_len=16, embed=16, n_layers=2, n_heads=2,
          moe_experts=4, sparse_labels=True)


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    jn = JLM(**LM, updater=jupd.Adam(learning_rate=3e-3)).init()
    d = tmp_path_factory.mktemp("moe_lm")
    return jn, _load(jn, d)


def _lm_batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, LM["vocab_size"], (6, LM["seq_len"]))
    return x, (x * 3 + 1) % LM["vocab_size"]


def test_moe_lm_loss_aux_and_every_gradient_in_f64(lm_pair):
    jn, tn = lm_pair
    x, y = _lm_batch(0)

    def jloss(p):
        return j_stack_loss(jn.conf, p, jn.state, jnp.asarray(x),
                            jnp.asarray(y), train=True, key=None)

    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                jn.params)
    (jv, jst), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = _tree64(jn.params, grad=True)
    tv, tst = _stack_loss_state(tn.conf, tp, tn.state, torch.as_tensor(x),
                                torch.as_tensor(y), train=True)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=TOL64_LM)
    blocks = [k for k, lc in zip(tn.params, tn.conf.layers)
              if getattr(lc, "AUX_LOSS", False)]
    assert blocks == ["layer_2", "layer_3"]
    aux = 0.0
    for k in blocks:
        np.testing.assert_allclose(tst[k]["aux_loss"].item(),
                                   float(jst[k]["aux_loss"]), rtol=TOL64_LM)
        aux += tst[k]["aux_loss"].item()
    assert aux > 0
    keys = [(k, n) for k in tp for n in tp[k]]
    got = torch.autograd.grad(tv, [tp[k][n] for k, n in keys])
    for (k, n), g in zip(keys, got):
        want = np.asarray(jg[k][n])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=TOL64_LM * (1 + np.abs(want).max()),
                                   err_msg=f"{k}/{n}")


def test_moe_lm_drops_tokens_at_its_capacity(lm_pair):
    """At capacity factor 1.25 some expert of the loaded LM overflows on
    this batch: the parity above covers dropped tokens."""
    _, tn = lm_pair
    x, _ = _lm_batch(0)
    h = tn.feed_forward(x)[1]              # the first block's input
    lc = tn.conf.layers[2]
    p = {k: v.detach() for k, v in tn.params["layer_2"].items()}
    xn = tatt._layer_norm(h + lc._mha().attend(
        {k[4:]: v for k, v in p.items() if k.startswith("mha_")},
        tatt._layer_norm(h, p["ln1_g"], p["ln1_b"])), p["ln2_g"], p["ln2_b"])
    t = xn.shape[0] * xn.shape[1]
    probs = torch.softmax(xn.reshape(t, -1) @ p["router"], -1)
    dispatch, _ = texp._dispatch_tensors(
        probs, tmoe_layer.moe_capacity(1.25, t, 4))
    assert int(dispatch.sum()) < t


def test_moe_lm_output_and_adam_steps_f32(lm_pair, tmp_path):
    jn0, _ = lm_pair
    jn = JLM(**LM, updater=jupd.Adam(learning_rate=3e-3)).init()
    tn = _load(jn, tmp_path, "fresh.zip")
    x, y = _lm_batch(1)
    np.testing.assert_allclose(tn.output(x).detach().numpy(),
                               np.asarray(jn.output(x)), rtol=RTOL32,
                               atol=1e-6)
    for step in range(3):
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL32, err_msg=f"step {step}")
    for k in ("layer_2", "layer_3"):
        np.testing.assert_allclose(
            float(tn.state[k]["aux_loss"]),
            float(np.asarray(jn.state[k]["aux_loss"])), rtol=1e-4)


def test_moe_lm_container_crosses_back_to_jax(lm_pair, tmp_path):
    """The port's ``write_model`` of the MoE LM (router, w1, b1, w2, b2
    and the aux state) restores in the JAX package with the same output."""
    from deeplearning4j_tpu.utils.model_serializer import restore_model
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        write_model as twrite
    _, tn = lm_pair
    path = str(tmp_path / "port.zip")
    twrite(tn, path)
    back = restore_model(path)
    assert set(back.params["layer_2"]) >= {"router", "w1", "b1", "w2", "b2"}
    assert "aux_loss" in back.state["layer_2"]
    x, _ = _lm_batch(3)
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               tn.output(x).detach().numpy(), rtol=RTOL32,
                               atol=1e-6)


def test_moe_lm_builds_through_the_zoo_and_its_json_crosses_both_ways():
    jconf = JLM(**LM).init().conf
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json_eq(back.to_json(), jconf.to_json())
    tconf = TransformerLM(**LM).init(device="cpu").conf
    assert [type(lc).__name__ for lc in back.layers] == \
        [type(lc).__name__ for lc in jconf.layers]
    assert back.layers[2].moe_experts == 4
    layer = tmoe_layer.MixtureOfExpertsLayer(n_out=8, n_experts=2,
                                             hidden=16)
    jlayer = jmoe_layer.MixtureOfExpertsLayer(n_out=8, n_experts=2,
                                              hidden=16)
    from deeplearning4j_tpu.utils import serde as jserde
    from deeplearning4j_tpu_torch.utils import serde as tserde
    assert json_eq(tserde.to_json(layer), jserde.to_json(jlayer))
    again = tserde.from_json(jserde.to_json(jlayer))
    assert isinstance(again, tmoe_layer.MixtureOfExpertsLayer)
    assert JMLC.from_json(tconf.to_json()).layers[3].moe_experts == 4


def json_eq(a, b):
    import json
    return json.loads(a) == json.loads(b)


@pytest.mark.parametrize("mode", ["float32", "remat", "bfloat16"])
def test_aux_term_in_the_objective_under_remat_and_bf16(mode):
    """A step's loss is the data term plus the blocks' weighted aux
    terms: against a twin with aux weight 0 (the same routing, the aux
    term left out) on the same params and batch, the losses differ by
    the aux the step left in the state."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    nets = []
    for weight in (0.01, 0.0):
        conf = TransformerLM(**LM, compute_dtype="bfloat16"
                             if mode == "bfloat16" else None).conf()
        if mode == "remat":
            conf.defaults["cache_mode"] = "remat"
        for lc in conf.layers[2:4]:
            lc.aux_loss_weight = weight
        nets.append(MultiLayerNetwork(conf, device="cpu").init())
    with_aux, without = nets
    without.load_params({k: {n: p.detach().numpy() for n, p in g.items()}
                         for k, g in with_aux.params.items()})
    x, y = _lm_batch(2)
    with_aux.fit(x, y)
    without.fit(x, y)
    aux = sum(float(with_aux.state[k]["aux_loss"])
              for k in ("layer_2", "layer_3"))
    assert aux > 0
    # the two losses are ~2.5 apiece and agree to f32 (bf16) rounding of
    # their own size; the aux terms are ~1e-2
    tol = 2e-2 if mode == "bfloat16" else 1e-5
    np.testing.assert_allclose(with_aux.get_score() - without.get_score(),
                               aux, rtol=0, atol=tol * with_aux.get_score())
    assert all(t.dtype == torch.float32 for g in with_aux.params.values()
               for t in g.values())


def test_generation_refuses_an_aux_loss_stack():
    net = TransformerLM(**LM).init(device="cpu")
    eng = GenerationEngine.for_model(
        net, GenerationConfig(max_slots=2, max_seq=16, block_size=4),
        start=False)
    try:
        with pytest.raises(ValueError, match="AUX_LOSS"):
            eng.warmup()
    finally:
        eng.shutdown()
