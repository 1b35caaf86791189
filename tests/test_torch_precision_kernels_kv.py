"""The low-precision paths of the kernels' plain twins, the graph and the
attention carries under a precision policy, and the int8 paged KV pool,
against the JAX package on the CPU (its Pallas kernels in interpret
mode), mirroring ``tests/test_graph.py::test_graph_bf16_and_remat``,
``tests/test_attention.py::test_transformer_carry_parity_bf16_precision_policy``
and ``tests/test_paged_kv.py::TestInt8KV``.

Tolerances:
- Flash forward O, bf16/f16 inputs: ``chip_smoke.TOL_O`` (2e-2 bf16,
  4e-3 f16): both sides widen to f32 and round O once, one ulp of the
  input type apart at |O| < 4; lse (f32 on both sides) 2e-5, the f32
  tolerance of ``test_torch_flash_attention.py``.
- Flash backward: ``chip_smoke.TOL_BWD`` relative to each gradient's
  largest entry (1.6e-2 bf16, 2e-3 f16): the f32 results are rounded to
  the input type separately.
- BN apply: one ulp of the input type of the largest |x·scale| + |shift|
  (the Pallas kernel may round x·scale before adding shift in the input
  type; the port's twin rounds once).
- int8 codes and scales: exact (the same f32 division, rounding half to
  even).  Greedy streams: at most one of three prompts may differ (the
  JAX test's gate: quantization moves logits by ~1 %, a tied argmax may
  flip one tail token).
- Graph under bf16 + remat: each step's loss, the port starting every
  step from the JAX package's params and Adam state, 2e-3 relative.  XLA
  adds the bias inside the product's f32 epilogue and rounds once; torch
  rounds the bf16 product, then the sum: one bf16 ulp (2**-9 relative)
  per activation once the biases are no longer 0 (measured 9.4e-4 over 15
  steps; exact at step 0, where the biases are 0).  Left to run on their
  own, Adam amplifies such differences (1.3e-2 after 15 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_BWD, TOL_O
from deeplearning4j_tpu.generation import GenerationConfig as JConfig
from deeplearning4j_tpu.generation import GenerationEngine as JEngine
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf.computation_graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import \
    EmbeddingSequenceLayer as JEmb
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers.recurrent import \
    RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.precision import PrecisionPolicy as JPolicy
from deeplearning4j_tpu.ops import flash_attention as jflash
from deeplearning4j_tpu.ops import pallas_bn as jbn
from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                 GenerationEngine)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as tflash
from deeplearning4j_tpu_torch.ops import pallas_bn as tbn
from deeplearning4j_tpu_torch.utils.model_serializer import (
    params_from_jax, state_from_jax, updater_state_from_jax)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ATOL_LSE = 2e-5
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
RTOL_GRAPH = 2e-3


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _twin(jn, cls=MultiLayerNetwork, conf_cls=MultiLayerConfiguration):
    tn = cls(conf_cls.from_json(jn.conf.to_json()), device="cpu").init()
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    state_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.state))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    return tn


# ------------------------------------------------- kernels' plain twins
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(128, 64), (100, 128)])
def test_low_precision_plain_forward_matches_pallas_interpret(dt, causal,
                                                              t, d):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(t + d + causal)
    q, k, v = (rng.standard_normal((2, t, d)).astype(np.float32)
               for _ in range(3))
    bq, bk = jflash._auto_blocks(t, t, d)
    o_ref, lse_ref = jflash._flash_fwd_call(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), d ** -0.5, causal, bq,
        bk, True)
    o, lse = tflash.flash_attention_fwd_plain(
        *(torch.tensor(x).to(tdt) for x in (q, k, v)), causal, d ** -0.5)
    assert o.dtype == tdt and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), _np(o_ref), rtol=0,
                               atol=TOL_O[dt])
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref)[:, 0, :],
                               rtol=0, atol=ATOL_LSE)


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
def test_low_precision_plain_backward_matches_pallas_interpret(dt, causal):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(7 + causal)
    q, k, v, do = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
                   for _ in range(4))

    def loss(q_, k_, v_):
        o = jflash.flash_attention(q_, k_, v_, causal=causal,
                                   interpret=True)
        return jnp.sum(o.astype(jnp.float32) * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do).to(tdt))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        w = _np(w)
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= TOL_BWD[dt], err


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("relu", [False, True])
def test_low_precision_bn_apply_plain_matches_pallas_interpret(dt, relu):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(11 + relu)
    x = (rng.standard_normal((64, 128)) * 2 + 0.5).astype(np.float32)
    sc, sh = (rng.standard_normal((1, 128)).astype(np.float32)
              for _ in range(2))
    want = _np(jbn._apply(*(jnp.asarray(a, jdt) for a in (x, sc, sh)),
                          relu, True))
    tx, tsc, tsh = (torch.tensor(a).to(tdt) for a in (x, sc[0], sh[0]))
    got = tbn.bn_apply(tx, tsc, tsh, relu)
    assert got.dtype == tdt and tbn.launches["bn_apply"] == 0
    xs = tx.float() * tsc.float()
    tol = ULP[dt] * (xs.abs() + tsh.float().abs()).max().item()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_kernel_doors_take_f16_and_never_route_it_elsewhere(monkeypatch):
    """An f16 tensor at the flash door is the kernel's (dtype code 2): on
    a CUDA tensor the door launches or raises, and ``flash_attention``
    takes the kernel path for it, never ``sdpa_reference``."""
    assert tflash.KERNEL_DTYPES[torch.float16] == 2
    assert tbn.KERNEL_DTYPES[torch.float16] == 2
    q = torch.zeros(4, 128, 64, dtype=torch.float16)
    tflash._check_kernel_inputs(q, q, q)
    tbn._check_kernel_inputs(torch.zeros(8, 64, dtype=torch.float16),
                             torch.zeros(64, dtype=torch.float16),
                             torch.zeros(64, dtype=torch.float16))
    calls = []
    monkeypatch.setattr(tflash, "sdpa_reference",
                        lambda *a, **k: calls.append("sdpa"))
    x = torch.randn(1, 2, 128, 64).to(torch.float16)
    out = tflash.flash_attention(x, x, x, causal=True)
    assert out.dtype == torch.float16 and calls == []


# ------------------------------------------------ graph, attention carries
def test_graph_bf16_and_remat_matches_jax():
    """``test_graph_bf16_and_remat``: a graph under compute_dtype bfloat16
    and cache_mode remat trains as the JAX package's, masters f32."""
    g = JGB({"updater": JAdam(learning_rate=0.05),
             "compute_dtype": "bfloat16", "cache_mode": "remat"})
    g.add_inputs("in").set_input_types(JIT.feed_forward(4))
    g.add_layer("h", JDense(n_out=8, activation="relu"), "in")
    g.add_layer("out", JOut(n_out=2, activation="softmax", loss="mcxent"),
                "h")
    g.set_outputs("out")
    jn = JCG(g.build()).init()
    tn = _twin(jn, ComputationGraph, ComputationGraphConfiguration)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    losses = []
    for _ in range(15):
        # each step from the JAX package's params and Adam state: the
        # step's loss is the forward of the same params on both sides
        tn = _twin(jn, ComputationGraph, ComputationGraphConfiguration)
        jn.fit([x], [y])
        tn.fit([x], [y])
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL_GRAPH)
        losses.append(tn.get_score())
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in tn.params.parameters())


def test_transformer_carry_parity_bf16_precision_policy():
    """``test_transformer_carry_parity_bf16_precision_policy``: a bf16
    policy stack's ``rnn_time_step`` loop matches its full forward (the
    inference paths ignore the policy, on both sides) and the JAX
    package's output."""
    lb = (JNNC.builder().seed(11).weight_init("xavier")
          .precision("bfloat16").list()
          .layer(jatt.PositionalEncodingLayer())
          .layer(jatt.TransformerBlock(n_heads=2, ffn_mult=2, causal=True,
                                       attn_impl="reference"))
          .layer(JRnnOut(n_out=5, activation="softmax", loss="mcxent")))
    jn = JMLN(lb.set_input_type(JIT.recurrent(6, 10)).build()).init()
    tn = _twin(jn)
    x = np.random.default_rng(12).standard_normal((2, 10, 6)).astype(
        np.float32)
    full = tn.output(x).numpy()
    np.testing.assert_allclose(full, np.asarray(jn.output(x)), atol=1e-5)
    tn.rnn_clear_previous_state()
    inc = np.stack([tn.rnn_time_step(x[:, t:t + 1])[:, 0].numpy()
                    for t in range(10)], axis=1)
    np.testing.assert_allclose(inc, full, rtol=0.06, atol=0.02)
    assert (inc.argmax(-1) == full.argmax(-1)).mean() > 0.9


# ---------------------------------------------------------- int8 KV pool
def test_kv_quantize_codes_and_scales_equal_jax():
    rng = np.random.default_rng(3)
    for shape, scale in (((5, 2, 8), 1.0), ((7, 4, 16), 30.0),
                         ((3, 2, 8), 1e-3)):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        x[0, 0] = 0.0                           # an all-zero row: 1e-8 floor
        x[1, 0, :2] = [0.5 * 127, -0.5 * 127]   # ties round half to even
        jq, js = jatt._kv_quantize(jnp.asarray(x))
        tq, ts = tatt._kv_quantize(torch.tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _int8_lm(jax_side, kv_dtype=None, seed=5):
    """The JAX test's hand-built TransformerLM stack with a policy that
    carries ``kv_dtype`` (the port's built from the JAX conf JSON)."""
    b = (JNNC.builder().seed(seed).updater(JAdam(learning_rate=3e-4))
         .weight_init("xavier"))
    if kv_dtype is not None:
        b = b.precision(JPolicy(kv_dtype=kv_dtype))
    lb = (b.list().layer(JEmb(n_out=16))
          .layer(jatt.PositionalEncodingLayer())
          .layer(jatt.TransformerBlock(n_heads=2, causal=True))
          .layer(jatt.TransformerBlock(n_heads=2, causal=True))
          .layer(JRnnOut(n_out=32, activation="softmax", loss="mcxent")))
    jn = JMLN(lb.set_input_type(JIT.recurrent(32, 32)).build()).init()
    return jn, _twin(jn)


def test_int8_kv_halves_cache_bytes_with_greedy_parity():
    """``test_int8_kv_halves_cache_bytes_with_greedy_parity``: the int8
    pool holds at most half the f32 pool's bytes, its greedy streams
    equal the f32 pool's in all but at most one of three prompts, the
    JAX package's int8 engine gives the port's streams, and
    ``status()["kv"]`` names the pool."""
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8]]
    cfg = dict(max_slots=2, max_seq=32, block_size=4)
    out, nbytes = {}, {}
    for kv in (None, "int8"):
        jn, tn = _int8_lm(True, kv)
        eng = GenerationEngine.for_model(tn, GenerationConfig(**cfg))
        try:
            out[kv] = [eng.generate(p, max_new_tokens=8).tokens
                       for p in prompts]
            nbytes[kv] = eng.ring.cache_bytes
            assert eng.status()["kv"]["kv_dtype"] == (kv or "float32")
        finally:
            eng.shutdown()
        jeng = JEngine.for_model(jn, JConfig(**cfg))
        try:
            jout = [jeng.generate(p, max_new_tokens=8, timeout=60).tokens
                    for p in prompts]
            assert nbytes[kv] == jeng.ring.cache_bytes
        finally:
            jeng.shutdown()
        assert out[kv] == jout, (kv, out[kv], jout)
    assert nbytes["int8"] <= 0.5 * nbytes[None]
    same = sum(int(g == w) for g, w in zip(out["int8"], out[None]))
    assert same >= len(prompts) - 1

