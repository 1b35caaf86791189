"""Attention stacks trained with dropout, the port against the JAX
package: the TransformerLM with input dropout on every block, and an
attention LM whose MultiHeadAttention layers also drop their output
(``attn_dropout``, drawn from ``fold_in(key, 7)``).  The JAX package's
TransformerBlock builds its attention without ``attn_dropout``, so the
port's does too; the attention stack carries it.

vocab 32, seq 128, embed 128, 2 heads (head_dim 64): the port takes the
flash path (its plain twin on CPU tensors, forward and backward), JAX on
the CPU ``sdpa_reference``.  x64 is off on the JAX side, its production
setting, so the dropout masks are the same bits on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss_state
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

VOCAB, SEQ, EMBED, HEADS = 32, 128, 128, 2
BATCH, STEPS, LR = 3, 3, 1e-4
# Losses: a mean over 3 rows of sums over 128 steps of log-softmax
# terms; flash (plain twin) against reference attention and other
# matmul tilings move them ~1e-7 relative: 1e-6.
RTOL_LOSS = 1e-6
# Params after 3 Sgd steps at lr 1e-4: each step moves a param by
# lr·|g| <= 1e-2 and the gradients agree within ~1e-5 of each leaf's
# largest |g| (tests/test_torch_training.py): 1e-6 abs.
ATOL_PARAMS = 1e-6


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _transformer_lm():
    jn = JTransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                        n_layers=2, n_heads=HEADS, sparse_labels=True,
                        updater=JSgd(learning_rate=LR)).init()
    for lc in jn.conf.layers[2:-1]:
        lc.dropout = 0.9
    jn.invalidate_compile_cache()
    return jn


def _attention_lm():
    conf = (NeuralNetConfiguration.builder().seed(11)
            .updater(JSgd(learning_rate=LR)).weight_init("xavier").list()
            .layer(jff.EmbeddingSequenceLayer(n_out=EMBED))
            .layer(jatt.PositionalEncodingLayer()))
    for _ in range(2):
        conf = conf.layer(jatt.MultiHeadAttention(
            n_heads=HEADS, causal=True, attn_impl="reference",
            attn_dropout=0.8, dropout=0.9, activation="identity"))
    conf = (conf.layer(jrec.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                           loss="sparse_mcxent"))
            .set_input_type(JIT.recurrent(VOCAB, SEQ)).build())
    return JMLN(conf).init()


@pytest.mark.parametrize("build", [_transformer_lm, _attention_lm],
                         ids=["transformer_lm_block_dropout",
                              "attention_lm_attn_dropout"])
def test_dropout_training_matches_jax(build, tmp_path, monkeypatch):
    jn = build()
    write_model(jn, str(tmp_path / "lm.zip"))
    tn = load_reference_model(tmp_path / "lm.zip", device="cpu")
    for lc in tn.conf.layers:
        if hasattr(lc, "attn_impl"):
            lc.attn_impl = "flash"       # the kernel route's plain twin
    calls = {"fwd": 0, "bwd": 0}
    for name in ("fwd", "bwd"):
        real = getattr(fa, f"flash_attention_{name}_plain")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(fa, f"flash_attention_{name}_plain", counted)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ))
    y = rng.integers(0, VOCAB, (BATCH, SEQ))
    for step in range(STEPS):
        jn.fit(ids, y)
        tn.fit(ids, y)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS, err_msg=f"step {step}")
    assert calls == {"fwd": 2 * STEPS, "bwd": 2 * STEPS}
    for k, group in jn.params.items():
        for n, a in group.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), atol=ATOL_PARAMS,
                                       rtol=0, err_msg=f"{k}/{n}")
    # dropout was on: the step's key moves the loss off the no-key one
    key = _random.split(tn._rng)[1]
    with torch.no_grad():
        on, off = (float(_stack_loss_state(
            tn.conf, tn.params, tn.state, torch.as_tensor(ids),
            torch.as_tensor(y), train=True, key=k)[0]) for k in (key, None))
    assert abs(on - off) > 1e-4 * abs(off)
