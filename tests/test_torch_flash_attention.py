"""The port's flash-attention forward (plain path on the CPU) against the
JAX package's Pallas kernel run in interpret mode, and the port's
``supports``/fallback rule against the reference's.

The CUDA kernel itself is held against the plain path on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.ops import flash_attention as jflash
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tflash

# f32 on both sides; only the order of f32 sums differs (block sizes
# differ: the reference tiles by up to 256 rows, the port by 64).
ATOL = 2e-5


def _qkv(b=2, h=2, t=128, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 128, 256])
def test_plain_forward_matches_pallas_interpret(t, causal):
    q, k, v = _qkv(t=t, seed=t + causal)
    b, h, _, d = q.shape
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    # O and lse straight from the reference's kernel call
    bq, bk = jflash._auto_blocks(t, t, d)
    o_ref, lse_ref = jflash._flash_fwd_call(
        *(jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v)),
        d ** -0.5, causal, bq, bk, True)
    o, lse = tflash.flash_attention_fwd_plain(
        *(_t(x.reshape(b * h, t, d)) for x in (q, k, v)), causal, d ** -0.5)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, 0, :],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,d", [(64, 64), (100, 64), (128, 32),
                                 (192, 64), (256, 128), (384, 64),
                                 (200, 64), (512, 192), (7, 5)])
def test_supports_rule_matches_reference(t, d):
    bq, bk = jflash._auto_blocks(t, t, d)
    want = t % bq == 0 and t % bk == 0 and d % 64 == 0
    assert tflash.supports(t, t, d) == want


def test_flash_attention_fallback_on_odd_shapes():
    q, k, v = _qkv(t=7, d=5)
    before = tflash.launches
    out = tflash.flash_attention(_t(q), _t(k), _t(v))
    ref = tattn.sdpa_reference(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    jref = jattn.sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=1e-6)
    assert tflash.launches == before


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_reference_matches_jax(causal):
    q, k, v = _qkv(t=24, d=8, seed=3)
    mask = (np.arange(24)[None, :] < np.array([[20], [24]])).astype(
        np.float32)
    want = jattn.sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask=jnp.asarray(mask),
                                causal=causal, q_offset=2)
    got = tattn.sdpa_reference(_t(q), _t(k), _t(v), mask=_t(mask),
                               causal=causal, q_offset=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fully_masked_rows_give_zeros_not_nan():
    # t_q rows before any key under a causal mask: keys start past them
    q, k, v = (_t(x[0]) for x in _qkv(b=1, h=1, t=64, d=64, seed=4))
    q = q.reshape(1, 64, 64)
    o, lse = tflash.flash_attention_fwd_plain(
        q, k.reshape(1, 64, 64)[:, :0], v.reshape(1, 64, 64)[:, :0],
        False, 0.125)
    assert torch.all(o == 0) and torch.all(lse == tattn.NEG_INF)


def test_plain_forward_on_cpu_does_not_count_launches():
    q, k, v = (_t(x.reshape(4, 128, 64)) for x in _qkv())
    before = tflash.launches
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    assert tflash.launches == before
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (4, 128)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "noncontig",
                                 "shape"])
def test_kernel_input_checks(bad):
    q = torch.zeros(4, 128, 64)
    k = torch.zeros(4, 128, 64)
    v = torch.zeros(4, 128, 64)
    if bad == "dtype":
        q, k, v = (x.double() for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(4, 128, 192) for _ in range(3))
    elif bad == "noncontig":
        q = torch.zeros(4, 64, 128).transpose(1, 2)
    else:
        k = torch.zeros(4, 64, 64)
    with pytest.raises(ValueError):
        tflash._check_kernel_inputs(q, k, v)
