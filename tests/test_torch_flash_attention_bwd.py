"""The port's flash-attention backward (the plain tiled replay on the CPU)
against the JAX package's Pallas backward kernels run in interpret mode,
and the differentiable fallback against the reference's VJP.

The two CUDA backward kernels are held against the plain version on the
card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.ops import flash_attention as jflash
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tflash

# f32 on both sides; only the order of f32 sums differs (the reference
# tiles by up to 256 rows, the port by 64).  Gradients reach |g| ~ 4 and
# sum over up to 256 keys or queries: 1e-5 abs, ~10 f32 ulps at that
# magnitude.
ATOL = 1e-5


def _arrays(b=2, h=2, t=128, d=64, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(n)]


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _port_grads(q, k, v, do, causal):
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal)
    return torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(100, 64), (128, 64), (256, 64),
                                 (128, 128)])
def test_autograd_matches_pallas_backward_interpret(t, d, causal):
    q, k, v, do = _arrays(t=t, d=d, seed=t + d + causal)

    def loss(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(q_, k_, v_, causal=causal,
                                              interpret=True) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 256])
def test_bwd_plain_matches_reference_flash_bwd(t, causal):
    q, k, v, do = (x.reshape(4, t, 64) for x in
                   _arrays(t=t, seed=7 + t + causal))
    scale = 64 ** -0.5
    bq, bk = jflash._auto_blocks(t, t, 64)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jflash._flash_fwd_call(jq, jk, jv, scale, causal, bq, bk, True)
    want = jflash._flash_bwd(scale, causal, bq, bk, True,
                             (jq, jk, jv, o, lse), jdo)
    got = tflash.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(o), _t(np.asarray(lse)[:, 0, :]), _t(do),
        causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_path_gradcheck_float64(causal):
    # t = 8, d = 64: one tile, so the flash path (not the fallback) runs
    rng = np.random.default_rng(11 + causal)
    q, k, v = (torch.tensor(rng.standard_normal((1, 1, 8, 64)),
                            dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    assert tflash.supports(8, 8, 64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tflash.flash_attention(a, b, c, causal=causal),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_fallback_shape_differentiates_through_sdpa_reference():
    q, k, v, do = _arrays(t=7, d=5, seed=5)
    before = dict(tflash.launches)
    got = _port_grads(q, k, v, do, causal=True)
    assert tflash.launches == before

    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    ref = tattn.sdpa_reference(tq, tk, tv, causal=True)
    want_t = torch.autograd.grad((ref * _t(do)).sum(), (tq, tk, tv))

    def loss(q_, k_, v_):
        return jnp.sum(jattn.sdpa_reference(q_, k_, v_, causal=True) * do)

    want_j = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, wt, wj in zip(got, want_t, want_j):
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_reference_vjp_matches_jax(causal):
    # the fallback under autograd gives the reference's VJP, key-padding
    # mask and offsets included
    q, k, v, do = _arrays(t=24, d=8, seed=3)
    mask = (np.arange(24)[None, :] < np.array([[20], [24]])).astype(
        np.float32)

    def loss(q_, k_, v_):
        out = jattn.sdpa_reference(q_, k_, v_, mask=jnp.asarray(mask),
                                   causal=causal, q_offset=2)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    out = tattn.sdpa_reference(tq, tk, tv, mask=_t(mask), causal=causal,
                               q_offset=2)
    got = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_plain_backward_on_cpu_counts_no_launches():
    q, k, v, do = (_t(x.reshape(4, 128, 64)) for x in _arrays())
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    before = dict(tflash.launches)
    dq, dk, dv = tflash.flash_attention_bwd(q, k, v, o, lse, do, True, 0.125)
    assert tflash.launches == before
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert dq.dtype == q.dtype


def test_inference_saves_nothing_for_backward():
    q, k, v = (_t(x, grad=True) for x in _arrays(n=3))
    with torch.no_grad():
        out = tflash.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = tflash.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None


def test_reset_launches_zeroes_every_count():
    tflash.launches["fwd"] += 1
    tflash.reset_launches()
    assert tflash.launches == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def test_bwd_refuses_a_device_without_a_kernel():
    q = torch.zeros(2, 64, 64, device="meta")
    lse = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tflash.flash_attention_bwd(q, q, q, q, lse, q, True, 0.125)
