"""The flash backward kernels' arithmetic on the CPU: the plain backward
run through the 3xTF32 products of ``csrc/flash_attn_bwd.cu`` (its
``matmul`` argument) against the f32 and f64 backward and against the JAX
package's Pallas backward in interpret mode.

The CUDA kernels themselves are held against the plain backward on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jflash
from deeplearning4j_tpu_torch.ops import flash_attention as tflash
from chip_smoke import TOL_BWD
from test_torch_flash_attention import _tf32_products
from test_torch_flash_attention_bwd import ATOL


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(4)]


def _rel(got, want):
    """max |got − want| / max |want| per gradient, as chip_smoke holds the
    kernels against the plain backward."""
    return max(((g.double() - w.double()).abs().max()
                / w.double().abs().max()).item() for g, w in zip(got, want))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(8, 512, 64), (4, 256, 256)])
def test_three_tf32_products_keep_the_backward_at_f32_accuracy(shape,
                                                               causal):
    """dq, dk and dv through the kernels' 3xTF32 products stay within
    chip_smoke's kernel-vs-plain tolerance of the f32 backward at the
    model's shape and at head_dim 256; one TF32 product does not."""
    q, k, v, do = _inputs(shape, shape[2] + causal)
    scale = shape[2] ** -0.5
    o, lse = tflash.flash_attention_fwd_plain(q, k, v, causal, scale)
    f32 = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                           scale)
    three = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                             scale, matmul=_tf32_products(3))
    one = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                           scale, matmul=_tf32_products(1))
    assert _rel(three, f32) <= TOL_BWD["float32"]
    one_pass = _rel(one, f32)
    assert one_pass > TOL_BWD["float32"], one_pass


@pytest.mark.parametrize("causal", [False, True])
def test_key_bias_gradient_noise_needs_a_zeroed_tile(causal):
    """sum_j dk_j is zero in exact arithmetic (sum_j dS_ij = 0 for every
    query), so the TransformerLM's key-bias gradient is the rounding noise
    of the dk/dv kernel.  Against the f64 backward, at the model's shape,
    each k-step's three products in a zeroed tile added rounding to
    nearest keep that noise at the f32 backward's level (measured: 0.56x
    and 0.82x of it); three mma straight into the running accumulators,
    whose sums the tensor cores truncate, give 2.8x and 3.9x."""
    shape = (8, 512, 64)
    q, k, v, do = _inputs(shape, 64 + causal)
    scale = shape[2] ** -0.5
    o64, lse64 = tflash.flash_attention_fwd_plain(
        q.double(), k.double(), v.double(), causal, scale)
    _, dk64, _ = tflash.flash_attention_bwd_plain(
        q.double(), k.double(), v.double(), o64, lse64, do.double(), causal,
        scale)
    o, lse = o64.float(), lse64.float()

    def noise(matmul):
        _, dk, _ = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal, scale,
                                                    matmul=matmul)
        return (dk.double().sum(1) - dk64.sum(1)).abs().max().item()

    f32 = noise(torch.matmul)
    zeroed = noise(_tf32_products(3, "zeroed"))
    straight = noise(_tf32_products(3, "straight"))
    assert zeroed <= 1.25 * f32, (zeroed, f32)
    assert straight >= 2 * f32, (straight, f32)


@pytest.mark.parametrize("products", ["f32", "3xtf32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 256])
def test_bwd_plain_with_matmul_matches_reference_flash_bwd(t, causal,
                                                           products):
    """The plain backward with its ``matmul`` argument, f32 products or
    the kernels' 3xTF32 ones, against the reference's ``_flash_bwd``
    (Pallas, interpret mode) at the tolerance of
    ``test_bwd_plain_matches_reference_flash_bwd``."""
    rng = np.random.default_rng(17 + t + causal)
    q, k, v, do = (rng.standard_normal((4, t, 64)).astype(np.float32)
                   for _ in range(4))
    scale = 64 ** -0.5
    bq, bk = jflash._auto_blocks(t, t, 64)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jflash._flash_fwd_call(jq, jk, jv, scale, causal, bq, bk, True)
    want = jflash._flash_bwd(scale, causal, bq, bk, True,
                             (jq, jk, jv, o, lse), jdo)
    matmul = torch.matmul if products == "f32" else _tf32_products(3)
    got = tflash.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(lse)[:, 0, :]), torch.from_numpy(do),
        causal, scale, matmul=matmul)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
