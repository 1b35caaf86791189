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
from chip_smoke import TOL_LSE, TOL_O

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
@pytest.mark.parametrize("t,d", [
    pytest.param(100, 64, id="100"), pytest.param(128, 64, id="128"),
    pytest.param(256, 64, id="256"), pytest.param(128, 128, id="128-d128"),
    pytest.param(128, 256, id="128-d256")])
def test_plain_forward_matches_pallas_interpret(t, d, causal):
    q, k, v = _qkv(t=t, d=d, seed=t + causal + (d != 64) * d)
    b, h = q.shape[:2]
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
    before = dict(tflash.launches)
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
    before = dict(tflash.launches)
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    assert tflash.launches == before
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (4, 128)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "noncontig",
                                 "shape", "misaligned", "head_dim_96"])
def test_kernel_input_checks(bad):
    q = torch.zeros(4, 128, 64)
    k = torch.zeros(4, 128, 64)
    v = torch.zeros(4, 128, 64)
    match = None
    if bad == "dtype":
        q, k, v = (x.double() for x in (q, k, v))
    elif bad == "head_dim":
        # past the card's shared memory: the error gives d and the limit
        q, k, v = (torch.zeros(4, 128, 320) for _ in range(3))
        match = "head_dim 320 > 256"
    elif bad == "head_dim_96":
        q, k, v = (torch.zeros(4, 128, 96) for _ in range(3))
        match = "head_dim in"
    elif bad == "noncontig":
        q = torch.zeros(4, 64, 128).transpose(1, 2)
    elif bad == "misaligned":
        q = torch.zeros(4 * 128 * 64 + 1)[1:].view(4, 128, 64)
        match = "16-byte"
    else:
        k = torch.zeros(4, 64, 64)
    with pytest.raises(ValueError, match=match):
        tflash._check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_door_admits_every_head_dim_supports_admits(d, dtype):
    assert tflash.supports(512, 512, d)
    q, k, v = (torch.zeros(4, 128, d, dtype=dtype) for _ in range(3))
    tflash._check_kernel_inputs(q, k, v)
    tflash._check_kernel_inputs(q, k, v, (("o", q), ("do", q)),
                                who="flash_attention_bwd")


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384])
def test_kernel_rule_is_tighter_than_the_reference_above_head_dim_256(
        d, monkeypatch):
    """The North star's "same support rules", tightened where Hopper must:
    the reference runs its Pallas kernel at any head_dim that is a
    multiple of 64; the port's kernels are built up to 256 (their f32 tiles
    fill a block's shared memory), so ``flash_attention`` takes
    ``sdpa_reference`` above it, on every device, by that rule and not by
    a failed launch."""
    assert tflash.supports(512, 512, d)
    assert tflash.kernel_supports(512, 512, d) == (d <= 256)
    calls = []
    monkeypatch.setattr(tflash, "flash_attention_fwd",
                        lambda *a, **k: calls.append("kernel") or
                        tflash.flash_attention_fwd_plain(
                            *a, k["causal"], k["scale"]))
    monkeypatch.setattr(tflash, "sdpa_reference",
                        lambda *a, **k: calls.append("sdpa") or
                        tattn.sdpa_reference(*a, **k))
    q, k, v = (_t(x) for x in _qkv(b=1, h=1, t=128, d=d, seed=d))
    tflash.flash_attention(q, k, v, causal=True)
    assert calls == (["kernel"] if d <= 256 else ["sdpa"])


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_320_matches_the_reference_forward_and_gradients(causal):
    """d = 320, which the reference's Pallas kernel takes and the port's
    kernels do not: ``flash_attention`` (``sdpa_reference`` under
    autograd) against the reference's ``flash_attention`` in interpret
    mode, forward and gradients, at the tolerances of the flash path."""
    import jax
    from test_torch_flash_attention_bwd import ATOL as ATOL_BWD
    q, k, v, do = _qkv(b=1, h=2, t=128, d=320, seed=320 + causal) + \
        _qkv(b=1, h=2, t=128, d=320, seed=1320 + causal)[:1]

    def loss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, causal=causal,
                                     interpret=True)
        return jnp.sum(out * do), out

    (_, want), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    got_g = torch.autograd.grad((got * _t(do)).sum(), (tq, tk, tv))
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_BWD,
                                   rtol=0)


def _truncate_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` to f32 rounded toward zero, as the tensor cores drop the
    low bits of their f32 sums."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tf32_products(terms: int, tensor_core_sums: str = None):
    """A matmul taken the way the forward kernel takes it: three TF32
    products of the split operands, small terms first, summed in f32; or
    (terms = 1) one TF32 product of the operands rounded to nearest.

    ``tensor_core_sums`` models the mma's own sums per k-step of 8: each
    of the three products' partial sums is added exactly and the result
    truncated toward zero in f32, either ``"straight"`` into the running
    accumulator or ``"zeroed"`` into a zeroed tile that is then added to
    the accumulator rounding to nearest (csrc/flash_attn_fwd.cu)."""
    def mm(a, b):
        if terms == 1:
            return torch.matmul(tflash._tf32_rna(a), tflash._tf32_rna(b))
        (ah, al), (bh, bl) = tflash._tf32_split(a), tflash._tf32_split(b)
        if tensor_core_sums is None:
            small = torch.matmul(al, bh) + torch.matmul(ah, bl)
            return small + torch.matmul(ah, bh)
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
        for k0 in range(0, a.shape[-1], 8):
            ks = slice(k0, k0 + 8)
            # 8 products of two 11-bit significands: exact in f64
            parts = [torch.matmul(x[..., ks].double(), y[..., ks, :].double())
                     for x, y in ((al, bh), (ah, bl), (ah, bh))]
            if tensor_core_sums == "straight":
                for part in parts:
                    acc = _truncate_f32(acc.double() + part)
            else:
                tile = torch.zeros_like(acc)
                for part in parts:
                    tile = _truncate_f32(tile.double() + part)
                acc = acc + tile
        return acc
    return mm


def test_tf32_split_is_exact_in_tf32_and_close_to_f32():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32) * 50)
    hi, lo = tflash._tf32_split(x)
    for part in (hi, lo):      # 10 mantissa bits: the low 13 are zero
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
    # hi is the nearest TF32 value: x is within half of hi's spacing
    spacing = 2.0 ** (torch.floor(torch.log2(hi.abs())) - 10)
    assert ((x - hi).abs() <= spacing / 2).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(8, 512, 64), (4, 256, 256)])
def test_three_tf32_products_keep_f32_accuracy(shape, causal):
    """The forward kernel's arithmetic at the model's shape: O and lse
    through 3xTF32 products stay within chip_smoke's kernel-vs-plain
    tolerance of the f32 forward; one TF32 product does not."""
    rng = np.random.default_rng(shape[2] + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    scale = shape[2] ** -0.5
    o, lse = tflash.flash_attention_fwd_plain(q, k, v, causal, scale)
    o3, lse3 = tflash.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                matmul=_tf32_products(3))
    o1, lse1 = tflash.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                matmul=_tf32_products(1))
    assert (o3 - o).abs().max().item() <= TOL_O["float32"]
    assert (lse3 - lse).abs().max().item() <= TOL_LSE
    one_pass = max((o1 - o).abs().max().item(),
                   (lse1 - lse).abs().max().item())
    assert one_pass > TOL_O["float32"], one_pass


@pytest.mark.parametrize("causal", [False, True])
def test_truncating_tensor_core_sums_need_a_zeroed_tile(causal):
    """The tensor cores truncate their f32 sums.  Three mma per k-step
    straight into the running accumulator bias it toward zero, which put
    the kernel's first design several times farther from the f64 forward
    than the plain f32 forward is; each k-step's products in a zeroed
    tile, added rounding to nearest, keep the kernel as close as f32.
    At the model's shape, against the f64 forward, within one key tile."""
    shape = (8, 512, 64)
    rng = np.random.default_rng(64 + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    scale = shape[2] ** -0.5
    o64, lse64 = tflash.flash_attention_fwd_plain(
        q.double(), k.double(), v.double(), causal, scale)

    def err(matmul):
        o, lse = tflash.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                  matmul=matmul)
        return max((o.double() - o64).abs().max().item(),
                   (lse.double() - lse64).abs().max().item())

    f32 = err(torch.matmul)
    zeroed = err(_tf32_products(3, "zeroed"))
    straight = err(_tf32_products(3, "straight"))
    assert zeroed <= 1.25 * f32, (zeroed, f32)
    assert straight >= 2 * f32, (straight, f32)
