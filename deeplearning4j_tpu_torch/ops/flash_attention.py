"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain twins.

Port of ``deeplearning4j_tpu/ops/flash_attention.py``.  Its three Pallas
kernels become two CUDA sources, built for ``sm_90a`` at first use and
bound with ``ctypes``:

- ``_flash_kernel`` (launched by ``_flash_fwd_call``) ->
  ``csrc/flash_attn_fwd.cu``;
- ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (launched by
  ``_flash_bwd``) -> the two entry points of ``csrc/flash_attn_bwd.cu``.

``flash_attention_fwd`` and ``flash_attention_bwd`` run the kernels on
CUDA tensors and the plain versions on CPU tensors; on a CUDA tensor they
launch or raise.  ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain`` are the same tiled loops in plain torch
(64-row tiles, stop at the causal diagonal, f32 statistics): the CPU path
and the oracle the kernels are held against on the card.  The kernels pick
their own tile rows for the card's shared memory.  ``_tf32_split`` is the
kernels' split of an f32 operand into two TF32 terms; the CPU tests run
the plain forward and backward through it (their ``matmul`` argument) to
show that three TF32 products keep f32 accuracy and one does not.  The
reference's ``custom_vjp`` becomes ``_FlashAttention``, a
``torch.autograd.Function``.  ``flash_attention`` keeps the reference's
``supports`` rule and its fallback to ``sdpa_reference``, which autograd
differentiates; the kernels' rule is tighter (``kernel_supports``: head_dim
up to 256), and a shape the reference admits beyond it takes
``sdpa_reference`` too, on every device.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Optional, Tuple

import torch

from . import launch_count
from .attention import NEG_INF, sdpa_reference

BLOCK = 64            # q and k tile rows of the plain twins
KERNEL_HEAD_DIMS = (64, 128, 192, 256)
# The kernels are built for head_dim up to 256; their f32 tiles already
# take up to 197 KB (the forward at d = 192) of the 227 KB (232,448 bytes)
# a block may use on Hopper.  ``flash_attention`` sends the wider head_dims
# that ``supports`` admits to ``sdpa_reference`` (``kernel_supports``).
MAX_KERNEL_HEAD_DIM = 256
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SOURCE = "flash_attn_fwd.cu"
BWD_SOURCE = "flash_attn_bwd.cu"

# Kernel launches, one count per kernel, and the same launches by input
# dtype (``{(kernel, dtype name): n}``); each wrapper adds one to both
# where it launches its kernel and nowhere else (``launch_count``: under
# a lock, since replicas of the training masters launch from several
# threads, and into a capture's record while a CUDA graph is captured).
launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
launches_by_dtype: Counter = Counter()

_fns = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_dtype.clear()


def _count(name: str, dtype: torch.dtype) -> None:
    launch_count.count(launches, name)
    launch_count.count(launches_by_dtype,
                       (name, str(dtype).split(".")[-1]))


def _tile_ok(t: int) -> bool:
    # The reference tiles t by the largest power of two >= 128 dividing it
    # (``_auto_blocks``), or by t itself when t <= 128.
    return t <= 128 or t % 128 == 0


def supports(t_q: int, t_k: int, d: int) -> bool:
    """The reference's rule: sequences that tile and a head_dim that is
    a multiple of 64.  Other shapes take ``sdpa_reference``."""
    return _tile_ok(t_q) and _tile_ok(t_k) and d % 64 == 0


def kernel_supports(t_q: int, t_k: int, d: int) -> bool:
    """Where ``flash_attention`` takes the kernels: ``supports`` and a
    head_dim the kernels are built for (at most ``MAX_KERNEL_HEAD_DIM``).
    Tighter than the reference, which runs its Pallas kernel at any
    multiple of 64."""
    return supports(t_q, t_k, d) and d <= MAX_KERNEL_HEAD_DIM


def _causal_live(q0: int, rows: int, n_k: int) -> int:
    """Key tiles a causal q tile starting at ``q0`` sees: up to the one
    holding its last row (``_block_live``)."""
    return min(n_k, (q0 + rows - 1) // BLOCK + 1)


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi + lo ≈ x`` (f32) to ~2⁻²² relative, both
    exact in TF32 (10 mantissa bits): hi is x rounded to nearest TF32, lo
    the remainder rounded the same way, ties away from zero.  The same
    split as ``split_tf32`` in csrc/flash_attn_fwd.cu (two
    ``cvt.rna.tf32.f32``)."""
    hi = _tf32_rna(x.float())
    return hi, _tf32_rna(x.float() - hi)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to nearest TF32, ties away from zero: add half of
    the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    # -0x2000 is 0xffffe000 as int32: it clears the 13 low bits
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def flash_attention_fwd_plain(q, k, v, causal: bool, scale: float,
                              matmul: Callable = torch.matmul
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled online-softmax attention over ``[bh, t, d]``; returns
    ``(O, lse)`` with O in the input dtype and lse ``[bh, t_q]`` in f32.
    ``matmul`` takes both products (S = Q·Kᵀ and P·V)."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc_dt), k.to(acc_dt), v.to(acc_dt)
    out = torch.empty((bh, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    n_k = -(-t_k // BLOCK)
    for q0 in range(0, t_q, BLOCK):
        qt = qf[:, q0:q0 + BLOCK]
        rows = qt.shape[1]
        m = torch.full((bh, rows, 1), NEG_INF, dtype=acc_dt, device=q.device)
        l = torch.zeros((bh, rows, 1), dtype=acc_dt, device=q.device)
        acc = torch.zeros((bh, rows, d), dtype=acc_dt, device=q.device)
        live = _causal_live(q0, rows, n_k) if causal else n_k
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        for k0 in range(0, live * BLOCK, BLOCK):
            kt, vt = kf[:, k0:k0 + BLOCK], vf[:, k0:k0 + BLOCK]
            s = matmul(qt, kt.transpose(1, 2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[1],
                                    device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * (s > NEG_INF / 2)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + matmul(p, vt)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q0 + rows] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + rows] = (m + torch.log(l))[..., 0].to(torch.float32)
    return out, lse


def _rowsum_do_o(do, o) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in f32, ``[bh, t_q]``: the reference computes it
    outside its Pallas calls too."""
    acc_dt = torch.promote_types(do.dtype, torch.float32)
    return (do.to(acc_dt) * o.to(acc_dt)).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              scale: float, matmul: Callable = torch.matmul
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(dq, dk, dv)`` for ``[bh, t, d]`` tensors from the forward's
    ``O`` and ``lse`` (``[bh, t_q]``), replaying each 64x64 softmax block
    as ``_replay_p_ds`` does: P = exp(S − lse)·(S > NEG_INF/2),
    dS = P∘(dP − D)·scale.  Gradients leave in the input dtypes.
    ``matmul`` takes all five products (S, dP, dS·K, dSᵀ·Q, Pᵀ·dO)."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = (x.to(acc_dt) for x in (q, k, v, do))
    dd = _rowsum_do_o(dof, o.to(acc_dt))
    lse = lse.to(acc_dt)
    dq = torch.zeros((bh, t_q, d), dtype=acc_dt, device=q.device)
    dk = torch.zeros((bh, t_k, d), dtype=acc_dt, device=q.device)
    dv = torch.zeros((bh, t_k, d), dtype=acc_dt, device=q.device)
    n_k = -(-t_k // BLOCK)
    for q0 in range(0, t_q, BLOCK):
        qt, dot = qf[:, q0:q0 + BLOCK], dof[:, q0:q0 + BLOCK]
        rows = qt.shape[1]
        lse_t = lse[:, q0:q0 + rows, None]
        dd_t = dd[:, q0:q0 + rows, None]
        live = _causal_live(q0, rows, n_k) if causal else n_k
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        for k0 in range(0, live * BLOCK, BLOCK):
            kt, vt = kf[:, k0:k0 + BLOCK], vf[:, k0:k0 + BLOCK]
            s = matmul(qt, kt.transpose(1, 2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[1],
                                    device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
            p = torch.where(s > NEG_INF / 2, torch.exp(s - lse_t),
                            torch.zeros_like(s))
            dp = matmul(dot, vt.transpose(1, 2))
            ds = p * (dp - dd_t) * scale
            dq[:, q0:q0 + rows] += matmul(ds, kt)
            dk[:, k0:k0 + kt.shape[1]] += matmul(ds.transpose(1, 2), qt)
            dv[:, k0:k0 + kt.shape[1]] += matmul(p.transpose(1, 2), dot)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# C entry point -> (source, pointer arguments).  Each then takes bh, t_q,
# t_k, d and causal as ints, the scale as a float, the dtype code and the
# stream.
_ENTRIES = {"flash_attn_fwd": (SOURCE, 5),
            "flash_attn_bwd_dq": (BWD_SOURCE, 7),
            "flash_attn_bwd_dkv": (BWD_SOURCE, 8)}


def _kernel(name: str):
    """The ctypes function ``name`` from its source, built at first use."""
    fn = _fns.get(name)
    if fn is None:
        from ..utils.kernel_build import load
        source, n_ptr = _ENTRIES[name]
        fn = getattr(load(source), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_kernel_inputs(q, k, v, extra=(), who: str = "flash_attention_fwd"
                         ) -> None:
    """Device, dtype, rank, contiguity and shape checks before a launch;
    ``extra`` are further ``(name, tensor)`` pairs shaped like q (O, dO)."""
    named = [("q", q), ("k", k), ("v", v), *extra]
    for name, x in named:
        if x.device != q.device:
            raise ValueError(f"{who}: {name} is on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{who}: {name} is {x.dtype}, q is {q.dtype}")
        if x.ndim != 3:
            raise ValueError(f"{who}: {name} must be [bh, t, d], got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must start on a 16-byte "
                             f"boundary (the kernels copy 16-byte chunks)")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{who}: the kernel takes float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    bh, _, d = q.shape
    if d > MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"{who}: head_dim {d} > {MAX_KERNEL_HEAD_DIM}: the "
                         "kernels are built for head_dim up to 256, whose "
                         "f32 tiles already take up to 197 KB of the 227 KB "
                         "of shared memory a block may use on Hopper")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{who}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{who}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    for name, x in extra:
        if x.shape != q.shape:
            raise ValueError(f"{who}: {name} {tuple(x.shape)} != q "
                             f"{tuple(q.shape)}")


def _launch(name: str, *args) -> None:
    err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: cudaError_t {err}")


def _cuda_or_raise(x, who: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")


def flash_attention_fwd(q, k, v, *, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` for ``[bh, t, d]`` tensors: the Hopper kernel for CUDA
    tensors, ``flash_attention_fwd_plain`` for CPU tensors."""
    # Replaces the Pallas `_flash_kernel` (deeplearning4j_tpu/ops/
    # flash_attention.py, launched by `_flash_fwd_call`).  On the H100 the
    # f32 kernel is bound by operations: both products run on the tensor
    # cores as three TF32 mma.sync passes (hi·lo + lo·hi + hi·hi, f32
    # accuracy; bf16 and f16, exact in TF32, need one pass for Q·Kᵀ and
    # two for P·V), each warp
    # owning 16 query rows, K/V tiles fetched by cp.async a tile ahead,
    # the longest causal q tiles issued first.  Details in
    # csrc/flash_attn_fwd.cu.
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _cuda_or_raise(q, "flash_attention_fwd")
    _check_kernel_inputs(q, k, v)
    bh, t_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _launch("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), bh, t_q, k.shape[1], d,
                int(causal), float(scale), KERNEL_DTYPES[q.dtype], stream)
    _count("fwd", q.dtype)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for ``[bh, t, d]`` tensors: the two Hopper kernels
    for CUDA tensors, ``flash_attention_bwd_plain`` for CPU tensors."""
    # Replaces the Pallas `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
    # (deeplearning4j_tpu/ops/flash_attention.py, launched by `_flash_bwd`).
    # Both are bound by operations (6·d and 8·d per live pair): the five
    # products run on the tensor cores as three TF32 mma.sync passes at f32
    # accuracy, each k-step into a zeroed tile, on tiles staged by cp.async
    # a tile ahead and split once per CTA, the heaviest tiles issued first.
    # One CTA owns one output tile and loops over the other axis, so
    # neither needs atomics and the results are the same bits from run to
    # run.  Details in csrc/flash_attn_bwd.cu.
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    who = "flash_attention_bwd"
    _cuda_or_raise(q, who)
    do = do.contiguous()
    _check_kernel_inputs(q, k, v, (("o", o), ("do", do)), who=who)
    bh, t_q, d = q.shape
    if lse.shape != (bh, t_q) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{who}: lse must be contiguous float32 "
                         f"[{bh}, {t_q}] on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dd = _rowsum_do_o(do, o).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dims = (bh, t_q, k.shape[1], d, int(causal), float(scale),
            KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), dd.data_ptr())
    with torch.cuda.device(q.device):
        _launch("flash_attn_bwd_dq", *inputs, dq.data_ptr(), *dims)
        _count("bwd_dq", q.dtype)
        _launch("flash_attn_bwd_dkv", *inputs, dk.data_ptr(), dv.data_ptr(),
                *dims)
        _count("bwd_dkv", q.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_flash``: the forward saves
    (q, k, v, O, lse); the backward replays the softmax from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[b, h, t, d]`` tensors (no key-padding
    mask), differentiable.  Shapes outside ``supports`` take
    ``sdpa_reference``, as in the reference, and so do those outside
    ``kernel_supports`` (head_dim above 256)."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if not kernel_supports(t_q, t_k, d):
        return sdpa_reference(q, k, v, causal=causal, scale=scale)
    if scale is None:
        scale = d ** -0.5
    qr, kr, vr = (x.reshape(b * h, x.shape[2], d).contiguous()
                  for x in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _FlashAttention.apply(qr, kr, vr, causal, scale)
    else:   # inference: nothing is saved for a backward
        out, _ = flash_attention_fwd(qr, kr, vr, causal=causal, scale=scale)
    return out.reshape(b, h, t_q, d)
