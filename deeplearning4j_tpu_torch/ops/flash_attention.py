"""Flash-attention forward: a hand-written Hopper kernel and its plain twin.

Port of ``deeplearning4j_tpu/ops/flash_attention.py`` (forward only; the
two backward kernels come with training).  The TPU kernel
``_flash_kernel``, launched by ``_flash_fwd_call`` through
``pl.pallas_call``, becomes ``csrc/flash_attn_fwd.cu``, built for
``sm_90a`` at first use and bound with ``ctypes``.

- ``flash_attention_fwd`` runs the kernel on CUDA tensors and the plain
  version on CPU tensors; on a CUDA tensor it launches or raises.
- ``flash_attention_fwd_plain`` is the same tiled online softmax in plain
  torch (64-row tiles, stop at the causal diagonal, f32 statistics).  It
  is the CPU path and the oracle the kernel is held against on the card.
- ``flash_attention`` keeps the reference's ``supports`` rule and its
  fallback to ``sdpa_reference`` for shapes the rule refuses.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .attention import NEG_INF, sdpa_reference

BLOCK = 64            # q and k tile rows, in the kernel and the plain twin
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCE = "flash_attn_fwd.cu"

# Kernel launches made by ``flash_attention_fwd``; nothing else moves it.
launches = 0

_fn = None


def _tile_ok(t: int) -> bool:
    # The reference tiles t by the largest power of two >= 128 dividing it
    # (``_auto_blocks``), or by t itself when t <= 128.
    return t <= 128 or t % 128 == 0


def supports(t_q: int, t_k: int, d: int) -> bool:
    """The reference's rule: sequences that tile and a head_dim that is
    a multiple of 64.  Other shapes take ``sdpa_reference``."""
    return _tile_ok(t_q) and _tile_ok(t_k) and d % 64 == 0


def flash_attention_fwd_plain(q, k, v, causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled online-softmax attention over ``[bh, t, d]``; returns
    ``(O, lse)`` with O in the input dtype and lse ``[bh, t_q]`` in f32."""
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
        live = min(n_k, (q0 + rows - 1) // BLOCK + 1) if causal else n_k
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        for k0 in range(0, live * BLOCK, BLOCK):
            kt, vt = kf[:, k0:k0 + BLOCK], vf[:, k0:k0 + BLOCK]
            s = torch.matmul(qt, kt.transpose(1, 2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[1],
                                    device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * (s > NEG_INF / 2)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vt)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q0 + rows] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + rows] = (m + torch.log(l))[..., 0].to(torch.float32)
    return out, lse


def _kernel():
    global _fn
    if _fn is None:
        from ..utils.kernel_build import load
        fn = load(SOURCE).flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_kernel_inputs(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype}, "
                             f"q is {q.dtype}")
        if x.ndim != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[bh, t, d], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention_fwd: the kernel takes "
                         f"float32 or bfloat16, got {q.dtype}")
    bh, _, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: the kernel takes head_dim "
                         f"in {KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")


def flash_attention_fwd(q, k, v, *, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` for ``[bh, t, d]`` tensors: the Hopper kernel for CUDA
    tensors, ``flash_attention_fwd_plain`` for CPU tensors."""
    # Replaces the Pallas `_flash_kernel` (deeplearning4j_tpu/ops/
    # flash_attention.py, launched by `_flash_fwd_call`).  On the H100 the
    # f32 kernel is bound by operations: it runs both products as f32 FMAs
    # (no TF32) from shared-memory tiles, one CTA per 64-row q-tile with
    # the key loop inside, stopping at the causal diagonal.  In bf16 the
    # bytes bound it and this first version, without tensor cores, does
    # not reach that bound.  Details in csrc/flash_attn_fwd.cu.
    global launches
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    _check_kernel_inputs(q, k, v)
    bh, t_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), bh, t_q, k.shape[1], d, int(causal),
                 float(scale), KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd kernel failed: cudaError_t {err}")
    launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[b, h, t, d]`` tensors (no key-padding
    mask).  Shapes outside ``supports`` take ``sdpa_reference``, as in
    the reference."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if not supports(t_q, t_k, d):
        return sdpa_reference(q, k, v, causal=causal, scale=scale)
    if scale is None:
        scale = d ** -0.5
    out, _ = flash_attention_fwd(q.reshape(b * h, t_q, d).contiguous(),
                                 k.reshape(b * h, t_k, d).contiguous(),
                                 v.reshape(b * h, t_k, d).contiguous(),
                                 causal=causal, scale=scale)
    return out.reshape(b, h, t_q, d)
