"""BatchNorm apply (+ReLU): a hand-written Hopper kernel and its plain
twin, and the fused training-mode batch norm built on them.

Port of ``deeplearning4j_tpu/ops/pallas_bn.py``.  Its Pallas
``_apply_kernel`` (launched by ``_apply``) computes
``y = act(x·scale + shift)`` with per-channel ``scale``/``shift`` over
the ``[M, C]`` view of an ``[..., C]`` tensor, act ∈ {identity, relu};
here that is ``csrc/bn_apply.cu``, built for ``sm_90a`` at first use and
bound with ``ctypes``.

- ``supports``, ``_lane_geometry`` and ``_tile_m`` are the JAX package's
  rules, copied rule for rule, so the port takes the fused path exactly
  where the JAX package does (the fused and unfused paths round
  differently).  The TPU's lane geometry only decides *where*: the
  kernel itself reads the ``[M, C]`` view with no lane folding.
- ``bn_apply`` runs the kernel on CUDA tensors and ``bn_apply_plain`` on
  CPU tensors; on a CUDA tensor it launches or raises.
- ``bn_act_train`` is the reference's ``custom_vjp`` as a
  ``torch.autograd.Function``: the forward takes the statistics in torch,
  folds them into ``scale``/``shift`` as ``_fwd_math`` does and applies
  them; the backward is the shared two-pass formula with dy masked by
  ``y > 0`` for relu.  The mean/var cotangents are dropped.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

SOURCE = "bn_apply.cu"
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# scale and shift sit in one block's shared memory as f32: 8 bytes per
# channel within the 227 KB a block may have on Hopper
MAX_CHANNELS = 232448 // 8
_ACTS = ("identity", "relu")

# Kernel launches; the wrapper adds one where it launches and nowhere else.
launches = {"bn_apply": 0}

_fn = []


def reset_launches() -> None:
    launches["bn_apply"] = 0


def _lane_geometry(shape: Sequence[int]):
    """(rows M', lane width C', row-fold k) of the lane-tileable [M', C']
    view of an [..., C] tensor, or None when no valid view exists."""
    c = int(shape[-1])
    m = 1
    for d in shape[:-1]:
        m *= int(d)
    if c % 128 == 0:
        return m, c, 1
    if c > 128 or 128 % c:
        return None
    k = 128 // c
    if m % k:
        return None
    return m // k, k * c, k


def _tile_m(m: int, c: int, itemsize: int):
    """Largest multiple-of-8 row tile dividing m whose [tm, c] block stays
    within 4 MiB per operand, or None."""
    budget = (4 << 20) // max(c * itemsize, 1)
    for tm in (2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if tm <= budget and m % tm == 0:
            return tm
    return None


def supports(*, activation: str, shape: Sequence[int],
             itemsize: int = 4) -> bool:
    """The reference's checkSupported: identity/relu activations and
    geometries with a lane-tileable [M, C] view whose rows admit a
    multiple-of-8 tile within the 4 MiB budget."""
    if not (activation in _ACTS and len(shape) >= 2):
        return False
    geo = _lane_geometry(shape)
    if geo is None:
        return False
    m2, c2, _ = geo
    return _tile_m(m2, c2, itemsize) is not None


def bn_apply_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """``act(x·scale + shift)`` over the last axis, in the accumulation
    dtype (f32 for bf16 input), rounded once to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc) * scale.to(acc) + shift.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _kernel():
    if not _fn:
        from ..utils.kernel_build import load
        fn = load(SOURCE).bn_apply
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check_kernel_inputs(x, scale, shift) -> None:
    who = "bn_apply"
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{who}: the kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        # an NHWC activation is a channels-last NCHW view; anything else
        # would need a copy, which the caller should see
        raise ValueError(f"{who}: x {tuple(x.shape)} must be contiguous "
                         "with channels last (strides "
                         f"{tuple(x.stride())})")
    c = x.shape[-1]
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"{who}: {c} channels; the kernel takes 1.."
                         f"{MAX_CHANNELS}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c,) or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous {x.dtype} "
                             f"[{c}] on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(x, scale, shift, out, relu: bool) -> None:
    """One launch into ``out`` through the binding, on the current stream;
    no checks and no count (``bn_apply`` checks and counts)."""
    c = x.shape[-1]
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                        out.data_ptr(), x.numel() // c, c, int(relu),
                        KERNEL_DTYPES[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_apply kernel failed: cudaError_t {err}")


def bn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """``act(x·scale + shift)`` for ``[..., C]`` x and ``[C]`` scale and
    shift in x's dtype: the Hopper kernel for CUDA tensors,
    ``bn_apply_plain`` for CPU tensors."""
    # Replaces the Pallas `_apply_kernel` (deeplearning4j_tpu/ops/
    # pallas_bn.py, launched by `_apply`).  One elementwise pass: bound by
    # the bytes it moves (x read once, y written once), so the kernel is
    # a grid-stride loop of 16-byte loads and stores with scale and shift
    # staged in shared memory.  Details in csrc/bn_apply.cu.
    if x.device.type == "cpu":
        return bn_apply_plain(x, scale, shift, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply: no kernel for device {x.device}")
    _check_kernel_inputs(x, scale, shift)
    y = torch.empty_like(x)
    _launch(x, scale, shift, y, relu)
    launches["bn_apply"] += 1
    return y


def _fwd_math(x, gamma, beta, eps: float, act: str):
    from ..nn.layers.normalization import _bn_stats
    acc = torch.promote_types(x.dtype, torch.float32)
    mean, var, inv = _bn_stats(x, eps)
    scale = (inv * gamma.to(acc)).to(x.dtype)
    shift = (beta.to(acc) - mean * inv * gamma.to(acc)).to(x.dtype)
    y = bn_apply(x, scale, shift, act == "relu")
    return y, mean, var, inv


class _BnActTrain(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``bn_act_train``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, act: str):
        y, mean, var, inv = _fwd_math(x, gamma, beta, eps, act)
        # y is kept only for the relu mask
        ctx.save_for_backward(x, gamma, mean, inv,
                              y if act == "relu" else None)
        ctx.act = act
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from ..nn.layers.normalization import _bn_bwd_math
        x, gamma, mean, inv, y = ctx.saved_tensors
        if ctx.act == "relu":
            dy = dy * (y > 0).to(dy.dtype)
        dx, dgamma, dbeta = _bn_bwd_math(x, gamma, mean, inv, dy)
        return dx, dgamma, dbeta, None, None


def bn_act_train(x, gamma, beta, eps: float, act: str = "relu"):
    """Training-mode BN with the activation fused into the apply: returns
    (y after the activation, mean, var), statistics in f32.  Callers check
    :func:`supports` first; act must be identity or relu."""
    if act not in _ACTS:
        raise ValueError(f"bn_act_train: activation '{act}' is not one of "
                         f"{_ACTS}")
    return _BnActTrain.apply(x, gamma, beta, eps, act)
