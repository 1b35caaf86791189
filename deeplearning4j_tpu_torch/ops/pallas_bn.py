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
- ``plan`` chooses the kernel's launch on the host (vector width, grid,
  fixed or rolling channels), a pure function of the
  shape and the card's SM count (asked once per process); ``device_plan``
  applies it to the tensors at hand.
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
import functools
import math
from dataclasses import dataclass
from typing import Sequence

import torch

SOURCE = "bn_apply.cu"
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ``_tile_m``'s budget per operand block and its row tiles (the
# reference's rule); the smallest tile sets the widest C ``supports``
# admits, which is the widest the kernel door takes (``max_channels``).
TILE_BUDGET = 4 << 20
TILE_ROWS = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)
# The kernel's launch constants (csrc/bn_apply.cu kThreads, kUnroll,
# kBlocksPerSm: __launch_bounds__ caps a thread at 64 registers so that
# four blocks of 256 threads stay resident on an SM).
THREADS, UNROLL, BLOCKS_PER_SM = 256, 4, 4
_ACTS = ("identity", "relu")

# Kernel launches; the wrapper adds one where it launches and nowhere else.
launches = {"bn_apply": 0}

_fn = []
_sms = {}


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
    budget = TILE_BUDGET // max(c * itemsize, 1)
    for tm in TILE_ROWS:
        if tm <= budget and m % tm == 0:
            return tm
    return None


def max_channels(itemsize: int) -> int:
    """The widest C that ``supports`` admits for ``itemsize``-byte
    elements: one smallest row tile of ``_tile_m`` within its budget
    (131,072 in f32, 262,144 in bf16).  The kernel door takes every C up
    to it; the plan's index walk is checked there
    (tests/test_torch_bn_kernel.py)."""
    return TILE_BUDGET // (min(TILE_ROWS) * itemsize)


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


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/bn_apply.cu``: ``vec`` elements per vector (16
    bytes, or 1), ``grid`` blocks of ``THREADS`` threads; ``fixed`` when
    the grid stride is a whole number of rows (each thread keeps its
    channels)."""
    vec: int
    grid: int
    fixed: bool


@functools.lru_cache(maxsize=256)
def plan(m: int, c: int, itemsize: int, sms: int,
         aligned: bool = True) -> Plan:
    """The launch for ``[m, c]`` of ``itemsize`` bytes on ``sms`` SMs.

    16-byte vectors where C is a multiple of the width and the pointers are
    aligned, else single elements.  The grid is one wave of resident blocks
    (``BLOCKS_PER_SM`` per SM), fewer for small tensors so that each
    thread still has ``UNROLL`` vectors.  Where a grid of whole blocks
    makes the stride (grid · ``THREADS`` vectors) a multiple of the row's
    ``c / vec`` vectors, it is rounded down to one (never below the least
    such grid) and the plan is ``fixed``; otherwise the kernel rolls the
    channel index."""
    wide = 16 // itemsize
    vec = wide if aligned and c % wide == 0 else 1
    row_vecs = c // vec
    resident = sms * BLOCKS_PER_SM
    want = max(1, min(resident, -(-(m * row_vecs) // (THREADS * UNROLL))))
    # the least grid whose stride is a whole number of rows
    least = row_vecs // math.gcd(row_vecs, THREADS)
    if least <= resident:
        return Plan(vec, max(least, want // least * least), True)
    return Plan(vec, want, False)


def _sm_count(device) -> int:
    """SMs of ``device``'s card, asked once per process."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def device_plan(x, scale, shift, out) -> Plan:
    """``plan`` for these tensors on their card."""
    c = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, shift, out))
    return plan(x.numel() // c, c, x.element_size(), _sm_count(x.device),
                aligned)


def _kernel():
    if not _fn:
        from ..utils.kernel_build import load
        fn = load(SOURCE).bn_apply
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    widest = max_channels(x.element_size())
    if not 0 < c <= widest:
        raise ValueError(f"{who}: {c} channels; the kernel takes 1..{widest} "
                         f"in {x.dtype} (the widest C supports admits)")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c,) or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous {x.dtype} "
                             f"[{c}] on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(x, scale, shift, out, relu: bool, p: Plan = None) -> None:
    """One launch into ``out`` through the binding, on the current stream
    of x's card (``device_plan`` unless ``p`` is given); no checks and no
    count (``bn_apply`` checks and counts)."""
    # A ResNet50 step makes 53 of these launches, many of them only a few
    # µs of device time, so the host path is kept short: the raw stream
    # handle rather than a Stream object, and a device switch only when x
    # is not on the current card.
    c = x.shape[-1]
    if p is None:
        p = device_plan(x, scale, shift, out)
    index = x.get_device()
    args = (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            x.numel() // c, c, int(relu), KERNEL_DTYPES[x.dtype], p.vec,
            p.grid, int(p.fixed), torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"bn_apply kernel failed: cudaError_t {err} "
                           f"(plan {p})")


def bn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """``act(x·scale + shift)`` for ``[..., C]`` x and ``[C]`` scale and
    shift in x's dtype: the Hopper kernel for CUDA tensors,
    ``bn_apply_plain`` for CPU tensors."""
    # Replaces the Pallas `_apply_kernel` (deeplearning4j_tpu/ops/
    # pallas_bn.py, launched by `_apply`).  One elementwise pass: bound by
    # the bytes it moves (x read once, y written once), so the kernel is
    # a grid-stride loop of 16-byte loads, four in flight per thread, on a
    # launch planned here (``plan``) so that each thread keeps its
    # channels' scale and shift in registers.  Details in csrc/bn_apply.cu.
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
