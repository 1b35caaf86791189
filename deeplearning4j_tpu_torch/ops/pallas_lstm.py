"""LSTM forward recurrence: a hand-written Hopper kernel and its plain
twin, and the differentiable wrapper the ``LSTM`` layer's helper calls.

Port of ``deeplearning4j_tpu/ops/pallas_lstm.py``.  Its Pallas ``_kernel``
(launched by ``_run``) runs the recurrence over time with U resident and
(h, c) carried on chip; here that is ``csrc/lstm_fwd.cu``, one launch per
sequence, built for ``sm_90a`` at first use and bound with ``ctypes``.  The
kernel has two tiers, chosen by ``plan`` from the shape before the launch:
the cluster tier (a thread-block cluster owns a slice of batch rows; each
step its CTAs send h into each other's shared memory and wait on a local
mbarrier, with no barrier across the card) wherever U fits the shared
memory of a cluster, the grid tier (one cooperative launch, h through L2,
one grid barrier a step) for the wider h.

- ``supports`` is the reference's ``checkSupported`` rule, copied rule for
  rule: the kernel covers the sigmoid/tanh cell without peepholes or mask.
  Hopper's rule is tighter where the card has no launch in either tier
  (wide h, above 1024 on an H100; ``plan``): ``kernel_plan_exists`` says
  where, and the layer takes its plain loop there.
- ``lstm_forward`` hoists the input projection ``x·W + b`` out of the
  recurrence as one matrix product, as the reference does, then runs the
  kernel on CUDA tensors and ``lstm_forward_plain`` on CPU tensors; on a
  CUDA tensor it launches or raises.  The reference pads the batch to a
  multiple of 8 and h to a multiple of 32 for the TPU's tiling; the
  kernel takes any batch and h, so nothing is padded.
- ``lstm_forward_plain`` is the reference's ``_scan_impl`` as a torch
  loop over t: the CPU path and the yardstick the kernel is held against.
- ``lstm_forward_fast`` is the reference's ``custom_vjp`` as a
  ``torch.autograd.Function``: the forward is ``lstm_forward``; the
  backward reruns ``lstm_forward_plain`` on the saved inputs and
  differentiates it, exactly as the reference's ``_bwd`` takes the VJP of
  ``_scan_impl``.  There is no backward kernel, here or in the reference.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from . import launch_count

SOURCE = "lstm_fwd.cu"

# Configurations the planner tries.  Grid tier: threads per CTA, rows per
# thread (the kernel's template instances) and hidden units per CTA.
THREADS = (128, 256)
ROWS_PER_THREAD = (1, 2, 4)
UNITS_PER_CTA = (8, 16, 32, 64, 128)
# Cluster tier: batch rows per cluster (the template instances), CTAs per
# cluster (16 is above the portable 8) and threads per CTA, rounded down
# to a multiple of its units (384 at most); the planner also tries one
# column group per row, which gives each cell a thread of its own.
# Columns go to the groups 16 at a time: the kernel's product loop is
# unrolled by four steps of 4 columns, and a remainder runs without
# overlap.
CLUSTER_ROWS = tuple(range(1, 17))
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_THREADS = (128, 256, 384)
CLUSTER_K_STEP = 16
# Shared memory a cluster-tier CTA asks for at least: more than half an
# SM's 228 KB, so one SM holds one CTA.  Where two fit, the card places a
# cluster's CTAs two to an SM, which then computes both CTAs' steps.
ONE_CTA_PER_SM = 116 * 1024
# (row, unit) cells one thread of the cluster tier owns at most.
CLUSTER_CELLS = 2
# SM cycles the cost model charges each step for the exchange of h: the
# grid barrier with h's round trip through L2 (the grid tier's batch-1
# chain at h 256 takes ~7 us a step on an H100); for the cluster tier, the
# wait for the peers' h and the step's global loads and stores (clock
# counts of chip_lstm_probe.py).
GRID_BARRIER_CYCLES = 12000
CLUSTER_EXCHANGE_CYCLES = 600
# SM cycles of the cluster tier's cell, per cell a thread owns: expf and
# tanhf and the sends, and per column group one partial sum to load and
# add (clock counts of chip_lstm_probe.py on an H100).
CLUSTER_CELL_CYCLES = 900
CLUSTER_GROUP_CYCLES = 40
# SM cycles of one 4-column step of the product in one warp when nothing
# overlaps it: its loads' latency and 4 dependent FMAs a sum.
CLUSTER_QUAD_LATENCY = 60
# SM cycles of one round of U's staging gather: each thread has 4 float4
# (16 loads) in flight, and a round waits on L2 or memory.
CLUSTER_STAGE_ROUND_CYCLES = 700

# Kernel launches; the wrapper adds one where it launches and nowhere else.
launches = {"lstm_fwd": 0}

_fns = {}
_plans = {}


def reset_launches() -> None:
    launches["lstm_fwd"] = 0


def supports(*, peepholes: bool, gate_activation: str, activation: str,
             masked: bool) -> bool:
    """checkSupported (reference ``CudnnLSTMHelper.java:174-183``): the
    kernel covers the standard sigmoid/tanh cell only."""
    return (not peepholes and not masked
            and gate_activation == "sigmoid" and activation == "tanh")


def lstm_forward_plain(x, W, U, b, h0, c0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence as a loop over t (the reference's ``_scan_impl``):
    x [batch, t, f], W [f, 4h], U [h, 4h], b [4h], h0/c0 [batch, h]; IFOG
    gates.  Returns (ys [batch, t, h], hT, cT)."""
    batch, t, n_in = x.shape
    h = U.shape[0]
    xz = (x.reshape(batch * t, n_in) @ W + b).reshape(batch, t, 4 * h)
    hh, cc = h0, c0
    ys = []
    for s in range(t):
        z = xz[:, s] + hh @ U
        i = torch.sigmoid(z[:, :h])
        f = torch.sigmoid(z[:, h:2 * h])
        o = torch.sigmoid(z[:, 2 * h:3 * h])
        g = torch.tanh(z[:, 3 * h:])
        cc = f * cc + i * g
        hh = o * torch.tanh(cc)
        ys.append(hh)
    if not ys:
        return xz.new_zeros((batch, 0, h)), hh, cc
    return torch.stack(ys, dim=1), hh, cc


# ----------------------------------------------------------------- planner
@dataclass(frozen=True)
class Plan:
    """One launch configuration of ``csrc/lstm_fwd.cu``.

    Grid tier (``tier == "grid"``, ``cluster == 1``): ``rb`` rows per
    thread, ``hu`` hidden units and ``rows`` batch rows per CTA, ``kc``
    columns of h staged at a time, ``grid`` CTAs of ``threads`` threads and
    ``smem`` bytes of shared memory, all resident at once.

    Cluster tier (``tier == "cluster"``): clusters of ``cluster`` CTAs,
    each cluster ``rows`` batch rows (``rb == rows``, the template
    instance) and all h units, ``hu`` units per CTA, ``threads`` threads
    per CTA that split the product's columns into groups of ``kc``,
    ``grid`` CTAs in all (ceil(batch / rows) clusters), ``smem`` bytes
    each, one CTA an SM."""
    rb: int
    hu: int
    threads: int
    rows: int
    kc: int
    grid: int
    smem: int
    tier: str = "grid"
    cluster: int = 1


def smem_bytes(h: int, hu: int, rows: int, kc: int) -> int:
    """The CTA's U columns as float4 (i, f, o, g) per (k, unit), then its
    rows of h in chunks of kc columns with a row stride of kc + 1."""
    return 16 * h * hu + 4 * rows * (kc + 1)


def _k_chunk(h: int, hu: int, rows: int, max_smem: int) -> Optional[int]:
    """All h columns of h_{t-1} at once if they fit beside U, else the
    largest multiple of 32 that does (None below 32)."""
    if smem_bytes(h, hu, rows, h) <= max_smem:
        return h
    free = max_smem - 16 * h * hu
    kc = (free // (4 * rows) - 1) // 32 * 32
    return kc if kc >= 32 else None


def _cost(p: Plan, h: int, t: int, sms: int) -> int:
    """Grid tier: rough SM cycles of the busiest SM.  Per step and k, a
    warp spends 4 shared-memory wavefronts on its U float4 and one per row
    on h; the staging of h_{t-1} is rows·h loads and stores per CTA; U is
    staged once at ~64 bytes per cycle; CTAs beyond one per SM share it;
    each step ends in one grid barrier."""
    waves = -(-p.grid // sms)
    step = waves * (h * (p.threads // 32) * (4 + p.rb) + p.rows * h // 16)
    stage = waves * h * p.hu // 4
    return t * (step + GRID_BARRIER_CYCLES) + stage


def _padded(h: int) -> int:
    return -(-h // 4) * 4


def cluster_smem_bytes(h: int, hu: int, rows: int, threads: int) -> int:
    """Two mbarriers, the CTA's U columns as float4 (i, f, o, g) per (k,
    unit), the double buffer of h for the cluster's rows, and the partial
    sums of the product's column groups, h padded to a multiple of 4; at
    least ``ONE_CTA_PER_SM``."""
    hp = _padded(h)
    used = 16 + 16 * hp * hu + 8 * rows * hp + 16 * rows * threads
    return max(used, ONE_CTA_PER_SM)


def _cluster_cost(p: Plan, h: int, t: int, active: int) -> int:
    """Cluster tier: rough SM cycles, fitted to per-phase clock counts of
    the kernel on an H100.  Per step: the product, the larger of 1.1 x its
    issue (16·rows FMAs a warp per 4 columns of its group, on the busiest
    of the SM's 4 schedulers, plus the SM's shared-memory wavefronts, 16
    for the four U float4 and one per row's h) and one warp's chain of
    4-column steps (``CLUSTER_QUAD_LATENCY`` each); the partial sums, ~35
    cycles a row; the cell, ``CLUSTER_CELL_CYCLES`` plus
    ``CLUSTER_GROUP_CYCLES`` per column group, for each cell a thread
    owns; then the exchange (``CLUSTER_EXCHANGE_CYCLES``).  Clusters
    beyond those the card runs at once (``active``) run in waves.  U is
    staged once, a latency-bound gather of 4 float4 a thread a round
    (``CLUSTER_STAGE_ROUND_CYCLES``): for a short sequence, more threads
    stage it sooner."""
    quads = p.kc // 4
    groups = -(-_padded(h) // p.kc)             # groups that hold columns
    warps = -(-groups * p.hu // 32)             # warps in the product
    issue = -(-warps // 4) * quads * 16 * p.rows \
        + warps * quads * (16 + p.rows)
    product = max(11 * issue // 10, CLUSTER_QUAD_LATENCY * quads)
    cells = -(-p.rows * p.hu // p.threads)
    cell = CLUSTER_CELL_CYCLES + CLUSTER_GROUP_CYCLES * groups
    step = product + 35 * p.rows + cell * cells + CLUSTER_EXCHANGE_CYCLES
    waves = -(-(p.grid // p.cluster) // active)
    stage = -(-_padded(h) * p.hu // (4 * p.threads)) \
        * CLUSTER_STAGE_ROUND_CYCLES
    return waves * (t * step + stage)


def _search_cluster(batch: int, h: int, t: int, max_smem: int,
                    clusters_active: Callable[[int, int, int, int], int]
                    ) -> Optional[Plan]:
    """The cheapest cluster-tier configuration (by ``_cluster_cost``, then
    the smaller grid) that the card runs; None where none fits."""
    best, best_key = None, None
    hp = _padded(h)
    top = max(CLUSTER_THREADS)
    for cl in CLUSTER_SIZES:
        hu = -(-h // cl)
        if (cl - 1) * hu >= h:
            continue            # a CTA without units
        for rows in CLUSTER_ROWS:
            # fewer threads first: at equal cost the others wait idle
            for groups in sorted({n // hu for n in CLUSTER_THREADS}
                                 | {rows} - {0}):
                threads = groups * hu
                if threads > top or rows * hu > CLUSTER_CELLS * threads:
                    continue
                kc = CLUSTER_K_STEP * -(-hp // (CLUSTER_K_STEP * groups))
                smem = cluster_smem_bytes(h, hu, rows, threads)
                if smem > max_smem:
                    continue
                active = clusters_active(rows, cl, threads, smem)
                if active < 1:
                    continue
                p = Plan(rows, hu, threads, rows, kc,
                         -(-batch // rows) * cl, smem, "cluster", cl)
                key = (_cluster_cost(p, h, t, active), p.grid)
                if best_key is None or key < best_key:
                    best, best_key = p, key
    return best


def _search(batch: int, h: int, t: int, sms: int, max_smem: int,
            blocks_per_sm: Callable[[int, int, int], int],
            clusters_active: Optional[Callable[[int, int, int, int], int]]
            = None) -> Optional[Plan]:
    """``plan``'s search; None when no configuration fits.  The cluster
    tier where it fits (``clusters_active`` given: the card launches
    clusters), else the grid tier."""
    if clusters_active is not None:
        best = _search_cluster(batch, h, t, max_smem, clusters_active)
        if best is not None:
            return best
    best, best_key = None, None
    for threads in THREADS:
        for rb in ROWS_PER_THREAD:
            for hu in UNITS_PER_CTA:
                if hu > threads:
                    continue
                rows = rb * (threads // hu)
                kc = _k_chunk(h, hu, rows, max_smem)
                if kc is None:
                    continue
                grid = -(-h // hu) * -(-batch // rows)
                smem = smem_bytes(h, hu, rows, kc)
                if grid > blocks_per_sm(rb, threads, smem) * sms:
                    continue
                p = Plan(rb, hu, threads, rows, kc, grid, smem)
                key = (_cost(p, h, t, sms), grid)
                if best_key is None or key < best_key:
                    best, best_key = p, key
    return best


def _no_plan(batch: int, h: int, sms: int, max_smem: int) -> ValueError:
    return ValueError(
        f"lstm_fwd: no launch keeps every CTA resident for batch "
        f"{batch}, h {h}: U [{h}, {4 * h}] f32 is {16 * h * h} bytes "
        f"and each CTA also stages its batch rows of h, against "
        f"{sms} SMs x {max_smem} bytes of shared memory per block")


def plan(batch: int, h: int, t: int, sms: int, max_smem: int,
         blocks_per_sm: Callable[[int, int, int], int],
         clusters_active: Optional[Callable[[int, int, int, int], int]]
         = None) -> Plan:
    """The launch for this shape: the cheapest cluster-tier configuration
    the card runs, where one does (``clusters_active(rows, cluster,
    threads, smem)`` is the card's count of such clusters at once; None
    for a card without clusters); else the cheapest grid-tier one (by
    ``_cost``, then the smaller grid) whose CTAs are all resident at once
    (``blocks_per_sm(rb, threads, smem)`` is the card's occupancy of that
    instance).  Raises ValueError, with the numbers, when none is."""
    best = _search(batch, h, t, sms, max_smem, blocks_per_sm,
                   clusters_active)
    if best is None:
        raise _no_plan(batch, h, sms, max_smem)
    return best


# ----------------------------------------------------------------- binding
_ARGTYPES = {
    "lstm_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "lstm_fwd_cluster": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "lstm_fwd_occupancy": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "lstm_fwd_cluster_occupancy": [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_int)],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ..utils.kernel_build import load
        fn = getattr(load(SOURCE), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _occupancy(rb: int, threads: int, smem: int) -> Tuple[int, int, int]:
    """(CTAs per SM, SMs, shared memory a block may opt in to) of the
    current card for one grid-tier configuration."""
    out = (ctypes.c_int * 4)()
    err = _kernel("lstm_fwd_occupancy")(rb, threads, smem, out)
    if err != 0:
        raise RuntimeError(f"lstm_fwd occupancy query failed: cudaError_t "
                           f"{err}")
    if not out[3]:
        raise RuntimeError("lstm_fwd: this card has no cooperative launch")
    return out[0], out[1], out[2]


def _cluster_occupancy(rows: int, cl: int, threads: int, smem: int
                       ) -> Tuple[int, bool]:
    """(clusters the current card runs at once, whether it launches
    clusters at all) for one cluster-tier configuration."""
    out = (ctypes.c_int * 3)()
    err = _kernel("lstm_fwd_cluster_occupancy")(rows, cl, threads, smem, out)
    if err != 0:
        raise RuntimeError(f"lstm_fwd cluster occupancy query failed: "
                           f"cudaError_t {err}")
    return out[0], bool(out[1])


def _card(device):
    """(SMs, shared memory a block may opt in to, the grid tier's
    occupancy of one configuration, the cluster tier's, or None where the
    card launches no clusters) of the card of ``device``."""
    with torch.cuda.device(device):
        _, sms, max_smem = _occupancy(1, THREADS[0], 0)
        has_clusters = _cluster_occupancy(CLUSTER_ROWS[0], CLUSTER_SIZES[0],
                                          32, 0)[1]

    def blocks_per_sm(rb: int, threads: int, smem: int) -> int:
        with torch.cuda.device(device):
            return _occupancy(rb, threads, smem)[0]

    def clusters_active(rows: int, cl: int, threads: int, smem: int) -> int:
        with torch.cuda.device(device):
            return _cluster_occupancy(rows, cl, threads, smem)[0]
    return sms, max_smem, blocks_per_sm, \
        clusters_active if has_clusters else None


def _device_search(batch: int, h: int, t: int, device):
    """``(plan or None, SMs, shared memory)`` on the card of ``device``,
    cached per shape."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, batch, h, t)
    hit = _plans.get(key)
    if hit is None:
        sms, max_smem, blocks_per_sm, clusters_active = _card(device)
        hit = _plans[key] = (_search(batch, h, t, sms, max_smem,
                                     blocks_per_sm, clusters_active),
                             sms, max_smem)
    return hit


def device_plan(batch: int, h: int, t: int, device) -> Plan:
    """``plan`` on the card of ``device``, cached per shape; raises as
    ``plan`` does where the card has no launch."""
    p, sms, max_smem = _device_search(batch, h, t, device)
    if p is None:
        raise _no_plan(batch, h, sms, max_smem)
    return p


def kernel_plan_exists(batch: int, h: int, t: int, device) -> bool:
    """False where the card of ``device`` has no launch for this shape
    (``device_plan`` raises there): the ``LSTM`` layer then runs its plain
    loop, as it does where ``supports`` is False.  True off CUDA, where
    ``lstm_forward`` runs the plain twin at every shape."""
    if torch.device(device).type != "cuda":
        return True
    return _device_search(batch, h, t, device)[0] is not None


def _check_kernel_inputs(x, W, U, b, h0, c0) -> None:
    who = "lstm_fwd"
    if x.ndim != 3:
        raise ValueError(f"{who}: x must be [batch, t, f], got "
                         f"{tuple(x.shape)}")
    batch, t, f = x.shape
    h = U.shape[0] if U.ndim == 2 else -1
    if batch < 1 or t < 1 or h < 1:
        raise ValueError(f"{who}: the kernel takes batch >= 1, t >= 1 and "
                         f"h >= 1, got x {tuple(x.shape)}, U "
                         f"{tuple(U.shape)}")
    want = {"x": (x, None), "W": (W, (f, 4 * h)), "U": (U, (h, 4 * h)),
            "b": (b, (4 * h,)), "h0": (h0, (batch, h)),
            "c0": (c0, (batch, h))}
    for name, (a, shape) in want.items():
        if a.dtype != torch.float32 or a.device != x.device or \
                (shape is not None and tuple(a.shape) != shape):
            raise ValueError(
                f"{who}: {name} must be float32 {list(shape or a.shape)} on "
                f"{x.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
        if name in ("U", "h0", "c0") and not a.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous (strides "
                             f"{tuple(a.stride())})")


def _launch(xz, U, h0, c0, ys, hT, cT, p: Plan) -> None:
    """One launch of ``p``'s tier into ``ys``/``hT``/``cT`` through the
    binding, on the current stream; no checks and no count
    (``lstm_forward`` checks and counts).  xz is [t, batch, 4h]
    time-major, ys [t, batch, h]."""
    t, batch, h = ys.shape
    ptrs = (xz.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), hT.data_ptr(), cT.data_ptr())
    with torch.cuda.device(xz.device):
        stream = torch.cuda.current_stream(xz.device).cuda_stream
        if p.tier == "cluster":
            err = _kernel("lstm_fwd_cluster")(
                *ptrs, t, batch, h, p.rows, p.cluster, p.hu, p.threads, p.kc,
                stream)
        else:
            err = _kernel("lstm_fwd")(*ptrs, t, batch, h, p.rb, p.hu,
                                      p.threads, p.kc, stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel failed: cudaError_t {err} "
                           f"(plan {p})")


def input_projection(x, W, b) -> torch.Tensor:
    """``x·W + b`` for every step as one product, time-major:
    ``[t·batch, 4h]`` rows in (t, batch) order."""
    batch, t, f = x.shape
    return torch.addmm(b, x.transpose(0, 1).reshape(t * batch, f), W)


def lstm_forward(x, W, U, b, h0, c0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused LSTM forward (shapes as ``lstm_forward_plain``, f32): the
    Hopper kernel for CUDA tensors, ``lstm_forward_plain`` for CPU
    tensors.  ys comes back as a [batch, t, h] view of the kernel's
    time-major output."""
    # Replaces the Pallas `_kernel` (deeplearning4j_tpu/ops/pallas_lstm.py,
    # launched by `_run`).  The serial part: a [batch, h] x [h, 4h] product
    # and the cell per step, with one barrier between steps: a cluster's
    # or, for the widest h, the grid's.  Details in csrc/lstm_fwd.cu.
    if x.device.type == "cpu":
        return lstm_forward_plain(x, W, U, b, h0, c0)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_fwd: no kernel for device {x.device}")
    _check_kernel_inputs(x, W, U, b, h0, c0)
    batch, t, _ = x.shape
    h = U.shape[0]
    p = device_plan(batch, h, t, x.device)
    xz = input_projection(x, W, b)
    ys = torch.empty((t, batch, h), dtype=torch.float32, device=x.device)
    hT = torch.empty((batch, h), dtype=torch.float32, device=x.device)
    cT = torch.empty_like(hT)
    _launch(xz, U, h0, c0, ys, hT, cT, p)
    launch_count.count(launches, "lstm_fwd")
    return ys.transpose(0, 1), hT, cT


class _LstmForwardFast(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``lstm_forward_fast``."""

    @staticmethod
    def forward(ctx, x, W, U, b, h0, c0):
        ctx.save_for_backward(x, W, U, b, h0, c0)
        return lstm_forward(x, W, U, b, h0, c0)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, need)]
            outs = lstm_forward_plain(*leaves)
            grads = iter(torch.autograd.grad(
                outs, [a for a, n in zip(leaves, need) if n],
                (dys, dhT, dcT), allow_unused=True))
        return tuple(next(grads) if n else None for n in need)


def lstm_forward_fast(x, W, U, b, h0, c0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``lstm_forward`` under autograd: the kernel forward on CUDA, the
    gradient of ``lstm_forward_plain`` backward (the reference's scan
    VJP), so a helper-enabled layer trains exactly as the plain one."""
    return _LstmForwardFast.apply(x, W, U, b, h0, c0)
