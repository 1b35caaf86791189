#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It drives ``deeplearning4j_tpu_torch``
only (it imports nothing of JAX or of the JAX package) and exits non-zero
if any phase fails:

1. builds every kernel of the serving and training paths from
   ``deeplearning4j_tpu_torch/csrc`` into ``build/kernels/``, one ``nvcc``
   per source, all started together;
2. ``kernel_vs_plain``: holds the flash-attention forward kernel against
   its plain PyTorch version on the card at the model's attention shape
   and at ``[16, 512, d]`` for every other head_dim the kernels take
   (128, 192, 256) and a ragged ``[16, 100, 64]``, f32 and bf16, causal
   and full;
3. ``bwd_kernel_vs_plain``: the same for the two backward kernels (dq;
   dk and dv), and a second launch of both on the same inputs, which must
   give the same bits; ``wide_head_dim``: head_dim 320, which the
   reference's kernel takes and the port's do not, runs through
   ``flash_attention`` on the card by its shape rule (``sdpa_reference``,
   no kernel launch) and matches the plain forward;
4. ``serve``: serves a full-width TransformerLM (vocab 8192, seq 512,
   embed 512, 8 layers, 8 heads; random weights from the seed) through the
   port's ``ServingEngine`` for requests of 1, 5 and 16 rows, checks the
   rows against the same model on the reference attention path, and checks
   that every served batch launched the forward kernel once per layer;
5. ``train``: trains the same model (integer next-token targets,
   ``sparse_mcxent``, Adam) through ``MultiLayerNetwork.fit`` for 5 steps
   of batch 16 beside a twin on the reference attention path: step-0
   gradients of every parameter and each step's loss agree with the
   twin's, and each of the three kernels launched 8 times per step;
6. ``serve_time``, ``train_time`` and ``kernel_time``: the served batch-16
   request, the forward alone, the median training step (both attention
   paths) with a ``torch.profiler`` split of the step's device time, and
   each kernel beside its plain version, its bound and a PyTorch
   yardstick (``scaled_dot_product_attention``, forward or backward),
   which the port never calls; the backward rows add the pair (dq +
   dk/dv) beside SDPA's backward, which computes all three;
7. ``bn_kernel_vs_plain``: holds the BatchNorm-apply kernel against its
   plain version at every BN geometry of ResNet50 at batch 64 and
   224x224 and at a wide [64, 32768] (a C the first design refused), f32
   and bf16, relu and identity;
8. ``cnn_train``: trains the zoo ResNet50 at its published widths
   (224x224x3, 1000 classes, the full 50-layer graph; random weights from
   the seed) through ``ComputationGraph.fit`` for 5 Nesterovs steps of
   batch 64, f32 with TF32 off, every BatchNormalization at
   ``helper="pallas"``, beside a twin at ``helper=None`` (the unfused
   path): step-0 loss and gradients, each step's loss (the twin starts
   each step from the fused net's params), the running statistics after
   5 steps, the eval outputs of both, and 53 launches of ``bn_apply`` per
   step;
9. ``cnn_train_time`` and the ``bn_apply`` rows of ``kernel_time``: the
   median step of both nets and images/s, a ``torch.profiler`` split of
   the step (convolutions and matrix products / the BN kernel / the rest
   / idle), and the kernel at each geometry beside its plain version, its
   bound and ``torch.addcmul(shift, x, scale)``, which the port never
   calls, each launch after a read of 64 MB that leaves L2 clean;
10. ``lstm_kernel_vs_plain``: holds the LSTM-recurrence kernel against its
    plain version on ``ys``, ``hT`` and ``cT`` at (t, b, h) = (64, 128,
    256), (256, 32, 256), (1, 16, 256) from a nonzero state and the ragged
    (7, 5, 100), within an error bound derived from each run's data;
11. ``lstm_serve`` and ``lstm_train``: the zoo TextGenerationLSTM at its
    width (26 classes, two LSTM-256 layers; random weights from the seed),
    its LSTMs at ``helper="pallas"``, beside a twin at ``helper=None``
    (the plain recurrence on the card) that shares its params: ``output``
    on batch 128 x 64 steps, a 16-character prefix streamed through
    ``rnn_time_step`` and then 48 greedy single-step calls, and 5 ``fit``
    steps (one-hot next-character labels, Adam 2e-3, clipping at 10;
    step-0 loss and gradients, each step's loss); 2 kernel launches per
    ``output``, per streaming call and per training step;
12. ``lstm_train_time`` and the ``lstm_fwd`` rows of ``kernel_time``: the
    median step of both nets and tokens/s, a ``torch.profiler`` split of
    the step, the batch-128 ``output`` latency, and the kernel at both
    long shapes beside its plain version, its bound, its time at batch 1
    (the serial chain alone) and ``torch.nn.LSTM`` (cuDNN) on the same
    weights, which the port never calls.

Each phase prints one JSON line.  Then come the card's name and power
limit, the ``kernels`` record (the line before the last) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC_DIR = "deeplearning4j_tpu_torch/csrc"

# The model's width: TransformerLM as the repo benchmarks it
# (utils/benchmarks.py transformer_lm_step_time).
VOCAB, SEQ, EMBED, LAYERS, HEADS = 8192, 512, 512, 8, 8
MAX_BATCH = 16
REQUEST_SIZES = (1, 5, 16)
HEAD_DIM = EMBED // HEADS
# the kernels vs plain beyond the model's shape: every other head_dim the
# kernels take, and a ragged t (not a multiple of any tile)
CHECK_SHAPES = ((16, 512, 128), (16, 512, 192), (16, 512, 256),
                (16, 100, 64))
# a head_dim the reference's Pallas kernel takes and the port's kernels do
# not: flash_attention sends it to sdpa_reference by its shape rule
WIDE_HEAD_DIM_SHAPE = (2, 8, 512, 320)
TRAIN_BATCH = 16
TRAIN_STEPS = 5
TIMED_TRAIN_STEPS = 20

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM rate and the
# operation rate for each kind of work.  Work shaped as matrix products
# (attention, the LSTM's recurrent product) can be done at f32 accuracy
# on the tensor cores in three TF32 passes, 495 / 3 = 165 TFLOP/s: the
# least time the card could take for it in f32.  Elementwise f32 work
# runs on the CUDA cores, 67 TFLOP/s.  bf16 products: 989 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float32_products": 495e12 / 3,
                  "bfloat16": 989e12}

# Kernel vs plain twin, same inputs on the card.  Both widen to f32 and
# keep f32 statistics; only the order of the f32 sums differs (FMA
# chains in the kernel, cuBLAS tiles in the twin), which moves O by a
# few f32 ulps at |O| <= ~4: 1e-4 abs.  In bf16 the two f32 results are
# rounded to bf16 separately, and one bf16 ulp at |O| ~ 2 is 2**-7
# (7.8e-3): 2e-2 abs.  lse stays f32 in both dtypes: 1e-4 abs.
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-4
# Backward kernels vs plain twin, as max |kernel - plain| / max |plain|
# per gradient: dk and dv sum over up to 512 queries, so an absolute
# bound would have to follow their magnitude.  f32: the sums differ in
# order only, ~1e-6 of the largest entry: 1e-5.  bf16: the f32 results
# are rounded to bf16 separately, one ulp (2**-8 of the leading power of
# two) apart at most, and the widened bf16 inputs feed both sides
# alike: two ulps of the largest entry, 1.6e-2.
TOL_BWD = {"float32": 1e-5, "bfloat16": 1.6e-2}
# Served rows vs the same model with attn_impl="reference" (f32, TF32
# off): the two differ by f32 summation order only (attention, and the
# matmul shapes of a padded batch).  A probability p moves by about
# p * (logit error); logits of order 10 carry f32 reordering error of
# order 1e-5, and p <= 1: 1e-5 abs.
TOL_SERVE = 1e-5
# Training, flash path vs reference-attention twin, f32 without TF32.
# Step-0 gradients: per parameter, max |flash - reference| within 1e-4
# of that parameter's largest |g| plus 1e-6 of the largest |g| of the
# whole net.  The attention sums run in another order (~1e-6 relative),
# and the mha_bk gradients are 0 in exact arithmetic (the softmax
# ignores a per-row shift): their entries are f32 noise on both sides,
# which only the net-wide term bounds.  Losses: each of the 5 steps
# within 1e-5 relative of the twin's.  The loss is a sum over 8192 tokens
# of ~9 nats, whose f32 reordering is ~1e-7 relative; Adam moves every
# parameter by about lr per step whatever |g| is, so an entry whose
# gradient is noise (mha_bk, which the loss does not see) takes steps of
# either sign on the two sides without moving the loss.
TOL_GRAD_LEAF, TOL_GRAD_NET = 1e-4, 1e-6
TOL_TRAIN_LOSS = 1e-5
PROFILED_STEPS = 3

TIMED_RUNS = 30
SERVE_TIMED_RUNS = 10

# ResNet50 as the JAX package's bench.py trains it: published widths,
# batch 64 (cut from bench.py's 256 to leave room for the twin), f32.
CNN_BATCH, CNN_STEPS, CNN_TIMED_STEPS = 64, 5, 20
CNN_EVAL_ROWS = 16
# BN apply, kernel vs plain version on the same inputs.  The kernel
# rounds once (f32 FMA), the plain version twice (x·scale, then + shift):
# apart by at most half an ulp of |x·scale| plus half an ulp of |y|, so
# within 2**-23 of max(|x·scale| + |shift|).  bf16: both round the f32
# result once more, and may land one bf16 ulp (2**-7 of |y|) apart.
BN_TOL_F32, BN_TOL_BF16 = 2.0 ** -23, 2.0 ** -23 + 2.0 ** -7
# beside ResNet50's geometries: a BN over 32,768 channels, which
# ``pallas_bn.supports`` admits (the door takes C up to 131,072 in f32)
BN_WIDE_GEOMETRY = (64, 32768, "relu")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


# GPU clock cycles (~0.5 ms) the card spins ahead of a call timed with
# ``spin``, so that the host has enqueued the call before the start event
# fires.  Without it an idle card records the start event at once and
# the time includes the host's Python and ctypes launch work (10-25 µs a
# call beside an H100), which the port pays on every launch: ``ms`` keeps
# it, and ``ms_device_only`` is the same call timed with the spin.
SPIN_CYCLES = 1_000_000


def median_ms(fn, torch, runs: int = TIMED_RUNS, before=None,
              spin: bool = False) -> float:
    """Median of ``runs`` single calls, each between CUDA events, host
    launch work included.  With ``spin`` the card reaches the start event
    only after a spin, so the host's enqueue of the call is hidden.
    ``before()`` runs ahead of each call, outside the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, rate: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[rate] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(kernel: str, bh: int, t: int, d: int, causal: bool,
                       dtype: str) -> tuple:
    """Least time for one call of ``kernel`` at ``[bh, t, d]``: inputs
    read once, outputs written once; operations per live (query, key)
    pair (causal counts the t(t+1)/2 live pairs):
      fwd    reads q, k, v; writes O, lse;        4·d (two products)
      bwd_dq reads q, k, v, dO, lse, D; writes dq; 6·d (S, dP, dS·K)
      bwd_dkv reads the same; writes dk, dv;      8·d (S, dP, Pᵀ·dO, dSᵀ·Q)
    """
    elem = 4 if dtype == "float32" else 2
    mat = bh * t * d * elem
    row = bh * t * 4
    nbytes, per_pair = {"fwd": (4 * mat + row, 4),
                        "bwd_dq": (5 * mat + 2 * row, 6),
                        "bwd_dkv": (6 * mat + 2 * row, 8)}[kernel]
    pairs = t * (t + 1) // 2 if causal else t * t
    rate = "float32_products" if dtype == "float32" else dtype
    return _bound(nbytes, per_pair * d * bh * pairs, rate)


def bn_bound_ms(m: int, c: int, dtype: str) -> tuple:
    """Least time for one BN-apply call on an [m, c] tensor: x read and y
    written once, scale and shift read once; one multiply-add (2
    operations) per element on the CUDA cores."""
    elem = 4 if dtype == "float32" else 2
    return _bound(2 * m * c * elem + 2 * c * elem, 2 * m * c, "float32")


def bn_geometries(conf, batch: int):
    """``{(rows, channels, activation): count}`` of the BatchNorm layers
    of a graph configuration at ``batch``."""
    from collections import Counter
    geo = Counter()
    for name in conf.topological_order:
        lc = getattr(conf.vertices[name], "layer", None)
        if type(lc).__name__ != "BatchNormalization":
            continue
        shape = conf.vertex_input_types[name][0].shape(batch)
        m = 1
        for d in shape[:-1]:
            m *= d
        geo[(m, shape[-1], lc.resolved("activation", "identity"))] += 1
    return geo


def seeded_params(spec, seed: int):
    """JAX-layout numpy param tree for ``spec`` ({layer: {name: (shape,
    dtype)}}): xavier-normal matrices, small biases, unit LN gains."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tree = {}
    for key, group in spec.items():
        tree[key] = {}
        for name, (shape, _) in sorted(group.items()):
            if len(shape) == 2:
                std = (2.0 / (shape[0] + shape[1])) ** 0.5
                arr = rng.standard_normal(shape) * std
            elif name.startswith("ln") and name.endswith("_g"):
                arr = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                arr = 0.02 * rng.standard_normal(shape)
            tree[key][name] = arr.astype(np.float32)
    return tree


MATMUL_TAGS = ("gemm", "cutlass", "xmma", "sm90_")
# kernel classes of a step's device time: (class, name substrings), the
# first match wins; anything else is "other"
LM_KERNEL_CLASSES = (("flash_attn_fwd", ("flash_fwd_kernel",)),
                     ("flash_attn_bwd_dq", ("flash_bwd_dq_kernel",)),
                     ("flash_attn_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                     ("matmul", MATMUL_TAGS))
CNN_KERNEL_CLASSES = (("bn_apply", ("bn_apply_kernel",)),
                      ("conv_and_matmul", MATMUL_TAGS + (
                          "conv", "cudnn", "implicit", "wgrad", "dgrad",
                          "fprop")))


def profile_steps(torch, net, batches, classes) -> dict:
    """Device time per training step by kernel class, from a
    ``torch.profiler`` trace of ``len(batches)`` ``fit`` steps.  The wall
    time of the profiled steps includes the profiler's own host overhead;
    the caller sets the device time against the unprofiled step time for
    the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_class = {name: 0.0 for name, _ in classes}
    per_class["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        key = ev.key.lower()
        cls = next((name for name, tags in classes
                    if any(t in key for t in tags)), "other")
        per_class[cls] += us / 1e3
    n = len(batches)
    return {"steps": n, "profiled_wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": {k: v / n for k, v in per_class.items()},
            "device_ms_total_per_step": sum(per_class.values()) / n}


def ptxas_report(log: str) -> list:
    """``"<kernel><mangled template arguments>: Used N registers, ..."``
    per compiled kernel instance of an ``nvcc -Xptxas -v`` log."""
    out, entry = [], "?"
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            # the kernel's length-prefixed name, then its template arguments
            for k in re.finditer(r"(?=(\d\d?)([a-z]\w*?_kernel)I(\w+?)EEv)",
                                 entry):
                if int(k.group(1)) == len(k.group(2)):
                    entry = f"{k.group(2)}<{k.group(3)}>"
                    break
        elif "Used" in ln and "registers" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
    return out


def build_all(kernel_build, sources) -> dict:
    """Build every source at once (one nvcc each); returns per-source
    seconds and the ptxas register lines."""
    def one(src):
        t0 = time.perf_counter()
        lib = kernel_build.build(src)
        return src, {"seconds": round(time.perf_counter() - t0, 3),
                     "ptxas": ptxas_report(
                         lib.with_suffix(".log").read_text())}

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources))


# ResNet50 training, fused (helper="pallas") vs unfused twin, f32 with
# TF32 off; the twin starts each step from the fused net's params.
# - Losses (a mean over 64 rows of −log p): the two paths round each BN
#   output differently, ~1 f32 ulp, which moves the loss by ~1e-7
#   relative: 1e-5.
# - Running statistics after 5 steps: EMAs of batch statistics taken at
#   the same params, apart by that rounding (~1e-6 relative): 1e-5 of
#   each stat's largest entry.
# - Eval outputs (probabilities <= 1): 1e-4 abs.
# - Step-0 gradients.  At initialisation this 50-layer BN network
#   amplifies rounding enormously: the unfused path run on the same batch
#   with its rows reversed (the same loss in exact arithmetic, rounded
#   otherwise in every BN and weight-gradient sum) moves the gradient by
#   ~3 % in relative L2.  That reordered run is the noise floor: the fused
#   gradients must differ from the unfused ones by at most 2x its relative
#   L2 over the net, and per parameter by at most 4x its largest
#   difference on that parameter plus 1e-6 of the net's largest |g|.
CNN_GRAD_NOISE_K, CNN_GRAD_LEAF_K, CNN_TOL_GRAD_NET = 2.0, 4.0, 1e-6
CNN_TOL_LOSS = 1e-5
CNN_TOL_STATE = 1e-5
CNN_TOL_EVAL = 1e-4

# The char-LSTM as the repo benchmarks it (utils/benchmarks.py
# char_lstm_step_time): the zoo TextGenerationLSTM, 26 classes, two
# LSTM-256 layers, batch 128 x 64 steps, f32.
LSTM_CLASSES, LSTM_HIDDEN, LSTM_T, LSTM_BATCH = 26, 256, 64, 128
LSTM_STEPS, LSTM_TIMED_STEPS = 5, 20
STREAM_BATCH, STREAM_PREFIX = 16, 16
# kernel vs plain: (t, b, h, f, nonzero initial state)
LSTM_CHECK_SHAPES = ((64, 128, 256, 256, False), (256, 32, 256, 256, False),
                     (1, 16, 256, 256, True), (7, 5, 100, 26, True))
LSTM_TIME_SHAPES = ((64, 128, 256), (256, 32, 256))
# Probabilities of the helper net vs its plain twin (f32, TF32 off).  The
# two differ only in the order of the recurrence's 256-term sums: h by
# ~1e-6 (lstm_kernel_vs_plain measures it in the same run).  The output
# layer's 256-term sums, |W| <~ 0.15 (xavier, std 0.084), move a logit by
# at most 256 * 0.15 * 1e-6 ~ 4e-5, and a probability p by at most twice
# that times p <= 1: 1e-4 abs.  The same bound holds between the streamed
# outputs and ``output`` over the same characters, which differ in the
# same way (another plan and projection shape per call).  Where the two
# nets' probabilities differ by at most e everywhere, their greedy
# choices can differ only where the top two are within 2·e: the twin,
# fed the same characters, must pick the same character at every other
# step (e measured in this run; the steps within 2·e are counted).
TOL_LSTM_OUT = 1e-4
# Training, helper net vs twin: the helper's backward differentiates the
# plain recurrence at the same saved inputs, so the two differ only by the
# forward's rounding (~1e-6 relative): step-0 gradients within 1e-4 of
# each leaf's largest |g| plus 1e-6 of the net's; losses (per row a sum
# over 64 steps of ~3.3 nats, averaged over 128 rows) within 1e-5
# relative.
TOL_LSTM_GRAD_LEAF, TOL_LSTM_GRAD_NET = 1e-4, 1e-6
TOL_LSTM_LOSS = 1e-5
LSTM_KERNEL_CLASSES = (("lstm_fwd", ("lstm_fwd_kernel",)),
                       ("matmul", MATMUL_TAGS))


def lstm_error_bound(torch, x, W, U, b, h0, c0) -> float:
    """A bound on |kernel - plain| for ``ys``, ``hT`` and ``cT`` from these
    inputs (f32 on both sides; they differ only in the order of the sums).

    Per step, each side computes every z = xz + Σ_k h_k·U[k, j] with H + 1
    roundings, so each is within γ_{H+1}·S of the exact value (Higham's
    bound, γ_n = n·u / (1 - n·u), u = 2⁻²⁴), S = max |xz| + Σ_k |h_k||U_kj|:
    the two within e_z = 2·γ_{H+1}·S.  The gates are Lipschitz (sigmoid
    with 1/4, tanh with 1) and the two sides' expf / tanhf may differ by a
    few ulps of 1 (2⁻²¹ allowed): each gate value within e_g = e_z + 2⁻²¹.
    Then c' = f·c + i·g moves by at most |f||δc| + |c||δf| + |g||δi| +
    |i||δg| <= f·|δc| + (|c| + 2)·e_g (|i|, |g| <= 1), and h = o·tanh(c)
    by at most |δc| + e_g.  So, unit by unit, the c error after step t is
    at most B_t·e_g with B_t = f_t·B_{t-1} + |c_{t-1}| + 2, B_{-1} = 0: it
    grows through c, damped by the forget gate it passes, and the bound
    is (max_t B_t + 1)·e_g.  It leaves out the feedback of δh into the
    next step's z through U; the measured error, orders of magnitude
    below the bound, shows that feedback does not amplify it here.  S, f
    and c are taken from a plain f32 run of the recurrence on these
    inputs."""
    t, h = x.shape[1], U.shape[0]
    u = 2.0 ** -24
    gamma = (h + 1) * u / (1 - (h + 1) * u)
    xz = x @ W + b
    ua = U.abs()
    hh, cc = h0, c0
    s_max, b_max = 0.0, 0.0
    grow = torch.zeros_like(c0)      # B_t, in units of e_g
    for s in range(t):
        s_max = max(s_max, (xz[:, s].abs() + hh.abs() @ ua).max().item())
        zi, zf, zo, zg = (xz[:, s] + hh @ U).chunk(4, dim=-1)
        f = torch.sigmoid(zf)
        grow = f * grow + cc.abs() + 2
        cc = f * cc + torch.sigmoid(zi) * torch.tanh(zg)
        hh = torch.sigmoid(zo) * torch.tanh(cc)
        b_max = max(b_max, grow.max().item())
    e_g = 2 * gamma * s_max + 2.0 ** -21
    return (b_max + 1) * e_g


def lstm_bound_ms(t: int, b: int, h: int) -> tuple:
    """Least time for one ``lstm_fwd`` launch: xz [t, b, 4h], U [h, 4h],
    h0 and c0 read once, ys [t, b, h], hT and cT written once, all f32;
    per step and row, the [h] x [h, 4h] product (8h² operations), the 4h
    adds of xz, the cell's 4h multiply-adds and 5h sigmoids and tanhs,
    all counted at the f32 rate of products (three TF32 passes)."""
    nbytes = 4 * (t * b * 4 * h + 4 * h * h + 2 * b * h + t * b * h
                  + 2 * b * h)
    return _bound(nbytes, t * b * h * (8 * h + 13), "float32_products")


def lstm_phases(args, torch, dev, card):
    """Phases 10-12 (char-LSTM).  Returns ``(the lstm_fwd kernels record,
    None)``, or ``(None, what failed)``."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        _stack_loss)
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl

    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)

    def lstm_inputs(t, b, h, f, nonzero):
        x = torch.randn((b, t, f), generator=gen, device=dev)
        W = torch.randn((f, 4 * h), generator=gen, device=dev) \
            * (2 / (f + 4 * h)) ** 0.5
        U = torch.randn((h, 4 * h), generator=gen, device=dev) \
            * (2 / (5 * h)) ** 0.5
        bias = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
        h0, c0 = ((torch.randn((b, h), generator=gen, device=dev) * 0.5)
                  if nonzero else torch.zeros((b, h), device=dev)
                  for _ in range(2))
        return x, W, U, bias, h0, c0

    # ---- 10. LSTM kernel vs plain ----------------------------------------
    lstm_err = 0.0
    for t, b, h, f, nonzero in LSTM_CHECK_SHAPES:
        args6 = lstm_inputs(t, b, h, f, nonzero)
        got = pl.lstm_forward(*args6)
        want = pl.lstm_forward_plain(*args6)
        torch.cuda.synchronize()
        tol = lstm_error_bound(torch, *args6)
        errs = {}
        for name, g, w in zip(("ys", "hT", "cT"), got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                return None, f"lstm_fwd {name} at {(t, b, h)}: shape " \
                             f"{tuple(g.shape)} or not finite"
            errs[name] = (g - w).abs().max().item()
        p = pl.device_plan(b, h, t, dev)
        print(json.dumps({"phase": "lstm_kernel_vs_plain", "t": t,
                          "batch": b, "hidden": h, "features": f,
                          "nonzero_state": nonzero, "plan": p.__dict__,
                          "max_abs_err": errs, "tol": tol}), flush=True)
        if max(errs.values()) > tol:
            return None, (f"lstm_fwd disagrees with plain at (t, b, h) = "
                          f"{(t, b, h)}: {errs} > {tol}")
        lstm_err = max(lstm_err, *errs.values())
        del args6, got, want

    # ---- 11a. serve and stream -------------------------------------------
    zoo = TextGenerationLSTM(num_classes=LSTM_CLASSES, timesteps=LSTM_T,
                             hidden=LSTM_HIDDEN, seed=args.seed)

    def build(helper):
        conf = zoo.conf()
        for lc in conf.layers:
            if isinstance(lc, LSTM):
                lc.helper = helper
        return MultiLayerNetwork(conf, device=dev)

    net = build("pallas").init()
    twin = build(None).load_params({
        k: {n: p.detach().cpu().numpy() for n, p in g.items()}
        for k, g in net.params.items()})
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 6)

    def onehot(ids):
        return F.one_hot(ids, LSTM_CLASSES).float()

    def ifog_to_cudnn(a):
        """Gate blocks IFOG (the port's order) -> IFGO (cuDNN's), dim 0."""
        i, f, o, g = a.chunk(4, dim=0)
        return torch.cat((i, f, g, o))

    x_serve = onehot(torch.randint(0, LSTM_CLASSES, (LSTM_BATCH, LSTM_T),
                                   generator=dgen, device=dev))
    torch.cuda.synchronize()
    pl.reset_launches()
    probs = net.output(x_serve)
    torch.cuda.synchronize()
    output_launches = pl.launches["lstm_fwd"]
    want = twin.output(x_serve)
    out_err = (probs - want).abs().max().item()

    prefix = torch.randint(0, LSTM_CLASSES, (STREAM_BATCH, STREAM_PREFIX),
                           generator=dgen, device=dev)
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    pl.reset_launches()
    outs = [net.rnn_time_step(onehot(prefix))]
    fed = [prefix]
    nxt = outs[0][:, -1].argmax(-1)
    for _ in range(LSTM_T - STREAM_PREFIX):
        fed.append(nxt[:, None])
        step = net.rnn_time_step(onehot(nxt))
        outs.append(step[:, None])
        nxt = step.argmax(-1)
    torch.cuda.synchronize()
    stream_launches = pl.launches["lstm_fwd"]
    stream_calls = 1 + LSTM_T - STREAM_PREFIX
    text = torch.cat(fed, dim=1)
    streamed = torch.cat(outs, dim=1)
    # the twin, fed the same characters
    twin.rnn_clear_previous_state()
    touts = [twin.rnn_time_step(onehot(prefix))]
    for c in fed[1:]:
        touts.append(twin.rnn_time_step(onehot(c[:, 0]))[:, None])
    tstreamed = torch.cat(touts, dim=1)
    stream_err = (streamed - tstreamed).abs().max().item()
    # greedy choices: from the last prefix output on
    choice = streamed[:, STREAM_PREFIX - 1:].argmax(-1)
    tchoice_p = tstreamed[:, STREAM_PREFIX - 1:]
    top2 = tchoice_p.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * stream_err
    differ = (tchoice_p.argmax(-1) != choice)
    mismatches = int((differ & ~tie).sum().item())
    ties = int(tie.sum().item())
    whole = net.output(onehot(text))
    whole_err = (whole - streamed).abs().max().item()
    print(json.dumps({
        "phase": "lstm_serve", "model": {
            "name": "TextGenerationLSTM", "classes": LSTM_CLASSES,
            "hidden": LSTM_HIDDEN, "layers": "LSTM, LSTM, RnnOutputLayer",
            "dtype": "float32", "helper": "pallas",
            "num_params": net.num_params()},
        "output": {"batch": LSTM_BATCH, "t": LSTM_T,
                   "max_abs_err_vs_twin": out_err,
                   "kernel_launches": output_launches,
                   "expected_launches": 2},
        "stream": {"batch": STREAM_BATCH, "prefix": STREAM_PREFIX,
                   "single_steps": LSTM_T - STREAM_PREFIX,
                   "calls": stream_calls,
                   "max_abs_err_vs_twin": stream_err,
                   "greedy_choices": int(choice.numel()),
                   "choices_differing_from_twin": mismatches,
                   "ties_within_2x_err": ties,
                   "max_abs_err_vs_output_of_the_text": whole_err,
                   "kernel_launches": stream_launches,
                   "expected_launches": 2 * stream_calls},
        "tol": TOL_LSTM_OUT}), flush=True)
    if output_launches != 2 or stream_launches != 2 * stream_calls:
        return None, (f"lstm_fwd launched {output_launches} times for one "
                      f"output and {stream_launches} for {stream_calls} "
                      "streaming calls; expected 2 per call")
    if probs.shape != (LSTM_BATCH, LSTM_T, LSTM_CLASSES) or \
            not bool(torch.isfinite(probs).all()) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-4:
        return None, f"char-LSTM output shape {tuple(probs.shape)} or rows"
    if out_err > TOL_LSTM_OUT or stream_err > TOL_LSTM_OUT or \
            whole_err > TOL_LSTM_OUT:
        return None, (f"char-LSTM outputs differ: output vs twin {out_err}, "
                      f"stream vs twin {stream_err}, stream vs output "
                      f"{whole_err} (tol {TOL_LSTM_OUT})")
    if mismatches:
        return None, (f"{mismatches} greedy characters differ from the "
                      "twin's outside a tie")
    del probs, want, whole, streamed, tstreamed

    # ---- 11b. train ------------------------------------------------------
    seqs = torch.randint(0, LSTM_CLASSES, (LSTM_STEPS, LSTM_BATCH,
                                           LSTM_T + 1),
                         generator=dgen, device=dev)
    batches = [(onehot(s[:, :-1]), onehot(s[:, 1:])) for s in seqs]
    grads, loss0 = [], []
    for m in (net, twin):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss = _stack_loss(m.conf, params, *batches[0], train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss, [params[k][n] for k, n in keys]))))
        loss0.append(loss.item())
    net_max = max(g.abs().max().item() for g in grads[1].values())
    worst_ratio, worst_name = 0.0, ""
    for key, g in grads[0].items():
        w = grads[1][key]
        err = (g - w).abs().max().item()
        tol = TOL_LSTM_GRAD_LEAF * w.abs().max().item() \
            + TOL_LSTM_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return None, (f"step-0 gradient {key} helper vs twin: {err} > "
                          f"{tol}")
        if err / tol >= worst_ratio:
            worst_ratio, worst_name = err / tol, "/".join(key)
    del grads

    snaps = []
    torch.cuda.synchronize()
    pl.reset_launches()
    t0 = time.perf_counter()
    step_losses = []
    for x, y in batches:
        snaps.append([p.detach().clone() for p in net.parameters()])
        net.fit(x, y)
        step_losses.append(net._score)     # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = pl.launches["lstm_fwd"]
    losses = [float(v) for v in step_losses]
    twin_losses = []
    for snap, (x, y) in zip(snaps, batches):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        twin.fit(x, y)
        twin_losses.append(twin.get_score())
    del snaps
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))
    print(json.dumps({
        "phase": "lstm_train", "model": {
            "name": "TextGenerationLSTM", "batch": LSTM_BATCH, "t": LSTM_T,
            "dtype": "float32", "updater": "Adam(learning_rate=2e-3)",
            "gradient_normalization": "clipelementwiseabsolutevalue 10",
            "loss": "mcxent", "helper": "pallas"},
        "steps": LSTM_STEPS, "step0_loss": loss0, "losses": losses,
        "twin_losses": twin_losses, "max_rel_loss_diff": loss_diff,
        "tol_loss": TOL_LSTM_LOSS,
        "step0_grad_worst_err_over_tol": worst_ratio,
        "step0_grad_worst_param": worst_name,
        "tol_grad": [TOL_LSTM_GRAD_LEAF, TOL_LSTM_GRAD_NET],
        "kernel_launches": train_launches,
        "expected_launches": 2 * LSTM_STEPS,
        "seconds": round(train_s, 4)}), flush=True)
    if train_launches != 2 * LSTM_STEPS:
        return None, (f"lstm_fwd launched {train_launches} times in "
                      f"{LSTM_STEPS} steps; expected 2 per step")
    if not all(np.isfinite(losses + twin_losses)) or \
            loss_diff > TOL_LSTM_LOSS:
        return None, (f"char-LSTM losses {losses} vs twin {twin_losses}: "
                      f"{loss_diff} > {TOL_LSTM_LOSS}")

    # ---- 12. times -------------------------------------------------------
    models = {"pallas": net, "plain": twin}
    step_ms = {"pallas": [], "plain": []}
    for m in models.values():
        for x, y in batches[:2]:
            m.fit(x, y)
    torch.cuda.synchronize()
    for name in ("plain", "pallas", "pallas", "plain"):
        for i in range(LSTM_TIMED_STEPS // 2):
            x, y = batches[i % LSTM_STEPS]
            t1 = time.perf_counter()
            models[name].fit(x, y)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t1) * 1e3)
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    splits = {}
    for name, m in models.items():
        split = profile_steps(torch, m, batches[:PROFILED_STEPS],
                              LSTM_KERNEL_CLASSES)
        busy = split["device_ms_total_per_step"] / med[name] \
            if split["device_ms_total_per_step"] else None
        split["device_busy_share"] = busy
        split["device_idle_share"] = None if busy is None else 1 - busy
        splits[name] = split
    out_ms = {name: median_ms(lambda: m.output(x_serve), torch)
              for name, m in models.items()}
    tokens = LSTM_BATCH * LSTM_T
    print(json.dumps({"phase": "lstm_train_time", "batch": LSTM_BATCH,
                      "t": LSTM_T, "steps_per_net": LSTM_TIMED_STEPS,
                      "step_ms_median": med["pallas"],
                      "tokens_per_s": tokens / med["pallas"] * 1e3,
                      "plain_step_ms_median": med["plain"],
                      "plain_tokens_per_s": tokens / med["plain"] * 1e3,
                      "step_ms": step_ms, "profile": splits["pallas"],
                      "plain_profile": splits["plain"],
                      "output_batch128_ms": out_ms["pallas"],
                      "plain_output_batch128_ms": out_ms["plain"],
                      "card": card}), flush=True)
    del net, twin, models, batches, x_serve

    timings = {}
    for t, b, h in LSTM_TIME_SHAPES:
        f = h
        x, W, U, bias, h0, c0 = lstm_inputs(t, b, h, f, False)
        p = pl.device_plan(b, h, t, dev)
        xz = pl.input_projection(x, W, bias)
        ys = torch.empty((t, b, h), device=dev)
        hT, cT = torch.empty((b, h), device=dev), torch.empty((b, h),
                                                                device=dev)
        # straight through the binding: timing launches are not counted
        kern = median_ms(lambda: pl._launch(xz, U, h0, c0, ys, hT, cT, p),
                         torch)
        kern_dev = median_ms(lambda: pl._launch(xz, U, h0, c0, ys, hT, cT,
                                                p), torch, spin=True)
        with_proj = median_ms(lambda: pl._launch(
            pl.input_projection(x, W, bias), U, h0, c0, ys, hT, cT, p),
            torch)
        # the serial chain alone: the same t and h at batch 1
        p1 = pl.device_plan(1, h, t, dev)
        x1, h01, c01 = x[:1], h0[:1], c0[:1]
        xz1 = pl.input_projection(x1, W, bias)
        ys1 = torch.empty((t, 1, h), device=dev)
        hT1, cT1 = torch.empty((1, h), device=dev), torch.empty((1, h),
                                                                 device=dev)
        serial = median_ms(lambda: pl._launch(xz1, U, h01, c01, ys1, hT1,
                                              cT1, p1), torch)
        plain = median_ms(lambda: pl.lstm_forward_plain(x, W, U, bias, h0,
                                                        c0), torch, runs=10)
        # cuDNN on the same weights: gates IFOG -> IFGO, b_hh = 0
        lib = torch.nn.LSTM(f, h, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifog_to_cudnn(W.t()))
            lib.weight_hh_l0.copy_(ifog_to_cudnn(U.t()))
            lib.bias_ih_l0.copy_(ifog_to_cudnn(bias))
            lib.bias_hh_l0.zero_()
            lib_y = lib(x, (h0[None], c0[None]))[0]
            lib_err = (lib_y - ys.transpose(0, 1)).abs().max().item()
            lib_ms = median_ms(lambda: lib(x, (h0[None], c0[None])), torch)
        bound, bound_by = lstm_bound_ms(t, b, h)
        timings[(t, b, h)] = (kern, plain, lib_ms, bound, bound_by,
                              with_proj, kern_dev)
        print(json.dumps({"phase": "kernel_time", "kernel": "lstm_fwd",
                          "t": t, "batch": b, "hidden": h, "features": f,
                          "plan": p.__dict__, "ms": kern,
                          "ms_device_only": kern_dev,
                          "ms_with_projection": with_proj,
                          "serial_ms_at_batch_1": serial,
                          "plain_ms": plain, "library_ms": lib_ms,
                          "library_call": "torch.nn.LSTM (cuDNN), "
                                          "projection included",
                          "library_max_abs_diff": lib_err,
                          "bound_ms": bound, "bound_by": bound_by,
                          "card": card}), flush=True)
        del x, xz, ys, lib
    kern, plain, lib_ms, bound, bound_by, with_proj, kern_dev = \
        timings[LSTM_TIME_SHAPES[0]]
    return {"name": "lstm_fwd", "route": "cuda",
            "source": f"{SRC_DIR}/{pl.SOURCE}",
            "replaces": "deeplearning4j_tpu/ops/pallas_lstm.py:51",
            "launches": train_launches, "max_abs_err": lstm_err,
            "ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms,
            "ms_device_only": kern_dev, "ms_with_projection": with_proj,
            "launches_by_path": {"output": output_launches,
                                 "stream": stream_launches,
                                 "fit": train_launches},
            "per": "one launch at t 64, batch 128, h 256; plain_ms and "
                   "library_ms include the input projection, as "
                   "ms_with_projection does"}, None


def cnn_phases(args, torch, dev, card):
    """Phases 7-9 (ResNet50).  Returns ``(the bn_apply kernels record,
    None)``, or ``(None, what failed)``."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import (
        ComputationGraph, _graph_loss)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb

    zoo = ResNet50(seed=args.seed)
    geoms = bn_geometries(zoo.conf(), CNN_BATCH)
    if sum(geoms.values()) != 53:
        return None, f"ResNet50 has {sum(geoms.values())} BN layers, not 53"

    # ---- 7. BN apply kernel vs plain at every geometry -------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    bn_err = 0.0
    for (m, c, act), count in sorted(geoms.items()) + [(BN_WIDE_GEOMETRY,
                                                         0)]:
        for dname, dt, tol_rel in (("float32", torch.float32, BN_TOL_F32),
                                   ("bfloat16", torch.bfloat16,
                                    BN_TOL_BF16)):
            x = (torch.randn((m, c), generator=gen, device=dev) * 2
                 + 0.5).to(dt)
            scale = torch.randn(c, generator=gen, device=dev).to(dt)
            shift = torch.randn(c, generator=gen, device=dev).to(dt)
            tol = tol_rel * (x.float().abs() * scale.float().abs()
                             + shift.float().abs()).max().item()
            errs = {}
            for relu in (True, False):
                y = pb.bn_apply(x, scale, shift, relu)
                want = pb.bn_apply_plain(x, scale, shift, relu)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(y.float()).all()):
                    return None, f"bn_apply not finite at [{m}, {c}] {dname}"
                errs["relu" if relu else "identity"] = \
                    (y.float() - want.float()).abs().max().item()
            print(json.dumps({"phase": "bn_kernel_vs_plain", "rows": m,
                              "channels": c, "resnet_activation": act,
                              "resnet_layers": count, "dtype": dname,
                              "max_abs_err": errs, "tol": tol}), flush=True)
            if max(errs.values()) > tol:
                return None, (f"bn_apply disagrees with plain at [{m}, {c}] "
                              f"{dname}: {errs} > {tol}")
            if dname == "float32":
                bn_err = max(bn_err, *errs.values())
            del x, y, want

    # ---- 8. full-width ResNet50 training ---------------------------------
    nets = {}
    for helper in ("pallas", None):
        conf = zoo.conf()
        for v in conf.vertices.values():
            lc = getattr(v, "layer", None)
            if type(lc).__name__ == "BatchNormalization":
                lc.helper = helper
        nets[helper] = ComputationGraph(conf, device=dev)
    net = nets["pallas"].init()
    twin = nets[None].load_params({
        k: {n: p.detach().cpu().numpy() for n, p in g.items()}
        for k, g in net.params.items()})
    h, w, c = zoo.input_shape
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    xs = [torch.randn((CNN_BATCH, h, w, c), generator=dgen, device=dev)
          for _ in range(CNN_STEPS)]
    ys = [F.one_hot(torch.randint(0, zoo.num_classes, (CNN_BATCH,),
                                  generator=dgen, device=dev),
                    zoo.num_classes).float() for _ in range(CNN_STEPS)]

    # step-0 loss and gradients of every parameter, fused vs unfused; and
    # the unfused twin once more on the batch in reverse row order: the
    # same loss in exact arithmetic (BN statistics and the loss are means
    # over rows), rounded otherwise in every BN and every weight-gradient
    # sum.  That pair is the f32 noise floor of each gradient here.
    grads, loss0 = [], []
    for m, x, y in ((net, xs[0], ys[0]), (twin, xs[0], ys[0]),
                    (twin, xs[0].flip(0), ys[0].flip(0))):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss, _ = _graph_loss(m.conf, params, m.state, [x], [y],
                              train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss, [params[k][n] for k, n in keys]))))
        loss0.append(loss.item())
        del loss
    fused_g, twin_g, flip_g = grads
    net_max = max(g.abs().max().item() for g in twin_g.values())
    worst_ratio, worst_name, rel = 0.0, "", []
    sq = {"fused": 0.0, "reordered": 0.0, "norm": 0.0}
    for key, g in fused_g.items():
        want = twin_g[key]
        err = (g - want).abs().max().item()
        noise = (flip_g[key] - want).abs().max().item()
        tol = CNN_GRAD_LEAF_K * noise + CNN_TOL_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return None, (f"step-0 gradient {key} fused vs unfused: {err} > "
                          f"{tol} ({CNN_GRAD_LEAF_K} x the reordered "
                          f"twin's {noise})")
        rel.append((err / noise if noise else float("inf"), "/".join(key)))
        if err / tol >= worst_ratio:
            worst_ratio, worst_name = err / tol, "/".join(key)
        sq["fused"] += ((g - want) ** 2).sum().item()
        sq["reordered"] += ((flip_g[key] - want) ** 2).sum().item()
        sq["norm"] += (want ** 2).sum().item()
    grad_rel_l2 = {k: (sq[k] / sq["norm"]) ** 0.5
                   for k in ("fused", "reordered")}
    del grads, fused_g, twin_g, flip_g
    if grad_rel_l2["fused"] > CNN_GRAD_NOISE_K * grad_rel_l2["reordered"]:
        return None, (f"step-0 gradients fused vs unfused, relative L2 "
                      f"{grad_rel_l2['fused']} > {CNN_GRAD_NOISE_K} x the "
                      f"reordered twin's {grad_rel_l2['reordered']}")

    # the main path: 5 fit steps of the fused net, counted
    names = [n for n, _ in net.named_parameters()]
    if names != [n for n, _ in twin.named_parameters()]:
        return None, "the twin's parameters are not the fused net's"
    snaps = []
    torch.cuda.synchronize()
    pb.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    step_losses = []
    for x, y in zip(xs, ys):
        snaps.append([p.detach().clone() for p in net.parameters()])
        net.fit(x, y)
        step_losses.append(net._score)     # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(pb.launches)
    flash_launches = dict(fa.launches)
    losses = [float(v) for v in step_losses]

    # the twin: each step from the fused net's params before that step
    pb.reset_launches()
    twin_losses = []
    for snap, x, y in zip(snaps, xs, ys):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        twin.fit(x, y)
        twin_losses.append(twin.get_score())
    twin_launches = pb.launches["bn_apply"]
    del snaps
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))
    state_diff = max(
        ((net.state[k][n] - t).abs().max()
         / t.abs().max().clamp(min=1e-30)).item()
        for k, g in twin.state.items() for n, t in g.items())
    xe = xs[0][:CNN_EVAL_ROWS]
    pe, te = net.output(xe), twin.output(xe)
    eval_diff = (pe - te).abs().max().item()
    eval_max_prob = pe.max().item()
    expected = 53 * CNN_STEPS
    rel.sort(reverse=True)
    print(json.dumps({
        "phase": "cnn_train", "model": {
            "name": "ResNet50", "input": list(zoo.input_shape),
            "classes": zoo.num_classes, "batch": CNN_BATCH,
            "dtype": "float32", "tf32": False,
            "updater": "Nesterovs(learning_rate=0.1, momentum=0.9)",
            "bn_helper": "pallas", "num_params": net.num_params()},
        "steps": CNN_STEPS, "step0_loss": loss0, "losses": losses,
        "twin_losses": twin_losses, "max_rel_loss_diff": loss_diff,
        "tol_loss": CNN_TOL_LOSS,
        "step0_grad_worst_err_over_tol": worst_ratio,
        "step0_grad_worst_param": worst_name,
        "step0_grad_err_over_reordered_noise_worst": rel[:5],
        "step0_grad_rel_l2": grad_rel_l2,
        "tol_grad": {"rel_l2_times_reordered": CNN_GRAD_NOISE_K,
                     "leaf_times_reordered": CNN_GRAD_LEAF_K,
                     "leaf_of_net_max": CNN_TOL_GRAD_NET},
        "max_rel_running_stat_diff": state_diff,
        "tol_state": CNN_TOL_STATE, "eval_max_abs_diff": eval_diff,
        "tol_eval": CNN_TOL_EVAL, "eval_max_prob": eval_max_prob,
        "kernel_launches": launches,
        "expected_launches": {"bn_apply": expected},
        "flash_launches": flash_launches, "twin_bn_launches": twin_launches,
        "seconds": round(train_s, 4)}), flush=True)
    if launches["bn_apply"] != expected or twin_launches or \
            any(flash_launches.values()):
        return None, (f"bn_apply launched {launches} (twin {twin_launches}"
                      f", flash {flash_launches}); expected {expected}")
    if not all(np.isfinite(losses + twin_losses)) or \
            loss_diff > CNN_TOL_LOSS:
        return None, (f"losses {losses} vs twin {twin_losses}: "
                      f"{loss_diff} > {CNN_TOL_LOSS}")
    if state_diff > CNN_TOL_STATE:
        return None, (f"running stats differ from the twin's by "
                      f"{state_diff} > {CNN_TOL_STATE}")
    if pe.shape != (CNN_EVAL_ROWS, zoo.num_classes) or \
            not bool(torch.isfinite(pe).all()) or \
            (pe.sum(-1) - 1).abs().max().item() > 1e-4 or \
            eval_diff > CNN_TOL_EVAL:
        return None, f"eval outputs differ from the twin's by {eval_diff}"
    del pe, te

    # ---- 9. times -----------------------------------------------------
    step_ms = {"pallas": [], "unfused": []}
    models = {"pallas": net, "unfused": twin}
    for m in models.values():
        for i in range(2):
            m.fit(xs[i], ys[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ("unfused", "pallas", "pallas", "unfused"):
        for i in range(CNN_TIMED_STEPS // 2):
            x, y = xs[i % CNN_STEPS], ys[i % CNN_STEPS]
            t1 = time.perf_counter()
            models[name].fit(x, y)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t1) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    splits = {}
    for name, m in models.items():
        split = profile_steps(torch, m, list(zip(xs, ys))[:PROFILED_STEPS],
                              CNN_KERNEL_CLASSES)
        busy = split["device_ms_total_per_step"] / med[name] \
            if split["device_ms_total_per_step"] else None
        split["device_busy_share"] = busy
        split["device_idle_share"] = None if busy is None else 1 - busy
        splits[name] = split
    del twin, models
    print(json.dumps({"phase": "cnn_train_time", "batch": CNN_BATCH,
                      "steps_per_net": CNN_TIMED_STEPS,
                      "step_ms_median": med["pallas"],
                      "images_per_s": CNN_BATCH / med["pallas"] * 1e3,
                      "unfused_step_ms_median": med["unfused"],
                      "unfused_images_per_s": CNN_BATCH / med["unfused"]
                      * 1e3, "step_ms": step_ms,
                      "peak_memory_gb": peak_gb, "profile": splits["pallas"],
                      "unfused_profile": splits["unfused"],
                      "card": card}), flush=True)
    del net, xs, ys
    torch.cuda.empty_cache()

    # BN apply at each geometry: kernel, plain version, torch.addcmul.
    # Each timed launch follows a 64 MB read, which evicts the 50 MB L2
    # and leaves it clean (a write flush would leave dirty lines whose
    # writeback the timed launch pays for).
    flush_buf = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    flush_out = torch.empty((), dtype=torch.float32, device=dev)

    def flush():
        torch.sum(flush_buf, dim=0, out=flush_out)

    totals = {"ms": 0.0, "ms_device_only": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0, "bound_ms": 0.0}
    bound_by_all = set()
    for (m, c, act), count in sorted(geoms.items()):
        x = torch.randn((m, c), generator=gen, device=dev)
        scale = torch.randn(c, generator=gen, device=dev)
        shift = torch.randn(c, generator=gen, device=dev)
        out = torch.empty_like(x)
        relu = act == "relu"
        p = pb.device_plan(x, scale, shift, out)
        row = {}
        # straight through the binding: timing launches are not counted
        row["ms"] = median_ms(lambda: pb._launch(x, scale, shift, out, relu),
                              torch, before=flush)
        row["ms_device_only"] = median_ms(
            lambda: pb._launch(x, scale, shift, out, relu), torch,
            before=flush, spin=True)
        row["library_ms"] = median_ms(lambda: torch.addcmul(shift, x, scale),
                                      torch, before=flush)
        row["plain_ms"] = median_ms(
            lambda: pb.bn_apply_plain(x, scale, shift, relu), torch, runs=10,
            before=flush)
        bound, bound_by = bn_bound_ms(m, c, "float32")
        row["bound_ms"] = bound
        bound_by_all.add(bound_by)
        for key in totals:
            totals[key] += count * row[key]
        nbytes = 2 * m * c * 4 + 2 * c * 4
        print(json.dumps({"phase": "kernel_time", "kernel": "bn_apply",
                          "dtype": "float32", "rows": m, "channels": c,
                          "activation": act, "layers_per_step": count,
                          "plan": dataclasses.asdict(p), **row,
                          "gbps": nbytes / row["ms"] / 1e6,
                          "bound_share": bound / row["ms"],
                          "library_call": "torch.addcmul(shift, x, scale)"
                          + (" (relu would need a second call)"
                             if relu else ""),
                          "bound_by": bound_by, "card": card}), flush=True)
        del x, out
    in_step = splits["pallas"]["device_ms_per_step"]["bn_apply"]
    return {"name": "bn_apply", "route": "cuda",
            "source": f"{SRC_DIR}/{pb.SOURCE}",
            "replaces": "deeplearning4j_tpu/ops/pallas_bn.py:82",
            "launches": launches["bn_apply"], "max_abs_err": bn_err,
            **totals, "bound_share": totals["bound_ms"] / totals["ms"],
            "bound_by": "/".join(sorted(bound_by_all)),
            "in_step_profiled_ms": in_step,
            "per": "one ResNet50 training step at batch 64, f32: the 53 "
                   "launches at their shapes, summed, each after a clean "
                   "L2 flush"}, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (REPO / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        return fail(f"no deeplearning4j_tpu_torch package beside {__file__}")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke needs "
                    "a CUDA GPU")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.utils import kernel_build
    from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    src_dir = SRC_DIR

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all(kernel_build, [fa.SOURCE, fa.BWD_SOURCE, pb.SOURCE,
                                     pl.SOURCE])
    print(json.dumps({"phase": "build", "seconds": round(
        time.perf_counter() - t0, 3), "sources": {
            f"{src_dir}/{s}": v for s, v in built.items()}}), flush=True)

    # ---- 2-3. forward and backward kernels vs plain on the card --------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bh = MAX_BATCH * HEADS
    shape = (bh, SEQ, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    inputs, saved, max_err = {}, {}, {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for shp in (shape, *CHECK_SHAPES):
            sc = shp[2] ** -0.5
            q, k, v, do = (torch.randn(shp, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            main_shape = shp == shape
            if main_shape:
                inputs[dname] = (q, k, v, do)
            for causal in (True, False):
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                scale=sc)
                po, plse = fa.flash_attention_fwd_plain(q, k, v, causal, sc)
                torch.cuda.synchronize()
                err_o = (o.float() - po.float()).abs().max().item()
                err_l = (lse - plse).abs().max().item()
                finite = bool(torch.isfinite(o.float()).all())
                print(json.dumps({"phase": "kernel_vs_plain", "dtype": dname,
                                  "causal": causal, "shape": list(shp),
                                  "max_abs_err_o": err_o,
                                  "max_abs_err_lse": err_l,
                                  "tol_o": TOL_O[dname], "tol_lse": TOL_LSE}),
                      flush=True)
                if not finite or err_o > TOL_O[dname] or err_l > TOL_LSE:
                    return fail(f"kernel disagrees with plain ({dname}, "
                                f"causal={causal}, {list(shp)}): O {err_o}, "
                                f"lse {err_l}")
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sc)
                again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                               sc)
                want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal, sc)
                torch.cuda.synchronize()
                # one CTA owns each output tile: no atomics, the same bits
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                rel, absolute = {}, {}
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    if not bool(torch.isfinite(g.float()).all()):
                        return fail(f"{name} not finite ({dname}, causal="
                                    f"{causal}, {list(shp)})")
                    diff = (g.float() - w.float()).abs().max().item()
                    absolute[name] = diff
                    rel[name] = diff / w.float().abs().max().item()
                print(json.dumps({"phase": "bwd_kernel_vs_plain",
                                  "dtype": dname, "causal": causal,
                                  "shape": list(shp), "max_abs_err": absolute,
                                  "rel_err": rel,
                                  "tol_rel": TOL_BWD[dname],
                                  "deterministic": same}), flush=True)
                if max(rel.values()) > TOL_BWD[dname]:
                    return fail(f"backward kernels disagree with plain "
                                f"({dname}, causal={causal}, {list(shp)}): "
                                f"{rel}")
                if not same:
                    return fail(f"two backward launches on the same inputs "
                                f"differ ({dname}, causal={causal}, "
                                f"{list(shp)})")
                if main_shape:
                    saved[(dname, causal)] = (o, lse)
                    max_err[("fwd", dname, causal)] = max(err_o, err_l)
                    max_err[("bwd_dq", dname, causal)] = absolute["dq"]
                    max_err[("bwd_dkv", dname, causal)] = max(
                        absolute["dk"], absolute["dv"])
                del o, lse, po, plse, got, again, want
            del q, k, v, do

    # head_dim 320: flash_attention takes sdpa_reference by its shape rule
    # (kernel_supports); no kernel launches, and the plain forward agrees
    b, h, t, d = WIDE_HEAD_DIM_SHAPE
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
               for _ in range(3))
    fa.reset_launches()
    for causal in (True, False):
        out = fa.flash_attention(q, k, v, causal=causal)
        want, _ = fa.flash_attention_fwd_plain(
            *(x.reshape(b * h, t, d) for x in (q, k, v)), causal, d ** -0.5)
        torch.cuda.synchronize()
        err = (out.reshape(b * h, t, d) - want).abs().max().item()
        wide_launches = dict(fa.launches)
        print(json.dumps({"phase": "wide_head_dim", "shape": [b, h, t, d],
                          "causal": causal, "supports": fa.supports(t, t, d),
                          "kernel_supports": fa.kernel_supports(t, t, d),
                          "kernel_launches": wide_launches,
                          "max_abs_err": err, "tol": TOL_O["float32"]}),
              flush=True)
        if any(wide_launches.values()) or not fa.supports(t, t, d) or \
                not bool(torch.isfinite(out).all()) or \
                err > TOL_O["float32"]:
            return fail(f"head_dim {d} through flash_attention: launches "
                        f"{wide_launches}, error {err}")
    del q, k, v, out, want

    # ---- 4. full-width serve ---------------------------------------------
    lm = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                       n_layers=LAYERS, n_heads=HEADS)
    net = lm.init(device="cuda")
    tree = seeded_params(net.param_spec(), args.seed)
    params_from_jax(net, tree)
    ref_lm = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                           n_layers=LAYERS, n_heads=HEADS,
                           attn_impl="reference")
    ref = params_from_jax(ref_lm.init(device="cuda"), tree)
    rng = np.random.default_rng(args.seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    requests = [eye[rng.integers(0, VOCAB, (n, SEQ))] for n in REQUEST_SIZES]

    engine = ServingEngine(net, max_batch_size=MAX_BATCH)
    try:
        engine.warmup()
        torch.cuda.synchronize()
        fa.reset_launches()
        batches0 = engine.batches_dispatched
        t_serve = time.perf_counter()
        outs = [engine.predict(x) for x in requests]
        serve_s = time.perf_counter() - t_serve
        serve_launches = dict(fa.launches)
        batches = engine.batches_dispatched - batches0
        worst = 0.0
        for x, y in zip(requests, outs):
            want = ref.output(x).cpu().numpy()
            if y.shape != (len(x), SEQ, VOCAB) or not np.isfinite(y).all():
                return fail(f"served output shape {y.shape} or not finite")
            if np.abs(y.sum(-1) - 1.0).max() > 1e-4:
                return fail("served rows are not probability distributions")
            worst = max(worst, float(np.abs(y - want).max()))
        print(json.dumps({"phase": "serve", "requests": list(REQUEST_SIZES),
                          "batches": batches,
                          "kernel_launches": serve_launches,
                          "expected_launches": LAYERS * batches,
                          "max_abs_err_vs_reference": worst,
                          "tol": TOL_SERVE, "seconds": round(serve_s, 4),
                          "num_params": net.num_params(),
                          "stats": engine.stats()}), flush=True)
        if serve_launches["fwd"] != LAYERS * batches or batches == 0:
            return fail(f"forward kernel launched {serve_launches['fwd']} "
                        f"times over {batches} batches; expected {LAYERS} "
                        "per batch")
        if serve_launches["bwd_dq"] or serve_launches["bwd_dkv"]:
            return fail(f"serving launched backward kernels: "
                        f"{serve_launches}")
        if worst > TOL_SERVE:
            return fail(f"served rows differ from the reference path by "
                        f"{worst} > {TOL_SERVE}")

        batch16 = requests[-1]
        serve_ms = []
        for i in range(SERVE_TIMED_RUNS + 3):
            t1 = time.perf_counter()
            engine.predict(batch16)
            torch.cuda.synchronize()
            if i >= 3:
                serve_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        engine.shutdown()
    serve_med = statistics.median(serve_ms)
    # the same batch with input and output left on the card: the share of
    # a served request that is the model's forward
    x16 = torch.as_tensor(batch16, device=dev)
    fwd = median_ms(lambda: net.output(x16), torch)
    fwd_ref = median_ms(lambda: ref.output(x16), torch)
    print(json.dumps({"phase": "serve_time", "batch": MAX_BATCH,
                      "runs": len(serve_ms),
                      "latency_ms_median": serve_med,
                      "latency_ms_max": max(serve_ms),
                      "tokens_per_s": MAX_BATCH * SEQ / serve_med * 1e3,
                      "forward_ms": fwd, "forward_reference_ms": fwd_ref,
                      "card": card}), flush=True)
    del net, ref, engine, x16, outs

    # ---- 5. full-width training ------------------------------------------
    # integer ids in, next-token ids as targets (sparse_mcxent); the
    # network default updater, Adam(learning_rate=3e-4)
    tnet, tref = (params_from_jax(TransformerLM(
        vocab_size=VOCAB, seq_len=SEQ, embed=EMBED, n_layers=LAYERS,
        n_heads=HEADS, attn_impl=impl, sparse_labels=True).init(
            device="cuda"), tree) for impl in ("auto", "reference"))
    trng = np.random.default_rng(args.seed + 1)
    tokens = trng.integers(0, VOCAB, (TRAIN_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(b[:, :-1], b[:, 1:]) for b in tokens]

    # step-0 gradients of every parameter, flash path vs reference path
    x0, y0 = (torch.as_tensor(a, device=dev) for a in batches[0])
    grads = []
    for m in (tnet, tref):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss0 = _stack_loss(m.conf, params, x0, y0, train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss0, [params[k][n] for k, n in keys]))))
    net_max = max(g.abs().max().item() for g in grads[1].values())
    worst_leaf, worst_name = 0.0, ""
    for key, g in grads[0].items():
        w = grads[1][key]
        err = (g - w).abs().max().item()
        tol = TOL_GRAD_LEAF * w.abs().max().item() + TOL_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return fail(f"step-0 gradient {key} differs from the reference "
                        f"path by {err} > {tol}")
        ratio = err / tol
        if ratio >= worst_leaf:
            worst_leaf, worst_name = ratio, "/".join(key)
    del grads, loss0

    torch.cuda.synchronize()
    fa.reset_launches()
    t_train = time.perf_counter()
    step_losses = []
    for x, y in batches:
        tnet.fit(x, y)
        step_losses.append(tnet._score)    # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    train_launches = dict(fa.launches)
    losses = [float(v) for v in step_losses]
    ref_losses = []
    for x, y in batches:
        tref.fit(x, y)
        ref_losses.append(tref.get_score())
    final_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    expected = {name: LAYERS * TRAIN_STEPS for name in train_launches}
    probs = tnet.output(batches[0][0][:1])
    print(json.dumps({"phase": "train", "model": {
        "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
        "heads": HEADS, "batch": TRAIN_BATCH, "dtype": "float32",
        "updater": "Adam(learning_rate=3e-4)", "loss": "sparse_mcxent",
        "num_params": tnet.num_params()},
        "steps": TRAIN_STEPS, "losses": losses,
        "reference_losses": ref_losses, "max_rel_loss_diff": final_diff,
        "tol_loss": TOL_TRAIN_LOSS,
        "step0_grad_worst_err_over_tol": worst_leaf,
        "step0_grad_worst_param": worst_name,
        "tol_grad": [TOL_GRAD_LEAF, TOL_GRAD_NET],
        "kernel_launches": train_launches, "expected_launches": expected,
        "seconds": round(train_s, 4)}), flush=True)
    if not all(np.isfinite(losses)) or final_diff > TOL_TRAIN_LOSS:
        return fail(f"training losses {losses} differ from the reference "
                    f"path's {ref_losses} by {final_diff} > {TOL_TRAIN_LOSS}")
    if train_launches != expected:
        return fail(f"training launched {train_launches}; expected "
                    f"{expected} ({LAYERS} per kernel per step)")
    if probs.shape != (1, SEQ, VOCAB) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-4:
        return fail("the trained net's output rows are not distributions")

    # ---- 6. times --------------------------------------------------------
    step_ms = {}
    for name, m in (("flash", tnet), ("reference", tref)):
        times = []
        for i in range(TIMED_TRAIN_STEPS + 2):
            x, y = batches[i % TRAIN_STEPS]
            t1 = time.perf_counter()
            m.fit(x, y)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t1) * 1e3)
        step_ms[name] = statistics.median(times)
    del tref
    split = profile_steps(torch, tnet, batches[:PROFILED_STEPS],
                          LM_KERNEL_CLASSES)
    # device busy share of an unprofiled step; None when the profiler
    # saw no device time
    split["device_busy_share"] = (
        split["device_ms_total_per_step"] / step_ms["flash"]
        if split["device_ms_total_per_step"] else None)
    print(json.dumps({"phase": "train_time", "batch": TRAIN_BATCH,
                      "steps": TIMED_TRAIN_STEPS,
                      "step_ms_median": step_ms["flash"],
                      "tokens_per_s": TRAIN_BATCH * SEQ
                      / step_ms["flash"] * 1e3,
                      "reference_step_ms_median": step_ms["reference"],
                      "reference_tokens_per_s": TRAIN_BATCH * SEQ
                      / step_ms["reference"] * 1e3,
                      "profile": split, "card": card}), flush=True)

    timings = {}
    for dname, (q, k, v, do) in inputs.items():
        q4, k4, v4, do4 = (x.view(MAX_BATCH, HEADS, SEQ, HEAD_DIM)
                           for x in (q, k, v, do))
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q4, k4, v4))
        for causal in (True, False):
            o, lse = saved[(dname, causal)]
            dd = (do.float() * o.float()).sum(-1)
            o_buf, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
            lse_buf = torch.empty_like(lse)
            dims = (bh, SEQ, SEQ, HEAD_DIM, int(causal), float(scale),
                    fa.KERNEL_DTYPES[q.dtype],
                    torch.cuda.current_stream().cuda_stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dd.data_ptr())
            # launched straight through the bindings: timing launches are
            # not counted
            calls = {
                "fwd": lambda: fa._launch(
                    "flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o_buf.data_ptr(), lse_buf.data_ptr(), bh, SEQ,
                    SEQ, HEAD_DIM, int(causal), float(scale),
                    fa.KERNEL_DTYPES[q.dtype],
                    torch.cuda.current_stream().cuda_stream),
                "bwd_dq": lambda: fa._launch(
                    "flash_attn_bwd_dq", *ptrs, dq.data_ptr(), *dims),
                "bwd_dkv": lambda: fa._launch(
                    "flash_attn_bwd_dkv", *ptrs, dk.data_ptr(),
                    dv.data_ptr(), *dims),
            }
            kern = {n: median_ms(f, torch) for n, f in calls.items()}
            kern_dev = {n: median_ms(f, torch, spin=True)
                        for n, f in calls.items()}
            plain_fwd = median_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal, scale), torch, runs=10)
            plain_bwd = median_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale), torch, runs=10)
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale), torch)
            lib_fwd_bwd = median_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                               scale=scale),
                (qg, kg, vg), do4), torch)
            # the plain backward and SDPA's backward each compute dq, dk
            # and dv in one pass: both backward kernels carry that time
            plain = {"fwd": plain_fwd, "bwd_dq": plain_bwd,
                     "bwd_dkv": plain_bwd}
            lib = {"fwd": lib_fwd, "bwd_dq": lib_fwd_bwd - lib_fwd,
                   "bwd_dkv": lib_fwd_bwd - lib_fwd}
            for name in ("fwd", "bwd_dq", "bwd_dkv"):
                bound, bound_by = attention_bound_ms(name, bh, SEQ, HEAD_DIM,
                                                     causal, dname)
                timings[(name, dname, causal)] = (kern[name], plain[name],
                                                  lib[name], bound, bound_by,
                                                  kern_dev[name])
                # the pair computes what SDPA's backward computes
                pair = {} if name == "fwd" else {
                    "pair_ms": kern["bwd_dq"] + kern["bwd_dkv"],
                    "pair_ms_device_only": kern_dev["bwd_dq"]
                    + kern_dev["bwd_dkv"],
                    "library_pair_ms": lib_fwd_bwd - lib_fwd}
                print(json.dumps({"phase": "kernel_time",
                                  "kernel": f"flash_attn_{name}",
                                  "dtype": dname, "causal": causal,
                                  "shape": list(shape), "ms": kern[name],
                                  "ms_device_only": kern_dev[name],
                                  "plain_ms": plain[name],
                                  "library_ms": lib[name],
                                  "bound_ms": bound, "bound_by": bound_by,
                                  **pair, "card": card}), flush=True)

    del tnet, inputs, saved
    torch.cuda.empty_cache()

    # ---- 7-9. ResNet50: BN kernel vs plain, training, times --------------
    bn_record, err = cnn_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 10-12. char-LSTM: kernel vs plain, serve, stream, train, times --
    lstm_record, err = lstm_phases(args, torch, dev, card)
    if err:
        return fail(err)

    # the training path runs f32, causal
    sources = {"fwd": fa.SOURCE, "bwd_dq": fa.BWD_SOURCE,
               "bwd_dkv": fa.BWD_SOURCE}
    replaces = {"fwd": "deeplearning4j_tpu/ops/flash_attention.py:77",
                "bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:170",
                "bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:194"}
    records = []
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        kern, plain, lib_ms, bound, bound_by, kern_dev = \
            timings[(name, "float32", True)]
        records.append({
            "name": f"flash_attn_{name}", "route": "cuda",
            "source": f"{src_dir}/{sources[name]}",
            "replaces": replaces[name],
            "launches": train_launches[name],
            "max_abs_err": max_err[(name, "float32", True)],
            "ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms,
            "ms_device_only": kern_dev})
    records.append(bn_record)
    records.append(lstm_record)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
