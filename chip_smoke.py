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
   its plain PyTorch version on the card at the model's attention shape,
   f32 and bf16, causal and full;
3. ``bwd_kernel_vs_plain``: the same for the two backward kernels (dq;
   dk and dv);
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
   which the port never calls.

Each phase prints one JSON line.  Then come the card's name and power
limit, the ``kernels`` record (the line before the last) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The model's width: TransformerLM as the repo benchmarks it
# (utils/benchmarks.py transformer_lm_step_time).
VOCAB, SEQ, EMBED, LAYERS, HEADS = 8192, 512, 512, 8, 8
MAX_BATCH = 16
REQUEST_SIZES = (1, 5, 16)
HEAD_DIM = EMBED // HEADS
TRAIN_BATCH = 16
TRAIN_STEPS = 5
TIMED_TRAIN_STEPS = 20

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM rate and the
# operation rate for each input type.  f32 attention runs on the CUDA
# cores (no TF32), so its peak is the non-tensor f32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

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


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def median_ms(fn, torch, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` single calls, each between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
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
    return _bound(nbytes, per_pair * d * bh * pairs, dtype)


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


KERNEL_CLASSES = (("flash_attn_fwd", "flash_fwd_kernel"),
                  ("flash_attn_bwd_dq", "flash_bwd_dq_kernel"),
                  ("flash_attn_bwd_dkv", "flash_bwd_dkv_kernel"))


def profile_steps(torch, net, batches) -> dict:
    """Device time per training step by kernel class, from a
    ``torch.profiler`` trace of ``len(batches)`` ``fit`` steps: the three
    attention kernels, matrix products (cuBLAS/CUTLASS kernels), and the
    rest.  The wall time of the profiled steps includes the profiler's
    own host overhead; the caller sets the device time against the
    unprofiled step time for the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    per_class.update(matmul=0.0, other=0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        key = ev.key.lower()
        cls = next((name for name, tag in KERNEL_CLASSES if tag in key),
                   None)
        if cls is None:
            cls = "matmul" if any(t in key for t in (
                "gemm", "cutlass", "xmma", "sm90_")) else "other"
        per_class[cls] += us / 1e3
    n = len(batches)
    return {"steps": n, "profiled_wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": {k: v / n for k, v in per_class.items()},
            "device_ms_total_per_step": sum(per_class.values()) / n}


def build_all(kernel_build, sources) -> dict:
    """Build every source at once (one nvcc each); returns per-source
    seconds and the ptxas register lines."""
    def one(src):
        t0 = time.perf_counter()
        lib = kernel_build.build(src)
        ptxas = [ln.split(":", 1)[1].strip()
                 for ln in lib.with_suffix(".log").read_text().splitlines()
                 if "Used" in ln and "registers" in ln]
        return src, {"seconds": round(time.perf_counter() - t0, 3),
                     "ptxas": ptxas}

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources))


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
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.utils import kernel_build
    from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    src_dir = "deeplearning4j_tpu_torch/csrc"

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all(kernel_build, [fa.SOURCE, fa.BWD_SOURCE])
    print(json.dumps({"phase": "build", "seconds": round(
        time.perf_counter() - t0, 3), "sources": {
            f"{src_dir}/{s}": v for s, v in built.items()}}), flush=True)

    # ---- 2. forward kernel vs plain on the card -------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bh = MAX_BATCH * HEADS
    shape = (bh, SEQ, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    inputs = {}
    max_err = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for _ in range(4))
        inputs[dname] = (q, k, v, do)
        for causal in (True, False):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            scale=scale)
            po, plse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
            torch.cuda.synchronize()
            err_o = (o.float() - po.float()).abs().max().item()
            err_l = (lse - plse).abs().max().item()
            finite = bool(torch.isfinite(o.float()).all())
            print(json.dumps({"phase": "kernel_vs_plain", "dtype": dname,
                              "causal": causal, "shape": list(shape),
                              "max_abs_err_o": err_o,
                              "max_abs_err_lse": err_l,
                              "tol_o": TOL_O[dname], "tol_lse": TOL_LSE}),
                  flush=True)
            if not finite or err_o > TOL_O[dname] or err_l > TOL_LSE:
                return fail(f"kernel disagrees with plain ({dname}, causal="
                            f"{causal}): O {err_o}, lse {err_l}")
            max_err[("fwd", dname, causal)] = max(err_o, err_l)

    # ---- 3. backward kernels vs plain on the card -----------------------
    saved = {}
    for dname, (q, k, v, do) in inputs.items():
        for causal in (True, False):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            scale=scale)
            saved[(dname, causal)] = (o, lse)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                                scale)
            torch.cuda.synchronize()
            rel, absolute = {}, {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                if not bool(torch.isfinite(g.float()).all()):
                    return fail(f"{name} not finite ({dname}, causal="
                                f"{causal})")
                diff = (g.float() - w.float()).abs().max().item()
                absolute[name] = diff
                rel[name] = diff / w.float().abs().max().item()
            print(json.dumps({"phase": "bwd_kernel_vs_plain", "dtype": dname,
                              "causal": causal, "shape": list(shape),
                              "max_abs_err": absolute, "rel_err": rel,
                              "tol_rel": TOL_BWD[dname]}), flush=True)
            if max(rel.values()) > TOL_BWD[dname]:
                return fail(f"backward kernels disagree with plain ({dname},"
                            f" causal={causal}): {rel}")
            max_err[("bwd_dq", dname, causal)] = absolute["dq"]
            max_err[("bwd_dkv", dname, causal)] = max(absolute["dk"],
                                                      absolute["dv"])

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
    split = profile_steps(torch, tnet, batches[:PROFILED_STEPS])
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
            kern = {
                "fwd": median_ms(lambda: fa._launch(
                    "flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o_buf.data_ptr(), lse_buf.data_ptr(), bh, SEQ,
                    SEQ, HEAD_DIM, int(causal), float(scale),
                    fa.KERNEL_DTYPES[q.dtype],
                    torch.cuda.current_stream().cuda_stream), torch),
                "bwd_dq": median_ms(lambda: fa._launch(
                    "flash_attn_bwd_dq", *ptrs, dq.data_ptr(), *dims),
                    torch),
                "bwd_dkv": median_ms(lambda: fa._launch(
                    "flash_attn_bwd_dkv", *ptrs, dk.data_ptr(),
                    dv.data_ptr(), *dims), torch),
            }
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
                                                  lib[name], bound, bound_by)
                print(json.dumps({"phase": "kernel_time",
                                  "kernel": f"flash_attn_{name}",
                                  "dtype": dname, "causal": causal,
                                  "shape": list(shape), "ms": kern[name],
                                  "plain_ms": plain[name],
                                  "library_ms": lib[name],
                                  "bound_ms": bound, "bound_by": bound_by,
                                  "card": card}), flush=True)

    # the training path runs f32, causal
    sources = {"fwd": fa.SOURCE, "bwd_dq": fa.BWD_SOURCE,
               "bwd_dkv": fa.BWD_SOURCE}
    replaces = {"fwd": "deeplearning4j_tpu/ops/flash_attention.py:77",
                "bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:170",
                "bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:194"}
    records = []
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        kern, plain, lib_ms, bound, bound_by = \
            timings[(name, "float32", True)]
        records.append({
            "name": f"flash_attn_{name}", "route": "cuda",
            "source": f"{src_dir}/{sources[name]}",
            "replaces": replaces[name],
            "launches": train_launches[name],
            "max_abs_err": max_err[(name, "float32", True)],
            "ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms})
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
