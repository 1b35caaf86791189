#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It drives ``deeplearning4j_tpu_torch``
only (it imports nothing of JAX or of the JAX package) and exits non-zero
if any phase fails:

1. prints the card's name and power limit; builds every kernel of the
   serving path from ``deeplearning4j_tpu_torch/csrc`` into
   ``build/kernels/``;
2. holds the flash-attention kernel against its plain PyTorch version on
   the card at the serving shape, f32 and bf16, causal and full;
3. serves a full-width TransformerLM (vocab 8192, seq 512, embed 512,
   8 layers, 8 heads; random weights from the seed) through the port's
   ``ServingEngine`` for requests of 1, 5 and 16 rows, checks the rows
   against the same model on the reference attention path, and checks
   that every served batch launched the kernel once per layer;
4. times the kernel, its plain version, ``scaled_dot_product_attention``
   as a yardstick, the served batch-16 request, and the model's forward
   alone on that batch (flash and reference attention).

Each phase prints one JSON line.  The line before the last is the
``kernels`` record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Serving-path shape: TransformerLM at the width the repo benchmarks
# (utils/benchmarks.py transformer_lm_step_time).
VOCAB, SEQ, EMBED, LAYERS, HEADS = 8192, 512, 512, 8, 8
MAX_BATCH = 16
REQUEST_SIZES = (1, 5, 16)
HEAD_DIM = EMBED // HEADS

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
# Served rows vs the same model with attn_impl="reference" (f32, TF32
# off): the two differ by f32 summation order only (attention, and the
# matmul shapes of a padded batch).  A probability p moves by about
# p * (logit error); logits of order 10 carry f32 reordering error of
# order 1e-5, and p <= 1: 1e-5 abs.
TOL_SERVE = 1e-5

TIMED_RUNS = 30


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


def attention_bound_ms(bh: int, t: int, d: int, causal: bool,
                       dtype: str) -> tuple:
    """Least time for one forward: each of q, k, v read once, O and lse
    written once; 4·d operations per live (query, key) pair (two
    products).  Causal counts only the t(t+1)/2 live pairs."""
    elem = 4 if dtype == "float32" else 2
    nbytes = 4 * bh * t * d * elem + bh * t * 4
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * d * bh * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


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
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.utils import kernel_build
    from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernel_build.build(fa.SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = [ln.split(":", 1)[1].strip()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "Used" in ln and "registers" in ln]
    print(json.dumps({"phase": "build", "source": f"deeplearning4j_tpu_torch/"
                      f"csrc/{fa.SOURCE}", "seconds": round(build_s, 3),
                      "ptxas": ptxas}), flush=True)

    # ---- 2. kernel vs plain on the card ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bh = MAX_BATCH * HEADS
    shape = (bh, SEQ, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    inputs = {}
    max_err = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        inputs[dname] = (q, k, v)
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
            max_err[(dname, causal)] = max(err_o, err_l)

    # ---- 3. full-width serve ---------------------------------------------
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
        fa.launches = 0
        batches0 = engine.batches_dispatched
        t_serve = time.perf_counter()
        outs = [engine.predict(x) for x in requests]
        serve_s = time.perf_counter() - t_serve
        launches = fa.launches
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
                          "batches": batches, "kernel_launches": launches,
                          "expected_launches": LAYERS * batches,
                          "max_abs_err_vs_reference": worst,
                          "tol": TOL_SERVE, "seconds": round(serve_s, 4),
                          "num_params": net.num_params(),
                          "stats": engine.stats()}), flush=True)
        if launches == 0 or launches != LAYERS * batches:
            return fail(f"kernel launched {launches} times over {batches} "
                        f"batches; expected {LAYERS} per batch")
        if worst > TOL_SERVE:
            return fail(f"served rows differ from the reference path by "
                        f"{worst} > {TOL_SERVE}")

        # ---- 4. times ----------------------------------------------------
        batch16 = requests[-1]
        serve_ms = []
        for i in range(TIMED_RUNS + 3):
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

    timings = {}
    for (dname, causal) in max_err:
        q, k, v = inputs[dname]
        q4, k4, v4 = (x.view(MAX_BATCH, HEADS, SEQ, HEAD_DIM)
                      for x in (q, k, v))
        kern = median_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, scale=scale), torch)
        plain = median_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal, scale), torch)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), torch)
        bound, bound_by = attention_bound_ms(bh, SEQ, HEAD_DIM, causal, dname)
        timings[(dname, causal)] = (kern, plain, lib_ms, bound, bound_by)
        print(json.dumps({"phase": "kernel_time", "dtype": dname,
                          "causal": causal, "shape": list(shape),
                          "ms": kern, "plain_ms": plain,
                          "library_ms": lib_ms, "bound_ms": bound,
                          "bound_by": bound_by, "card": card}), flush=True)

    # the serving path runs f32, causal
    kern, plain, lib_ms, bound, bound_by = timings[("float32", True)]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/csrc/{fa.SOURCE}",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:77",
        "launches": launches,
        "max_abs_err": max_err[("float32", True)],
        "ms": kern, "plain_ms": plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
