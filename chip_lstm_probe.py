#!/usr/bin/env python3
"""Where the LSTM-recurrence kernel's time goes, on one NVIDIA GPU.

    python3 chip_lstm_probe.py [--sass PATH]

Run from the root of a checkout, after or beside ``chip_smoke.py`` (it
uses its timing helpers).  For the char-LSTM's shapes, (t, b, h) = (64,
128, 256), (64, 1, 256), (256, 32, 256) and (1, 16, 256):

1. ``plans``: every cluster-tier configuration the planner of
   ``ops/pallas_lstm.py`` weighs, and the grid tier's, each timed as in
   ``chip_smoke.py`` (``ms``, and ``ms_device_only`` after a spin of the
   card), beside the planner's cost; one JSON line per shape, naming the
   plan the planner chose;
2. ``phases``: a copy of ``csrc/lstm_fwd.cu`` with ``clock64()`` stamps
   around the phases of the cluster kernel's step (the wait for h, the
   product, the partial sums and their barriers, the cell with its sends,
   the step's global loads and stores), built into ``build/probe/``; the
   planner's plan of each shape, with SM cycles per step of each phase
   (thread 0 of each CTA, averaged over the CTAs; steps 1 to t-1).

With ``--sass PATH`` it writes ``cuobjdump -sass`` of the kernel library
there.  Each line is one JSON object; the card's name and power limit come
first.  It exits non-zero without a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SHAPES = ((64, 128, 256), (64, 1, 256), (256, 32, 256), (1, 16, 256))
PHASES = ("wait", "product", "partials", "cell_and_sends", "ys_and_next_xz")

# Text inserted into a copy of the kernel: (anchor, text placed before it).
# Stamps c0..c5 bound the phases; thread 0 of each CTA sums them over
# steps 1..T-1 and stores the sums at the end.
STAMPS = (
    ("    if (t > 0) {\n      // h_{t-1}", "    long long c0_ = clock64();\n"),
    ("    const float* hcur = hbuf", "    long long c1_ = clock64();\n"),
    ("    __syncthreads();      // every cell of step t-1",
     "    long long c2_ = clock64();\n"),
    ("    const bool more = t + 1 < T;", "    long long c3_ = clock64();\n"),
    ("    // outputs and the next step's xz while h_t travels",
     "    long long c4_ = clock64();\n"),
)
LOOP_END = ("        for (int q = 0; q < 4; ++q) xv[j][q] = p0[(size_t)q * H];\n"
            "      }\n    }\n  }\n")
SUMS = ("    long long c5_ = clock64();\n"
        "    if (threadIdx.x == 0 && t > 0) {\n"
        "      sums_[0] += c1_ - c0_; sums_[1] += c2_ - c1_;\n"
        "      sums_[2] += c3_ - c2_; sums_[3] += c4_ - c3_;\n"
        "      sums_[4] += c5_ - c4_;\n    }\n  }\n"
        "  if (threadIdx.x == 0)\n"
        "    for (int i = 0; i < 5; ++i) g_phase[blockIdx.x * 5 + i] = sums_[i];\n")
MAX_CTAS = 8192


def instrumented_source(src: str) -> str:
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in lstm_fwd.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, text + anchor)
    if src.count(LOOP_END) != 1:
        raise RuntimeError("the step loop's end was not found in lstm_fwd.cu")
    src = src.replace(LOOP_END, LOOP_END[:-4] + SUMS)
    src = src.replace("  cluster_sync_all();\n\n  for (int t = 0;",
                      "  cluster_sync_all();\n"
                      "  long long sums_[5] = {0, 0, 0, 0, 0};\n\n"
                      "  for (int t = 0;", 1)
    src = src.replace("// The (row, unit) cells a thread owns",
                      f"__device__ long long g_phase[5 * {MAX_CTAS}];\n"
                      "// The (row, unit) cells a thread owns", 1)
    return src + ('\nextern "C" int lstm_phase_read(long long* out, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_phase, "
                  "n * sizeof(long long));\n}\n")


def build_instrumented(kernel_build, pl) -> ctypes.CDLL:
    out_dir = REPO / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "lstm_fwd_phases.cu"
    src.write_text(instrumented_source(
        (kernel_build.CSRC_DIR / pl.SOURCE).read_text()))
    lib = out_dir / "lstm_fwd_phases.so"
    proc = subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                           "-I", str(kernel_build.CSRC_DIR), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.lstm_fwd_cluster.argtypes = pl._ARGTYPES["lstm_fwd_cluster"]
    dll.lstm_fwd_cluster.restype = ctypes.c_int
    dll.lstm_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.lstm_phase_read.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_lstm_probe: FAIL: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.utils import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    lib = kernel_build.build(pl.SOURCE)
    if args.sass is not None:
        sass = subprocess.run(
            [str(Path(kernel_build.find_nvcc()).with_name("cuobjdump")),
             "-sass", str(lib)], capture_output=True, text=True)
        args.sass.write_text(sass.stdout + sass.stderr)
    sms, max_smem, blocks_per_sm, clusters_active = pl._card(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    runs = {}
    for t, b, h in SHAPES:
        x = torch.randn((b, t, h), generator=gen, device=dev)
        W = torch.randn((h, 4 * h), generator=gen, device=dev) * 0.05
        U = torch.randn((h, 4 * h), generator=gen, device=dev) * 0.05
        bias = torch.zeros(4 * h, device=dev)
        h0 = torch.zeros((b, h), device=dev)
        c0 = torch.zeros((b, h), device=dev)
        xz = pl.input_projection(x, W, bias)
        ys = torch.empty((t, b, h), device=dev)
        hT = torch.empty((b, h), device=dev)
        cT = torch.empty((b, h), device=dev)
        runs[(t, b, h)] = (xz, U, h0, c0, ys, hT, cT)
        # ---- 1. every plan the planner weighs -----------------------------
        weighed = []
        cost = pl._cluster_cost
        pl._cluster_cost = lambda p, *a: weighed.append((p, cost(p, *a))) \
            or weighed[-1][1]
        try:
            pl._search_cluster(b, h, t, max_smem, clusters_active)
        finally:
            pl._cluster_cost = cost
        chosen = pl.device_plan(b, h, t, dev)
        grid = pl._search(b, h, t, sms, max_smem, blocks_per_sm, None)
        rows = []
        for p, c in weighed + [(grid, pl._cost(grid, h, t, sms))]:
            def go(p=p):
                pl._launch(xz, U, h0, c0, ys, hT, cT, p)
            rows.append({"tier": p.tier, "cluster": p.cluster,
                         "rows": p.rows, "threads": p.threads,
                         "grid": p.grid, "cost": c,
                         "ms": cs.median_ms(go, torch),
                         "ms_device_only": cs.median_ms(go, torch, spin=True),
                         "chosen": p == chosen})
        print(json.dumps({"phase": "plans", "t": t, "batch": b, "hidden": h,
                          "bound_ms": cs.lstm_bound_ms(t, b, h)[0],
                          "plans": rows}), flush=True)
    # ---- 2. phases of the chosen plans ------------------------------------
    dll = build_instrumented(kernel_build, pl)
    for (t, b, h), (xz, U, h0, c0, ys, hT, cT) in runs.items():
        p = pl.device_plan(b, h, t, dev)
        if p.tier != "cluster" or t < 2:
            continue
        with torch.cuda.device(dev):
            err = dll.lstm_fwd_cluster(
                xz.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), t, b, h, p.rows,
                p.cluster, p.hu, p.threads, p.kc,
                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        out = (ctypes.c_longlong * (5 * p.grid))()
        if err != 0 or dll.lstm_phase_read(out, 5 * p.grid) != 0:
            print(f"chip_lstm_probe: FAIL: instrumented launch ({err})",
                  file=sys.stderr)
            return 1
        per = [[out[c * 5 + i] / (t - 1) for i in range(5)]
               for c in range(p.grid)]
        mean = {name: sum(r[i] for r in per) / p.grid
                for i, name in enumerate(PHASES)}
        print(json.dumps({"phase": "phases", "t": t, "batch": b, "hidden": h,
                          "plan": p.__dict__, "cycles_per_step": mean,
                          "cycles_per_step_total": sum(mean.values()),
                          "max_wait": max(r[0] for r in per)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
