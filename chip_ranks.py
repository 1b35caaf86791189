"""The port's data-parallel trainers across several cards of one host.

    python3 chip_ranks.py [--seed N] [--ranks 4] [--steps 5]

Run from the root of a checkout on a host with at least ``--ranks``
CUDA cards.  It starts one process per card (a NCCL process group over
``127.0.0.1``).  Every rank first trains two single-card twins of the
full-width TransformerLM of ``chip_smoke.py`` (vocab 8192, seq 512,
embed 512, 8 layers, 8 heads; random weights from the seed; f32, TF32
off; Adam 3e-4) on the whole global batches of 16 rows: the twin, and
the twin with each batch's rows permuted (the same objective, its sums
over rows taken in another order: the f32 noise floor of this training).
Then it trains the LM from the same weights, keeping its own rows, first
through ``ParallelWrapper``, then through ``ShardedTrainer`` (ZeRO-3,
whose all-gathers and reduce-scatters run over NCCL only here: at one
rank ``zero3_spec`` replicates every leaf).  Then the full-width
ResNet50 (224x224x3, 1000 classes, every BatchNormalization at
``helper="pallas"``, zoo Nesterovs) through ``ParallelWrapper`` on the
global batch of 64, against a one-card twin on rank 0.

Gates:

* LM: each wrapped run's losses within 1e-5 relative of the twin's;
  every rank's full parameters (gathered under ZeRO-3) against its twin's,
  leaf by leaf, within max(1e-5, 4x the permuted twin's distance) of the
  leaf's largest |value| (phase 21's rule for Adam, whose step divides by
  ~|g| and so turns the rounding of a near-zero gradient into a step);
  every rank's parameters equal to rank 0's (the exchange keeps replicas
  exact); 8 launches of each flash kernel per step on every rank.
* ResNet50: 53 ``bn_apply`` launches per step on every rank (the fused
  kernel applies the global batch's statistics), replicas equal to rank
  0's, finite losses, and step 0's loss within 1e-4 relative of the
  twin's.

Printed per trainer: losses, the median step beside the twin's, the
peak allocated bytes of every card, the per-card parameter bytes of the
layout and the worst leaf.  Then the cards' name and power limit, and
last ``{"ok": true, ...}``.  Exits non-zero without enough cards.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import queue
import socket
import statistics
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL_LOSS = 1e-5
# params against the twin: phase 21's Adam rule (chip_smoke.py)
TOL_PARAMS, FLOOR_K = 1e-5, 4.0
RESULT_TIMEOUT_S = 900.0
RN_STEPS = 3
RN_BN_LAUNCHES = 53
# step 0 of the ResNet50 under 4 ranks against the one-card twin: the
# same weights and batch; the forward rounds differently (convolutions
# at 16 rows a card against 64, the BN sums reassociated over the
# ranks), ~1e-6 of the loss.  Statistics of one rank's 16 rows instead
# of the global 64 would move the loss by ~1e-3 (the deep layers' 7x7
# maps give 784 rows a channel a card).
TOL_RN_LOSS0 = 1e-4


def fail(msg: str) -> int:
    print(json.dumps({"ok": False, "error": msg}), flush=True)
    return 1


def _rank_main(rank, world, port, args, out):
    try:
        out.put((rank, True, _rank_run(rank, world, port, args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def _detached(params):
    return {k: {n: p.detach().clone() for n, p in g.items()}
            for k, g in params.items()}


def _rel_err_by_leaf(a, b):
    """``{leaf: max |a - b| / max |b|}`` over the parameters of ``b``."""
    out = {}
    for k, g in b.items():
        for n, p in g.items():
            scale = p.abs().max().item() or 1.0
            out[f"{k}/{n}"] = \
                (a[k][n].detach() - p).abs().max().item() / scale
    return out


def _max_diff_vs_rank0(params):
    """Largest |p - rank 0's p| over every parameter."""
    import torch.distributed as dist
    worst = 0.0
    for g in params.values():
        for t in g.values():
            t = t.detach()
            ref = t.clone()
            dist.broadcast(ref, src=0)
            worst = max(worst, (t - ref).abs().max().item())
    return worst


def _resnet_run(args, torch, dev, mesh, rank):
    """The ResNet50 through ``ParallelWrapper`` with the fused BN kernel;
    on rank 0 also the one-card twin on the whole batches."""
    import torch.nn.functional as F
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    zoo = ResNet50(seed=args.seed)

    def make():
        conf = zoo.conf()
        for v in conf.vertices.values():
            lc = getattr(v, "layer", None)
            if type(lc).__name__ == "BatchNormalization":
                lc.helper = "pallas"
        return ComputationGraph(conf, device=dev)

    net = make().init()
    # rank 0's weights: the wrapper lays them out on every rank
    tree0 = cs._host_tree(net)
    h, w_, c = zoo.input_shape
    gen = torch.Generator().manual_seed(args.seed + 62)
    batches = [(torch.randn((cs.CNN_BATCH, h, w_, c), generator=gen)
                .to(dev),
                F.one_hot(torch.randint(0, zoo.num_classes, (cs.CNN_BATCH,),
                                        generator=gen),
                          zoo.num_classes).float().to(dev))
               for _ in range(RN_STEPS)]
    w = ParallelWrapper(net, mesh)
    losses, launches, ms = [], [], []
    for x, y in batches:
        torch.cuda.synchronize()
        pb.reset_launches()
        t1 = time.perf_counter()
        w.fit(x, y)
        losses.append(float(net.get_score()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(pb.launches["bn_apply"])
    res = {"losses": losses, "bn_apply_launches": launches,
           "step_ms": ms,
           "max_abs_diff_vs_rank0": _max_diff_vs_rank0(net.params)}
    del w, net
    torch.cuda.empty_cache()
    if rank == 0:
        twin = make().load_params(tree0)
        t_losses = []
        for x, y in batches:
            twin.fit(x, y)
            t_losses.append(float(twin.get_score()))
        res["twin_losses"] = t_losses
        del twin
        torch.cuda.empty_cache()
    return res


def _rank_run(rank, world, port, args):
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ShardedTrainer,
                                                   initialize_distributed,
                                                   make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    import torch.distributed as dist
    try:
        import numpy as np
        mesh = make_mesh(device=dev)
        tree = cs._lm_tree(args, dev, 60)
        batches = cs._lm_batches(args, 60, args.steps)
        res = {}
        # the twins: the whole batches on this card, and the same with
        # each batch's rows permuted (the noise floor)
        twin = cs._lm_net(args, dev, tree)
        losses, ms = cs._fit_timed(torch, twin, twin, batches)
        res["twin"] = {"losses": losses,
                       "step_ms_median": statistics.median(ms[1:])}
        twin_params = _detached(twin.params)
        del twin
        perm = np.random.default_rng(args.seed + 61).permutation(
            cs.TRAIN_BATCH)
        permuted = cs._lm_net(args, dev, tree)
        cs._fit_timed(torch, permuted, permuted,
                      [(x[perm], y[perm]) for x, y in batches])
        res["twin"]["permuted_rel_err"] = max(
            _rel_err_by_leaf(permuted.params, twin_params).values())
        del permuted
        torch.cuda.empty_cache()
        for name in ("wrapper", "sharded"):
            net = cs._lm_net(args, dev, tree)
            w = ParallelWrapper(net, mesh) if name == "wrapper" else \
                ShardedTrainer(net, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fa.reset_launches()
            losses, ms = cs._fit_timed(torch, w, net, batches)
            launches = dict(fa.launches)
            peak = torch.cuda.max_memory_allocated(dev)
            full = w.full_params() if name == "sharded" else \
                _detached(net.params)
            errs = _rel_err_by_leaf(full, twin_params)
            worst_leaf = max(errs, key=errs.get)
            res[name] = {"losses": losses,
                         "step_ms_median": statistics.median(ms[1:]),
                         "launches": launches, "peak_bytes": peak,
                         "max_abs_diff_vs_rank0": _max_diff_vs_rank0(full),
                         "max_rel_err_vs_twin": errs[worst_leaf],
                         "worst_leaf": worst_leaf}
            if name == "sharded":
                res[name]["per_device_param_bytes"] = \
                    w.per_device_param_bytes()
                res[name]["param_bytes"] = w.global_param_bytes()
            del net, w, full
            torch.cuda.empty_cache()
        del twin_params
        torch.cuda.empty_cache()
        res["resnet"] = _resnet_run(args, torch, dev, mesh, rank)
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not (REPO / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        return fail(f"no deeplearning4j_tpu_torch package beside {__file__}")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.ranks:
        return fail(f"needs {args.ranks} CUDA cards, found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.utils import kernel_build
    t0 = time.perf_counter()
    cs.build_all(kernel_build, [fa.SOURCE, fa.BWD_SOURCE, pb.SOURCE])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, args.ranks, port, args, out))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < args.ranks:
            try:
                rank, ok, value = out.get(timeout=RESULT_TIMEOUT_S)
            except queue.Empty:
                return fail("a rank gave no result in time")
            if not ok:
                return fail(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(30)
    card = cs.card_line()
    twin = results[0]["twin"]
    expected = {k: cs.LAYERS * args.steps for k in ("fwd", "bwd_dq",
                                                   "bwd_dkv")}
    ranks = range(args.ranks)
    for name in ("wrapper", "sharded"):
        r0 = results[0][name]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(r0["losses"], twin["losses"]))
        floors = [results[r]["twin"]["permuted_rel_err"] for r in ranks]
        tols = [max(TOL_PARAMS, FLOOR_K * f) for f in floors]
        errs = [results[r][name]["max_rel_err_vs_twin"] for r in ranks]
        record = {
            "phase": f"ranks_{name}", "ranks": args.ranks,
            "global_batch": cs.TRAIN_BATCH, "steps": args.steps,
            "losses": r0["losses"], "twin_losses": twin["losses"],
            "max_rel_loss_diff_vs_twin": rel, "tol": TOL_LOSS,
            "step_ms_median": r0["step_ms_median"],
            "twin_step_ms_median": twin["step_ms_median"],
            "peak_bytes_per_card": [results[r][name]["peak_bytes"]
                                    for r in range(args.ranks)],
            "max_abs_diff_vs_rank0": max(results[r][name][
                "max_abs_diff_vs_rank0"] for r in range(args.ranks)),
            "kernel_launches_per_rank": [results[r][name]["launches"]
                                         for r in range(args.ranks)],
            "max_rel_err_params_vs_twin_per_rank": errs,
            "worst_leaf_per_rank": [results[r][name]["worst_leaf"]
                                    for r in ranks],
            "permuted_twin_rel_err_per_rank": floors,
            "params_tol_per_rank": tols,
            "card": card}
        for key in ("per_device_param_bytes", "param_bytes"):
            if key in r0:
                record[key] = r0[key]
        print(json.dumps(record), flush=True)
        if not all(math.isfinite(v) for v in r0["losses"]) or \
                rel > TOL_LOSS:
            return fail(f"{name} losses {r0['losses']} differ from the "
                        f"single-card twin's {twin['losses']} by {rel}")
        if any(e > t for e, t in zip(errs, tols)):
            return fail(f"{name}: params differ from the single-card "
                        f"twin's by {errs} of their leaves' scale "
                        f"(tol {tols})")
        if record["max_abs_diff_vs_rank0"] != 0.0:
            return fail(f"{name}: ranks' params differ from rank 0's by "
                        f"{record['max_abs_diff_vs_rank0']}")
        if any(lc != expected for lc in record["kernel_launches_per_rank"]):
            return fail(f"{name} launched {record['kernel_launches_per_rank']}"
                        f"; expected {expected} on every rank")
    rn = [results[r]["resnet"] for r in ranks]
    rn_twin = rn[0]["twin_losses"]
    rel0 = abs(rn[0]["losses"][0] - rn_twin[0]) / abs(rn_twin[0])
    record = {
        "phase": "ranks_resnet_bn", "ranks": args.ranks,
        "global_batch": cs.CNN_BATCH, "steps": RN_STEPS,
        "input": list(cs.RN_INPUT), "classes": cs.RN_CLASSES,
        "losses": rn[0]["losses"], "twin_losses": rn_twin,
        "step0_rel_loss_diff_vs_twin": rel0, "tol": TOL_RN_LOSS0,
        "rel_loss_diff_vs_twin": [abs(a - b) / abs(b) for a, b in
                                  zip(rn[0]["losses"], rn_twin)],
        "step_ms": rn[0]["step_ms"],
        "bn_apply_launches_per_rank": [r["bn_apply_launches"] for r in rn],
        "max_abs_diff_vs_rank0": max(r["max_abs_diff_vs_rank0"]
                                     for r in rn),
        "card": card}
    print(json.dumps(record), flush=True)
    if not all(math.isfinite(v) for v in rn[0]["losses"] + rn_twin) or \
            rel0 > TOL_RN_LOSS0:
        return fail(f"ResNet50 losses {rn[0]['losses']} against the "
                    f"single-card twin's {rn_twin}: step 0 off by {rel0}")
    if record["max_abs_diff_vs_rank0"] != 0.0:
        return fail(f"ResNet50: ranks' params differ from rank 0's by "
                    f"{record['max_abs_diff_vs_rank0']}")
    if any(r["bn_apply_launches"] != [RN_BN_LAUNCHES] * RN_STEPS
           for r in rn):
        return fail(f"ResNet50 launched bn_apply "
                    f"{record['bn_apply_launches_per_rank']}; expected "
                    f"{RN_BN_LAUNCHES} a step on every rank")
    print(json.dumps({"phase": "ranks", "seconds":
                      round(time.perf_counter() - t0, 3)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
