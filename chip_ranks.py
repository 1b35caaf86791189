"""The port's trainers and model axes across several cards of one host.

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

Then the model axes, each held against a one-card twin on the same
card (every rank computes the twin itself):

* ``tensor``: the same LM through ``ParallelWrapper(param_rule=
  megatron_dense_rule)`` at dp 2 x tp 2 (the embedding and output layers
  split over ``model`` and gathered in the step), with the LM's gates
  and the per-card parameter bytes of the layout;
* ``ring`` and ``ulysses``: attention at sp 4 on the LM's attention
  shape (16 x 8 heads x seq 512 x d 64, causal): each rank's output
  block and input gradients against ``sdpa_reference`` on the whole
  sequence; Ulysses also with ``attn_fn`` the port's flash kernels (one
  forward and one launch of each backward kernel a rank), against
  ``flash_attention`` on the whole sequence;
* ``demo3d``: the 3D demo step at dp 1 x pp 2 x sp 2 (embed 512, 8 heads,
  seq 512; GPipe over two ring-attention blocks) against the two blocks
  run in sequence on the whole sequence;
* ``expert``: the MoE train step at dp 2 x ep 2 (embed 512, hidden 2048,
  8 experts, 2048 tokens a rank, capacity from factor 1.25) against
  ``moe_ffn`` with every expert on each rank's tokens;
* ``dryrun``: ``parallel/dryrun.run(4)`` (NCCL, one rank a card) against
  its MLP trained on one card.

Then the rest of parallel:

* ``moe_wrapper``: the Switch-MoE LM (8 experts, capacity factor 1.25;
  Sgd 1e-5) under ``ParallelWrapper`` at dp 4, routing the global batch,
  5 steps against a one-card twin on the global batches: losses within
  chip_smoke's ``TOL_MOE_LOSS``, step 1's params by ``update_gate`` (plus
  ``TOL_UPDATE_NET`` of the net's largest update), 8 launches of each
  flash kernel a step; printed: routing flips against the twin and the
  tokens a rank-local routing of the same step would route otherwise;
* ``tp_sharded_ckpt``: the tensor-parallel LM at dp 2 x tp 2 through
  ``save_sharded`` at step 3 (bytes, write seconds); a fresh net restored
  in the same layout and trained to step 6 equals the uninterrupted run
  bit for bit on every rank; a dense restore's outputs equal the gathered
  net's at the save (0.0);
* ``zero3_per_layer``: the ``ShardedTrainer`` and ``ParallelWrapper``
  runs above, each card's peak allocated bytes (after collecting the
  last run's network): ``ShardedTrainer``'s must be below.

Then the input pipeline:

* ``prefetch_mesh``: a small CNN (32x32x3; two 3x3 convolutions of 32
  and 64 channels, each followed by a BatchNormalization at
  ``helper="pallas"`` with relu; average pooling; softmax 10; Nesterovs
  0.01) under
  ``ParallelWrapper`` at dp 4, 6 steps of global batches of 64 and a
  ragged last one of 66 (trimmed to 64), fed by
  ``DevicePrefetchIterator(mesh=...)`` (the trimmed global batch placed
  on each rank's card) and, from the same weights, by the host batches:
  params, running statistics and losses bitwise equal on every rank, 2
  ``bn_apply`` launches a step, and against a one-card twin on the
  global batches (the statistics of the global batch): losses within
  ``TOL_PREFETCH`` of the twin's, running statistics within 4x the
  distance of a twin fed the rows permuted.

Gates:

* LM: each wrapped run's losses within 1e-5 relative of the twin's;
  every rank's full parameters (gathered under ZeRO-3) against its twin's,
  leaf by leaf, within max(1e-5, 4x the permuted twin's distance) of the
  leaf's largest |value| (phase 21's rule for Adam, whose step divides by
  ~|g| and so turns the rounding of a near-zero gradient into a step);
  every rank's parameters equal to rank 0's (the exchange keeps replicas
  exact); 8 launches of each flash kernel per step on every rank.  The
  tensor-parallel run is held to the same gates, with every rank's
  gathered parameters.
* ring, Ulysses: outputs within ``TOL_SEQ_OUT`` and gradients within
  ``TOL_SEQ_GRAD`` of the twin's largest |value| (f32, the same sums in
  another order).
* demo3d, expert: the loss within 1e-5 relative of the twin's, and each
  element of each parameter's new value within ``TOL_AXES_UPDATE`` of
  the twin's largest update plus one f32 ulp of that element of the
  twin's new value (``update_gate``).
* dryrun: its ranks ran over NCCL on the cards (its record's backend and
  device), and the loss within 1e-5 relative of the one-card twin's.
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
import gc
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
# the model axes against their one-card twins, f32 without TF32: the
# same sums in another order, ~1e-6 of the largest |value|
TOL_SEQ_OUT, TOL_SEQ_GRAD = 1e-5, 1e-4
# new params against the twin's (new = p - lr * g, both rounded to f32),
# element by element: 1e-4 of the twin's largest update, plus one ulp of
# that element's |value|.  The expert step's w1 moves by ~1e-5 a step
# against values of ~4e-2, whose ulp is ~4e-9: the rounding of the new
# value alone is ~1e-3 of the update there (measured on four H100s)
TOL_AXES_UPDATE = 1e-4
SEQ_SHAPE = (16, 8, 512, 64)             # the LM's attention: b, h, t, d
DEMO_3D = dict(n_stages=2, embed=512, n_heads=8, seq_len=512,
               microbatch=2, n_micro=2)
EXPERT = dict(embed=512, hidden=2048, experts=8, tokens=2048,
              capacity_factor=1.25)


def fail(msg: str) -> int:
    print(json.dumps({"ok": False, "error": msg}), flush=True)
    return 1


def _rank_main(rank, world, port, args, out):
    # the result (or the traceback) goes out before the process group is
    # taken down: destroying a group with a collective still pending on
    # another rank can block until NCCL's timeout
    try:
        out.put((rank, True, _rank_run(rank, world, port, args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


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



def update_gate(new, old, want_update, floor=0.0):
    """``(|new - twin_new|, its bound)`` at the element of a parameter
    with the worst ratio of the two after one step.  The twin's new
    value is ``old + want_update`` rounded to f32 like ``new``; each
    element's bound is ``TOL_AXES_UPDATE`` of the leaf's largest |update|
    plus one f32 ulp of that element's |twin_new| (the spacing above it:
    two sums of nearly equal updates onto the same value round at most
    one ulp apart), plus ``floor``."""
    import torch
    twin_new = (old + want_update).to(new.dtype)
    err = (new - twin_new).abs()
    mag = twin_new.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
    bound = TOL_AXES_UPDATE * want_update.abs().max() + ulp + floor
    worst = torch.argmax(err / bound)
    return err.flatten()[worst].item(), bound.flatten()[worst].item()


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return (a - b).abs().max().item() / (b.abs().max().item() or 1.0)


def _seq_run(torch, dev, seed, world):
    """Ring and Ulysses at sp = world on the LM's attention shape, each
    rank's block against the whole sequence on this card."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.attention import sdpa_reference
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.sequence import (
        ring_self_attention, ulysses_attention)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(SEQ_SHAPE, generator=gen, device=dev)
                   for _ in range(4))
    grid = make_grid(("seq",), (world,), device=dev)
    i, t = grid.index("seq"), SEQ_SHAPE[2] // world
    out = {}
    for name, fn, ref in (
            ("ring", ring_self_attention, sdpa_reference),
            ("ulysses", ulysses_attention, sdpa_reference),
            ("ulysses_flash", lambda *a, **kw: ulysses_attention(
                *a, attn_fn=fa.flash_attention, **kw), fa.flash_attention)):
        full = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o_ref = ref(*full, causal=True)
        g_ref = torch.autograd.grad((o_ref * do).sum(), full)
        mine = [x[:, :, i * t:(i + 1) * t].clone().requires_grad_(True)
                for x in (q, k, v)]
        fa.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with grid:
            o = fn(*mine, axis_name="seq", causal=True)
            g = torch.autograd.grad(
                (o * do[:, :, i * t:(i + 1) * t]).sum(), mine)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        blk = lambda a: a[:, :, i * t:(i + 1) * t]  # noqa: E731
        out[name] = {"out_rel_err": _rel(o, blk(o_ref)),
                     "grad_rel_err": max(_rel(a, blk(b))
                                         for a, b in zip(g, g_ref)),
                     "launches": dict(fa.launches), "fwd_bwd_ms": ms}
    return out


def _demo3d_run(torch, dev, world):
    """The 3D demo step at dp 1 x pp 2 x sp 2 against the two blocks in
    sequence on the whole sequence."""
    from deeplearning4j_tpu_torch.parallel import Axis, make_grid
    from deeplearning4j_tpu_torch.parallel.demo import (
        build_demo_inputs, make_pipelined_train_step,
        ring_transformer_block)
    dp, pp, sp = 1, 2, world // 2
    lr = 0.1
    stacked, xs, ys = build_demo_inputs(device=dev, **DEMO_3D)
    grid = make_grid(("data", "pipe", "seq"), (dp, pp, sp), device=dev)
    p, s = grid.index("pipe"), grid.index("seq")
    t = DEMO_3D["seq_len"] // sp
    local = {k: v[p:p + 1] for k, v in stacked.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with grid:
        loss, new = make_pipelined_train_step(
            n_heads=DEMO_3D["n_heads"], lr=lr)(
            local, xs[:, :, s * t:(s + 1) * t].contiguous(),
            ys[:, :, s * t:(s + 1) * t].contiguous())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    # the twin: both stages in sequence over the whole sequence; the
    # step's gradient is the sum over the dp * sp ranks of their shares
    # (parallel/demo.py), dp * sp times the whole batch's gradient
    leaves = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    whole = Axis("seq", 1, 0)          # the whole sequence on this card
    outs = []
    for mb in xs:
        h = mb
        for st in range(pp):
            h = ring_transformer_block(
                {k: v[st] for k, v in leaves.items()}, h,
                n_heads=DEMO_3D["n_heads"], seq_axis=whole)
        outs.append(h)
    twin_loss = torch.mean((torch.stack(outs) - ys) ** 2)
    grads = dict(zip(leaves, torch.autograd.grad(twin_loss,
                                                 list(leaves.values()))))
    errs = {k: update_gate(v, local[k], -lr * dp * sp * grads[k][p:p + 1])
            for k, v in new.items()}
    return {"loss": float(loss), "twin_loss": float(twin_loss),
            "update_err_and_bound": errs, "step_ms": ms}


def _expert_run(torch, dev, seed, world):
    """The MoE train step at dp 2 x ep (world / 2) against ``moe_ffn``
    with every expert on each rank's tokens, on this card."""
    from deeplearning4j_tpu_torch.nn.activations import relu
    from deeplearning4j_tpu_torch.nn.layers.moe import moe_capacity
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.expert import (
        init_moe_params, make_moe_train_step, moe_ffn)
    from deeplearning4j_tpu_torch.utils import _random
    dp, ep = 2, world // 2
    lr, aux_w = 0.1, 0.01
    e, h, n_exp = EXPERT["embed"], EXPERT["hidden"], EXPERT["experts"]
    tokens = EXPERT["tokens"]
    cap = moe_capacity(EXPERT["capacity_factor"], tokens, n_exp)
    params = init_moe_params(_random.prng_key(seed), n_exp, e, h,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((world * tokens, e), generator=gen, device=dev)
    wy = torch.randn((e, e), generator=gen, device=dev) * e ** -0.5
    y = torch.tanh(x @ wy)
    grid = make_grid(("data", "expert"), (dp, ep), device=dev)
    d, r = grid.index("data"), grid.index("expert")
    per = n_exp // ep
    local = {"router": params["router"],
             "w1": params["w1"][r * per:(r + 1) * per],
             "w2": params["w2"][r * per:(r + 1) * per]}
    blk = d * ep + r
    rows = slice(blk * tokens, (blk + 1) * tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with grid:
        new, loss = make_moe_train_step(capacity=cap, lr=lr,
                                        aux_weight=aux_w)(
            local, x[rows], y[rows])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    # the twin: each rank's token block through all the experts; the
    # step's gradient is the sum of the blocks' (parallel/expert.py)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    total, losses = 0.0, []
    for b in range(world):
        sl = slice(b * tokens, (b + 1) * tokens)
        out, aux = moe_ffn(leaves, x[sl], cap, act=relu)
        lb = torch.mean((out - y[sl]) ** 2) + aux_w * aux
        losses.append(lb.item())
        total = total + lb
    grads = dict(zip(leaves, torch.autograd.grad(total,
                                                 list(leaves.values()))))
    errs = {"router": update_gate(new["router"], local["router"],
                                  -lr * grads["router"])}
    for k in ("w1", "w2"):
        errs[k] = update_gate(new[k], local[k],
                              -lr * grads[k][r * per:(r + 1) * per])
    return {"loss": float(loss), "twin_loss": sum(losses) / len(losses),
            "update_err_and_bound": errs, "step_ms": ms, "capacity": cap}


def _model_axes_run(args, torch, dev, world):
    out = {"seq": _seq_run(torch, dev, args.seed + 70, world)}
    torch.cuda.empty_cache()
    out["demo3d"] = _demo3d_run(torch, dev, world)
    torch.cuda.empty_cache()
    out["expert"] = _expert_run(torch, dev, args.seed + 71, world)
    torch.cuda.empty_cache()
    return out


def _model_axes_gates(results, args, card):
    """Print the model-axis records; returns what failed, or None."""
    ranks = range(args.ranks)
    axes = [results[r]["axes"] for r in ranks]
    seq = {"phase": "ranks_seq_parallel", "ranks": args.ranks,
           "shape": list(SEQ_SHAPE), "causal": True,
           "per_rank": [a["seq"] for a in axes],
           "tol_out": TOL_SEQ_OUT, "tol_grad": TOL_SEQ_GRAD, "card": card}
    print(json.dumps(seq), flush=True)
    for a in axes:
        for name, r in a["seq"].items():
            if r["out_rel_err"] > TOL_SEQ_OUT or \
                    r["grad_rel_err"] > TOL_SEQ_GRAD:
                return f"{name} at sp {args.ranks} against the twin: {r}"
        got = a["seq"]["ulysses_flash"]["launches"]
        if got != {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}:
            return f"Ulysses over the flash kernels launched {got}"
    for name, conf in (("demo3d", DEMO_3D), ("expert", EXPERT)):
        rec = {"phase": f"ranks_{name}", "ranks": args.ranks,
               "config": conf, "per_rank": [a[name] for a in axes],
               "tol_loss": TOL_LOSS, "tol_update": TOL_AXES_UPDATE,
               "card": card}
        print(json.dumps(rec), flush=True)
        for a in axes:
            r = a[name]
            rel = abs(r["loss"] - r["twin_loss"]) / abs(r["twin_loss"])
            if not math.isfinite(r["loss"]) or rel > TOL_LOSS:
                return f"{name}: loss {r['loss']} against {r['twin_loss']}"
            if any(e > b for e, b in r["update_err_and_bound"].values()):
                return f"{name}: updates against the twin {r}"
    return None


def _dryrun_vs_twin(args, card):
    """``dryrun.run(ranks)`` on the cards, then its MLP's step on one
    card from the same (seeded) weights on the whole batch."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.parallel import dryrun
    t1 = time.perf_counter()
    rec = dryrun.run(args.ranks, device="cuda", timeout_s=RESULT_TIMEOUT_S)
    seconds = time.perf_counter() - t1
    dev = torch.device("cuda", 0)
    tp = 2 if args.ranks % 2 == 0 else 1
    batch = (args.ranks // tp) * 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                                OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder()
            .seed(42).activation("relu").weight_init("xavier")
            .updater(Adam(learning_rate=1e-3)).list()
            .layer(DenseLayer(n_out=64)).layer(DenseLayer(n_out=64))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    twin = MultiLayerNetwork(conf, device=dev).init()
    twin.fit(x, y)
    loss = rec["tp"]["loss"]
    rel = abs(loss - twin.get_score()) / abs(twin.get_score())
    worst = max(
        float(np.abs(rec["tp"]["params"][k][n]
                     - p.detach().cpu().numpy()).max()
              / (np.abs(p.detach().cpu().numpy()).max() or 1.0))
        for k, g in twin.params.items() for n, p in g.items())
    print(json.dumps({"phase": "ranks_dryrun", "ranks": args.ranks,
                      "backend": rec["backend"], "device": rec["device"],
                      "tp": rec["tp"]["tp"], "dp": rec["tp"]["dp"],
                      "pairs": rec["tp"]["pairs"], "loss": loss,
                      "twin_loss": twin.get_score(),
                      "rel_loss_diff": rel, "tol": TOL_LOSS,
                      "max_rel_param_diff_vs_twin": worst,
                      "pipeline": rec.get("pipeline"),
                      "expert": rec.get("expert"),
                      "seconds": round(seconds, 3), "card": card}),
          flush=True)
    if (rec["backend"], rec["device"]) != ("nccl", "cuda"):
        return f"dryrun ran on {rec['backend']}/{rec['device']}, not " \
               "nccl/cuda"
    if not math.isfinite(loss) or rel > TOL_LOSS:
        return f"dryrun loss {loss} against the one-card twin's " \
               f"{twin.get_score()}"
    return None


# ---- four cards: MoE under the wrapper, the TP sharded checkpoint -------
# the MoE LM under ParallelWrapper at dp = world: Sgd, so one step's
# params are held by update_gate (Adam turns a near-zero gradient's f32
# noise into a step of +-lr, and a row-permuted twin is no noise floor for
# a router: another row order drops other tokens)
MOE_WRAPPER_LR = 1e-5
# ... and each leaf's bound gains 1e-6 of the net's largest update: the
# step-0 gradient gate's net term (TOL_GRAD_NET in chip_smoke.py), for a
# leaf whose gradient is 0 in exact arithmetic (the attention's mha_bk:
# the softmax ignores a per-row shift), whose update is f32 noise alone
TOL_UPDATE_NET = 1e-6
TP_CKPT_FIRST, TP_CKPT_STEPS = 3, 6


def _moe_recorder(orig, log, local_capacity):
    """Wrap ``expert._dispatch_tensors``: per call, each token's expert,
    whether it kept a slot, and (when the call routes the global batch)
    whether it would keep one under a rank-local routing of its own
    tokens."""
    def wrapped(probs, capacity, offset=None):
        dispatch, combine = orig(probs, capacity, offset)
        entry = {"top": probs.argmax(-1).cpu(),
                 "keep": (dispatch.sum((1, 2)) > 0).cpu()}
        if offset is not None:
            local, _ = orig(probs, local_capacity)
            entry["keep_local"] = (local.sum((1, 2)) > 0).cpu()
        log.append(entry)
        return dispatch, combine
    return wrapped


def _moe_wrapper_run(args, torch, dev, mesh, world, rank):
    """The Switch-MoE LM of chip_smoke's phase 43 under ParallelWrapper
    at dp = world, and its one-card twin on the global batches."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.layers.moe import moe_capacity
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, expert
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    def make():
        conf = TransformerLM(vocab_size=cs.VOCAB, seq_len=cs.SEQ,
                             embed=cs.EMBED, n_layers=cs.LAYERS,
                             n_heads=cs.HEADS, moe_experts=cs.MOE_EXPERTS,
                             sparse_labels=True, seed=args.seed,
                             updater=Sgd(learning_rate=MOE_WRAPPER_LR)
                             ).conf()
        for lc in conf.layers:
            if getattr(lc, "moe_experts", 0):
                lc.moe_capacity_factor = cs.MOE_CAPACITY_FACTOR
        return MultiLayerNetwork(conf, device=dev)

    tree = cs.seeded_params(make().param_spec(), args.seed + 80)
    batches = cs._lm_batches(args, 80, args.steps)
    local_tokens = cs.TRAIN_BATCH // world * cs.SEQ
    local_cap = moe_capacity(cs.MOE_CAPACITY_FACTOR, local_tokens,
                             cs.MOE_EXPERTS)
    orig = expert._dispatch_tensors
    runs = {}
    for name in ("twin", "wrapper"):
        net = params_from_jax(make(), tree)
        old = _detached(net.params)
        trainer = net if name == "twin" else ParallelWrapper(net, mesh)
        log = []
        expert._dispatch_tensors = _moe_recorder(orig, log, local_cap)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launches()
        try:
            losses, ms, first = [], [], None
            for i, (x, y) in enumerate(batches):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                trainer.fit(x, y)
                losses.append(float(net.get_score()))
                ms.append((time.perf_counter() - t1) * 1e3)
                if i == 0:
                    first = _detached(net.params)
        finally:
            expert._dispatch_tensors = orig
        runs[name] = {"losses": losses, "step_ms": ms, "old": old,
                      "first": first, "log": log,
                      "launches": dict(fa.launches),
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        del net, trainer
        torch.cuda.empty_cache()
    tw, wr = runs["twin"], runs["wrapper"]
    lo, hi = rank * local_tokens, (rank + 1) * local_tokens
    flips = sum(int((a["top"][lo:hi] != b["top"]).sum())
                for a, b in zip(tw["log"], wr["log"]))
    keep_diff = sum(int((a["keep"][lo:hi] != b["keep"]).sum())
                    for a, b in zip(tw["log"], wr["log"]))
    local_diff = sum(int((b["keep_local"] != b["keep"]).sum())
                     for b in wr["log"])
    net_update = max((t - tw["old"][k][n]).abs().max().item()
                     for k, g in tw["first"].items() for n, t in g.items())
    gate = {}
    for k, g in tw["first"].items():
        for n, t in g.items():
            gate[f"{k}/{n}"] = update_gate(
                wr["first"][k][n], tw["old"][k][n], t - tw["old"][k][n],
                floor=TOL_UPDATE_NET * net_update)
    worst = max(gate, key=lambda k: gate[k][0] / gate[k][1])
    return {"losses": wr["losses"], "twin_losses": tw["losses"],
            "step_ms": wr["step_ms"], "twin_step_ms": tw["step_ms"],
            "launches": wr["launches"], "twin_launches": tw["launches"],
            "peak_bytes": wr["peak_bytes"], "twin_peak_bytes":
            tw["peak_bytes"], "dispatch_calls": len(wr["log"]),
            "routing_flips_vs_twin": flips,
            "kept_slot_diff_vs_twin": keep_diff,
            "tokens_routed_differently_than_rank_local": local_diff,
            "local_capacity": local_cap,
            "update_worst_leaf": worst,
            "update_err_and_bound": gate[worst],
            "update_gate_ok": all(e <= b for e, b in gate.values())}


def _tp_ckpt_run(args, torch, dev, world, rank):
    """The tensor-parallel LM at dp world/2 x tp 2: save_sharded at step
    ``TP_CKPT_FIRST``; a fresh net restored in the same layout trained to
    step ``TP_CKPT_STEPS`` against the uninterrupted run; on rank 0 a
    dense restore's outputs against the gathered net's at the save."""
    import shutil
    import torch.distributed as dist
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.faulttolerance.checkpoint import (
        CheckpointManager, ShardBarrier)
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   make_mesh,
                                                   megatron_dense_rule)
    root = REPO / "build" / "ranks_tp_ckpt"
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
    dist.barrier()
    tp_mesh = make_mesh(dp=world // 2, tp=2, device=dev)
    tree = cs._lm_tree(args, dev, 81)
    batches = cs._lm_batches(args, 81, TP_CKPT_STEPS)
    probe = batches[0][0][:2]

    def wrap(net):
        return ParallelWrapper(net, tp_mesh,
                               param_rule=megatron_dense_rule(net.params))

    net = cs._lm_net(args, dev, tree)
    w = wrap(net)
    for x, y in batches[:TP_CKPT_FIRST]:
        w.fit(x, y)
    mgr = CheckpointManager(str(root), background=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    path = mgr.save_sharded(net, barrier=ShardBarrier(timeout_s=300))
    write_s = time.perf_counter() - t1
    saved_out = w.output(probe).detach().clone()
    for x, y in batches[TP_CKPT_FIRST:]:
        w.fit(x, y)
    uninterrupted = w.full_params()
    del w, net
    dist.barrier()
    fresh = cs._lm_net(args, dev, tree)
    t1 = time.perf_counter()
    mgr.restore_sharded(path, net=fresh, device=dev)
    w2 = wrap(fresh)
    restore_s = time.perf_counter() - t1
    for x, y in batches[TP_CKPT_FIRST:]:
        w2.fit(x, y)
    resumed = w2.full_params()
    bitwise = all(torch.equal(resumed[k][n], t)
                  for k, g in uninterrupted.items() for n, t in g.items())
    out = {"write_s": write_s, "restore_s": restore_s,
           "writer": w2.exchange.writer_index, "bitwise": bitwise}
    del w2, fresh, resumed, uninterrupted
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        import os
        out["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                           for f in os.listdir(path))
        with open(os.path.join(path, "topology.json")) as f:
            out["mesh"] = json.load(f)["mesh"]
        dense, _ = mgr.restore_sharded(path, device=dev)
        got = dense.output(probe)
        out["dense_max_abs_diff"] = (got - saved_out).abs().max().item()
        del dense
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _item8_gates(results, args, card):
    """Print the moe_wrapper, tp_sharded_ckpt and zero3_per_layer
    records; returns what failed, or None."""
    import chip_smoke as cs
    ranks = range(args.ranks)
    moe = [results[r]["moe_wrapper"] for r in ranks]
    m0 = moe[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(m0["losses"],
                                                  m0["twin_losses"]))
    expected = {k: cs.LAYERS * args.steps
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "ranks_moe_wrapper", "ranks": args.ranks,
        "experts": cs.MOE_EXPERTS,
        "capacity_factor": cs.MOE_CAPACITY_FACTOR,
        "global_batch": cs.TRAIN_BATCH, "steps": args.steps,
        "updater": f"Sgd({MOE_WRAPPER_LR})",
        "losses": m0["losses"], "twin_losses": m0["twin_losses"],
        "max_rel_loss_diff_vs_twin": rel, "tol": cs.TOL_MOE_LOSS,
        "per_rank": [{k: v for k, v in m.items()
                      if k not in ("losses", "twin_losses")} for m in moe],
        "tol_update": TOL_AXES_UPDATE, "card": card}), flush=True)
    if not all(math.isfinite(v) for v in m0["losses"]) or \
            rel > cs.TOL_MOE_LOSS:
        return f"moe_wrapper losses {m0['losses']} against the twin's " \
               f"{m0['twin_losses']}: {rel}"
    for r, m in enumerate(moe):
        if not m["update_gate_ok"]:
            return f"moe_wrapper rank {r}: step-1 params against the " \
                   f"twin {m['update_worst_leaf']} {m['update_err_and_bound']}"
        if m["launches"] != expected:
            return f"moe_wrapper rank {r} launched {m['launches']}"
    tp = [results[r]["tp_ckpt"] for r in ranks]
    print(json.dumps({
        "phase": "ranks_tp_sharded_ckpt", "ranks": args.ranks,
        "shape": [args.ranks // 2, 2], "saved_at": TP_CKPT_FIRST,
        "steps": TP_CKPT_STEPS, "bytes": tp[0].get("bytes"),
        "mesh": tp[0].get("mesh"),
        "write_s_per_rank": [t["write_s"] for t in tp],
        "restore_s_per_rank": [t["restore_s"] for t in tp],
        "resumed_bitwise_per_rank": [t["bitwise"] for t in tp],
        "writers": [t["writer"] for t in tp],
        "dense_restore_max_abs_diff": tp[0].get("dense_max_abs_diff"),
        "card": card}), flush=True)
    if not all(t["bitwise"] for t in tp):
        return "tp_sharded_ckpt: the resumed run differs from the " \
               "uninterrupted one"
    if tp[0].get("dense_max_abs_diff") != 0.0:
        return f"tp_sharded_ckpt: dense restore's outputs differ by " \
               f"{tp[0].get('dense_max_abs_diff')}"
    pw = [results[r]["wrapper"]["peak_bytes"] for r in ranks]
    z3 = [results[r]["sharded"]["peak_bytes"] for r in ranks]
    print(json.dumps({
        "phase": "ranks_zero3_per_layer", "ranks": args.ranks,
        "steps": args.steps,
        "sharded_peak_bytes_per_card": z3,
        "wrapper_peak_bytes_per_card": pw,
        "sharded_allocated_at_start": [results[r]["sharded"][
            "allocated_at_start"] for r in ranks],
        "wrapper_allocated_at_start": [results[r]["wrapper"][
            "allocated_at_start"] for r in ranks],
        "sharded_losses": results[0]["sharded"]["losses"],
        "wrapper_losses": results[0]["wrapper"]["losses"],
        "sharded_step_ms_median": results[0]["sharded"]["step_ms_median"],
        "wrapper_step_ms_median": results[0]["wrapper"]["step_ms_median"],
        "card": card}), flush=True)
    if not all(a < b for a, b in zip(z3, pw)):
        return f"zero3_per_layer: ShardedTrainer's peak {z3} is not below " \
               f"ParallelWrapper's {pw}"
    return None


PREFETCH_BATCHES = (64, 64, 64, 64, 64, 66)
# the wrapped BN sums its statistics over the ranks (an all-reduce of
# per-rank sums) where the twin sums the global batch at once: the same
# sums in another order.  Losses within 1e-5 relative; the running
# statistics within max(1e-5, 4x the distance of a second twin fed each
# batch's rows permuted) of each leaf's largest |value| (a variance as
# E[x^2] - E[x]^2 cancels, so its noise floor sits above 1e-5)
TOL_PREFETCH, PREFETCH_FLOOR_K = 1e-5, 4.0


def prefetch_cnn(seed, dev, helper="pallas"):
    """The small CNN of the ``prefetch_mesh`` phase."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization
    from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Nesterovs(learning_rate=0.01, momentum=0.9)).list())
    for ch in (32, 64):
        b = (b.layer(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                      padding=(1, 1), activation="identity"))
             .layer(BatchNormalization(activation="relu", helper=helper)))
    conf = (b.layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(32, 32, 3)).build())
    return MultiLayerNetwork(conf, device=dev)


def _prefetch_run(args, torch, dev, mesh, rank):
    """The CNN under ``ParallelWrapper`` fed by the mesh prefetcher and by
    host batches from the same weights, and a one-card twin."""
    import numpy as np
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ExistingDataSetIterator)
    from deeplearning4j_tpu_torch.data.pipeline import DevicePrefetchIterator
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    rng = np.random.default_rng(args.seed + 63)
    batches = [DataSet(rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])
               for n in PREFETCH_BATCHES]
    first = prefetch_cnn(args.seed, dev).init()
    tree0 = cs._host_tree(first)
    res = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        perm = [rng.permutation(len(b.features) // mesh.dp * mesh.dp)
                for b in batches]
        for name in ("host", "prefetch", "twin", "twin_permuted"):
            net = first if name == "host" else \
                prefetch_cnn(args.seed, dev).load_params(tree0)
            feed = ExistingDataSetIterator(batches)
            if name == "prefetch":
                feed = DevicePrefetchIterator(feed, depth=2, mesh=mesh)
            clock = cs._StepClock()
            net.set_listeners(clock)
            torch.cuda.synchronize()
            pb.reset_launches()
            if name.startswith("twin"):
                # the whole (trimmed) global batches on this card alone
                rows = perm if name == "twin_permuted" else \
                    [np.arange(len(q)) for q in perm]
                net.fit(ExistingDataSetIterator(
                    [DataSet(b.features[r], b.labels[r])
                     for b, r in zip(batches, rows)]))
            else:
                ParallelWrapper(net, mesh).fit(feed)
            torch.cuda.synchronize()
            losses = [float(v) for v in clock.losses]
            res[name] = {"losses": losses,
                         "bn_apply_launches": pb.launches["bn_apply"],
                         "last_batch_size": net.last_batch_size,
                         "params": _detached(net.params),
                         "state": {k: {n: t.clone() for n, t in g.items()}
                                   for k, g in net.state.items()}}
    finally:
        torch.backends.cudnn.deterministic = det
    out = {"losses": {k: res[k]["losses"] for k in res},
           "bn_apply_launches": {k: res[k]["bn_apply_launches"]
                                 for k in res},
           "last_batch_size": {k: res[k]["last_batch_size"] for k in res}}
    h, p, t = res["host"], res["prefetch"], res["twin"]

    def state_rel(a):
        return max(((a["state"][k][n] - t["state"][k][n]).abs().max()
                    / t["state"][k][n].abs().max().clamp(min=1e-30)).item()
                   for k in t["state"] for n in t["state"][k])

    out["params_max_abs_diff"] = max(
        (h["params"][k][n] - p["params"][k][n]).abs().max().item()
        for k in h["params"] for n in h["params"][k])
    out["state_max_abs_diff"] = max(
        (h["state"][k][n] - p["state"][k][n]).abs().max().item()
        for k in h["state"] for n in h["state"][k])
    out["state_max_rel_diff_vs_twin"] = state_rel(p)
    out["state_floor_permuted_twin"] = state_rel(res["twin_permuted"])
    out["max_abs_diff_vs_rank0"] = _max_diff_vs_rank0(p["params"])
    return out


def _prefetch_gates(results, args, card):
    """Gates and record of the ``prefetch_mesh`` phase; None or what
    failed."""
    rs = [results[r]["prefetch"] for r in sorted(results)]
    r0 = rs[0]
    steps = len(PREFETCH_BATCHES)
    twin_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(r0["losses"]["prefetch"], r0["losses"]["twin"]))
    record = {"phase": "prefetch_mesh", "ranks": args.ranks,
              "global_batches": list(PREFETCH_BATCHES),
              "losses": r0["losses"],
              "max_rel_loss_diff_vs_twin": twin_rel,
              "bn_apply_launches_per_rank": [r["bn_apply_launches"]
                                             for r in rs],
              "last_batch_size": r0["last_batch_size"],
              "params_max_abs_diff_host_vs_prefetch": [
                  r["params_max_abs_diff"] for r in rs],
              "state_max_abs_diff_host_vs_prefetch": [
                  r["state_max_abs_diff"] for r in rs],
              "state_max_rel_diff_vs_twin": [
                  r["state_max_rel_diff_vs_twin"] for r in rs],
              "state_tol": [max(TOL_PREFETCH, PREFETCH_FLOOR_K
                                * r["state_floor_permuted_twin"])
                            for r in rs],
              "max_abs_diff_vs_rank0": max(r["max_abs_diff_vs_rank0"]
                                           for r in rs),
              "tol": TOL_PREFETCH, "card": card}
    print(json.dumps(record), flush=True)
    if any(r["params_max_abs_diff"] or r["state_max_abs_diff"] or
           r["losses"]["host"] != r["losses"]["prefetch"] for r in rs):
        return "prefetch-fed training differs from host-fed on some rank"
    if any(n != 2 * steps for r in rs
           for n in r["bn_apply_launches"].values()):
        return (f"bn_apply launches {record['bn_apply_launches_per_rank']}"
                f"; expected 2 a step")
    last = PREFETCH_BATCHES[-1] // args.ranks * args.ranks
    if r0["last_batch_size"]["prefetch"] != last:
        return (f"last_batch_size {r0['last_batch_size']}: expected the "
                f"global {last}")
    if not all(math.isfinite(v) for v in r0["losses"]["prefetch"]) or \
            twin_rel > TOL_PREFETCH or \
            any(e > t for e, t in zip(record["state_max_rel_diff_vs_twin"],
                                      record["state_tol"])):
        return (f"the wrapped CNN is not the one-card twin on the global "
                f"batch: losses {twin_rel}, running statistics "
                f"{record['state_max_rel_diff_vs_twin']}")
    if record["max_abs_diff_vs_rank0"] != 0.0:
        return "prefetch_mesh: ranks' params differ from rank 0's"
    return None


def _rank_run(rank, world, port, args):
    sys.path.insert(0, str(REPO))
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ShardedTrainer,
                                                   initialize_distributed,
                                                   make_mesh,
                                                   megatron_dense_rule,
                                                   param_bytes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    import torch.distributed as dist
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
    tp_mesh = make_mesh(dp=world // 2, tp=2, device=dev)
    for name in ("wrapper", "sharded", "tensor"):
        net = cs._lm_net(args, dev, tree)
        if name == "wrapper":
            w = ParallelWrapper(net, mesh)
        elif name == "sharded":
            w = ShardedTrainer(net, mesh)
        else:
            w = ParallelWrapper(net, tp_mesh, param_rule=
                                megatron_dense_rule(net.params))
        # the last run's network is cyclic garbage until collected: its
        # params and slots must not count in this run's peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        fa.reset_launches()
        losses, ms = cs._fit_timed(torch, w, net, batches)
        launches = dict(fa.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        full = w.full_params() if name != "wrapper" else \
            _detached(net.params)
        errs = _rel_err_by_leaf(full, twin_params)
        worst_leaf = max(errs, key=errs.get)
        res[name] = {"losses": losses,
                     "step_ms_median": statistics.median(ms[1:]),
                     "launches": launches, "peak_bytes": peak,
                     "allocated_at_start": start,
                     "max_abs_diff_vs_rank0": _max_diff_vs_rank0(full),
                     "max_rel_err_vs_twin": errs[worst_leaf],
                     "worst_leaf": worst_leaf}
        if name != "wrapper":
            res[name]["per_device_param_bytes"] = \
                w.per_device_param_bytes()
            res[name]["param_bytes"] = \
                param_bytes(net.param_spec())
        del net, w, full
        torch.cuda.empty_cache()
    del twin_params
    torch.cuda.empty_cache()
    res["resnet"] = _resnet_run(args, torch, dev, mesh, rank)
    res["axes"] = _model_axes_run(args, torch, dev, world)
    torch.cuda.empty_cache()
    res["moe_wrapper"] = _moe_wrapper_run(args, torch, dev, mesh, world,
                                          rank)
    torch.cuda.empty_cache()
    res["tp_ckpt"] = _tp_ckpt_run(args, torch, dev, world, rank)
    torch.cuda.empty_cache()
    res["prefetch"] = _prefetch_run(args, torch, dev, mesh, rank)
    dist.barrier()
    return res


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
    for name in ("wrapper", "sharded", "tensor"):
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
    err = _model_axes_gates(results, args, card)
    if err:
        return fail(err)
    err = _item8_gates(results, args, card)
    if err:
        return fail(err)
    err = _prefetch_gates(results, args, card)
    if err:
        return fail(err)
    err = _dryrun_vs_twin(args, card)
    if err:
        return fail(err)
    print(json.dumps({"phase": "ranks", "seconds":
                      round(time.perf_counter() - t0, 3)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
