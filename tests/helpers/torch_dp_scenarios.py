"""Rank-side scenarios of the port's data-parallel tests, run by
``torch_ranks.run_ranks`` on gloo ranks (torch and the port only: no jax
here).  ``jobs(rank, world, payload)`` runs every job of ``payload`` in
order on every rank; a job on a mesh smaller than the world runs on the
mesh's ranks, and the others pass it by (they still join the mesh's
``new_group``).  Rank 0 of a job's mesh reports its result.

A job is a dict with ``"fn"`` naming one of the functions below and its
arguments; networks start from a ``write_model`` zip of the JAX package
(``load_reference_model``), so both packages start from the same
weights and a fresh updater.
"""
import hashlib
import os
from contextlib import contextmanager

import numpy as np


def _net(job):
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        load_reference_model
    return load_reference_model(job["zip"], device="cpu")


def _wrap(kind, net, mesh, job):
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ShardedTrainer)
    if kind == "pw":
        return ParallelWrapper(net, mesh)
    if kind == "zero1":
        return ParallelWrapper(net, mesh, shard_optimizer_state=True)
    if kind == "zero3":
        return ShardedTrainer(net, mesh,
                              min_shard_size=job.get("min_shard_size", 1024))
    raise ValueError(kind)


def _full(w):
    """Every parameter whole, as numpy."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer
    if isinstance(w, ShardedTrainer):
        tree = w.full_params()
    else:
        tree = {k: {n: p.detach() for n, p in g.items()}
                for k, g in w.model.params.items()}
    return {k: {n: t.numpy().copy() for n, t in g.items()}
            for k, g in tree.items()}


def _full_slots(w):
    """Every updater slot whole, as numpy (gathered where sharded)."""
    m = w.model
    layout = m._shard_layout
    out = {}
    for k, g in m.opt_state["slots"].items():
        for n, sl in g.items():
            for s, t in sl.items():
                d = None if layout is None else \
                    layout[2].get(k, {}).get(n)
                full = t if d is None else layout[0].all_gather_dim(t, d)
                out[f"{k}/{n}/{s}"] = full.numpy().copy()
    return out


def digest(tree) -> dict:
    return {f"{k}/{n}": hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest()
        for k, g in tree.items() for n, a in g.items()}


@contextmanager
def _bn_calls(on):
    """Counts of the batch-norm paths taken inside the block (None when
    off): the fused one with and without a global batch, the unfused
    one."""
    if not on:
        yield None
        return
    from deeplearning4j_tpu_torch.nn.layers import normalization
    from deeplearning4j_tpu_torch.ops import pallas_bn
    calls = {"fused_global": 0, "fused_local": 0, "unfused": 0}
    fused, unfused = pallas_bn.bn_act_train, normalization.bn_train_norm

    def spy_fused(*a, **k):
        calls["fused_global" if k.get("gb") is not None
              else "fused_local"] += 1
        return fused(*a, **k)

    def spy_unfused(*a, **k):
        calls["unfused"] += 1
        return unfused(*a, **k)
    pallas_bn.bn_act_train = spy_fused
    normalization.bn_train_norm = spy_unfused
    try:
        yield calls
    finally:
        pallas_bn.bn_act_train = fused
        normalization.bn_train_norm = unfused


@contextmanager
def _rank_local_routing(on):
    """With ``on``, every mixture-of-experts layer routes its own rank's
    tokens only (no routing axis): the routing the global one replaces."""
    if not on:
        yield
        return
    from deeplearning4j_tpu_torch.parallel import expert
    real = expert.routing_axis
    expert.routing_axis = lambda: None
    try:
        yield
    finally:
        expert.routing_axis = real


def fit(job, mesh):
    """``job["steps"]`` batches through a wrapper; the losses after each
    step, the params (and slots) after the last.  ``local_routing``
    routes each rank's tokens alone (``_rank_local_routing``)."""
    net = _net(job)
    w = _wrap(job["kind"], net, mesh, job)
    losses = []
    with _bn_calls(job.get("count_fused_bn")) as calls, \
            _rank_local_routing(job.get("local_routing")):
        for b in job["batches"]:
            x, y, m, lm = (list(b) + [None, None])[:4]
            w.fit(x, y, mask=m, label_mask=lm)
            losses.append(float(net.get_score()))
    out = {"losses": losses, "params": _full(w)}
    if calls is not None:
        out["bn_calls"] = calls
    if job.get("slots"):
        out["slots"] = _full_slots(w)
    if job.get("bytes"):
        out["per_device_param_bytes"] = w.per_device_param_bytes()
        out["layout"] = w.layout()
    if job.get("touched"):
        out["touched"] = int(net._last_grad_stats["embedding_rows_touched"])
    if job.get("output"):
        out["output"] = _output_without_broadcast(w, job["batches"][0][0])
    return out


def _output_without_broadcast(w, x):
    """``w.output(x)`` with every broadcast refused, and whether this
    rank's stored params and updater slots are bit for bit the ones it
    held before."""
    import torch
    from deeplearning4j_tpu_torch.parallel.exchange import GradientExchange
    m = w.model

    def stored():
        out = [p.detach().clone() for g in m.params.values()
               for p in g.values()]
        return out + [t.clone() for g in m.opt_state["slots"].values()
                      for sl in g.values() for t in sl.values()]

    def refuse(self, t, src=0):
        raise AssertionError("output broadcast the network's state")
    before = stored()
    orig = GradientExchange.broadcast_
    GradientExchange.broadcast_ = refuse
    try:
        rows = np.asarray(w.output(x).detach().numpy()).copy()
    finally:
        GradientExchange.broadcast_ = orig
    after = stored()
    return {"rows": rows, "blocks_unchanged": len(before) == len(after)
            and all(torch.equal(a, b) for a, b in zip(before, after))}


def save_sharded(job, mesh):
    """Train ``job["batches"]`` under a ShardedTrainer, then every rank
    writes its blocks through a barrier round; returns the digests of the
    params written."""
    from deeplearning4j_tpu_torch.faulttolerance.checkpoint import (
        CheckpointManager, ShardBarrier)
    net = _net(job)
    w = _wrap("zero3", net, mesh, job)
    for b in job["batches"]:
        w.fit(*b)
    mgr = CheckpointManager(job["dir"], background=False)
    path = w.save_sharded(mgr, barrier=ShardBarrier(timeout_s=60))
    full = _full(w)
    return {"path": path, "digest": digest(full), "params": full,
            "slots": _full_slots(w), "rng": net._rng.tolist()}


def restore_sharded(job, mesh):
    """Restore ``job["path"]`` into a fresh net, lay it out under a
    ShardedTrainer on this mesh, and report the digests of the whole
    params and slots, and the sharded dims of the layout."""
    from deeplearning4j_tpu_torch.faulttolerance.checkpoint import \
        CheckpointManager
    net = _net(job)
    CheckpointManager(os.path.dirname(job["path"])).restore_sharded(
        path=job["path"], net=net, device="cpu")
    w = _wrap("zero3", net, mesh, job)
    full = _full(w)
    slots = _full_slots(w)
    out = {"digest": digest(full), "params": full, "layout": w.layout(),
           "slot_digest": {k: hashlib.sha256(v.tobytes()).hexdigest()
                           for k, v in slots.items()},
           "iteration": net.iteration, "rng": net._rng.tolist()}
    if job.get("continue"):
        for b in job["continue"]:
            w.fit(*b)
        out["after"] = _full(w)
    return out


def elastic_survivor(job, mesh):
    """Both ranks train a ShardedTrainer under an ElasticTrainer (a static
    world: generation-0 barrier saves every ``save_freq`` steps) for
    ``job["first"]`` batches; then rank 1 is gone and rank 0 alone builds
    a survivor mesh over itself (a one-rank group), restores the newest
    complete checkpoint onto it and trains the remaining batches."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    net = _net(job)
    w = _wrap("zero3", net, mesh, job)
    et = ElasticTrainer(w, job["dir"], save_freq=job["save_freq"],
                        keep_last=100)
    batches = job["batches"]
    n = et.fit(lambda: iter(batches), max_steps=job["first"])
    if mesh.rank != 0:
        return {"steps": n}
    solo = dist.new_group([0], use_local_synchronization=True)
    w.retarget(Mesh(1, 0, group=solo, device="cpu"))
    restored = et.restore_latest()
    steps = ElasticTrainer(w, job["dir"], save_freq=job["save_freq"],
                           keep_last=100) \
        .fit(lambda: iter(batches))
    return {"restored": restored, "steps": steps, "dp": w.mesh.dp,
            "params": _full(w), "losses": [float(net.get_score())]}


def zero3_gathers(job, mesh):
    """``job["batches"]`` through a ShardedTrainer, every whole leaf the
    exchange gathers (forward and backward) watched by a weak reference:
    after each gather, the layers that still have a whole leaf alive.
    Returns the most such layers at once, the gathers counted, and the
    whole params."""
    import gc
    import time
    import weakref
    from deeplearning4j_tpu_torch.parallel.exchange import GradientExchange
    net = _net(job)
    w = _wrap("zero3", net, mesh, job)
    owner = {id(p): k for k, g in net.params.items() for p in g.values()}
    seen, worst = [], [0]
    real = GradientExchange.gather_blocks

    def alive():
        return {k for k, r in seen if r() is not None}

    def watched(self, block, dim):
        out = real(self, block, dim)
        layer = owner.get(id(block))
        if layer is not None:
            seen.append((layer, weakref.ref(out)))
            # gloo's worker thread lets go of a finished collective's
            # output a moment after the caller's wait returns: give it
            # that moment before counting what the step still holds
            deadline = time.monotonic() + 2.0
            while len(alive()) > 1 and time.monotonic() < deadline:
                time.sleep(0.001)
            worst[0] = max(worst[0], len(alive()))
        return out
    gc.disable()        # liveness by reference counts alone
    GradientExchange.gather_blocks = watched
    try:
        for b in job["batches"]:
            w.fit(*b)
    finally:
        GradientExchange.gather_blocks = real
        gc.enable()
    return {"most_layers_alive": worst[0], "gathers": len(seen),
            "layers": sorted({k for k, _ in seen}), "params": _full(w)}


_FNS = {"fit": fit, "save_sharded": save_sharded, "zero3_gathers": zero3_gathers,
        "restore_sharded": restore_sharded,
        "elastic_survivor": elastic_survivor}


def jobs(rank, world, payload):
    from deeplearning4j_tpu_torch.parallel import make_mesh
    out = {}
    for job in payload:
        mesh = make_mesh(dp=job["dp"], device="cpu")
        if mesh.rank is None:
            continue
        res = _FNS[job["fn"]](job, mesh)
        if mesh.rank == 0:
            out[job["name"]] = res
    return out


def run(world, payload):
    """Rank 0's results of every job (``run_ranks`` over ``jobs``)."""
    from torch_ranks import run_ranks
    return run_ranks(world, "torch_dp_scenarios:jobs", payload)[0]

