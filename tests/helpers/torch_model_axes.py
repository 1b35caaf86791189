"""Rank-side jobs of the port's model-axis tests (sequence, pipeline,
expert and tensor parallelism), run by ``torch_ranks.run_ranks`` on gloo
ranks: torch, numpy and the port only, no jax.

``jobs(rank, world, payload)`` runs every job of ``payload`` in order on
every rank.  A job builds its grid over the first ranks of the world
(every rank joins the grid's ``new_group`` calls); a rank outside the
grid passes the job by.  Each rank returns ``{job name: its result}``;
the test joins the ranks' shards.
"""
import numpy as np


def _t(a, dtype=None, grad=False):
    import torch
    t = torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.clone().requires_grad_(grad)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _cut(a, dim, n, i):
    k = a.shape[dim] // n
    return np.take(a, np.arange(i * k, (i + 1) * k), axis=dim)


def seq_attention(job, rank):
    """Ring or Ulysses attention over a ``seq`` axis of ``n``: this rank's
    output block and the input gradients of ``sum(o * do)``."""
    import torch
    from deeplearning4j_tpu_torch.ops.flash_attention import \
        flash_attention
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.sequence import (
        ring_self_attention, ulysses_attention)
    n = job["n"]
    grid = make_grid(("seq",), (n,), device="cpu")
    if not grid.member:
        return None
    i = grid.index("seq")
    q, k, v, do = (_t(_cut(job[a], 2, n, i), grad=a != "do")
                   for a in ("q", "k", "v", "do"))
    with grid:
        if job["impl"] == "ring":
            o = ring_self_attention(q, k, v, axis_name="seq",
                                    causal=job["causal"])
        else:
            kw = {"attn_fn": flash_attention} if job.get("flash") else {}
            o = ulysses_attention(q, k, v, axis_name="seq",
                                  causal=job["causal"], **kw)
        grads = torch.autograd.grad((o * do).sum(), (q, k, v))
    return {"index": i, "o": _np(o), "dq": _np(grads[0]),
            "dk": _np(grads[1]), "dv": _np(grads[2])}


def seq_mha(job, rank):
    """``MultiHeadAttention(attn_impl=ring|ulysses)`` on this rank's time
    block of the input."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    from deeplearning4j_tpu_torch.parallel import make_grid
    n = job["n"]
    grid = make_grid(("seq",), (n,), device="cpu")
    if not grid.member:
        return None
    i = grid.index("seq")
    layer = MultiHeadAttention(**job["conf"])
    layer.apply_global_defaults({})
    params = {k: _t(a, torch.float64) for k, a in job["params"].items()}
    x = _t(_cut(job["x"], 1, n, i), torch.float64)
    with grid:
        y = layer.apply(params, x)
    return {"index": i, "y": _np(y)}


def _stage(params, x):
    import torch
    return torch.tanh(x @ params["W"] + params["b"])


def gpipe(job, rank):
    """``gpipe`` over a ``pipe`` axis of ``n`` stages: the outputs and the
    gradient of ``sum(ys ** 2)`` with respect to this rank's stage."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.pipeline import gpipe as run
    n = job["n"]
    grid = make_grid(("pipe",), (n,), device="cpu")
    if not grid.member:
        return None
    i = grid.index("pipe")
    local = {k: _t(a[i:i + 1], grad=True)
             for k, a in job["stacked"].items()}
    xs = _t(job["xs"])
    with grid:
        ys = run(_stage, local, xs, axis_name="pipe")
        grads = torch.autograd.grad((ys ** 2).sum(), [local["W"],
                                                      local["b"]])
    return {"index": i, "ys": _np(ys), "W": _np(grads[0]),
            "b": _np(grads[1])}


def demo3d(job, rank):
    """One step of the 3D demo on a ``(data, pipe, seq)`` grid."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.demo import (
        build_demo_inputs, make_pipelined_train_step)
    dp, pp, sp = job["shape"]
    grid = make_grid(("data", "pipe", "seq"), (dp, pp, sp), device="cpu")
    if not grid.member:
        return None
    d, p, s = (grid.index(a) for a in ("data", "pipe", "seq"))
    stacked, xs, ys = build_demo_inputs(dtype=torch.float64, **job["demo"])
    local = {k: v[p:p + 1] for k, v in stacked.items()}

    def block(a):
        mb, t = a.shape[1] // dp, a.shape[2] // sp
        return a[:, d * mb:(d + 1) * mb, s * t:(s + 1) * t].contiguous()

    with grid:
        loss, new = make_pipelined_train_step(n_heads=job["heads"])(
            local, block(xs), block(ys))
    return {"coords": (d, p, s), "loss": float(loss),
            "new": {k: _np(v) for k, v in new.items()}}


def gpipe_other_thread(job, rank):
    """The 3D demo's GPipe over ring-attention blocks on a ``(pipe,
    seq)`` grid of 2 x 2: the stage gradients of ``sum(ys ** 2)`` with the
    backward run on this thread and on another one (where the grid is not
    entered: on CUDA autograd runs the backward on its device thread)."""
    import threading
    import torch
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.demo import (
        build_demo_inputs, ring_transformer_block)
    from deeplearning4j_tpu_torch.parallel.pipeline import gpipe as run
    grid = make_grid(("pipe", "seq"), (2, 2), device="cpu")
    if not grid.member:
        return None
    p, s = grid.index("pipe"), grid.index("seq")
    stacked, xs, _ = build_demo_inputs(dtype=torch.float64, **job["demo"])
    t = xs.shape[2] // 2
    xs = xs[:, :, s * t:(s + 1) * t].contiguous()
    names = sorted(stacked)

    def block(params, x):
        return ring_transformer_block(params, x, n_heads=job["heads"])

    out = {}
    for where in ("same", "other"):
        local = {k: stacked[k][p:p + 1].clone().requires_grad_(True)
                 for k in names}
        with grid:
            loss = (run(block, local, xs, axis_name="pipe") ** 2).sum()
        leaves = [local[k] for k in names]
        if where == "same":
            grads = torch.autograd.grad(loss, leaves)
        else:
            box = {}

            def backward():
                try:
                    box["g"] = torch.autograd.grad(loss, leaves)
                except BaseException as e:    # re-raised below
                    box["e"] = repr(e)
            th = threading.Thread(target=backward)
            th.start()
            th.join(120)
            if "g" not in box:
                raise RuntimeError(f"backward on another thread: {box}")
            grads = box["g"]
        out[where] = [_np(g) for g in grads]
    return out


def moe(job, rank):
    """The MoE train step (or forward) on a ``(data, expert)`` grid."""
    import torch
    from deeplearning4j_tpu_torch.parallel import make_grid
    from deeplearning4j_tpu_torch.parallel.expert import (
        make_moe_train_step, moe_ffn)
    dp, ep = job["shape"]
    grid = make_grid(("data", "expert"), (dp, ep), device="cpu")
    if not grid.member:
        return None
    d, e = grid.index("data"), grid.index("expert")
    per = job["params"]["w1"].shape[0] // ep
    params = {"router": _t(job["params"]["router"]),
              "w1": _t(job["params"]["w1"][e * per:(e + 1) * per]),
              "w2": _t(job["params"]["w2"][e * per:(e + 1) * per])}
    blk = d * ep + e
    x = _t(_cut(job["x"], 0, dp * ep, blk))
    with grid:
        if job.get("forward"):
            y, aux = moe_ffn(params, x, job["capacity"],
                             expert_axis="expert")
            return {"block": blk, "y": _np(y), "aux": float(aux)}
        y = _t(_cut(job["y"], 0, dp * ep, blk))
        new, loss = make_moe_train_step(capacity=job["capacity"],
                                        lr=job["lr"])(params, x, y)
    return {"coords": (d, e), "loss": float(loss),
            "new": {k: _np(v) for k, v in new.items()}}


def tensor_parallel(job, rank):
    """``ParallelWrapper(param_rule=megatron_dense_rule)`` on a
    ``(data, model)`` mesh: losses, gathered params and the layout."""
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   make_mesh,
                                                   megatron_dense_rule)
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        load_reference_model
    dp, tp = job["shape"]
    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    if not mesh.member:
        return None
    net = load_reference_model(job["zip"], device="cpu")
    w = ParallelWrapper(net, mesh, param_rule=megatron_dense_rule(
        net.params))
    losses = []
    for x, y in job["batches"]:
        w.fit(x, y)
        losses.append(float(net.get_score()))
    full = {k: {n: _np(t) for n, t in g.items()}
            for k, g in w.full_params().items()}
    out = {"losses": losses, "params": full,
           "local": sorted(f"{k}/{n}" for k, n in w.exchange.local),
           "plan": w.exchange.param_plan,
           "per_device_param_bytes": w.per_device_param_bytes()}
    if job.get("output") is not None:
        out["output"] = _np(w.output(job["output"]))
    return out


_FNS = {"seq_attention": seq_attention, "seq_mha": seq_mha, "gpipe": gpipe,
        "demo3d": demo3d, "moe": moe, "tensor_parallel": tensor_parallel,
        "gpipe_other_thread": gpipe_other_thread}


def jobs(rank, world, payload):
    out = {}
    for job in payload:
        res = _FNS[job["fn"]](job, rank)
        if res is not None:
            out[job["name"]] = res
    return out


def run(world, payload):
    """Every rank's results (``run_ranks`` over ``jobs``)."""
    from torch_ranks import run_ranks
    return run_ranks(world, "torch_model_axes:jobs", payload)
