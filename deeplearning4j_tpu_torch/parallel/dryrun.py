"""Multi-rank dry run (port of ``parallel/dryrun.py``): one training step
of each model axis on tiny shapes, over ``n`` ranks.

``run(n)`` starts ``n`` processes, one ``torch.distributed`` rank each:
by default NCCL with one rank per card, which needs ``n`` CUDA cards
(fewer is an error); ``device="cpu"`` runs the ranks on the CPU over
gloo (the JAX package provisions ``n`` virtual CPU devices instead; the
port needs no such flag).  Every rank runs

* ``_train_steps``: an MLP (784 -> 64 -> 64 -> 10, Adam) through
  ``ParallelWrapper`` with ``megatron_dense_rule`` on a ``(data, model)``
  mesh, tp 2 when ``n`` is even (the first two dense layers run as a
  Megatron pair), one step on a batch of ``8 * dp`` rows;

and, when ``n % 8 == 0``,

* ``_pipeline_seq_step``: the 3D demo (``demo.py``) on a ``(data, pipe,
  seq)`` grid of ``2 x 2 x n/4``: GPipe over two stages of ring-attention
  blocks, one SGD step;
* ``_expert_parallel_step``: the MoE train step (``expert.py``) on a
  ``(data, expert)`` grid of ``2 x n/2``.

Each step's loss must be finite.  ``run`` returns rank 0's record: the
backend and the device type the ranks ran on, the losses, and the MLP's
parameters after its step (gathered).
``init_params`` (a ``{layer: {name: array}}`` tree) starts the MLP from
given weights instead of the seed's.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import traceback
from typing import Any, Dict, Optional

import numpy as np

RESULT_TIMEOUT_S = 600.0
JOIN_TIMEOUT_S = 30.0

__all__ = ["run"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _use_cards(n_devices: int, device: str) -> bool:
    """Whether the ranks run on cards (one each): ``device`` is "cuda"
    or "cpu"; "cuda" with fewer than ``n_devices`` cards raises."""
    import torch
    kind = torch.device(device).type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"dry run on {device!r}: pass 'cuda' or 'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(
            f"dry run over {n_devices} ranks needs {n_devices} CUDA "
            f"card(s), found {have}; pass device='cpu' to run the ranks "
            "on the CPU over gloo")
    return True


def run(n_devices: int, *, init_params: Optional[Dict[str, Any]] = None,
        device: str = "cuda",
        timeout_s: float = RESULT_TIMEOUT_S) -> Dict[str, Any]:
    """The dry run over ``n_devices`` ranks on ``device`` ("cuda": one
    card a rank over NCCL; "cpu": gloo); rank 0's record.  Raises with
    the failing rank's traceback, or when a rank gives no result within
    ``timeout_s``."""
    n_devices = int(n_devices)
    cards = _use_cards(n_devices, device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, n_devices, port, cards, init_params, out),
                         daemon=True)
             for r in range(n_devices)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < n_devices:
            try:
                rank, ok, value = out.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"{n_devices - len(results)} dry-run rank(s) gave no "
                    f"result within {timeout_s:.0f} s") from None
            if not ok:
                raise RuntimeError(f"dry-run rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join(JOIN_TIMEOUT_S)
    return results[0]


def _child(rank, world, port, cards, init_params, out):
    # the result (or the traceback) goes out before the process group is
    # taken down: destroying a group with a collective still pending on
    # another rank can block until the backend's timeout
    import torch.distributed as dist
    try:
        import torch
        if cards:
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(
            "nccl" if cards else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=300))
        value = _run_rank(world, device, init_params)
        value.update(backend=str(dist.get_backend()), device=device.type)
        dist.barrier()
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_rank(n_devices: int, device, init_params) -> Dict[str, Any]:
    out = {"tp": _train_steps(n_devices, device, init_params)}
    if n_devices % 8 == 0:
        out["pipeline"] = _pipeline_seq_step(n_devices, device)
        out["expert"] = _expert_parallel_step(n_devices, device)
    return out


def _train_steps(n_devices: int, device, init_params=None) -> Dict[str, Any]:
    from ..nn.conf.input_type import InputType
    from ..nn.conf.multi_layer import NeuralNetConfiguration
    from ..nn.conf.updaters import Adam
    from ..nn.layers.feedforward import DenseLayer, OutputLayer
    from ..nn.multilayer import MultiLayerNetwork
    from .mesh import make_mesh
    from .wrapper import ParallelWrapper, megatron_dense_rule

    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, tp=tp, device=device)
    conf = (NeuralNetConfiguration.builder()
            .seed(42).activation("relu").weight_init("xavier")
            .updater(Adam(learning_rate=1e-3))
            .list()
            .layer(DenseLayer(n_out=64))
            .layer(DenseLayer(n_out=64))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(784))
            .build())
    model = MultiLayerNetwork(conf, device=device).init()
    if init_params is not None:
        model.load_params(init_params)
    rng = np.random.default_rng(0)
    dp = n_devices // tp
    batch = dp * 8  # divisible by the data axis
    x = rng.standard_normal((batch, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    pw = ParallelWrapper(model, mesh,
                         param_rule=megatron_dense_rule(model.params))
    pw.fit(x, y)
    loss = model.get_score()
    assert np.isfinite(loss), "dry-run step produced non-finite loss"
    params = {k: {n: t.cpu().numpy() for n, t in g.items()}
              for k, g in pw.full_params().items()}
    return {"dp": dp, "tp": tp, "loss": loss, "params": params,
            "pairs": sorted(f"{k}/{n}" for k, n in pw.exchange.local)}


def _pipeline_seq_step(n_devices: int, device) -> Dict[str, Any]:
    """The data x pipe x seq step: GPipe microbatching with ring attention
    inside each stage, gradients reduced over data and seq, SGD.  Model
    and step come from ``demo.py``."""
    from .demo import build_demo_inputs, make_pipelined_train_step
    from .mesh import make_grid

    dp, pp, sp = 2, 2, n_devices // 4
    stacked, xs, ys = build_demo_inputs(
        n_stages=pp, embed=8, n_heads=2, seq_len=4 * sp, microbatch=2 * dp,
        n_micro=pp, device=device)
    grid = make_grid(("data", "pipe", "seq"), (dp, pp, sp), device=device)
    d, p, s = (grid.index(a) for a in ("data", "pipe", "seq"))
    local = {k: v[p:p + 1] for k, v in stacked.items()}
    xs_l, ys_l = (_block(a, (1, 2), (dp, sp), (d, s)) for a in (xs, ys))
    with grid:
        loss, _ = make_pipelined_train_step(n_heads=2)(local, xs_l, ys_l)
    loss = float(loss)
    assert np.isfinite(loss), "pipeline dry-run produced non-finite loss"
    return {"loss": loss}


def _expert_parallel_step(n_devices: int, device) -> Dict[str, Any]:
    """The data x expert MoE step: top-1 routed FFN, tiled all-to-all
    token exchange over the expert axis, gradients reduced over data."""
    import torch

    from ..utils import _random
    from .expert import init_moe_params, make_moe_train_step
    from .mesh import make_grid

    dp, ep = 2, n_devices // 2
    embed, hidden, experts = 8, 16, ep
    grid = make_grid(("data", "expert"), (dp, ep), device=device)
    d, e = grid.index("data"), grid.index("expert")
    params = init_moe_params(_random.prng_key(0), experts, embed, hidden,
                             device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_devices * 4, embed)).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((embed, embed)).astype(np.float32))
    per = experts // ep
    local = {"router": params["router"],
             "w1": params["w1"][e * per:(e + 1) * per],
             "w2": params["w2"][e * per:(e + 1) * per]}
    rows = slice((d * ep + e) * 4, (d * ep + e + 1) * 4)
    xl, yl = (torch.as_tensor(a[rows], device=device) for a in (x, y))
    with grid:
        _, loss = make_moe_train_step(capacity=4)(local, xl, yl)
    loss = float(loss)
    assert np.isfinite(loss), "MoE dry-run produced non-finite loss"
    return {"loss": loss}


def _block(a, dims, counts, index):
    """This rank's block of ``a``: dim ``dims[i]`` cut into ``counts[i]``
    pieces, piece ``index[i]``."""
    for dim, n, i in zip(dims, counts, index):
        k = a.shape[dim] // n
        a = a.narrow(dim, i * k, k)
    return a.contiguous()
