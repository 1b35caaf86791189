"""Run a function on ``world`` gloo ranks of the port, each a spawned
process on the CPU, and collect what each rank returns.

``run_ranks(world, "module:function", payload)`` starts the processes,
each of which joins one ``torch.distributed`` group (gloo on a free
localhost port), calls ``function(rank, world, payload)`` and sends its
result back.  Every wait has its own timeout, so a hung rank fails the
caller's test instead of running into the suite's clock; a rank's
exception comes back as its traceback.  The children import torch and
the port only (``module`` must not import jax), run one intra-op thread
each, and stop before this returns.
"""
import datetime
import importlib
import multiprocessing as mp
import queue
import socket
import traceback

RESULT_TIMEOUT_S = 300.0
JOIN_TIMEOUT_S = 30.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(rank, world, port, target, payload, out):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=120))
        try:
            mod, fn = target.split(":")
            value = getattr(importlib.import_module(mod), fn)(
                rank, world, payload)
            out.put((rank, True, value))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(world: int, target: str, payload,
              timeout_s: float = RESULT_TIMEOUT_S):
    """``[result of rank 0, ..., result of rank world-1]``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, target, payload, out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"{world - len(results)} rank(s) of {target} gave no "
                    f"result within {timeout_s:.0f} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of {target} failed:\n"
                                   f"{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join(JOIN_TIMEOUT_S)
    return [results[r] for r in range(world)]
