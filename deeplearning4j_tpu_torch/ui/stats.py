"""Training stats collection (port of ``ui/stats.py``; reference
``ui-model/.../ui/stats/BaseStatsListener.java:44`` — ``iterationDone``
:286 collects score, param/update histograms & mean-magnitudes, memory,
GC and hardware info into ``Persistable`` records).

Every statistic is computed with torch ops on the tensor's own device,
in f32, element for element as the JAX package's ``_stats_one``: ``lo``,
``hi``, ``width = max(hi - lo, 1e-12)``, ``idx = clip(int32((x - lo) /
width * bins), 0, bins - 1)``, a 20-bin count (a scatter-add, which
needs no host sync), the mean, the population std (ddof 0, as
``jnp.std``), the mean magnitude and the 2-norm of the flattened tensor.
The listener stacks the arrays of one shape (a transformer's layers
share their shapes) and reduces each stack along its rows, so a
collection launches ~20 kernels a shape, not ~20 an array.

Deliberate differences from the JAX listener:

- ``StatsListener.iteration_done`` copies to the host once per collected
  iteration: every parameter's and every update's statistics and the
  score are stacked on the device into one f64 tensor (exact for the f32
  scalars and for counts below 2^53) and copied together, where the JAX
  listener pulls each array's statistics separately.
- The previous parameters, from which the updates are the deltas, are
  kept on the device (the stacks above, which are copies).  The JAX
  listener keeps host copies because its jitted step donates the
  parameter buffers; the port's step does not.
- The memory record reads the CUDA caching allocator
  (``device{i}_bytes_in_use``) and each card's total memory
  (``device{i}_bytes_limit``) where CUDA is initialised, and the host's
  RSS only on the CPU.

Names, record fields and the score equal the JAX listener's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..observability.clock import monotonic_s
from ..train.listeners import TrainingListener

__all__ = ["StatsListener", "StatsReport", "array_stats"]

_N_BINS = 20
_HIST_COPIES = 64
_SCALARS = ("mean", "std", "min", "max", "mean_magnitude", "norm2")


def _stats_rows(x: torch.Tensor, bins: int = _N_BINS) -> torch.Tensor:
    """``[k, 6 + bins]`` f64 for the ``k`` rows of ``x`` (``[k, n]``, each
    row one array): the six scalars in ``_SCALARS`` order, then the
    histogram counts.  Each row's arithmetic is the JAX ``_stats_one``'s,
    element for element in f32; the reductions run along the rows."""
    x = x.detach().to(torch.float32)
    k, n = x.shape
    lo, hi = torch.aminmax(x, dim=1)
    width = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo[:, None]) / width[:, None] * bins)
                      .to(torch.int32), 0, bins - 1)
    # the counts go to _HIST_COPIES copies of the k x bins table, column
    # j to copy j % _HIST_COPIES, summed after: the scatter's atomic adds
    # then spread over that many more addresses (integers: the same
    # counts in any order)
    copies = min(_HIST_COPIES, n)
    dev = x.device
    flat = (idx.long() + torch.arange(0, k * bins, bins, device=dev)[:, None]
            + (torch.arange(n, device=dev) % copies * (k * bins))[None, :]
            ).reshape(-1)
    hist = torch.zeros(copies * k * bins, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, flat, torch.ones((), dtype=torch.int64,
                                          device=dev).expand(flat.shape))
    hist = hist.view(copies, k * bins).sum(0)
    scalars = torch.stack([x.mean(1), x.std(1, correction=0), lo, hi,
                           x.abs().mean(1), torch.linalg.vector_norm(x, dim=1)],
                          dim=1)
    return torch.cat([scalars.double(), hist.view(k, bins).double()], dim=1)


def _row_dict(row: np.ndarray) -> Dict[str, Any]:
    out = {k: float(v) for k, v in zip(_SCALARS, row[:len(_SCALARS)])}
    out["hist"] = [int(c) for c in row[len(_SCALARS):]]
    return out


def array_stats(x) -> Dict[str, Any]:
    """Host dict of scalar stats + histogram for one array (a tensor on
    any device, or anything numpy takes): one device pass, one copy."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return _row_dict(_stats_rows(x.reshape(1, -1))[0].cpu().numpy())


def _groups(flat: Dict[str, torch.Tensor]) -> Dict[tuple, List[str]]:
    """Names by (shape, dtype, device), in first-seen order: the arrays
    of one group are stacked and reduced together."""
    groups: Dict[tuple, List[str]] = {}
    for name, a in flat.items():
        groups.setdefault((tuple(a.shape), a.dtype, a.device), []).append(name)
    return groups


def _flatten_params(params, prefix="") -> Dict[str, Any]:
    flat = {}
    if hasattr(params, "items"):
        for k, v in params.items():
            flat.update(_flatten_params(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = params
    return flat


@dataclass
class StatsReport:
    """One iteration's record (reference ``StatsReport``/``SbeStatsReport``)."""
    session_id: str
    worker_id: str
    iteration: int
    epoch: int
    timestamp: float
    score: float
    iter_time_ms: float
    param_stats: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    update_stats: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    memory: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StatsReport":
        return cls(**d)


def _memory_info() -> Dict[str, Any]:
    mem: Dict[str, Any] = {}
    try:
        import resource
        mem["host_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except (ImportError, OSError):
        pass
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            mem[f"device{i}_bytes_in_use"] = st.get(
                "allocated_bytes.all.current", 0)
            mem[f"device{i}_bytes_limit"] = \
                torch.cuda.get_device_properties(i).total_memory
    return mem


class StatsListener(TrainingListener):
    """Collects per-iteration stats into a :class:`StatsStorage`-compatible
    router (reference ``BaseStatsListener``).

    ``update stats`` are parameter deltas between consecutive collected
    iterations — the functional-update analogue of the reference's updater
    output histograms.
    """

    def __init__(self, storage, session_id: Optional[str] = None,
                 worker_id: str = "worker_0", frequency: int = 1,
                 collect_histograms: bool = True, collect_memory: bool = True):
        self.storage = storage
        self.session_id = session_id or f"session_{int(time.time() * 1000)}"
        self.worker_id = worker_id
        self.frequency = max(1, frequency)
        self.collect_histograms = collect_histograms
        self.collect_memory = collect_memory
        # {(shape, dtype, device): (names, [k, n] stack)} of the last
        # collected iteration
        self._last_params: Optional[Dict[tuple, tuple]] = None
        self._last_time: Optional[float] = None

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        # interval on the monotonic clock; the record keeps a wall-clock
        # timestamp for cross-host correlation
        now_mono = monotonic_s()
        iter_ms = ((now_mono - self._last_time) * 1000.0
                   if self._last_time else 0.0)
        self._last_time = now_mono
        now = time.time()
        if iteration % self.frequency != 0:
            return
        flat = {n: a.detach() for n, a in
                _flatten_params(model.params).items()
                if torch.is_tensor(a) and a.numel()}
        # one [k, n] stack per group of same-shaped arrays: its rows, and
        # the next collected iteration's previous params
        groups = _groups(flat)
        stacks = {key: torch.stack([flat[n].reshape(-1) for n in names])
                  for key, names in groups.items()}
        rows: List[torch.Tensor] = []
        keys: List[tuple] = []
        last = self._last_params
        for key, names in groups.items():
            rows.append(_stats_rows(stacks[key]))
            keys += [("param", n) for n in names]
            if last is not None and last.get(key, (None,))[0] == names:
                rows.append(_stats_rows(stacks[key] - last[key][1]))
                keys += [("update", n) for n in names]
        score = getattr(model, "_score", None)
        on_device = torch.is_tensor(score)
        if rows:
            dev = rows[0].device
            tail = [score.detach().reshape(1).to(dev, torch.float64)] \
                if on_device else []
            host = torch.cat([torch.cat([r.to(dev) for r in rows])
                              .reshape(-1), *tail]).cpu().numpy()
        else:
            host = np.asarray([float(score)] if on_device else [])
        width = len(_SCALARS) + _N_BINS
        found: Dict[tuple, Dict[str, Any]] = {}
        for j, key in enumerate(keys):
            st = _row_dict(host[j * width:(j + 1) * width])
            if not self.collect_histograms:
                st.pop("hist")
            found[key] = st
        # the records list the arrays in the model's order
        param_stats = {n: found[("param", n)] for n in flat}
        update_stats = {n: found[("update", n)] for n in flat
                        if ("update", n) in found}
        self._last_params = {key: (names, stacks[key])
                             for key, names in groups.items()}
        report = StatsReport(
            session_id=self.session_id, worker_id=self.worker_id,
            iteration=iteration, epoch=epoch, timestamp=now,
            score=float(host[-1]) if on_device else float(model.get_score()),
            iter_time_ms=iter_ms, param_stats=param_stats,
            update_stats=update_stats,
            memory=_memory_info() if self.collect_memory else {})
        self.storage.put_record(report)
