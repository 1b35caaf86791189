"""Cluster-style training masters (port of ``parallel/master.py``;
reference ``deeplearning4j-scaleout``: ``ParameterAveragingTrainingMaster``
— treeAggregate parameter averaging with configurable depth — and
``SharedTrainingMaster`` — asynchronous decentralized gradient sharing,
here over the :class:`EncodedGradientsAccumulator`).

Workers are threads, each owning a full replica of the network on the
same device (the reference's Spark executors).  Synchronous data
parallelism across devices is ``ParallelWrapper``; these masters keep the
reference's cluster semantics: periodic averaging, retries, elastic
degradation, and quantized asynchronous sharing.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .accumulation import EncodedGradientsAccumulator, EncodingHandler
from ..faulttolerance.faults import RetryPolicy
from ..observability.clock import monotonic_s
from ..observability.recorder import get_flight_recorder
from ..observability.registry import MetricsRegistry, default_registry
from ..observability.tracer import get_tracer

__all__ = ["TrainingMaster", "ParameterAveragingTrainingMaster",
           "SharedGradientsTrainingMaster", "TrainingMasterStats",
           "tree_average"]

log = logging.getLogger("deeplearning4j_tpu_torch.parallel")


class TrainingMasterStats:
    """Phase wall-times per fit() call (reference
    ``ParameterAveragingTrainingMasterStats`` / ``SparkTrainingStats``:
    split/fit/aggregation/broadcast timings).  Times in seconds.

    A thin view over a metrics registry: each ``record`` lands in a
    ``training_master_phase_seconds{phase,worker}`` histogram (per-worker
    label for fan-out phases; master-side phases carry ``worker="-"``).
    By default the stats own a private always-on registry so phase
    timings survive even when the process-global registry is disabled;
    inject the default registry (or any other) to fold them into a
    ``/metrics`` exposition.

    Semantics note: fan-out phases ("fit") are recorded once per WORKER,
    so their totals are worker-seconds (CPU-time style — ~N_workers x the
    round wall time when workers run concurrently); master-side phases
    (split/broadcast/aggregation) are wall time.  The per-worker rows in
    ``stats_text`` make the distinction visible.
    """

    _HIST = "training_master_phase_seconds"
    # phase buckets: sub-ms splits to multi-second aggregation rounds
    _BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                10.0, 60.0)
    _MASTER = "-"   # worker label for phases the master itself runs

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=True)
        self._hist = self.registry.histogram(
            self._HIST, "TrainingMaster phase wall time",
            ("phase", "worker"), buckets=self._BUCKETS)

    def record(self, phase: str, seconds: float,
               worker: Optional[int] = None) -> None:
        label = self._MASTER if worker is None else str(worker)
        self._hist.labels(phase, label).observe(seconds)

    def _by_phase(self):
        out: Dict[str, Dict[str, Any]] = {}
        for (phase, worker), child in self._hist.samples():
            out.setdefault(phase, {})[worker] = child
        return out

    def total(self, phase: str) -> float:
        return float(sum(c.sum for c in
                         self._by_phase().get(phase, {}).values()))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """Backward-compatible shape: per-phase count/total/mean
        aggregated over workers."""
        out = {}
        for phase, workers in self._by_phase().items():
            count = sum(c.count for c in workers.values())
            total = sum(c.sum for c in workers.values())
            if count:
                out[phase] = {"count": count, "total_s": float(total),
                              "mean_s": float(total / count)}
        return out

    def stats_text(self) -> str:
        """Deterministic table: rows sorted by (phase, worker), one row
        per (phase, worker) series plus the worker-aggregated line the
        pre-registry format printed."""
        by_phase = self._by_phase()
        lines = ["phase                worker  count   total_s   mean_s"]
        for phase, d in sorted(self.as_dict().items()):
            lines.append(f"{phase:<20} {'all':>6} {d['count']:>6} "
                         f"{d['total_s']:>9.3f} {d['mean_s']:>8.4f}")
            workers = by_phase[phase]
            if set(workers) != {self._MASTER}:
                for w in sorted(workers, key=lambda s: (len(s), s)):
                    c = workers[w]
                    if not c.count:
                        continue
                    mean = c.sum / c.count
                    lines.append(f"{phase:<20} {w:>6} {c.count:>6} "
                                 f"{c.sum:>9.3f} {mean:>8.4f}")
        return "\n".join(lines)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts (lists and tuples too)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *c) for c in zip(*trees))
    return fn(*trees)


def tree_average(param_trees: Sequence[Any], depth: int = 2):
    """Average parameter trees pairwise to the given aggregation depth
    (reference ``treeAggregate`` ``aggregationDepth``: numerically a mean,
    shaped as a reduction tree so partial aggregates stay bounded)."""
    trees = list(param_trees)
    n = len(trees)
    if n == 1:
        return trees[0]

    def add(a, b):
        return _tree_map(lambda x, y: x + y, a, b)

    level = 0
    while len(trees) > 1 and level < max(depth, 1):
        nxt = [add(trees[i], trees[i + 1]) if i + 1 < len(trees) else trees[i]
               for i in range(0, len(trees), 2)]
        trees, level = nxt, level + 1
    total = trees[0]
    for t in trees[1:]:
        total = add(total, t)
    return _tree_map(lambda s: s / n, total)


def _cast_like(a, ref):
    """Restore ``ref``'s type on an averaged leaf: integer leaves (step
    counts) round back to ints, floats pass through."""
    if isinstance(ref, (bool, int, np.integer)):
        return int(round(float(a)))
    if isinstance(ref, torch.Tensor) and not ref.is_floating_point():
        return torch.round(a).to(ref.dtype)
    return a


def _params_of(net) -> Dict[str, Dict[str, torch.Tensor]]:
    return {k: {n: p.detach() for n, p in g.items()}
            for k, g in net.params.items()}


def _owned(tree):
    """An owned copy of a tree of tensors (ints pass through)."""
    return _tree_map(lambda t: t.detach().clone()
                     if isinstance(t, torch.Tensor) else t, tree)


@torch.no_grad()
def _install_params(net, tree) -> None:
    for k, g in tree.items():
        for n, t in g.items():
            net.params[k][n].copy_(t)


def _flatten_params(net):
    """``(flat vector, unravel)`` of a network's params in sorted order
    (the JAX package's ``ravel_pytree``)."""
    keys = [(k, n) for k in sorted(net.params)
            for n in sorted(net.params[k], key=lambda s: s.split("/"))]
    parts = [net.params[k][n].detach().reshape(-1) for k, n in keys]
    flat = torch.cat(parts) if parts else torch.zeros(0)

    def unravel(vec):
        out, off = {}, 0
        for k, n in keys:
            p = net.params[k][n]
            out.setdefault(k, {})[n] = vec[off:off + p.numel()].view_as(p)
            off += p.numel()
        return out

    return flat, unravel


def _sync(net) -> None:
    dev = getattr(net, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _np(a):
    """A host array of a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _chunk_batches(iterator, n_workers: int) -> List[List[Any]]:
    """Round-robin batch assignment (the repartition step,
    ``ParameterAveragingTrainingMaster.java:97-98``)."""
    parts: List[List[Any]] = [[] for _ in range(n_workers)]
    for i, batch in enumerate(iterator):
        parts[i % n_workers].append(batch)
    return parts


class TrainingMaster:
    """fit(model, iterator) contract (reference ``TrainingMaster.java:28``),
    plus the distributed evaluation/scoring surface the reference exposes on
    the Spark facades (``SparkDl4jMultiLayer.evaluate`` map-partitions +
    ``IEvaluation.merge`` reduce; ``calculateScore`` :~ sum/average loss)."""

    num_workers: int = 2

    def fit(self, model, iterator) -> None:
        raise NotImplementedError

    def _get_replicas(self, model) -> List[Any]:
        """Replica pool: clone once per master+model, refresh params from
        the (possibly updated) master model on later calls (the reference
        re-broadcasts params per split, it does not rebuild workers).
        Each clone draws an independent key stream (decorrelated
        dropout)."""
        if (getattr(self, "_replicas", None) is None
                or self._replica_src is not model
                or len(self._replicas) != self.num_workers):
            self._replicas = [model] + [model.clone()
                                        for _ in range(self.num_workers - 1)]
            self._replica_src = model
        else:
            for r in self._replicas[1:]:
                _install_params(r, _params_of(model))
                r.state = _owned(model.state)
                r.opt_state = _owned(model.opt_state)
                # keep LR-schedule/epoch counters in lockstep too — the
                # master model may have been checkpoint-restored between fits
                r.iteration = model.iteration
                r.epoch = model.epoch
        return self._replicas

    def _fan_out(self, model, iterator, num_workers: Optional[int],
                 per_batch: Callable[[Any, Any, int], None]) -> int:
        """Shared map scaffolding for the evaluation/scoring surface: chunk
        batches over worker threads, run ``per_batch(model, batch, worker)``
        on each share, re-raise the first worker error.  Returns the worker
        count used.  The one model is shared across threads — output/score
        are read-only, so the reference's broadcast-a-copy step has no role
        here and cloning would just pay a param copy per worker."""
        if hasattr(iterator, "reset"):
            iterator.reset()
        parts = [p for p in _chunk_batches(
            iterator, num_workers or self.num_workers) if p]
        if not parts:
            return 0
        errors: List[Exception] = []

        def work(w):
            try:
                for batch in parts[w]:
                    per_batch(model, batch, w)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(len(parts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return len(parts)

    def evaluate(self, model, iterator, eval_factory=None,
                 num_workers: Optional[int] = None):
        """Distributed evaluation: batches fan out over worker threads, each
        accumulating a partial IEvaluation against the one shared read-only
        model; partials merge at the end.  ``eval_factory`` picks the evaluation type (Evaluation by
        default — pass e.g. ``RegressionEvaluation`` or
        ``lambda: ROC(threshold_steps=30)``)."""
        from ..evaluation.classification import Evaluation
        n_max = num_workers or self.num_workers
        evals = [(eval_factory or Evaluation)() for _ in range(n_max)]

        def per_batch(net, batch, w):
            x, y, _, lm = net._normalize_batch(batch)
            if isinstance(x, list):  # ComputationGraph batch
                out = net.output(*x)
                if isinstance(out, (list, tuple)) and len(out) > 1:
                    import warnings
                    warnings.warn(
                        "TrainingMaster.evaluate: multi-output graph — "
                        "only output[0]/labels[0] are evaluated; evaluate "
                        "other heads separately", stacklevel=2)
                out = out[0] if isinstance(out, (list, tuple)) else out
                y0 = y[0] if isinstance(y, (list, tuple)) else y
                lm0 = lm[0] if isinstance(lm, (list, tuple)) else lm
            else:
                out, y0, lm0 = net.output(x), y, lm
            evals[w].eval(_np(y0), _np(out),
                          mask=None if lm0 is None else _np(lm0))

        used = self._fan_out(model, iterator, num_workers, per_batch)
        merged = evals[0]
        for ev in evals[1:used]:
            merged.merge(ev)
        return merged

    def score(self, model, iterator, average: bool = True,
              num_workers: Optional[int] = None) -> float:
        """Distributed loss over the dataset (reference
        ``SparkDl4jMultiLayer.calculateScore``: per-partition loss sums,
        reduced; ``average`` divides by the example count)."""
        n_max = num_workers or self.num_workers
        totals, counts = [0.0] * n_max, [0] * n_max

        def per_batch(net, batch, w):
            x, y, _, _ = net._normalize_batch(batch)
            if isinstance(x, list):
                s = net.score(inputs=x, labels=y)
                bs = int(np.asarray(x[0]).shape[0])
            else:
                s = net.score(x=x, y=y)
                bs = int(np.asarray(x).shape[0])
            totals[w] += s * bs
            counts[w] += bs

        self._fan_out(model, iterator, num_workers, per_batch)
        total, n = sum(totals), sum(counts)
        return total / max(n, 1) if average else total


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous data parallelism with periodic parameter averaging
    (reference ``ParameterAveragingTrainingMaster.java``): per split, every
    worker replica fits its partition locally, then params (and optionally
    updater state) are tree-averaged and re-broadcast.

    **Worker-failure recovery** (the Spark lineage-re-execution role,
    TensorFlow-paper posture: recover by re-execution, not per-op
    reliability): each worker's round runs against a round-start snapshot
    of its replica.  A failed round is retried up to ``max_retries`` times
    with seeded exponential backoff + jitter, re-executing the chunk from
    the snapshot (exactly-once in surviving state).  A worker exceeding
    ``straggler_timeout_s`` — or out of retries — is marked LOST: its
    round chunk is immediately re-chunked over the surviving workers and
    the rest of its shard rides their queues (*elastic degradation* — the
    fit completes on survivors instead of aborting), and it is excluded
    from every later round, aggregation, and broadcast.  A seeded
    :class:`~..faulttolerance.faults.FaultInjector` makes all of
    this deterministically testable.  Emits
    ``training_worker_retries_total`` / ``training_worker_lost_total``.
    """

    def __init__(self, num_workers: int, averaging_frequency: int = 5,
                 aggregation_depth: int = 2, average_updaters: bool = True,
                 tracer=None, max_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 straggler_timeout_s: Optional[float] = None,
                 fault_injector=None, retry_seed: int = 0,
                 elastic: bool = True):
        self.num_workers = num_workers
        self.averaging_frequency = max(1, averaging_frequency)
        self.aggregation_depth = aggregation_depth
        self.average_updaters = average_updaters
        self.stats = TrainingMasterStats()
        self.tracer = tracer   # None -> process-global (off by default)
        self.retry_policy = RetryPolicy(max_retries=max_retries,
                                        backoff_s=retry_backoff_s,
                                        seed=retry_seed)
        self.straggler_timeout_s = straggler_timeout_s
        self.fault_injector = fault_injector
        self.elastic = elastic
        self.lost_workers: set = set()
        self.retry_counts: Dict[int, int] = {}

    def fit(self, model, iterator) -> None:
        tracer = self.tracer if self.tracer is not None else get_tracer()
        with tracer.span("master.fit", mode="averaging",
                         workers=self.num_workers):
            self._fit_traced(model, iterator, tracer)

    # ------------------------------------------------- recovery plumbing
    @staticmethod
    def _snapshot_replica(replica):
        """Round-start snapshot: owned copies of params, state, updater
        state and key + counters, so a retry re-executes the chunk from
        EXACTLY the state the failed attempt started at."""
        return (_owned(_params_of(replica)), _owned(replica.state),
                _owned(replica.opt_state), replica._rng.clone(),
                replica.iteration, replica.epoch)

    @staticmethod
    def _restore_replica(replica, snap) -> None:
        p, s, o, rng, it, ep = snap
        _install_params(replica, p)   # the snapshot stays intact for the
        replica.state = _owned(s)     # next attempt
        replica.opt_state = _owned(o)
        replica._rng = rng.clone()
        replica.iteration = it
        replica.epoch = ep

    def _run_chunk(self, replica, chunk, w: int, rnd: int) -> None:
        """Fit one worker's round chunk, consulting the fault injector at
        batch boundaries.  fit_batch syncs the loss per step, so wall time
        recorded around this is honest compute+dispatch."""
        from ..faulttolerance.faults import InjectedWorkerFault

        inj = self.fault_injector
        for i, batch in enumerate(chunk):
            if inj is not None:
                inj.on_batch(w, rnd, i)
            replica.fit_batch(batch)
        if inj is not None and inj.should_drop(w, rnd):
            raise InjectedWorkerFault(w, rnd, "dropped result")

    def _count(self, name: str, doc: str) -> None:
        reg = default_registry()
        if reg.enabled:
            reg.counter(name, doc, ("mode",)).labels("threads").inc()

    def _retry_worker(self, replica, w, chunk, snap, rnd, tracer) -> bool:
        """Per-worker retry with exponential backoff + jitter, restoring
        the round-start snapshot before each attempt.  True on success."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.retry_policy.max_retries + 1):
            self.retry_counts[w] = self.retry_counts.get(w, 0) + 1
            self._count("training_worker_retries_total",
                        "Worker round retries in the training masters")
            self.retry_policy.sleep(attempt, worker=w)
            self._restore_replica(replica, snap)
            try:
                with tracer.span("master.worker_retry", worker=w,
                                 round=rnd, attempt=attempt):
                    self._run_chunk(replica, chunk, w, rnd)
                return True
            except Exception as e:
                last = e
        if last is not None:
            log.warning("worker %d exhausted %d retries at round %d: %s",
                        w, self.retry_policy.max_retries, rnd, last)
        return False

    def _run_round(self, replicas, work, rnd, tracer, ctx):
        """Run one round's chunks on worker threads.  Returns
        ``{w: None | Exception | "straggler"}``; straggler threads are
        left running (their replicas are excluded from now on) and joined
        at the end of fit."""
        outcome: Dict[int, Any] = {}

        def runner(w, chunk):
            t_w = monotonic_s()
            try:
                with tracer.attach(ctx), \
                        tracer.span("master.worker_fit", worker=w,
                                    round=rnd):
                    self._run_chunk(replicas[w], chunk, w, rnd)
            except Exception as e:    # surfaced via the retry path
                outcome[w] = e
            else:
                outcome[w] = None
            finally:
                self.stats.record("fit", monotonic_s() - t_w, worker=w)

        threads = {w: threading.Thread(target=runner, args=(w, chunk))
                   for w, chunk in work.items()}
        for t in threads.values():
            t.start()
        deadline = None if self.straggler_timeout_s is None else \
            monotonic_s() + self.straggler_timeout_s
        for w, t in threads.items():
            t.join(None if deadline is None
                   else max(deadline - monotonic_s(), 0.0))
            if t.is_alive():
                outcome[w] = "straggler"
                self._lingering.append(t)
        return outcome

    def _fit_traced(self, model, iterator, tracer) -> None:
        t0 = monotonic_s()
        with tracer.span("master.split"):
            parts = _chunk_batches(iterator, self.num_workers)
        self.stats.record("split", monotonic_s() - t0)
        t0 = monotonic_s()
        with tracer.span("master.broadcast"):
            replicas = self._get_replicas(model)
        self.stats.record("broadcast", monotonic_s() - t0)
        queues = [deque(p) for p in parts]
        alive = list(range(self.num_workers))
        self.lost_workers = set()
        self.retry_counts = {}
        self._lingering: List[threading.Thread] = []
        freq = self.averaging_frequency
        ctx = tracer.current_context()   # propagated into worker threads
        try:
            self._fit_rounds(replicas, queues, alive, freq, tracer, ctx)
        finally:
            # join lingering straggler threads on EVERY exit path: a
            # zombie thread must never keep mutating a replica — least of
            # all replicas[0], which IS the caller's model — after fit()
            # returns or raises
            for t in self._lingering:
                t.join()
        # model IS replicas[0]; with worker 0 lost, install the surviving
        # state so fit() still ends with the trained params on the model
        if 0 in self.lost_workers and alive:
            src = replicas[min(alive)]
            _install_params(model, _params_of(src))
            model.state = _owned(src.state)
            model.opt_state = _owned(src.opt_state)
            model.iteration = src.iteration
            model.epoch = src.epoch

    def _fit_rounds(self, replicas, queues, alive, freq, tracer,
                    ctx) -> None:
        """Round loop: chunk → run → retry/lose/re-chunk → aggregate,
        until every surviving queue drains.  ``alive`` is mutated in
        place so the caller sees the surviving set."""
        rnd = 0
        while True:
            work = {}
            for w in alive:
                chunk = [queues[w].popleft()
                         for _ in range(min(freq, len(queues[w])))]
                if chunk:
                    work[w] = chunk
            if not work:
                break
            snapshots = {w: self._snapshot_replica(replicas[w])
                         for w in work}
            outcome = self._run_round(replicas, work, rnd, tracer, ctx)
            ran = {w for w, res in outcome.items() if res is None}
            lost_now = []
            for w, res in outcome.items():
                if res is None:
                    continue
                if res == "straggler":
                    # its thread still runs — the replica can't be reused
                    # for a retry; treat as lost for the rest of the fit
                    log.warning("worker %d exceeded straggler timeout "
                                "%.3fs at round %d", w,
                                self.straggler_timeout_s, rnd)
                    lost_now.append(w)
                elif self._retry_worker(replicas[w], w, work[w],
                                        snapshots[w], rnd, tracer):
                    ran.add(w)
                else:
                    lost_now.append(w)
            for w in lost_now:
                if not self.elastic:
                    res = outcome[w]
                    raise res if isinstance(res, Exception) else \
                        RuntimeError(f"worker {w} lost at round {rnd} "
                                     "(straggler)")
                self.lost_workers.add(w)
                self._count("training_worker_lost_total",
                            "Workers permanently lost (retries/straggler "
                            "budget exhausted)")
                rec = get_flight_recorder()
                if rec is not None:
                    # the loss record carries the degradation context a
                    # post-mortem needs: which round, who survives
                    rec.record("cluster", "worker_lost", worker=w,
                               round=rnd, survivors=len(alive) - 1,
                               straggler=outcome[w] == "straggler")
                    rec.maybe_dump("worker_lost")
                alive.remove(w)
                if not alive:
                    res = outcome[w]
                    raise RuntimeError(
                        f"all {self.num_workers} workers lost by round "
                        f"{rnd}") from (res if isinstance(res, Exception)
                                        else None)
                # elastic degradation: the lost worker's ROUND chunk runs
                # on survivors now (the round's data is covered before its
                # average), and the rest of its shard rides their queues.
                # Each replayed batch gets the same snapshot+retry
                # protection as a normal round — a transient survivor
                # hiccup here must not abort the fit the recovery
                # machinery just saved
                with tracer.span("master.rechunk", round=rnd, worker=w,
                                 survivors=len(alive)):
                    survivors = sorted(alive)
                    for i, batch in enumerate(work[w]):
                        tw = survivors[i % len(survivors)]
                        snap = self._snapshot_replica(replicas[tw])
                        try:
                            self._run_chunk(replicas[tw], [batch], tw, -1)
                        except Exception as e:
                            if not self._retry_worker(replicas[tw], tw,
                                                      [batch], snap, -1,
                                                      tracer):
                                raise RuntimeError(
                                    f"survivor {tw} failed while "
                                    f"re-chunking lost worker {w}'s "
                                    f"round {rnd}") from e
                        ran.add(tw)
                    for i, batch in enumerate(queues[w]):
                        queues[survivors[i % len(survivors)]].append(batch)
                    queues[w].clear()
            participants = sorted(ran & set(alive))
            if len(participants) > 1:
                t_agg = monotonic_s()
                with tracer.span("master.aggregation", round=rnd,
                                 participants=len(participants)):
                    avg = tree_average(
                        [_params_of(replicas[w]) for w in participants],
                        self.aggregation_depth)
                    if self.average_updaters:
                        # integer leaves (step counts) round back to ints
                        opt_avg = _tree_map(
                            _cast_like,
                            tree_average(
                                [replicas[w].opt_state
                                 for w in participants],
                                self.aggregation_depth),
                            replicas[participants[0]].opt_state)
                    # broadcast to SURVIVORS only: a lost straggler's
                    # thread may still be writing its replica
                    for w in alive:
                        _install_params(replicas[w], avg)
                        if self.average_updaters:
                            replicas[w].opt_state = _owned(opt_avg)
                    # the recorded time measures the reduction, not its
                    # enqueue
                    _sync(replicas[participants[0]])
                self.stats.record("aggregation", monotonic_s() - t_agg)
            rnd += 1


class SharedGradientsTrainingMaster(TrainingMaster):
    """Asynchronous decentralized update sharing (reference
    ``SharedTrainingMaster`` + ``SharedTrainingWrapper.run :127``): each
    worker publishes its threshold-encoded local param-update after every
    step and applies whatever peer updates have arrived — no barrier, no
    master copy; residuals carry the unsent mass."""

    def __init__(self, num_workers: int, threshold: float = 1e-3,
                 handler_factory: Optional[Callable[[], EncodingHandler]] = None,
                 tracer=None):
        self.num_workers = num_workers
        factory = handler_factory or (
            lambda: EncodingHandler(initial_threshold=threshold))
        self.accumulator = EncodedGradientsAccumulator(num_workers, factory)
        self.tracer = tracer

    def fit(self, model, iterator) -> None:
        tracer = self.tracer if self.tracer is not None else get_tracer()
        parts = _chunk_batches(iterator, self.num_workers)
        replicas = self._get_replicas(model)
        acc = self.accumulator
        errors: List[Exception] = []
        ctx = tracer.current_context()

        def work(w):
            try:
                replica = replicas[w]
                with tracer.attach(ctx), \
                        tracer.span("master.worker_fit", worker=w,
                                    mode="shared"):
                    self._work_shared(replica, parts[w], acc, w)
            except Exception as e:  # surface worker crashes to the caller
                errors.append(e)

        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        # final convergence pass: drain late messages into worker 0 (= model)
        flat, unravel = _flatten_params(model)
        _install_params(model, unravel(acc.apply_updates(0, flat)))

    @staticmethod
    def _work_shared(replica, batches, acc, w) -> None:
        for batch in batches:
            flat_before, unravel = _flatten_params(replica)
            flat_before = flat_before.clone()
            replica.fit_batch(batch)
            flat_after, _ = _flatten_params(replica)
            acc.store_update(w, flat_after - flat_before)
            merged = acc.apply_updates(w, flat_after)
            _install_params(replica, unravel(merged))
