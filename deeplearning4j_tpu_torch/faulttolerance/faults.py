"""Deterministic fault injection + retry policy (port of
``faulttolerance/faults.py``; pure host code).

The reference recovers lost Spark partitions by lineage re-execution;
our thread-based masters (``parallel/master.py``) need the same property
— and a way to PROVE it.  :class:`FaultInjector` is a seeded, fully
deterministic test harness the masters consult at batch boundaries:

- ``fail(worker, rnd, times)``   raise before the round's first batch on
  the next ``times`` attempts (``times=-1``: permanently);
- ``delay(worker, rnd, seconds)`` sleep before the round's first batch
  (straggler simulation, drives the master's straggler timeout);
- ``drop(worker, rnd, times)``   complete the round's work but discard
  the result (the master treats a dropped result as a failed attempt and
  retries from the round-start snapshot).

Optionally ``fail_rate`` injects seeded random failures for soak-style
tests; everything is reproducible from the seed.

:class:`RetryPolicy` owns the per-worker retry budget and seeded
exponential backoff with jitter (decorrelated sleeps so N workers
retrying the same dead dependency don't stampede in lockstep).  Each
worker draws from its OWN ``default_rng((seed, worker))`` stream: numpy
Generators are not thread-safe, so N workers sharing one generator under
concurrency would race its state — and the race would also make the
"deterministic from the seed" property a lie (draw order would depend on
thread scheduling).  Per-worker streams are both safe and
schedule-independent.

:class:`ChaosSchedule` promotes the injector to PROCESS level: a seeded
plan that can SIGKILL a worker process mid-round, partition/delay a
broker link for a window (via :class:`ChaosBroker`), and hard-crash a
process mid-checkpoint-commit (via the ``CheckpointManager.chaos``
hook) — all deterministic from the seed, driving the soak tests that
prove training completes with the correct final params after every
injected fault.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.clock import monotonic_s

__all__ = ["FaultInjector", "InjectedWorkerFault", "RetryPolicy",
           "ChaosSchedule", "ChaosBroker"]


def _record_fault(type: str, **fields) -> None:
    """Mirror an injected fault into the flight recorder's ``cluster``
    channel — a chaos soak's dump shows the faults interleaved with the
    heartbeats and evictions they caused."""
    from ..observability.recorder import get_flight_recorder
    rec = get_flight_recorder()
    if rec is not None:
        rec.record("cluster", type, **fields)


class InjectedWorkerFault(RuntimeError):
    """Raised by FaultInjector in a worker's execution path."""

    def __init__(self, worker: int, rnd: int, kind: str):
        self.worker, self.rnd, self.kind = worker, rnd, kind
        super().__init__(
            f"injected {kind}: worker {worker}, round {rnd}")


class FaultInjector:
    """Deterministic fault plans keyed by (worker, round); thread-safe by
    construction (each plan entry is consumed by exactly one worker)."""

    def __init__(self, seed: int = 0, fail_rate: float = 0.0):
        self.seed = seed
        self.fail_rate = float(fail_rate)
        self._rng = np.random.default_rng(seed)
        self._fail: Dict[Tuple[int, int], int] = {}
        self._delay: Dict[Tuple[int, int], float] = {}
        self._drop: Dict[Tuple[int, int], int] = {}
        self.events: List[Tuple[str, int, int]] = []   # (kind, worker, rnd)
        # recovery-time observability (bench.py recovery_time_ms): per
        # faulted worker, the first fault-free on_batch afterwards marks
        # the first post-recovery step — either the worker's own retry
        # attempt, or (elastic degradation, rnd == -1) a survivor
        # replaying the lost worker's chunk
        self.last_fault_s: Dict[int, float] = {}
        self.recoveries_s: List[float] = []

    # ------------------------------------------------------------- plans
    def fail(self, worker: int, rnd: int, times: int = 1) -> "FaultInjector":
        """Worker ``worker`` raises at the start of round ``rnd`` for the
        next ``times`` attempts (-1 = every attempt: a permanent loss)."""
        self._fail[(worker, rnd)] = times
        return self

    def delay(self, worker: int, rnd: int, seconds: float) -> "FaultInjector":
        """Worker ``worker`` sleeps ``seconds`` before round ``rnd``'s
        first batch (every attempt) — straggler simulation."""
        self._delay[(worker, rnd)] = float(seconds)
        return self

    def drop(self, worker: int, rnd: int, times: int = 1) -> "FaultInjector":
        """Worker ``worker`` completes round ``rnd`` but its result is
        discarded for the next ``times`` attempts."""
        self._drop[(worker, rnd)] = times
        return self

    # ------------------------------------------------------------- hooks
    def on_batch(self, worker: int, rnd: int, batch_index: int) -> None:
        """Master-side hook before each batch of a worker's round chunk.
        First-batch position carries the planned fault/delay."""
        if batch_index != 0:
            self._mark_recovered(worker, rnd)
            return
        key = (worker, rnd)
        delay = self._delay.get(key)
        if delay:
            self.events.append(("delay", worker, rnd))
            _record_fault("injected_delay", worker=worker, round=rnd,
                          seconds=delay)
            time.sleep(delay)
        n = self._fail.get(key, 0)
        if n != 0:
            if n > 0:
                self._fail[key] = n - 1
            self.events.append(("fail", worker, rnd))
            _record_fault("injected_fail", worker=worker, round=rnd)
            self.last_fault_s[worker] = monotonic_s()
            raise InjectedWorkerFault(worker, rnd, "failure")
        if self.fail_rate and self._rng.random() < self.fail_rate:
            self.events.append(("fail", worker, rnd))
            _record_fault("injected_fail", worker=worker, round=rnd)
            self.last_fault_s[worker] = monotonic_s()
            raise InjectedWorkerFault(worker, rnd, "random failure")
        self._mark_recovered(worker, rnd)

    def _mark_recovered(self, worker: int, rnd: int) -> None:
        """A fault-free batch hook after an injected failure = the first
        post-recovery step; the gap is what bench.py's recovery_time_ms
        reports.  The faulted worker's own clean attempt resolves its
        fault (sync retry path); a replay batch (``rnd == -1``) run by a
        survivor resolves the oldest pending fault (elastic path — the
        lost worker never runs again)."""
        t = self.last_fault_s.pop(worker, None)
        if t is None and rnd == -1 and self.last_fault_s:
            oldest = min(self.last_fault_s, key=self.last_fault_s.get)
            t = self.last_fault_s.pop(oldest)
        if t is not None:
            self.recoveries_s.append(monotonic_s() - t)

    def should_drop(self, worker: int, rnd: int) -> bool:
        """Master-side hook after a worker finishes its round chunk."""
        key = (worker, rnd)
        n = self._drop.get(key, 0)
        if n == 0:
            return False
        if n > 0:
            self._drop[key] = n - 1
        self.events.append(("drop", worker, rnd))
        return True


class RetryPolicy:
    """Per-worker retry budget + seeded exponential backoff with jitter.

    Delay for attempt ``k`` (1-based) is ``base * 2**(k-1) * u`` with
    ``u ~ Uniform(0.5, 1.5)`` drawn from the calling worker's OWN seeded
    stream (``default_rng((seed, worker))``) — bounded, decorrelated
    across workers/attempts, and safe under concurrency: numpy Generators
    are not thread-safe, so a single shared stream raced by N worker
    threads would corrupt generator state AND make the draw order (hence
    the delays) depend on thread scheduling.  Per-worker streams keep
    every worker's backoff sequence deterministic regardless of how the
    threads interleave.
    """

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.05,
                 max_backoff_s: float = 5.0, seed: int = 0):
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.seed = int(seed)
        self._rngs: Dict[int, np.random.Generator] = {}
        self._rng_lock = threading.Lock()

    def _stream(self, worker: int) -> np.random.Generator:
        # the dict mutation is the only shared-state write; the generator
        # itself is only ever advanced by its own worker afterwards
        with self._rng_lock:
            rng = self._rngs.get(worker)
            if rng is None:
                rng = self._rngs[worker] = np.random.default_rng(
                    (self.seed, int(worker)))
            return rng

    def backoff(self, attempt: int, worker: int = 0) -> float:
        """Jittered delay (seconds) before retry ``attempt`` (1-based) of
        ``worker``'s task."""
        base = self.backoff_s * (2.0 ** max(attempt - 1, 0))
        return float(min(base * self._stream(worker).uniform(0.5, 1.5),
                         self.max_backoff_s))

    def sleep(self, attempt: int, worker: int = 0, sleep=time.sleep) -> float:
        d = self.backoff(attempt, worker)
        if d > 0:
            sleep(d)
        return d


# ------------------------------------------------------------------- chaos
class ChaosSchedule:
    """Seeded, process-level chaos plan — the cluster runtime's proof rig.

    Where :class:`FaultInjector` raises exceptions inside a cooperative
    worker, ``ChaosSchedule`` attacks the PROCESS boundary, which is what
    a real cluster loses:

    - ``kill_process(worker, after_s)`` — SIGKILL the worker's OS process
      ``after_s`` seconds into the run (no cleanup, no goodbye: the lease
      simply stops renewing);
    - ``partition(start_s, duration_s, topic=, mode=, delay_s=)`` — a
      broker-link fault window applied by :class:`ChaosBroker`:
      ``mode="delay"`` holds each publish for ``delay_s``, ``mode="drop"``
      discards it (at-most-once transports must tolerate this);
    - ``crash_in_commit(step, stage)`` — hard ``os._exit`` between a
      checkpoint's staged file writes (attach the schedule to
      ``CheckpointManager.chaos``): the commit rename never runs, so
      recovery must skip the ``.tmp-`` orphan and restore the previous
      complete checkpoint.

    Explicit plans are trivially deterministic; ``randomized`` draws
    kill targets/times from ``default_rng(seed)`` so soak tests replay
    bit-identically from the seed.  Executed events land in ``events``
    for assertions.
    """

    CRASH_EXIT_CODE = 23    # distinguishable from SIGKILL and from rc 0

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._kills: List[Tuple[int, float]] = []       # (worker, after_s)
        self._partitions: List[Dict] = []
        self._commit_crashes: Dict[int, int] = {}       # step -> stage
        self.events: List[Tuple] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monkey: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # ------------------------------------------------------------- plans
    def kill_process(self, worker: int, after_s: float) -> "ChaosSchedule":
        """SIGKILL ``worker``'s process ``after_s`` seconds after
        :meth:`start` (the mid-round host loss)."""
        self._kills.append((int(worker), float(after_s)))
        return self

    def partition(self, start_s: float, duration_s: float, *,
                  topic: Optional[str] = None, mode: str = "delay",
                  delay_s: float = 0.2) -> "ChaosSchedule":
        """Degrade a broker link for ``[start_s, start_s + duration_s)``:
        ``topic=None`` hits every topic; ``mode`` is ``delay`` or
        ``drop``."""
        if mode not in ("delay", "drop"):
            raise ValueError(f"partition mode must be delay|drop, got "
                             f"{mode!r}")
        self._partitions.append({"start": float(start_s),
                                 "end": float(start_s) + float(duration_s),
                                 "topic": topic, "mode": mode,
                                 "delay_s": float(delay_s)})
        return self

    def crash_in_commit(self, step: int, stage: int = 1) -> "ChaosSchedule":
        """Hard-exit the process between checkpoint staging writes of the
        checkpoint at ``step``.  Dense/single-writer sharded saves fire
        stage 1 (after model.zip / container) and 2 (after rng.npy /
        shard blocks).  A multi-writer BARRIER save fires 1 (primary:
        container+topology staged), 2 (any writer: shard bytes staged,
        completion marker NOT yet posted — "killed mid-block"), 3
        (primary: every marker landed, nothing committed — "killed
        between barrier and commit") and 4 (primary: manifest written,
        rename not yet run)."""
        self._commit_crashes[int(step)] = int(stage)
        return self

    @classmethod
    def randomized(cls, seed: int, workers: Sequence[int],
                   horizon_s: float, kills: int = 1) -> "ChaosSchedule":
        """A seeded random plan: ``kills`` SIGKILLs spread uniformly over
        ``horizon_s`` across ``workers`` — same seed, same plan."""
        sched = cls(seed)
        workers = list(workers)
        for _ in range(int(kills)):
            wid = int(workers[int(sched._rng.integers(len(workers)))])
            sched.kill_process(wid, float(sched._rng.uniform(0, horizon_s)))
        return sched

    # --------------------------------------------------------- execution
    def arm(self) -> "ChaosSchedule":
        """Zero the schedule clock (partition windows are relative to
        this).  ``start`` arms implicitly."""
        if self._t0 is None:
            self._t0 = monotonic_s()
        return self

    def elapsed(self) -> float:
        self.arm()
        return monotonic_s() - self._t0

    def start(self, pids: Callable[[], Dict[int, int]]) -> "ChaosSchedule":
        """Launch the chaos monkey thread.  ``pids()`` maps worker id ->
        live OS pid (called at fire time, so respawned incarnations are
        targeted correctly)."""
        self.arm()
        if self._monkey is not None or not self._kills:
            return self
        self._stop.clear()
        self._monkey = threading.Thread(
            target=self._run_kills, args=(pids,), daemon=True,
            name="dl4j-chaos-monkey")
        self._monkey.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monkey is not None:
            self._monkey.join(timeout=5.0)
            self._monkey = None

    def _run_kills(self, pids: Callable[[], Dict[int, int]]) -> None:
        for worker, after_s in sorted(self._kills, key=lambda k: k[1]):
            wait = after_s - self.elapsed()
            if wait > 0 and self._stop.wait(wait):
                return
            pid = pids().get(worker)
            if pid is None:
                with self._lock:
                    self.events.append(("kill_miss", worker, after_s))
                continue
            try:
                os.kill(pid, signal.SIGKILL)
                with self._lock:
                    self.events.append(("kill", worker, pid, after_s))
                # the killing side is the one that survives to dump: the
                # chaos fault lands on the cluster channel alongside the
                # victim's final heartbeats
                _record_fault("chaos_kill", worker=worker, pid=pid,
                              after_s=after_s)
                from ..observability.recorder import get_flight_recorder
                rec = get_flight_recorder()
                if rec is not None:
                    rec.maybe_dump("chaos_fault")
            except (OSError, ProcessLookupError):
                with self._lock:
                    self.events.append(("kill_miss", worker, after_s))

    # ------------------------------------------------------------- hooks
    def on_commit_stage(self, step: int, stage: int) -> None:
        """CheckpointManager hook: called between staged file writes; a
        matching plan entry hard-exits the process mid-commit."""
        if self._commit_crashes.get(int(step)) == int(stage):
            # the event can't be observed from this process again — leave
            # a breadcrumb on disk semantics instead: the .tmp- orphan IS
            # the evidence the recovery path must cope with
            os._exit(self.CRASH_EXIT_CODE)

    def link_state(self, topic: str) -> Tuple[str, float]:
        """Current fault on ``topic``'s link: ``("ok"|"delay"|"drop",
        delay_seconds)``."""
        now = self.elapsed()
        for p in self._partitions:
            if p["start"] <= now < p["end"] and \
                    (p["topic"] is None or p["topic"] == topic):
                return p["mode"], p["delay_s"]
        return "ok", 0.0


class ChaosBroker:
    """Broker proxy that applies a :class:`ChaosSchedule`'s partition
    windows to the publish path (subscriptions pass through: a partition
    models the LINK, and the transports here deliver at publish time).
    Drop-in for any publish/subscribe broker."""

    def __init__(self, inner, schedule: ChaosSchedule):
        self.inner = inner
        self.schedule = schedule

    def publish(self, topic: str, payload: bytes) -> None:
        mode, delay_s = self.schedule.link_state(topic)
        if mode == "drop":
            with self.schedule._lock:
                self.schedule.events.append(("drop_publish", topic))
            return
        if mode == "delay":
            with self.schedule._lock:
                self.schedule.events.append(("delay_publish", topic))
            time.sleep(delay_s)
        self.inner.publish(topic, payload)

    def subscribe(self, topic: str, ack: bool = False):
        return self.inner.subscribe(topic, ack=ack)

    def unsubscribe(self, topic: str, sub) -> None:
        if hasattr(self.inner, "unsubscribe"):
            self.inner.unsubscribe(topic, sub)

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()
