"""Lease-based elastic cluster membership over the shared checkpoint store
(port of ``faulttolerance/cluster.py``; pure host code, the same lease and
view files, so members of both packages read each other's).

The reference delegates cluster membership to Spark (executors register
with the driver; a lost executor's partitions are re-executed from
lineage).  Neither array runtime has lineage, so membership here is decoupled from the
data plane and recovery is checkpoint-mediated (TensorFlow's coordinated
checkpoint-restart posture, PAPERS.md 1605.08695): the *control plane* in
this module only decides WHO is in the cluster and WHICH round epoch a
write belongs to; restoring state after a change is the job of
``CheckpointManager`` + ``ElasticTrainer`` (a checkpoint written at world
size N seeds a rejoin at world size M — the portable-collectives
resharding argument, PAPERS.md 2112.01075).

Three pieces:

- :class:`FileLeaseStore` — leases + the membership view as atomic JSON
  files in a shared directory (the checkpoint store's filesystem: the one
  piece of infrastructure every worker already mounts).  Wall-clock
  deadlines, not intervals: leases must be comparable across processes.
- :class:`ClusterMember` — a worker's heartbeat: renews its lease on a
  background thread every ``ttl/3`` seconds; exposes the current
  membership view (generation, members) for generation-tagged writes.
- :class:`ClusterCoordinator` — evicts expired leases, admits joiners at
  ROUND boundaries only (mid-round membership never changes — the round
  in flight completes against the old view), bumps the rendezvous
  *generation* on every membership change and persists the view
  atomically.  ``accept(generation)`` is the write fence: a stale worker
  — one that missed an eviction/admission — can never push a frame into
  a newer round, because its tagged generation no longer matches.

Metrics: ``cluster_members`` / ``cluster_generation`` /
``cluster_heartbeat_age_seconds{worker}`` gauges,
``cluster_evictions_total{reason}`` / ``cluster_rejoins_total`` counters.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .atomic import atomic_write_json
from ..observability.registry import default_registry

__all__ = ["FileLeaseStore", "ClusterMember", "ClusterCoordinator",
           "ClusterView", "LeaseView", "shard_owner", "live_ranks"]

_LEASE_DIR = "membership"
_VIEW_FILE = "view.json"


def shard_owner(index: int, world_size: int) -> int:
    """Deterministic data-shard ownership: global batch ``index`` belongs
    to rank ``index % world_size``.  Depends only on (index, world_size),
    so any two workers that agree on the view agree on the split, and a
    rejoin at a different world size re-chunks without negotiation."""
    if world_size <= 0:
        raise ValueError(f"world_size must be positive, got {world_size}")
    return index % world_size


class LeaseView:
    """Read-only liveness over a :class:`FileLeaseStore`: who holds an
    unexpired lease *right now*, with payloads.  Reusable by any tier
    that needs membership without the coordinator's rank/generation
    machinery — the serving fleet's replica health rides this (a
    replica whose heartbeat stops simply falls out of :meth:`live` when
    its lease deadline passes; no eviction protocol needed)."""

    def __init__(self, store: "FileLeaseStore"):
        self.store = store

    def live(self, now: Optional[float] = None) -> Dict[int, Dict]:
        """Unexpired leases keyed by worker id (payloads included)."""
        now = time.time() if now is None else now
        return {wid: lease
                for wid, lease in self.store.all_leases().items()
                if float(lease["expires_at"]) >= now}

    def live_ids(self, now: Optional[float] = None) -> set:
        return set(self.live(now))

    def is_live(self, worker_id: int,
                now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        lease = self.store.read(int(worker_id))
        return lease is not None and float(lease["expires_at"]) >= now


def live_ranks(store: "FileLeaseStore", view: "ClusterView",
               now: Optional[float] = None) -> set:
    """Dense view-ranks of members whose lease is currently unexpired —
    the ``ShardBarrier.live_fn`` any member can evaluate: it only READS
    leases (eviction verdicts stay the coordinator's), so a barrier
    primary on a non-coordinator host can still tell "that writer's
    marker is missing because the writer is dead" from "still writing"
    and abort the round instead of waiting out the full timeout."""
    out = set()
    for wid in LeaseView(store).live_ids(now):
        rank = view.rank_of(wid)
        if rank is not None:
            out.add(rank)
    return out


@dataclass(frozen=True)
class ClusterView:
    """One rendezvous epoch: who is in, and which generation fence tags
    their writes.  ``round_index`` records the round boundary the view
    was installed at (views only ever change between rounds)."""

    generation: int
    members: Tuple[int, ...]
    round_index: int = 0

    @property
    def world_size(self) -> int:
        return len(self.members)

    def rank_of(self, worker_id: int) -> Optional[int]:
        """Dense rank by sorted worker id (the deterministic re-chunking
        key), or None for a non-member."""
        try:
            return self.members.index(worker_id)
        except ValueError:
            return None

    def to_dict(self) -> Dict:
        return {"generation": self.generation,
                "members": list(self.members),
                "round_index": self.round_index}

    @staticmethod
    def from_dict(d: Dict) -> "ClusterView":
        return ClusterView(generation=int(d["generation"]),
                           members=tuple(int(m) for m in d["members"]),
                           round_index=int(d.get("round_index", 0)))


class FileLeaseStore:
    """Leases and the membership view as atomic JSON files in a shared
    directory — the same filesystem the checkpoint store lives on, so no
    extra broker/etcd dependency.  Every write goes through
    ``faulttolerance.atomic`` (temp-then-rename): a reader never sees a
    torn lease, and a crashed writer leaves only an ignorable orphan."""

    def __init__(self, directory: str):
        self.directory = os.path.join(str(directory), _LEASE_DIR)
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------- leases
    def _lease_path(self, worker_id: int) -> str:
        return os.path.join(self.directory, f"lease-{int(worker_id):05d}.json")

    def renew(self, worker_id: int, ttl_s: float, *, incarnation: int = 0,
              payload: Optional[Dict] = None) -> Dict:
        """Write/refresh ``worker_id``'s lease: valid until wall-clock
        ``now + ttl_s`` (wall clock, not monotonic — the deadline must be
        comparable from other processes/hosts)."""
        now = time.time()
        lease = {"worker_id": int(worker_id),
                 "incarnation": int(incarnation),
                 "renewed_at": now,
                 "expires_at": now + float(ttl_s),
                 "payload": dict(payload or {})}
        atomic_write_json(self._lease_path(worker_id), lease)
        return lease

    def read(self, worker_id: int) -> Optional[Dict]:
        return self._read_file(self._lease_path(worker_id))

    @staticmethod
    def _read_file(path: str) -> Optional[Dict]:
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def all_leases(self) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith("lease-") and name.endswith(".json")):
                continue
            lease = self._read_file(os.path.join(self.directory, name))
            if lease is not None:
                out[int(lease["worker_id"])] = lease
        return out

    def revoke(self, worker_id: int) -> bool:
        try:
            os.unlink(self._lease_path(worker_id))
            return True
        except OSError:
            return False

    # --------------------------------------------------------------- view
    def read_view(self) -> Optional[ClusterView]:
        d = self._read_file(os.path.join(self.directory, _VIEW_FILE))
        return None if d is None else ClusterView.from_dict(d)

    def write_view(self, view: ClusterView) -> None:
        atomic_write_json(os.path.join(self.directory, _VIEW_FILE),
                          view.to_dict())


class ClusterMember:
    """One worker's membership endpoint: a lease renewed on a background
    heartbeat thread, plus read access to the coordinator's view so the
    worker can tag its writes with the current generation.

    The heartbeat interval defaults to ``ttl/3``: two missed beats still
    leave slack before the lease expires, so a briefly-descheduled worker
    isn't evicted by scheduling jitter alone."""

    def __init__(self, store: FileLeaseStore, worker_id: int, *,
                 lease_ttl_s: float = 10.0,
                 heartbeat_interval_s: Optional[float] = None,
                 incarnation: int = 0,
                 payload_fn: Optional[Callable[[], Dict]] = None):
        self.store = store
        self.worker_id = int(worker_id)
        self.lease_ttl_s = float(lease_ttl_s)
        self.heartbeat_interval_s = (float(heartbeat_interval_s)
                                     if heartbeat_interval_s is not None
                                     else self.lease_ttl_s / 3.0)
        self.incarnation = int(incarnation)
        self.payload_fn = payload_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.renew_count = 0

    # ------------------------------------------------------------ control
    def renew_once(self) -> Dict:
        payload = self.payload_fn() if self.payload_fn else None
        lease = self.store.renew(self.worker_id, self.lease_ttl_s,
                                 incarnation=self.incarnation,
                                 payload=payload)
        self.renew_count += 1
        return lease

    def start(self) -> "ClusterMember":
        if self._thread is not None:
            return self
        self.renew_once()            # joiners are visible before start returns
        self._stop.clear()
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name=f"dl4j-lease-{self.worker_id}")
        self._thread.start()
        return self

    def _beat(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                self.renew_once()
            except OSError:
                # a transient shared-FS hiccup: the next beat retries; a
                # persistent one expires the lease, which is the correct
                # outcome — the coordinator evicts an unreachable worker
                pass

    def stop(self, revoke: bool = True) -> None:
        """Stop heartbeating; ``revoke`` releases the lease immediately
        (a clean leave), otherwise it simply expires (a crash looks the
        same — that is the point of leases)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_interval_s + 1.0)
            self._thread = None
        if revoke:
            self.store.revoke(self.worker_id)

    def __enter__(self) -> "ClusterMember":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- view
    def view(self) -> Optional[ClusterView]:
        return self.store.read_view()

    def generation(self) -> int:
        v = self.view()
        return -1 if v is None else v.generation


class ClusterCoordinator:
    """Membership authority: sweeps expired leases, installs a new view —
    with a bumped rendezvous generation — at round boundaries only, and
    fences stale writes by generation.

    Round-boundary admission keeps the data plane simple: the round in
    flight always completes against the view it started with; a joiner
    (or an eviction) takes effect at the NEXT ``begin_round``.  A worker
    that missed the change keeps tagging frames with the old generation,
    and ``accept`` rejects them — it can never write into a newer round.
    """

    def __init__(self, store: FileLeaseStore, *, lease_ttl_s: float = 10.0,
                 registry=None):
        self.store = store
        self.lease_ttl_s = float(lease_ttl_s)
        self._registry = registry
        existing = store.read_view()
        self.view = existing if existing is not None else ClusterView(
            generation=0, members=())
        self.evicted_total = 0
        self.rejoined_total = 0
        reg = self._reg()
        if reg.enabled:
            # pre-register at zero: a scrape sees the full metric set the
            # moment a coordinator exists, not after the first incident
            reg.counter("cluster_evictions_total",
                        "Workers evicted from the membership view",
                        ("reason",)).labels("lease_expired").inc(0)
            reg.counter("cluster_rejoins_total",
                        "Workers (re)admitted into an existing cluster "
                        "at a round boundary").inc(0)

    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    # ------------------------------------------------------------ sweeps
    def sweep(self, now: Optional[float] = None
              ) -> Tuple[Dict[int, Dict], List[int]]:
        """Partition leases into (live, evicted); expired leases are
        revoked on the spot so a later joiner with the same id starts
        from a clean slate."""
        now = time.time() if now is None else now
        leases = self.store.all_leases()
        live: Dict[int, Dict] = {}
        evicted: List[int] = []
        for wid, lease in leases.items():
            if float(lease["expires_at"]) < now:
                # re-read before the verdict: the worker may have renewed
                # between the directory scan and now (read-then-revoke
                # TOCTOU) — deleting a fresh lease would evict a live
                # heartbeating worker.  The residual window (re-read to
                # unlink) is microseconds against a ttl/3 beat period.
                cur = self.store.read(wid)
                lease = cur if cur is not None else lease
            if float(lease["expires_at"]) >= now:
                live[wid] = lease
            else:
                evicted.append(wid)
                self.store.revoke(wid)
        if evicted:
            self.evicted_total += len(evicted)
            reg = self._reg()
            if reg.enabled:
                reg.counter("cluster_evictions_total",
                            "Workers evicted from the membership view",
                            ("reason",)).labels("lease_expired").inc(
                                len(evicted))
        self._observe(live, now)
        return live, evicted

    def _observe(self, live: Dict[int, Dict], now: float) -> None:
        reg = self._reg()
        if not reg.enabled:
            return
        reg.gauge("cluster_members",
                  "Live workers holding an unexpired lease"
                  ).set(len(live))
        reg.gauge("cluster_generation",
                  "Current rendezvous generation of the membership view"
                  ).set(self.view.generation)
        age = reg.gauge("cluster_heartbeat_age_seconds",
                        "Seconds since a worker last renewed its lease",
                        ("worker",))
        for wid, lease in live.items():
            age.labels(str(wid)).set(
                max(0.0, now - float(lease["renewed_at"])))

    # ---------------------------------------------------------- rendezvous
    def begin_round(self, round_index: int) -> ClusterView:
        """Round-boundary rendezvous: sweep leases, and if the live set
        differs from the current view install a new view with a bumped
        generation.  Returns the view the round must run under."""
        live, _ = self.sweep()
        members = tuple(sorted(live))
        if members != self.view.members:
            joiners = [m for m in members if m not in self.view.members]
            rejoins = sum(1 for m in joiners
                          if int(live[m].get("incarnation", 0)) > 0
                          or self.view.generation > 0)
            if rejoins:
                self.rejoined_total += rejoins
                reg = self._reg()
                if reg.enabled:
                    reg.counter("cluster_rejoins_total",
                                "Workers (re)admitted into an existing "
                                "cluster at a round boundary").inc(rejoins)
            self.view = ClusterView(generation=self.view.generation + 1,
                                    members=members,
                                    round_index=int(round_index))
            self.store.write_view(self.view)
        elif self.view.round_index != int(round_index):
            # same membership: only advance the recorded round (no
            # generation bump — nothing a stale worker could exploit)
            self.view = ClusterView(generation=self.view.generation,
                                    members=members,
                                    round_index=int(round_index))
            self.store.write_view(self.view)
        self._observe(live, time.time())
        return self.view

    def accept(self, generation: int) -> bool:
        """The write fence: a frame tagged with ``generation`` is valid
        only if it matches the installed view — a worker evicted (or
        superseded by its own replacement) keeps the old generation and
        its late writes are dropped, never merged into a newer round."""
        return int(generation) == self.view.generation

    def expect_members(self, want: Sequence[int], *, timeout_s: float,
                       poll_s: float = 0.05) -> Dict[int, Dict]:
        """Block until every worker in ``want`` holds a live lease (initial
        rendezvous), or raise ``TimeoutError`` listing the absentees."""
        deadline = time.time() + float(timeout_s)
        while True:
            live, _ = self.sweep()
            missing = [w for w in want if w not in live]
            if not missing:
                return live
            if time.time() > deadline:
                raise TimeoutError(
                    f"cluster rendezvous incomplete: workers {missing} "
                    f"never acquired a lease within {timeout_s:.1f}s")
            time.sleep(poll_s)
