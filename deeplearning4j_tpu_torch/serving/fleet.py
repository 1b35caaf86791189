"""Serving fleet: N engine replicas behind ONE admission front (port of
``serving/fleet.py``; host code over the port's engines).

One :class:`ServingEngine` or :class:`GenerationEngine` replica tops out
at a single dispatcher/decode loop.  The fleet tier
replicates the engine N times and keeps every hard problem — admission,
affinity, health, promotion — in ONE place, the :class:`FleetRouter`:

- **Stateless ``predict``** routes least-loaded: live queue depth (the
  engine's own ``queue_depth``) plus the router's in-flight count per
  replica.  A replica-side fault retries ONCE on a different replica
  before surfacing — transient single-replica failures are the fleet's
  to absorb.
- **Stateful ``generate``/``stream``** routes with *session affinity*:
  a decoding session is pinned to the replica holding its KV slot.  The
  router mirrors every token event it relays, so the mirror is exactly
  the client-visible stream; because sampling keys are
  ``(seed, token_index)``, mirror + sampling knobs are the COMPLETE
  decode state.  When a replica dies mid-stream the router re-prefills
  the session's full history onto a survivor
  (:meth:`GenerationEngine.import_session`) and the stream continues
  bit-identical to what a single replica would have produced.
- **Health** rides :class:`~..faulttolerance.cluster.LeaseView`
  membership (each replica heartbeats a lease via ``ClusterMember``)
  plus a consecutive-failure circuit (``PredictCircuitMixin``
  semantics): an expired lease or an open circuit ejects the replica,
  its sessions migrate, and a later :meth:`ServingFleet.rejoin` builds
  and warms a fresh engine on the current stable model.
- **Tenant quotas + priorities** (:mod:`.tenancy`) gate every request
  BEFORE it reaches any engine queue.
- **Canary/shadow promotion**: :meth:`ServingFleet.canary` installs a
  candidate model on a subset of replicas and routes a deterministic
  fraction of traffic there; :class:`CanaryController` watches per-arm
  p99 + error-rate windows and auto-promotes (fleet-wide ``hot_swap``)
  or auto-rolls-back.  Versions never move backwards on any replica:
  promotion and rollback are both forward ``hot_swap``\\ s.  Shadow mode
  mirrors requests to the candidate and discards its responses.

Observability: ``fleet_replicas{state}``,
``fleet_routed_total{route,replica}``, ``fleet_migrations_total{reason}``,
per-arm latency windows in the canary status, a ``fleet``
flight-recorder channel whose replica-ejection dump carries the recent
routing trail, and :meth:`ServingFleet.health` aggregating per-replica
readiness for the HTTP ``/health``.
"""
from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..faulttolerance.cluster import ClusterMember, FileLeaseStore, LeaseView
from ..observability import clock
from ..observability.events import emit_event
from ..observability.quantiles import LatencyWindow
from ..observability.recorder import get_flight_recorder
from ..observability.registry import default_registry
from ..parallel.inference import InvalidInputError
from ..utils.device import resolve_device
from ..utils.http import BackgroundHttpServer, JsonClient, JsonHandler
from .engine import ServingEngine, ShedError
from .tenancy import TenantAdmission

__all__ = ["FleetConfig", "CanaryConfig", "ServingFleet", "FleetRouter",
           "CanaryController", "FleetServer", "FleetClient"]

log = logging.getLogger("deeplearning4j_tpu_torch.serving.fleet")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-tier knobs (per-replica engine knobs ride ``engine_kw``)."""

    lease_ttl_s: float = 2.0            # replica heartbeat lease
    health_interval_s: float = 0.25     # health-loop poll period
    failure_threshold: int = 3          # consecutive faults -> eject
    session_poll_s: float = 0.05        # stream wrapper event poll
    retry_after_s: float = 1.0          # Retry-After when no replica


@dataclass(frozen=True)
class CanaryConfig:
    """Promotion guardrails: the candidate must serve ``min_samples``
    requests with an error rate under ``max_error_rate`` AND a p99 no
    worse than ``p99_ratio`` x the stable arm's before it promotes; a
    breach of either rolls it back immediately (no sample minimum — a
    failing canary should not get to keep failing)."""

    min_samples: int = 20
    max_error_rate: float = 0.1
    p99_ratio: float = 3.0
    window: int = 256


class _Replica:
    """One engine replica + its fleet-side state.  ``state`` moves
    ``live -> ejected|dead -> (rejoin) live``; routing only ever sees
    ``live`` replicas."""

    def __init__(self, rid: int, engine: ServingEngine,
                 member: Optional[ClusterMember] = None):
        self.id = int(rid)
        self.engine = engine
        self.member = member
        self.state = "live"
        self.arm = "stable"
        self.inflight = 0
        self.failures = 0           # consecutive dispatch failures
        self._lock = threading.Lock()

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1

    def end(self) -> None:
        with self._lock:
            self.inflight -= 1

    def note(self, ok: bool) -> None:
        """PredictCircuitMixin semantics: a success closes the circuit,
        a streak of failures opens it (the health loop ejects past the
        threshold)."""
        with self._lock:
            self.failures = 0 if ok else self.failures + 1

    def load(self) -> int:
        eng = self.engine
        depth = eng.queue_depth
        if eng.generation is not None:
            depth += eng.generation.queue_depth
        with self._lock:
            return depth + self.inflight

    def decode_room(self) -> int:
        """Free KV capacity — the placement signal for NEW sessions."""
        gen = self.engine.generation
        if gen is None or gen.ring is None:
            return 0
        return gen.ring.free_slots - gen.queue_depth

    def describe(self) -> dict:
        eng_ready, admission = self.engine.ready()
        return {"state": self.state, "arm": self.arm,
                "ready": self.state == "live" and eng_ready,
                "version": self.engine.model_version,
                "load": self.load(), "failures": self.failures,
                "queue_depth": admission["queue_depth"]}


class _Session:
    """Router-side record of one generation session: which replica owns
    the KV slot, the live request handle, and the mirror — the
    import-ready state built from exactly the events the client has
    consumed (so a migration never replays or drops a token)."""

    __slots__ = ("sid", "replica", "handle", "epoch", "mirror", "done",
                 "lock", "tenant", "priority", "catchup")

    def __init__(self, sid: str, replica: _Replica, handle,
                 mirror: dict, tenant, priority: str):
        self.sid = sid
        self.replica = replica
        self.handle = handle
        self.epoch = 0              # bumps on every migration
        self.mirror = mirror
        self.done = False
        self.lock = threading.Lock()
        self.tenant = tenant
        self.priority = priority
        # token events the dying replica produced but never relayed
        # (authoritative export ran ahead of the mirror): re-emitted to
        # the client before the survivor's stream resumes, so the relay
        # never drops an index
        self.catchup: List[dict] = []

    def snapshot(self):
        with self.lock:
            return self.handle, self.epoch, self.replica


class CanaryController:
    """Per-arm health watcher for a running canary: feeds ``stable`` /
    ``canary`` latency windows + error counters from the router and
    decides ``promote`` / ``rollback`` / ``None`` against the
    :class:`CanaryConfig` guardrails.  The decision is made here; the
    fleet applies it (hot swaps are the fleet's to own)."""

    def __init__(self, config: Optional[CanaryConfig] = None):
        self.config = config or CanaryConfig()
        self._lock = threading.Lock()
        self._lat = {"stable": LatencyWindow(self.config.window),
                     "canary": LatencyWindow(self.config.window)}
        self._requests = {"stable": 0, "canary": 0}
        self._errors = {"stable": 0, "canary": 0}
        self.decision: Optional[str] = None

    def note(self, arm: str, seconds: Optional[float] = None,
             error: bool = False) -> None:
        if arm not in self._lat:
            return
        with self._lock:
            self._requests[arm] += 1
            if error:
                self._errors[arm] += 1
        if seconds is not None:
            self._lat[arm].observe(seconds)

    def evaluate(self) -> Optional[str]:
        """One guardrail pass; sticky once decided."""
        with self._lock:
            if self.decision is not None:
                return self.decision
            n = self._requests["canary"]
            errs = self._errors["canary"]
        cfg = self.config
        if n and errs / n > cfg.max_error_rate and \
                errs >= max(2, int(cfg.min_samples * cfg.max_error_rate)):
            return self._decide("rollback")
        if n < cfg.min_samples:
            return None
        p99_c = self._lat["canary"].quantile(0.99)
        p99_s = self._lat["stable"].quantile(0.99)
        if p99_c is not None and p99_s is not None and p99_s > 0 \
                and p99_c > cfg.p99_ratio * p99_s:
            return self._decide("rollback")
        return self._decide("promote")

    def _decide(self, verdict: str) -> str:
        with self._lock:
            if self.decision is None:
                self.decision = verdict
            return self.decision

    def status(self) -> dict:
        with self._lock:
            req = dict(self._requests)
            errs = dict(self._errors)
            decision = self.decision
        out = {"decision": decision, "requests": req, "errors": errs}
        for arm, w in self._lat.items():
            p99 = w.quantile(0.99)
            out[f"{arm}_p99_ms"] = None if p99 is None \
                else round(p99 * 1e3, 3)
        return out


class FleetRouter:
    """The ONE admission front: tenant quotas + priorities, least-loaded
    predict routing, session-affinity generate routing with mirror-based
    failover, deterministic canary traffic split, shadow mirroring, and
    the routing trail the ejection forensics dump carries."""

    _TRAIL = 64                     # routing decisions kept for forensics

    def __init__(self, fleet: "ServingFleet",
                 tenants: Optional[TenantAdmission] = None,
                 registry=None):
        self.fleet = fleet
        self.tenancy = tenants if tenants is not None else TenantAdmission(
            registry=registry)
        self._registry = registry
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._exported: Dict[str, dict] = {}
        self._sid_counter = 0
        self._split_counter = 0
        self.trail: "deque[dict]" = deque(maxlen=self._TRAIL)

    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    # ------------------------------------------------------------- metrics
    def _count_routed(self, route: str, replica: _Replica) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.counter("fleet_routed_total",
                        "Requests routed by the fleet front",
                        ("route", "replica")).labels(
                            route, str(replica.id)).inc()
        self.trail.append({"t": round(clock.monotonic_s(), 4),
                           "route": route, "replica": replica.id,
                           "arm": replica.arm})

    def _observe(self, seconds: float, priority: str) -> None:
        reg = self._reg()
        if reg.enabled:
            from .engine import _LATENCY_BUCKETS
            reg.histogram("serving_request_seconds",
                          "Engine request latency, enqueue to result",
                          ("priority",),
                          buckets=_LATENCY_BUCKETS).labels(
                              priority).observe(seconds)

    # ------------------------------------------------------------- routing
    def _live(self, arm: Optional[str] = None) -> List[_Replica]:
        out = [r for r in self.fleet.replicas if r.state == "live"]
        if arm is not None:
            armed = [r for r in out if r.arm == arm]
            if armed:
                return armed
        return out

    def _pick_arm(self) -> str:
        """Deterministic canary split: request k goes to the canary arm
        iff ``floor(k*f) > floor((k-1)*f)`` — exactly fraction ``f`` of
        traffic, no RNG, reproducible in tests."""
        canary = self.fleet._canary
        if canary is None or canary["shadow"]:
            return "stable"
        f = canary["fraction"]
        with self._lock:
            self._split_counter += 1
            k = self._split_counter
        return "canary" if int(k * f) > int((k - 1) * f) else "stable"

    def _least_loaded(self, arm: Optional[str] = None,
                      exclude: int = -1,
                      key: Callable[[_Replica], Any] = None) -> _Replica:
        live = [r for r in self._live(arm) if r.id != exclude]
        if not live and arm is not None:
            # the arm's only replica was just excluded (a canary fault
            # mid-retry): fall back to any live replica rather than
            # shedding a request the stable arm can absorb
            live = [r for r in self._live(None) if r.id != exclude]
        if not live:
            raise ShedError("no live replicas in the fleet", status=503,
                            retry_after_s=self.fleet.config.retry_after_s)
        return min(live, key=key or (lambda r: (r.load(), r.id)))

    def predict(self, x, *, tenant: Optional[str] = None,
                priority: str = "interactive",
                timeout: Optional[float] = 60.0):
        """Stateless route: quota gate -> arm split -> least-loaded live
        replica -> dispatch; ONE retry on a different replica absorbs a
        single-replica fault."""
        self.tenancy.check(tenant, priority)
        arm = self._pick_arm()
        canary = self.fleet._canary
        last_err: Optional[Exception] = None
        exclude = -1
        for _ in range(2):
            replica = self._least_loaded(arm, exclude=exclude)
            t0 = clock.monotonic_s()
            replica.begin()
            try:
                out = replica.engine.predict(x, timeout=timeout)
            except (ShedError, InvalidInputError):
                replica.end()
                raise           # client-class refusals don't burn retries
            except Exception as e:
                replica.end()
                replica.note(False)
                if canary is not None:
                    self.fleet.canary_controller.note(replica.arm,
                                                      error=True)
                last_err = e
                exclude = replica.id
                continue
            replica.end()
            replica.note(True)
            dt = clock.monotonic_s() - t0
            self._observe(dt, priority)
            if canary is not None:
                self.fleet.canary_controller.note(replica.arm, seconds=dt)
                self.fleet._canary_tick()
            self._count_routed("predict", replica)
            self._maybe_shadow(x)
            return out
        raise last_err if last_err is not None else ShedError(
            "no live replicas in the fleet", status=503,
            retry_after_s=self.fleet.config.retry_after_s)

    def _maybe_shadow(self, x) -> None:
        """Shadow mode: mirror the request to a canary-arm replica on a
        daemon thread and DISCARD the response — the candidate sees real
        traffic, clients never see the candidate."""
        canary = self.fleet._canary
        if canary is None or not canary["shadow"]:
            return
        try:
            replica = self._least_loaded("canary")
        except ShedError:
            return
        if replica.arm != "canary":
            return
        ctl = self.fleet.canary_controller

        def mirror():
            t0 = clock.monotonic_s()
            try:
                replica.engine.predict(x, timeout=10.0)
            except Exception:
                ctl.note("canary", error=True)
            else:
                ctl.note("canary", seconds=clock.monotonic_s() - t0)
            self.fleet._canary_tick()

        threading.Thread(target=mirror, daemon=True,
                         name="dl4j-fleet-shadow").start()
        self._count_routed("shadow", replica)

    # ----------------------------------------------------------- generation
    def open_session(self, tokens, *, tenant: Optional[str] = None,
                     priority: str = "interactive", **kw) -> _Session:
        """Admit one generation session: quota gate, place on the live
        replica with the most free KV room (a session HOLDS a slot for
        its lifetime — free capacity, not instantaneous queue depth, is
        the right signal), pin it there, and mirror its identity."""
        self.tenancy.check(tenant, priority)
        replica = self._least_loaded(
            self._pick_arm(),
            key=lambda r: (-r.decode_room(), r.load(), r.id))
        gen = replica.engine.generation
        if gen is None:
            raise InvalidInputError("generation not enabled on the fleet")
        handle = gen.submit(tokens, **kw)
        with self._lock:
            self._sid_counter += 1
            sid = f"fs-{self._sid_counter}"
        mirror = handle.export_state()
        mirror["request_id"] = sid
        mirror["tokens"] = []       # mirror tracks CONSUMED tokens only
        mirror["versions"] = []
        sess = _Session(sid, replica, handle, mirror, tenant, priority)
        with self._lock:
            self._sessions[sid] = sess
        self._count_routed("generate", replica)
        return sess

    def events(self, sess: _Session,
               timeout: Optional[float] = 60.0):
        """Relay the session's token events, maintaining the mirror and
        failing over transparently: a dead/ejected owner triggers
        re-prefill onto a survivor and the relay resumes from the NEW
        handle — token indexes continue exactly where the mirror ends,
        so the client stream is seamless and bit-identical."""
        poll = self.fleet.config.session_poll_s
        deadline = None if timeout is None \
            else clock.monotonic_s() + timeout
        t0 = clock.monotonic_s()
        try:
            while True:
                handle, epoch, replica = sess.snapshot()
                with sess.lock:
                    catchup = sess.catchup
                    sess.catchup = []
                for ev in catchup:
                    yield ev
                try:
                    ev = handle.events.get(timeout=poll)
                except queue.Empty:  # the poll is the backoff
                    if sess.epoch != epoch:
                        continue    # migrated under us: re-snapshot
                    if replica.state != "live":
                        self.migrate_session(sess, reason=replica.state,
                                             expect_epoch=epoch)
                        continue
                    if deadline is not None and \
                            clock.monotonic_s() > deadline:
                        handle.cancelled.set()
                        raise TimeoutError(
                            f"session {sess.sid} timed out")
                    continue
                if sess.epoch != epoch:
                    continue        # stale pre-migration event: drop
                if "error" in ev:
                    if "cross-replica migration" in ev["error"] or \
                            replica.state != "live":
                        # the owner drained/died; its terminal marker is
                        # the router's cue, never the client's problem
                        self.migrate_session(sess, reason="replica_error",
                                             expect_epoch=epoch)
                        continue
                    if self.fleet._canary is not None:
                        self.fleet.canary_controller.note(replica.arm,
                                                          error=True)
                        self.fleet._canary_tick()
                    yield ev
                    return
                if "token" in ev:
                    sess.mirror["tokens"].append(int(ev["token"]))
                    sess.mirror["versions"].append(
                        int(ev["model_version"]))
                yield ev
                if ev.get("done"):
                    sess.done = True
                    dt = clock.monotonic_s() - t0
                    self._observe(dt, sess.priority)
                    if self.fleet._canary is not None:
                        self.fleet.canary_controller.note(replica.arm,
                                                          seconds=dt)
                        self.fleet._canary_tick()
                    return
        finally:
            with self._lock:
                self._sessions.pop(sess.sid, None)
            handle, _, _ = sess.snapshot()
            handle.cancelled.set()  # no-op after normal completion

    def migrate_session(self, sess: _Session, reason: str,
                        expect_epoch: Optional[int] = None) -> None:
        """Re-home one session onto a survivor.  The state used is the
        replica's own export when the eject path captured one
        (authoritative), else the router's mirror — which by
        construction equals the client-visible stream, so the survivor
        regenerates any produced-but-unrelayed tokens bit-identically
        ((seed, token_index) sampling keys).  ``expect_epoch`` makes the
        call idempotent under the health-loop/stream-wrapper race: a
        caller that observed a stale epoch finds the session already
        re-homed and does nothing."""
        with sess.lock:
            if sess.done:
                return
            if expect_epoch is not None and sess.epoch != expect_epoch:
                return              # someone already migrated it
            old = sess.replica
            state = self._exported.pop(sess.sid, None)
            if state is not None:
                # the export ran ahead of the relay: replay the gap to
                # the client before the survivor's stream resumes
                seen = len(sess.mirror["tokens"])
                toks = list(state.get("tokens", ()))
                vers = list(state.get("versions", ()))
                sess.catchup.extend(
                    {"token": int(toks[i]), "index": i,
                     "model_version": int(vers[i]) if i < len(vers)
                     else 0}
                    for i in range(seen, len(toks)))
                sess.mirror["tokens"] = [int(t) for t in toks]
                sess.mirror["versions"] = [int(v) for v in vers]
            else:
                state = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in sess.mirror.items()}
            survivor = self._least_loaded(
                exclude=old.id,
                key=lambda r: (-r.decode_room(), r.load(), r.id))
            gen = survivor.engine.generation
            new_handle = gen.import_session(state)
            sess.replica = survivor
            sess.handle = new_handle
            sess.epoch += 1
        reg = self._reg()
        if reg.enabled:
            reg.counter("fleet_migrations_total",
                        "Sessions re-homed onto a survivor replica",
                        ("reason",)).labels(reason).inc()
        self._count_routed("migrate", survivor)
        emit_event("fleet_session_migrated", session=sess.sid,
                   source=old.id, target=survivor.id, reason=reason,
                   tokens_kept=len(state.get("tokens", ())))
        log.info("session %s migrated %d -> %d (%s, %d tokens kept)",
                 sess.sid, old.id, survivor.id, reason,
                 len(state.get("tokens", ())))

    def sessions_on(self, replica: _Replica) -> List[_Session]:
        with self._lock:
            return [s for s in self._sessions.values()
                    if s.replica is replica and not s.done]

    def stash_exported(self, states: List[dict]) -> None:
        """Eject-path exports, keyed by session id, consumed (preferred
        over mirrors) by the next migration of each session."""
        with self._lock:
            for state in states:
                self._exported[str(state.get("request_id"))] = state


class ServingFleet:
    """N engine replicas + the router + the health loop + promotion.

    In-process replicas on ``device``: by default every replica serves
    the same model object (serving only reads its weights); pass
    ``model_factory`` for per-replica models.  For crash isolation run
    each replica behind its own :class:`~.engine.ServingServer` and front
    them with :class:`FleetServer` over HTTP.
    """

    def __init__(self, model=None, *, n_replicas: int = 2,
                 model_factory: Optional[Callable[[], Any]] = None,
                 generation=None, engine_kw: Optional[dict] = None,
                 tenants: Optional[TenantAdmission] = None,
                 lease_dir: Optional[str] = None,
                 config: Optional[FleetConfig] = None,
                 canary_config: Optional[CanaryConfig] = None,
                 registry=None, start_health: bool = True,
                 device="cuda"):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if model is None and model_factory is None:
            raise ValueError("need a model or a model_factory")
        self.device = resolve_device(device)
        self.config = config or FleetConfig()
        self.canary_config = canary_config or CanaryConfig()
        self._registry = registry
        self._generation = generation
        self._engine_kw = dict(engine_kw or {})
        self._model_factory = model_factory or (lambda: model)
        self._stable_model = None
        self._candidate_model = None
        self._canary: Optional[dict] = None
        self.canary_controller: Optional[CanaryController] = None
        self._lease_store = None if lease_dir is None \
            else FileLeaseStore(lease_dir)
        self._lease_view = None if self._lease_store is None \
            else LeaseView(self._lease_store)
        self.replicas: List[_Replica] = []
        self._fleet_lock = threading.Lock()
        for rid in range(n_replicas):
            self.replicas.append(self._build_replica(rid))
        self._stable_model = self.replicas[0].engine.slot.model
        self.router = FleetRouter(self, tenants=tenants, registry=registry)
        self._set_replica_gauge()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        if start_health:
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="dl4j-fleet-health")
            self._health_thread.start()

    # ------------------------------------------------------------ replicas
    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def _build_replica(self, rid: int,
                       model=None) -> _Replica:
        engine = ServingEngine(
            model if model is not None else self._model_factory(),
            device=self.device, generation=self._generation,
            registry=self._registry, **self._engine_kw)
        member = None
        if self._lease_store is not None:
            member = ClusterMember(
                self._lease_store, rid,
                lease_ttl_s=self.config.lease_ttl_s,
                payload_fn=lambda e=engine: {"ready": e.ready()[0]})
            member.start()
        return _Replica(rid, engine, member)

    def _set_replica_gauge(self) -> None:
        reg = self._reg()
        if not reg.enabled:
            return
        counts: Dict[str, int] = {}
        for r in self.replicas:
            counts[r.state] = counts.get(r.state, 0) + 1
        gauge = reg.gauge("fleet_replicas",
                          "Replicas per lifecycle state", ("state",))
        for state in ("live", "ejected", "dead", "stopped"):
            gauge.labels(state).set(counts.get(state, 0))

    def _record(self, type: str, **fields) -> None:
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("fleet", type, **fields)

    # -------------------------------------------------------------- health
    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            try:
                self.health_tick()
            except Exception:
                log.exception("fleet health tick failed")

    def health_tick(self) -> None:
        """One sweep: eject lease-expired and circuit-open replicas,
        then run the canary guardrails."""
        live_ids = None if self._lease_view is None \
            else self._lease_view.live_ids()
        for r in list(self.replicas):
            if r.state != "live":
                continue
            if live_ids is not None and r.id not in live_ids:
                self.eject(r.id, reason="lease_expired")
            elif r.failures >= self.config.failure_threshold:
                self.eject(r.id, reason="circuit_open")
        self._canary_tick()

    def eject(self, rid: int, reason: str = "manual") -> None:
        """Remove a replica from routing: drain its sessions (the
        engine's own export when it still answers, the router's mirrors
        when it doesn't), re-home every one onto survivors, and commit
        the forensics dump with the routing trail."""
        replica = self.replicas[rid]
        with self._fleet_lock:
            if replica.state not in ("live",):
                return
            replica.state = "dead" if reason in ("killed",) else "ejected"
        if replica.member is not None:
            replica.member.stop(revoke=True)
        exported: List[dict] = []
        if reason not in ("killed",):
            gen = replica.engine.generation
            if gen is not None:
                try:
                    states = gen.export_sessions()
                except Exception:
                    log.exception("replica %d export failed; falling "
                                  "back to router mirrors", rid)
                else:
                    by_sid = {s.sid: s
                              for s in self.router.sessions_on(replica)}
                    for state in states:
                        # engine request ids are replica-local; re-key
                        # by the fleet session the router knows
                        for sess in by_sid.values():
                            if state["seed"] == sess.mirror["seed"] and \
                                    state["prompt"] == \
                                    sess.mirror["prompt"]:
                                state = dict(state, request_id=sess.sid)
                                break
                        exported.append(state)
                    self.router.stash_exported(exported)
        sessions = self.router.sessions_on(replica)
        migrated = 0
        for sess in sessions:
            try:
                self.router.migrate_session(sess, reason=reason,
                                            expect_epoch=sess.epoch)
                migrated += 1
            except Exception:
                log.exception("session %s migration failed", sess.sid)
        self._set_replica_gauge()
        emit_event("fleet_replica_ejected", replica=rid, reason=reason,
                   migrated=migrated)
        self._record("replica_ejected", replica=rid, reason=reason,
                     migrated=migrated, exported=len(exported),
                     trail=list(self.router.trail))
        rec = get_flight_recorder()
        if rec is not None:
            rec.maybe_dump("replica_ejected")
        log.warning("replica %d ejected (%s): %d sessions migrated",
                    rid, reason, migrated)

    def kill(self, rid: int) -> None:
        """Simulated SIGKILL: the replica stops answering NOW — no
        export, no revoke (the lease just expires, as a real crash
        would).  Sessions migrate from router mirrors; the dead engine
        is torn down on a side thread so a wedged decode loop can't
        block the fleet."""
        replica = self.replicas[rid]
        if replica.member is not None:
            replica.member.stop(revoke=False)
        engine = replica.engine
        threading.Thread(target=engine.shutdown, daemon=True,
                         name=f"dl4j-fleet-reap-{rid}").start()
        self.eject(rid, reason="killed")

    def rejoin(self, rid: int) -> _Replica:
        """Bring an ejected/dead replica back: a fresh engine on the
        CURRENT stable model (never a stale checkpoint — versions only
        move forward), warmed before it takes traffic."""
        old = self.replicas[rid]
        if old.state == "live":
            return old
        replica = self._build_replica(rid, model=self._stable_model)
        replica.engine.warmup()
        with self._fleet_lock:
            self.replicas[rid] = replica
        self._set_replica_gauge()
        emit_event("fleet_replica_rejoined", replica=rid)
        self._record("replica_rejoined", replica=rid,
                     version=replica.engine.model_version)
        return replica

    # ------------------------------------------------------------- serving
    def predict(self, x, **kw):
        return self.router.predict(x, **kw)

    def generate(self, tokens, *, tenant: Optional[str] = None,
                 priority: str = "interactive",
                 timeout: Optional[float] = 60.0, **kw):
        """Blocking generate through the affinity/failover path — the
        result is assembled from the SAME relayed event stream the
        streaming route uses, so both see identical failover."""
        from ..generation.engine import GenerationResult
        sess = self.router.open_session(tokens, tenant=tenant,
                                        priority=priority, **kw)
        tokens_out: List[int] = []
        versions: List[int] = []
        finish = "length"
        for ev in self.router.events(sess, timeout=timeout):
            if "error" in ev:
                raise RuntimeError(ev["error"])
            if ev.get("done"):
                tokens_out = list(ev["tokens"])
                versions = list(ev["model_versions"])
                finish = ev["finish"]
        return GenerationResult(tokens=tokens_out, versions=versions,
                                finish=finish, request_id=sess.sid,
                                prompt_len=len(sess.mirror["prompt"]))

    def stream(self, tokens, *, tenant: Optional[str] = None,
               priority: str = "interactive",
               timeout: Optional[float] = 60.0, **kw):
        sess = self.router.open_session(tokens, tenant=tenant,
                                        priority=priority, **kw)
        return self.router.events(sess, timeout=timeout)

    # ----------------------------------------------------------- promotion
    def hot_swap(self, model, origin: str = "swap") -> Dict[int, int]:
        """Fleet-wide swap on every live replica; returns the new
        version per replica (each replica's version is monotonic — a
        fleet swap never moves any of them backwards)."""
        versions: Dict[int, int] = {}
        for r in self.replicas:
            if r.state == "live":
                versions[r.id] = r.engine.hot_swap(model, origin=origin)
                r.arm = "stable"
        with self._fleet_lock:
            self._stable_model = model
            self._candidate_model = None
            self._canary = None
        return versions

    def canary(self, model, fraction: float = 0.1, *,
               n_replicas: int = 1, shadow: bool = False) -> List[int]:
        """Install ``model`` as the candidate on ``n_replicas`` live
        replicas and start routing ``fraction`` of traffic there
        (``shadow=True``: mirror-and-discard instead).  Returns the
        canary replica ids; the controller auto-promotes or rolls back
        from there."""
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        live = [r for r in self.replicas if r.state == "live"]
        if len(live) < 2:
            raise ShedError("canary needs >= 2 live replicas",
                            status=503,
                            retry_after_s=self.config.retry_after_s)
        n = min(int(n_replicas), len(live) - 1)
        picked = live[-n:]
        for r in picked:
            r.engine.hot_swap(model, origin="canary")
            r.arm = "canary"
        ids = [r.id for r in picked]
        self.canary_controller = CanaryController(self.canary_config)
        with self._fleet_lock:
            self._candidate_model = model
            self._canary = {"fraction": float(fraction),
                            "shadow": bool(shadow),
                            "replicas": ids}
        emit_event("fleet_canary_started", fraction=fraction,
                   shadow=shadow, replicas=ids)
        self._record("canary_started", fraction=fraction, shadow=shadow,
                     replicas=ids)
        return ids

    def _canary_tick(self) -> None:
        canary, ctl = self._canary, self.canary_controller
        if canary is None or ctl is None:
            return
        verdict = ctl.evaluate()
        if verdict == "promote":
            self.promote_canary()
        elif verdict == "rollback":
            self.rollback_canary()

    def promote_canary(self) -> None:
        """Candidate goes fleet-wide: every STABLE replica hot-swaps
        forward to it (canary replicas already serve it — their version
        does not move at all, and no replica's version ever decreases)."""
        with self._fleet_lock:
            canary = self._canary
            if canary is None:
                return
            candidate = self._candidate_model
            self._canary = None
        for r in self.replicas:
            if r.state == "live" and r.arm == "stable":
                r.engine.hot_swap(candidate, origin="canary_promoted")
            r.arm = "stable"
        with self._fleet_lock:
            self._stable_model = candidate
            self._candidate_model = None
        emit_event("fleet_canary_promoted")
        self._record("canary_promoted",
                     status=self.canary_controller.status())
        log.info("canary promoted fleet-wide")

    def rollback_canary(self) -> None:
        """Candidate failed its guardrails: canary replicas hot-swap
        FORWARD to the stable model (version still increments — rollback
        is a forward swap of old weights, never a version decrease)."""
        with self._fleet_lock:
            canary = self._canary
            if canary is None:
                return
            self._canary = None
            self._candidate_model = None
            stable = self._stable_model
        for r in self.replicas:
            if r.state == "live" and r.arm == "canary":
                r.engine.hot_swap(stable, origin="canary_rollback")
            r.arm = "stable"
        emit_event("fleet_canary_rolled_back")
        self._record("canary_rolled_back",
                     status=self.canary_controller.status())
        log.warning("canary rolled back")

    # --------------------------------------------------------------- status
    def health(self) -> dict:
        """The aggregate ``/health`` payload: fleet-ready iff ANY live
        replica is ready, with per-replica readiness, tenant bucket
        state, and the canary verdict-in-progress."""
        replicas = {str(r.id): r.describe() for r in self.replicas}
        canary = None
        if self._canary is not None and self.canary_controller is not None:
            canary = dict(self._canary,
                          **self.canary_controller.status())
        return {"ready": any(d["ready"] for d in replicas.values()),
                "replicas": replicas,
                "live_replicas": sum(1 for r in self.replicas
                                     if r.state == "live"),
                "sessions": len(self.router._sessions),
                "tenants": self.router.tenancy.status(),
                "canary": canary}

    def stats(self) -> dict:
        # the port compiles nothing: no steady-recompile count to report
        return {"health": self.health(),
                "trail": list(self.router.trail)}

    def warmup(self) -> int:
        warmed = 0
        for r in self.replicas:
            if r.state == "live":
                warmed += r.engine.warmup()
        return warmed

    def shutdown(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
        for r in self.replicas:
            if r.member is not None:
                r.member.stop(revoke=True)
            if r.state != "dead":
                r.engine.shutdown()
            r.state = "stopped"
        self._set_replica_gauge()


# --------------------------------------------------------------------- HTTP
class _FleetHandler(JsonHandler):
    server_ref = None    # type: FleetServer

    def do_GET(self):
        if self._serve_metrics():
            return
        if self._serve_flightrecorder():
            return
        if self.path.rstrip("/") == "/health":
            return self._json(self.server_ref.fleet.health())
        if self.path.rstrip("/") == "/stats":
            return self._json(self.server_ref.fleet.stats())
        return self._json({"error": "not found"}, 404)

    def do_POST(self):
        route = self.path.rstrip("/")
        fleet = self.server_ref.fleet
        if route == "/predict":
            return self._predict(fleet)
        if route == "/generate":
            return self._generate(fleet)
        return self._json({"error": "not found"}, 404)

    @staticmethod
    def _class_kw(body) -> dict:
        return {"tenant": body.get("tenant"),
                "priority": body.get("priority", "interactive")}

    def _predict(self, fleet):
        try:
            body = self._read_json()
            x = np.asarray(body["data"], dtype=np.float32)
        except Exception as e:
            return self._json({"error": str(e)}, 400)
        try:
            out = fleet.predict(x, **self._class_kw(body))
        except ShedError as e:
            return self._json(
                {"error": str(e)}, e.status,
                headers={"Retry-After": max(1, round(e.retry_after_s))})
        except InvalidInputError as e:
            return self._json({"error": str(e)}, 400)
        except Exception as e:
            return self._json({"error": str(e)}, 500)
        return self._json({"output": np.asarray(out).tolist()})

    def _generate(self, fleet):
        try:
            body = self._read_json()
            tokens = body["tokens"]
            kw = self._class_kw(body)
            for name, cast in (("max_new_tokens", int),
                               ("temperature", float), ("top_k", int),
                               ("top_p", float), ("seed", int),
                               ("eos_id", int)):
                if body.get(name) is not None:
                    kw[name] = cast(body[name])
            stream = bool(body.get("stream", False))
        except Exception as e:
            return self._json({"error": str(e)}, 400)
        try:
            if not stream:
                res = fleet.generate(tokens, **kw)
                return self._json({"tokens": res.tokens,
                                   "model_versions": res.versions,
                                   "finish": res.finish,
                                   "request_id": res.request_id})
            events = fleet.stream(tokens, **kw)
        except ShedError as e:
            return self._json(
                {"error": str(e)}, e.status,
                headers={"Retry-After": max(1, round(e.retry_after_s))})
        except InvalidInputError as e:
            return self._json({"error": str(e)}, 400)
        except Exception as e:
            return self._json({"error": str(e)}, 500)
        # the router's relay already hides failover; an abandoned client
        # closes the generator, which cancels the session fleet-side
        self._stream_json_lines(events)


class FleetServer:
    """ONE HTTP front for the whole fleet.

    Endpoints::

      POST /predict   {"data", "tenant"?, "priority"?}
      POST /generate  {"tokens", "stream"?, "tenant"?, "priority"?, ...}
      GET  /health    aggregate replica readiness + tenants + canary
      GET  /stats     health + routing trail
      GET  /metrics   Prometheus text (?format=json snapshot)
    """

    def __init__(self, fleet: ServingFleet, port: int = 0, *,
                 max_concurrent: int = 64, registry=None):
        self.fleet = fleet
        self.registry = registry if registry is not None \
            else default_registry()
        self._server = BackgroundHttpServer(
            _FleetHandler, port, max_concurrent=max_concurrent,
            server_ref=self, metrics_registry=self.registry)

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "FleetServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()
        self.fleet.shutdown()


class FleetClient(JsonClient):
    """Client for the fleet front: tenant/priority-aware predict and
    generate (blocking or streaming)."""

    def predict(self, data, tenant: Optional[str] = None,
                priority: Optional[str] = None) -> np.ndarray:
        body = {"data": np.asarray(data).tolist()}
        if tenant is not None:
            body["tenant"] = tenant
        if priority is not None:
            body["priority"] = priority
        return np.asarray(self.post("/predict", body)["output"])

    @staticmethod
    def _body(tokens, **kw):
        body = {"tokens": [int(t) for t in tokens]}
        body.update({k: v for k, v in kw.items() if v is not None})
        return body

    def generate(self, tokens, **kw) -> dict:
        return self.post("/generate", self._body(tokens, **kw))

    def stream(self, tokens, **kw):
        return self.stream_lines(
            "/generate", self._body(tokens, stream=True, **kw))

    def health(self) -> dict:
        return self.get("/health")
