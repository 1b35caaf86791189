"""Tenant quotas and request classes for the serving admission tier
(port of ``serving/tenancy.py``, host code only).

The fleet front (``serving/fleet.py``) admits requests for MANY clients
through one router, so admission grows request *classes*: every request
carries a tenant id and one of two priorities, and each tenant draws
from its own token bucket BEFORE anything is enqueued — a noisy tenant
exhausts its own bucket and sheds itself (429 + ``Retry-After`` sized
to its refill), while everyone else's buckets (and the engine queues
behind them) stay untouched.

Priorities are a headroom contract, not a scheduler: ``interactive``
requests may drain a tenant's bucket to empty, ``batch`` requests must
leave ``interactive_reserve`` of the burst unspent — so a tenant's own
bulk traffic can never lock out its own interactive traffic, and the
check stays O(1) at admission with no cross-request bookkeeping.

Metric cardinality is bounded by construction: tenants named in the
quota table keep their id as the ``tenant`` label; any OTHER id is
hash-bucketed into one of :data:`TENANT_HASH_BUCKETS` ``anon-N`` labels
(an attacker spraying fresh tenant ids cannot grow the registry), and
requests with no tenant at all label as ``"-"``.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from ..observability import clock
from ..observability.registry import default_registry

__all__ = ["PRIORITIES", "TENANT_HASH_BUCKETS", "TenantQuota",
           "TenantAdmission", "tenant_label"]

#: the two request classes, in descending precedence
PRIORITIES = ("interactive", "batch")

#: anonymous-tenant label buckets (``anon-0`` .. ``anon-N-1``)
TENANT_HASH_BUCKETS = 16


def tenant_label(tenant: Optional[str], known=()) -> str:
    """Bounded-cardinality ``tenant`` metric label: configured tenants
    keep their id, unknown ids hash-bucket, missing ids collapse to
    ``"-"``."""
    if not tenant:
        return "-"
    if tenant in known:
        return str(tenant)
    h = int.from_bytes(
        hashlib.blake2s(str(tenant).encode(), digest_size=4).digest(),
        "big")
    return f"anon-{h % TENANT_HASH_BUCKETS}"


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's token bucket: ``rate`` tokens/second refill up to a
    ``burst`` ceiling; ``interactive_reserve`` of the burst is spendable
    only by interactive requests."""

    rate: float = 10.0
    burst: float = 20.0
    interactive_reserve: float = 0.2   # fraction of burst batch can't use

    def __post_init__(self):
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(
                f"rate/burst must be > 0, got {self.rate}/{self.burst}")
        if not 0.0 <= self.interactive_reserve < 1.0:
            raise ValueError("interactive_reserve must be in [0, 1)")


class _Bucket:
    __slots__ = ("tokens", "updated", "shed", "admitted")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.updated = now
        self.shed = 0
        self.admitted = 0


class TenantAdmission:
    """Per-tenant token-bucket quota gate, checked BEFORE enqueue.

    ``quotas`` maps tenant id -> :class:`TenantQuota`; ``default`` (if
    given) covers every unlisted tenant — each unlisted id still gets
    its OWN bucket (isolation), only its metric label is hash-bucketed.
    With no ``default``, unlisted tenants pass unmetered (quota is
    opt-in per deployment)."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default: Optional[TenantQuota] = None,
                 retry_after_s: float = 1.0, registry=None):
        self.quotas = dict(quotas or {})
        self.default = default
        self.retry_after_s = float(retry_after_s)
        self._registry = registry
        self._lock = threading.Lock()
        self._buckets: Dict[str, _Bucket] = {}

    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def label(self, tenant: Optional[str]) -> str:
        return tenant_label(tenant, self.quotas)

    def _count_shed(self, reason: str, tenant: Optional[str]) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.counter("serving_shed_total",
                        "Requests shed by admission control",
                        ("reason", "tenant")).labels(
                            reason, self.label(tenant)).inc()

    def check(self, tenant: Optional[str],
              priority: str = "interactive", cost: float = 1.0) -> None:
        """Spend ``cost`` tokens from ``tenant``'s bucket or raise
        :class:`~.engine.ShedError` (429) with ``Retry-After`` sized to
        the bucket's actual refill — the shed is self-inflicted and
        self-describing."""
        from .engine import ShedError
        if priority not in PRIORITIES:
            from ..parallel.inference import InvalidInputError
            raise InvalidInputError(
                f"unknown priority {priority!r} (one of {PRIORITIES})")
        quota = self.quotas.get(tenant or "", self.default)
        if quota is None:
            return
        key = str(tenant or "")
        now = clock.monotonic_s()
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = _Bucket(quota.burst, now)
            b.tokens = min(quota.burst,
                           b.tokens + (now - b.updated) * quota.rate)
            b.updated = now
            floor = quota.burst * quota.interactive_reserve \
                if priority == "batch" else 0.0
            if b.tokens - cost < floor:
                b.shed += 1
                short = cost + floor - b.tokens
                retry = max(self.retry_after_s, short / quota.rate)
            else:
                b.tokens -= cost
                b.admitted += 1
                retry = None
        if retry is not None:
            self._count_shed("tenant_quota", tenant)
            raise ShedError(
                f"tenant {self.label(tenant)!r} over quota "
                f"({quota.rate}/s, burst {quota.burst})", status=429,
                retry_after_s=retry)

    def status(self) -> dict:
        """Per-tenant bucket state for ``/health`` (labels, not raw ids
        — the payload is as cardinality-bounded as the metrics)."""
        now = clock.monotonic_s()
        out = {}
        with self._lock:
            for key, b in self._buckets.items():
                quota = self.quotas.get(key, self.default)
                if quota is None:
                    continue
                tokens = min(quota.burst,
                             b.tokens + (now - b.updated) * quota.rate)
                out[self.label(key)] = {
                    "tokens": round(tokens, 3), "burst": quota.burst,
                    "rate": quota.rate, "admitted": b.admitted,
                    "shed": b.shed}
        return out
