"""The port's tenant quotas against the JAX package's: ``tenant_label``
gives the same strings (configured ids, ``anon-N`` hash buckets, ``-``),
and ``TenantAdmission.check`` makes the same admit/shed decisions with the
same ``Retry-After`` for one request sequence under one fake clock
(exact), including the interactive reserve that batch traffic may not
spend.  The per-tenant status and the shed counter follow."""
import numpy as np
import pytest

from deeplearning4j_tpu.observability import MetricsRegistry as JRegistry
from deeplearning4j_tpu.observability import clock as jclock
from deeplearning4j_tpu.serving import tenancy as jten
from deeplearning4j_tpu.serving.engine import ShedError as JShedError
from deeplearning4j_tpu_torch.observability import MetricsRegistry
from deeplearning4j_tpu_torch.observability import clock as tclock
from deeplearning4j_tpu_torch.parallel.inference import InvalidInputError
from deeplearning4j_tpu_torch.serving import tenancy as tten
from deeplearning4j_tpu_torch.serving.engine import ShedError


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_tenant_labels_equal_the_jax_strings():
    known = {"alice", "bob"}
    ids = [None, "", "alice", "bob", "carol"] + [f"rando-{i}"
                                                  for i in range(200)]
    mine = [tten.tenant_label(t, known) for t in ids]
    assert mine == [jten.tenant_label(t, known) for t in ids]
    assert mine[:5] == ["-", "-", "alice", "bob", mine[4]]
    anon = set(mine[4:])
    assert all(a.startswith("anon-") for a in anon)
    assert len(anon) == tten.TENANT_HASH_BUCKETS == 16
    assert tten.PRIORITIES == jten.PRIORITIES


def _sequence(mod, shed_cls, reg, clock):
    adm = mod.TenantAdmission(
        {"noisy": mod.TenantQuota(rate=2.0, burst=4.0,
                                  interactive_reserve=0.25),
         "calm": mod.TenantQuota(rate=50.0, burst=50.0)},
        default=mod.TenantQuota(rate=1.0, burst=2.0), registry=reg)
    rng = np.random.default_rng(5)
    tenants = ["noisy", "calm", "other-1", "other-2", None]
    out = []
    for step in range(120):
        clock.t += float(rng.choice([0.0, 0.05, 0.1, 0.3, 1.0]))
        tenant = tenants[int(rng.integers(len(tenants)))]
        priority = "batch" if rng.random() < 0.4 else "interactive"
        cost = float(rng.choice([1.0, 1.0, 2.0]))
        try:
            adm.check(tenant, priority, cost)
            out.append((step, "ok", None))
        except shed_cls as e:
            out.append((step, e.status, e.retry_after_s))
    return out, adm


def test_check_decisions_and_retry_after_equal_the_jax_gate(monkeypatch):
    tc, jc = _Clock(), _Clock()
    monkeypatch.setattr(tclock, "monotonic_s", tc)
    monkeypatch.setattr(jclock, "monotonic_s", jc)
    reg = MetricsRegistry()
    mine, adm = _sequence(tten, ShedError, reg, tc)
    ref, jadm = _sequence(jten, JShedError, JRegistry(), jc)
    assert mine == ref
    sheds = [r for r in mine if r[1] != "ok"]
    assert sheds and all(r[1] == 429 and r[2] >= 1.0 for r in sheds)
    assert any(r[1] == "ok" for r in mine)
    assert adm.status() == jadm.status()
    counted = sum(s["value"] for s in reg.snapshot()[
        "serving_shed_total"]["samples"])
    assert counted == len(sheds)
    labels = {s["labels"]["tenant"] for s in reg.snapshot()[
        "serving_shed_total"]["samples"]}
    assert labels <= {"noisy", "calm", "-"} | {f"anon-{i}"
                                                for i in range(16)}


def test_batch_traffic_leaves_the_interactive_reserve(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tclock, "monotonic_s", clock)
    adm = tten.TenantAdmission({"t": tten.TenantQuota(
        rate=1.0, burst=10.0, interactive_reserve=0.3)},
        registry=MetricsRegistry())
    for _ in range(7):
        adm.check("t", "batch")
    with pytest.raises(ShedError) as ei:
        adm.check("t", "batch")
    # the shortfall (1 token above the 3-token reserve) refills in 1 s
    assert ei.value.retry_after_s == pytest.approx(1.0)
    for _ in range(3):
        adm.check("t", "interactive")
    with pytest.raises(ShedError):
        adm.check("t", "interactive")
    # unlisted tenants without a default pass unmetered
    for _ in range(50):
        adm.check("stranger")
    with pytest.raises(InvalidInputError, match="unknown priority"):
        adm.check("t", "urgent")
    with pytest.raises(ValueError):
        tten.TenantQuota(rate=0.0)
    with pytest.raises(ValueError):
        tten.TenantQuota(interactive_reserve=1.0)
