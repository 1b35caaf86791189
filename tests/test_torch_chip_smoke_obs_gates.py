"""The gates of ``chip_smoke.py``'s checkpoint and observability phases
(31, 32), pinned on the CPU with the phases' own helper functions.

- ``resume_gate``: the resumed run against the one that went on, and the
  checkpointed run against one without checkpoints, are both bitwise.
  Only a recorded cause lets the measured difference of two runs without
  checkpoints replace 0, never a tolerance picked by hand, and a
  difference between the checkpointed run and one without never loosens
  the gate by itself.
- ``state_max_diff``: 0 only for bit-equal states; a NaN against a
  finite value reads inf.
- ``mfu_agrees``: a sampled step's MFU is flops / (device slice x peak),
  checked on records the port's step profiler wrote.
- ``lm_step_flops``: PaLM's 6N + 12·L·T·E per token for the full-width
  TransformerLM.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.observability import (FlightRecorder,
                                                    MetricsRegistry,
                                                    StepProfiler)


@pytest.mark.parametrize("diff,observer,noise,ok", [
    (0.0, 0.0, None, True),            # bitwise
    (1e-12, 0.0, None, False),         # any resume difference
    (float("inf"), 0.0, None, False),  # mismatched names, shapes or NaN
    (0.0, 1e-12, None, False),         # checkpointing moved the run
    (3e-7, 5e-7, None, False),         # the observer gap never loosens it
    (3e-7, 0.0, 5e-7, True),           # a recorded cause's measured noise
    (6e-7, 0.0, 5e-7, False),
    (0.0, 6e-7, 5e-7, False)])
def test_resume_gate_is_bitwise_unless_a_twin_difference_replaces_it(
        diff, observer, noise, ok):
    assert chip_smoke.resume_gate(diff, observer, noise) is ok
    assert chip_smoke.RESUME_NONDETERMINISM is None


def test_state_max_diff_reads_params_slots_counts_and_key():
    net = TransformerLM(vocab_size=16, seq_len=8, embed=16, n_layers=1,
                        n_heads=2, sparse_labels=True).init(device="cpu")
    a = chip_smoke.training_state(net)
    assert {k.split("/")[0] for k in a} == {"param", "slot", "count", "key"}
    assert chip_smoke.state_max_diff(a, dict(a)) == 0.0
    b = dict(a)
    b["count/default"] = torch.tensor(1)
    assert chip_smoke.state_max_diff(a, b) == 1.0
    b = {k: v for k, v in a.items() if k != "key"}
    assert chip_smoke.state_max_diff(a, b) == float("inf")
    name = next(k for k in a if k.startswith("slot/"))
    b = dict(a)
    b[name] = a[name] + 0.25
    assert chip_smoke.state_max_diff(a, b) == 0.25
    b[name] = a[name].clone()
    b[name].view(-1)[0] = float("nan")
    assert chip_smoke.state_max_diff(a, b) == float("inf")
    assert chip_smoke.state_max_diff(b, a) == float("inf")
    assert chip_smoke.state_max_diff(b, dict(b)) == 0.0
    # bits that differ in the sign of a zero alone are not bitwise
    b[name].view(-1)[0] = -0.0
    c = dict(b)
    c[name] = b[name].clone()
    c[name].view(-1)[0] = 0.0
    assert chip_smoke.state_max_diff(b, c) > 0.0


def test_mfu_gate_is_flops_over_slice_times_peak(monkeypatch, tmp_path):
    """Step records the port's profiler wrote (every step sampled, FLOPs
    from a card file, the H100 peak from the environment) pass the gate;
    a record whose MFU or slice was altered does not."""
    flops, peak = 3.0e9, chip_smoke.OBS_PEAK_FLOPS
    (tmp_path / "probe.json").write_text(json.dumps({"flops": flops}))
    monkeypatch.setenv("DL4J_TPU_CARDS_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", str(peak))
    rec = FlightRecorder()
    prof = StepProfiler("probe", sample_every=1, registry=MetricsRegistry(),
                        recorder=rec)
    x = torch.ones(256, 256)
    for i in range(3):
        prof.begin(chip_smoke.time.perf_counter())
        loss = (x @ x).sum()
        prof.dispatched(loss)
        prof.end(i + 1)
    prof.flush()
    records = rec.channel("profile").items()
    assert len(records) == 3
    for r in records:
        assert chip_smoke.mfu_agrees(r, flops, peak)
        # the record keeps the slice rounded to 1e-7 s
        assert abs(flops / (r["mfu"] * peak) - r["phases"]["device"]) \
            <= 5e-8
        assert not chip_smoke.mfu_agrees(r, flops, peak * 2)
        assert not chip_smoke.mfu_agrees(r, 2 * flops, peak)
        bad = dict(r, mfu=r["mfu"] * (1 + 1e-9))
        assert not chip_smoke.mfu_agrees(bad, flops, peak)


def test_lm_step_flops_at_full_width():
    conf = TransformerLM(vocab_size=8192, seq_len=512, embed=512,
                         n_layers=8, n_heads=8, sparse_labels=True).conf()
    b, t, e, layers, v = 16, 512, 512, 8, 8192
    per_token = layers * (24 * e * e + 4 * t * e) + 2 * e * v
    assert chip_smoke.lm_step_flops(conf, b) == 3.0 * b * t * per_token
    # 6 x 33.6 M params x 8192 tokens, and the attention's products
    assert chip_smoke.lm_step_flops(conf, b) == pytest.approx(1.6493e12,
                                                              rel=1e-4)
    assert np.isfinite(chip_smoke.OBS_PEAK_FLOPS)


class _Ev:
    def __init__(self, key, us, device="DeviceType.CUDA", annotation=False):
        self.key, self.self_device_time_total = key, us
        self.device_type, self.is_user_annotation = device, annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def key_averages(self):
        return self._events


def test_profiler_device_time_leaves_out_annotations_and_host_ops():
    """A ``record_function`` range shows on the device as a user
    annotation spanning its kernels: counting it would double the step's
    CUDA time (the first chip call read 129 ms of CUDA time in an 80 ms
    step).  Every flagged annotation is left out, whatever its name; a
    profiler without the flag fails loudly."""
    prof = _Prof([_Ev("gemm_kernel", 30_000.0), _Ev("flash_fwd_kernel",
                                                    20_000.0),
                  _Ev("aten::mm", 30_000.0, device="DeviceType.CPU"),
                  _Ev("smoke.train_step", 79_000.0, annotation=True),
                  _Ev("serve.batch", 5_000.0, annotation=True)])
    assert chip_smoke.device_ms_in(prof) == 50.0
    unflagged = _Ev("gemm_kernel", 30_000.0)
    del unflagged.is_user_annotation
    with pytest.raises(RuntimeError, match="is_user_annotation"):
        chip_smoke.device_ms_in(_Prof([unflagged]))
