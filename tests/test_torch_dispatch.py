"""The port's bounded dispatch window (``nn/dispatch.py``) and the fit
loop that drives it, against the JAX package's.

* the window's own semantics, as ``tests/test_dispatch_pipeline.py``
  holds the JAX package's: env parsing, blocking at depth, depth 1 as the
  serial loop, the owner/profiler/NaN bookkeeping, ``abandon`` never
  blocks, ``drain_timed`` order;
* depth is scheduling only: depths 1, 2 and 4 give bitwise-equal params
  on a small MLN and a small TransformerLM, and both equal the JAX
  package's ``fit`` from the same weights (a ``write_model`` zip read by
  ``load_reference_model``);
* a NaN at step N surfaces at a drain within the window, with N's own
  iteration;
* a checkpoint taken in the middle of a window resumes equal to the
  uninterrupted run.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.multi_layer import \
    MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.faulttolerance import CheckpointConfig
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.dispatch import (DEFAULT_DEPTH, ENV_VAR,
                                                  DispatchWindow,
                                                  configured_depth)
from deeplearning4j_tpu_torch.observability.recorder import (
    FlightRecorder, set_flight_recorder)
from deeplearning4j_tpu_torch.observability.registry import default_registry
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

# the port against the JAX package after the same steps from the same
# weights, f32 on the CPU: the sums differ in order only (~1e-7 a step)
TOL_JAX = 2e-5
LM = dict(vocab_size=32, seq_len=128, embed=64, n_layers=2, n_heads=1)


class _Token:
    """A fake loss token: ``float`` is the sync, so the order of the
    ``float`` calls is the order the window materializes in."""

    def __init__(self, value, log):
        self.value, self.log = value, log

    def __float__(self):
        self.log.append(self.value)
        return float(self.value)


class _Prof:
    def __init__(self):
        self.calls = []

    def drained(self, k):
        self.calls.append(k)


# --------------------------------------------------------- the window
@pytest.mark.parametrize("raw, depth", [(None, DEFAULT_DEPTH), ("4", 4),
                                        ("0", 1), ("-3", 1),
                                        ("two", DEFAULT_DEPTH),
                                        ("", DEFAULT_DEPTH)])
def test_configured_depth_reads_the_env(monkeypatch, raw, depth):
    if raw is None:
        monkeypatch.delenv(ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(ENV_VAR, raw)
    assert configured_depth() == depth


@pytest.mark.parametrize("depth, in_flight, first", [(3, 2, [0.0, 1.0, 2.0]),
                                                     (1, 0, [0.0, 1.0, 2.0,
                                                             3.0, 4.0])])
def test_push_blocks_on_the_oldest_at_depth(depth, in_flight, first):
    log = []
    win = DispatchWindow(depth=depth)
    for i in range(5):
        win.push(_Token(float(i), log), i)
        # after a push at most depth - 1 stay in flight (depth 1: none,
        # the serial loop)
        assert len(win) <= in_flight
    assert log == first
    win.drain()
    assert log == [0.0, 1.0, 2.0, 3.0, 4.0] and len(win) == 0


def test_owner_profiler_and_nan_bookkeeping():
    log, nans = [], []
    owner = type("Owner", (), {})()
    prof = _Prof()
    win = DispatchWindow(depth=2, owner=owner, profiler=prof,
                         on_nan=lambda it, v: nans.append((it, v)))
    win.push(_Token(0.5, log), 10)
    win.push(_Token(float("nan"), log), 11)
    win.push(_Token(0.25, log), 12)
    win.drain()
    assert owner.last_drained_score == 0.25
    assert owner.last_drained_iteration == 12
    assert prof.calls == [1, 1, 1]
    # the NaN fired with its own iteration, not the latest one
    assert len(nans) == 1 and nans[0][0] == 11 and nans[0][1] != nans[0][1]


def test_abandon_never_blocks_and_drain_timed_keeps_order():
    log = []
    win = DispatchWindow(depth=4)
    win.push(_Token(1.0, log), 0)
    win.push(_Token(2.0, log), 1)
    win.abandon()
    assert log == [] and len(win) == 0
    for i in range(3):
        win.push(_Token(float(i), log), 100 + i)
    out = win.drain_timed()
    assert [it for it, _ in out] == [100, 101, 102]
    assert all(a[1] <= b[1] for a, b in zip(out, out[1:]))


# ------------------------------------------------------ the fit loop
def _jax_mlp(seed=42):
    conf = (JNNC.builder().seed(seed)
            .updater(jupd.Adam(learning_rate=0.02)).list()
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    return JMLN(conf).init()


def _jax_lm():
    """The JAX TransformerLM holding the port's initial params (the JAX
    package's own ``init`` draws them op by op, seconds on the CPU)."""
    import jax.numpy as jnp
    tn = TransformerLM(**LM, sparse_labels=True,
                       updater=tupd.Sgd(learning_rate=1e-3)
                       ).init(device="cpu")
    jn = JMLN(JMLC.from_json(tn.conf.to_json()))
    jn.params = {k: {n: jnp.asarray(p.detach().numpy())
                     for n, p in g.items()} for k, g in tn.params.items()}
    jn.state = {k: {} for k in jn.params}
    jn._tx = jn._build_tx()
    jn.opt_state = jn._tx.init(jn.params)
    return jn


def _mlp_batches(n=10, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 4), dtype=np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)])
            for _ in range(n)]


def _lm_batches(n=2, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    v, t = LM["vocab_size"], LM["seq_len"]
    return [(rng.integers(0, v, (batch, t)), rng.integers(0, v, (batch, t)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """The JAX nets as ``write_model`` zips, and their params after the
    same fits the port runs."""
    d = tmp_path_factory.mktemp("dispatch")
    out = {}
    for name, jn, batches in (
            ("mlp", _jax_mlp(), _mlp_batches()),
            ("lm", _jax_lm(), _lm_batches())):
        path = str(d / f"{name}.zip")
        write_model(jn, path, save_updater=False)
        jn.fit(iter(batches), epochs=1)
        out[name] = (path, batches, np.asarray(jn.params_flat()))
    return out


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_depths_are_bitwise_equal_and_match_jax(zips, monkeypatch, name):
    path, batches, jax_flat = zips[name]
    flats = []
    for depth in (1, 2, 4):
        monkeypatch.setenv(ENV_VAR, str(depth))
        net = load_reference_model(path, device="cpu")
        net.fit(iter(batches), epochs=1)
        assert net.iteration == len(batches)
        flats.append(net.params_flat())
    assert np.array_equal(flats[0], flats[1])
    assert np.array_equal(flats[0], flats[2])
    np.testing.assert_allclose(flats[0], jax_flat, atol=TOL_JAX)


@pytest.fixture
def recorder(tmp_path):
    rec = FlightRecorder(capacity=256, directory=str(tmp_path / "disp"),
                         min_dump_interval_s=0.0)
    prev = set_flight_recorder(rec)
    try:
        yield rec
    finally:
        set_flight_recorder(prev)


def test_nan_surfaces_within_the_window_with_its_own_iteration(
        zips, recorder, monkeypatch):
    monkeypatch.setenv(ENV_VAR, "4")
    batches = _mlp_batches(8)
    bad = batches[3][0].copy()
    bad[0, 0] = np.nan
    batches[3] = (bad, batches[3][1])
    net = load_reference_model(zips["mlp"][0], device="cpu")
    net.fit(iter(batches), epochs=1)
    events = [r for r in recorder.channel("train").items()
              if r["type"] == "nan_at_drain"]
    # batch 3 is iteration 4 of a fresh net, and every later step is NaN
    # too, each with its own iteration, in order
    assert [e["iteration"] for e in events] == [4, 5, 6, 7, 8]
    assert all(e["score"] != e["score"] for e in events)
    assert net.last_drained_iteration == 8
    assert net.get_score() != net.get_score()


def test_mid_window_checkpoint_resumes_equal(zips, tmp_path, monkeypatch):
    batches = _mlp_batches(10)
    monkeypatch.setenv(ENV_VAR, "4")
    path = zips["mlp"][0]
    a = load_reference_model(path, device="cpu")
    a.fit(iter(batches), epochs=2)
    b = load_reference_model(path, device="cpu")
    cfg = CheckpointConfig(directory=str(tmp_path),
                           save_every_n_iterations=3, keep_last=10,
                           background=False)
    # saves every 3 steps at depth 4: each save lands inside a window
    b.fit(iter(batches), epochs=2, checkpoint=cfg)
    assert np.array_equal(a.params_flat(), b.params_flat())
    mid = cfg.resolve().checkpoints()[1][1]
    monkeypatch.setenv(ENV_VAR, "1")
    c = load_reference_model(path, device="cpu")
    c.fit(iter(batches), epochs=2, resume_from=mid)
    assert np.array_equal(a.params_flat(), c.params_flat())
    assert c.iteration == a.iteration


@pytest.mark.parametrize("depth", [2, 4])
def test_depth_gauge_reads_the_window(zips, recorder, monkeypatch, depth):
    monkeypatch.setenv(ENV_VAR, str(depth))
    monkeypatch.setenv("DL4J_TPU_STEPPROF", "1")
    monkeypatch.setenv("DL4J_TPU_STEPPROF_SAMPLE", "6")
    net = load_reference_model(zips["mlp"][0], device="cpu")
    net.fit(iter(_mlp_batches(12)), epochs=1)
    # between sampled fences the window holds the configured depth
    assert default_registry().get("training_dispatch_depth").value == depth
