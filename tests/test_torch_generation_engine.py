"""The port's continuous-batching generation engine against the JAX
package's on the same weights (``params_from_jax``): greedy and sampled
token streams must be identical on the ``REQUESTS`` workload of
``tests/test_paged_kv.py`` at two block geometries, with prefix sharing
and copy-on-write in play, and on a recurrent (LSTM) stack; greedy
streams must also equal the naive full re-forward.  Then the engine's
own behaviour: a late join equals a solo run bit for bit, EOS vacates,
streaming and cancel, admission sheds, invalid input, a failing decode
step, a hot swap, session export and import, warm-up while decoding,
the refusals, and the ``ServingEngine(generation=...)`` integration.

The JAX engine runs once per module (the ``jax_runs`` fixture).  Every
engine is shut down in ``finally``; every wait has its own timeout.
"""
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType as JInputType
from deeplearning4j_tpu import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.generation import GenerationConfig as JConfig
from deeplearning4j_tpu.generation import GenerationEngine as JEngine
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                 GenerationEngine,
                                                 StaticSlotSource)
from deeplearning4j_tpu_torch.generation.programs import _fresh_carry
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.inference import InvalidInputError
from deeplearning4j_tpu_torch.serving.engine import ServingEngine, ShedError
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

VOCAB = 17
SMALL = dict(vocab_size=VOCAB, seq_len=32, embed=16, n_layers=2, n_heads=2)
WAIT_S = 60.0

REQUESTS = [
    ([3, 1, 4, 1, 5], dict(max_new_tokens=8, seed=11)),
    ([9, 2, 6], dict(max_new_tokens=8, temperature=0.7, top_k=5, seed=42)),
    ([5, 3, 5, 8, 9, 7, 9, 3], dict(max_new_tokens=6, temperature=1.1,
                                    top_p=0.8, seed=7)),
    ([2, 7, 1], dict(max_new_tokens=8, temperature=0.4, seed=13)),
]
GEOMETRIES = {"block4": dict(max_slots=4, max_seq=32, block_size=4),
              "block8": dict(max_slots=2, max_seq=32, block_size=8)}
HEADER = [3, 1, 4, 1, 5, 9, 2, 6]            # two full 4-token blocks
SHARED = [(HEADER + tail, dict(max_new_tokens=6, temperature=0.6,
                               seed=100 + i))
          for i, tail in enumerate(([7], [8, 2], [9, 9, 1], [4]))]
COW = [([3, 1, 4, 1, 5, 9], dict(max_new_tokens=6, seed=1)),
       ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], dict(max_new_tokens=6, seed=2)),
       ([3, 1, 4, 1, 5, 9], dict(max_new_tokens=6, temperature=0.5,
                                 seed=3)),
       ([3, 1, 4, 1, 5, 9, 8], dict(max_new_tokens=6, seed=4))]
SHARE_CFG = dict(max_slots=2, max_seq=32, block_size=4)


def _perturbed(tree, seed):
    """The JAX init plus seeded noise: diverse token streams, so greedy
    and sampled paths are exercised away from a constant argmax."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.5)
        .astype(np.float32), tree)


def _lstm_pair():
    b = (NeuralNetConfiguration.builder().seed(3).weight_init("xavier"))
    lb = (b.list()
          .layer(jff.EmbeddingSequenceLayer(n_out=8))
          .layer(jrec.LSTM(n_out=16, activation="tanh"))
          .layer(jrec.LSTM(n_out=16, activation="tanh"))
          .layer(jrec.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                     loss="mcxent")))
    jn = JMultiLayerNetwork(
        lb.set_input_type(JInputType.recurrent(VOCAB, 24)).build()).init()
    tree = _perturbed(jn.params, 12)
    jn.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    return jn, params_from_jax(tn, tree)


@pytest.fixture(scope="module")
def nets():
    """The JAX init with the embedding table scaled up: at width 16 the
    positional encoding otherwise dominates the residual stream and every
    position predicts the same token."""
    jn = JTransformerLM(**SMALL).init()
    tree = jax.tree_util.tree_map(np.asarray, jn.params)
    tree["layer_0"]["W"] = tree["layer_0"]["W"] * 6.0
    jn.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tn = params_from_jax(TransformerLM(**SMALL).init(device="cpu"), tree)
    return jn, tn


def _run(eng, requests, sequential=False):
    if sequential:
        return [eng.generate(p, timeout=WAIT_S, **kw).tokens
                for p, kw in requests]
    handles = [eng.submit(p, **kw) for p, kw in requests]
    return [h.future.result(timeout=WAIT_S).tokens for h in handles]


def _engine_run(cls, cfg_cls, net, cfg, requests, sequential=False):
    eng = cls.for_model(net, cfg_cls(**cfg))
    try:
        toks = _run(eng, requests, sequential)
        return toks, eng.status()["kv"]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_runs(nets):
    """Every JAX engine run the module compares against, computed once."""
    jn, _ = nets
    out = {g: _engine_run(JEngine, JConfig, jn, cfg, REQUESTS)[0]
           for g, cfg in GEOMETRIES.items()}
    out["shared"] = _engine_run(JEngine, JConfig, jn, SHARE_CFG, SHARED,
                                sequential=True)
    out["cow"] = _engine_run(JEngine, JConfig, jn, SHARE_CFG, COW,
                             sequential=True)
    jl, _ = _lstm_pair()
    out["lstm"] = _engine_run(JEngine, JConfig, jl,
                              dict(max_slots=3, max_seq=24, block_size=4),
                              REQUESTS)[0]
    return out


def naive_greedy(net, history, n):
    hist = [int(t) for t in history]
    out = []
    for _ in range(n):
        probs = net.output(np.asarray([hist], np.int64)).numpy()
        tok = int(probs[0, len(hist) - 1].argmax())
        out.append(tok)
        hist.append(tok)
    return out


def wait_until(pred, timeout_s=WAIT_S, interval_s=0.005):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_streams_equal_jax_and_the_naive_reforward(nets, jax_runs, geometry):
    _, tn = nets
    got, kv = _engine_run(GenerationEngine, GenerationConfig, tn,
                          GEOMETRIES[geometry], REQUESTS)
    assert got == jax_runs[geometry]
    assert len({tuple(t) for t in got}) == len(got)   # diverse streams
    for (prompt, kw), toks in zip(REQUESTS, got):
        if not kw.get("temperature"):
            assert toks == naive_greedy(tn, prompt, len(toks))
    assert kv["block_size"] == GEOMETRIES[geometry]["block_size"]


@pytest.mark.parametrize("workload", ["shared", "cow"])
def test_prefix_sharing_and_cow_streams_equal_jax(nets, jax_runs, workload):
    _, tn = nets
    reqs = SHARED if workload == "shared" else COW
    got, kv = _engine_run(GenerationEngine, GenerationConfig, tn, SHARE_CFG,
                          reqs, sequential=True)
    want, jkv = jax_runs[workload]
    assert got == want
    for key in ("prefix_hits", "prefix_tokens_saved", "cow_copies",
                "blocks_registered", "blocks_free"):
        assert kv[key] == jkv[key], key
    assert kv["prefix_hits"] >= 2
    if workload == "cow":
        assert kv["cow_copies"] >= 1
    cold, _ = _engine_run(GenerationEngine, GenerationConfig, tn,
                          dict(SHARE_CFG, prefix_sharing=False), reqs,
                          sequential=True)
    assert cold == got


def test_lstm_stack_streams_equal_jax(jax_runs):
    _, tl = _lstm_pair()
    eng = GenerationEngine.for_model(
        tl, GenerationConfig(max_slots=3, max_seq=24, block_size=4))
    try:
        got = _run(eng, REQUESTS)
        assert eng.status()["kv"]["prefix_sharing"] is False
    finally:
        eng.shutdown()
    assert got == jax_runs["lstm"]
    for (prompt, kw), toks in zip(REQUESTS, got):
        if not kw.get("temperature"):
            assert toks == naive_greedy(tl, prompt, len(toks))


# ------------------------------------------------------- engine behaviour
def test_late_join_matches_solo_run_bit_level(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=4, max_seq=32))
    try:
        assert eng.warmup() == len(eng.buckets) + 1
        kw = dict(max_new_tokens=10, temperature=0.85, top_k=6,
                  top_p=0.95, seed=424242)
        prompt = [2, 7, 1, 8]
        solo = eng.generate(prompt, timeout=WAIT_S, **kw)
        long_req = eng.submit([5, 3], max_new_tokens=26, temperature=0.7,
                              seed=1)
        assert wait_until(lambda: len(long_req.out_tokens) >= 3)
        steps_before = eng.decode_steps
        late = eng.submit(prompt, **kw).future.result(timeout=WAIT_S)
        assert late.tokens == solo.tokens
        assert long_req.future.result(timeout=WAIT_S).finish == "length"
        assert eng.decode_steps > steps_before
        st = eng.status()
        assert st["steady_recompiles"] is None and st["warm"] is True
        assert st["tokens_generated"] == 10 + 10 + 26
    finally:
        eng.shutdown()


def test_eos_vacates_the_slot_and_the_trail_records_it(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=2, max_seq=32))
    try:
        prompt = [3, 1, 4, 1, 5]
        ref = naive_greedy(tn, prompt, 8)
        eos = ref[3]
        res = eng.generate(prompt, max_new_tokens=8, eos_id=eos,
                           timeout=WAIT_S)
        assert res.finish == "eos"
        assert res.tokens == ref[:ref.index(eos) + 1]
        assert wait_until(lambda: eng.ring.free_slots == 2)
        events = [(e["event"], e.get("reason")) for e in eng.ring.trail()]
        assert ("install", None) in events and ("vacate", "eos") in events
    finally:
        eng.shutdown()


def test_stream_yields_per_token_events_and_cancel_vacates(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=1, max_seq=32))
    try:
        events = list(eng.stream([4, 2], max_new_tokens=5, timeout=WAIT_S))
        assert [e["index"] for e in events[:-1]] == list(range(5))
        assert all("token" in e and e["model_version"] == 1
                   for e in events[:-1])
        assert events[-1]["done"] and events[-1]["finish"] == "length"
        assert events[-1]["tokens"] == [e["token"] for e in events[:-1]]
        it = eng.stream([1, 2, 3], max_new_tokens=28, timeout=WAIT_S)
        assert "token" in next(it)
        it.close()
        assert wait_until(lambda: eng.ring.free_slots == 1)
    finally:
        eng.shutdown()


def test_admission_sheds_no_slots_with_retry_after(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=1, queue_limit=2, max_seq=32),
        start=False)
    try:
        eng.submit([1], max_new_tokens=4)
        eng.submit([2], max_new_tokens=4)
        assert eng.ready() is False
        with pytest.raises(ShedError) as ei:
            eng.submit([3], max_new_tokens=4)
        assert ei.value.status == 429 and ei.value.retry_after_s > 0
        assert eng.status()["shed"] == {"no_slots": 1}
    finally:
        eng.shutdown()


def test_unready_sheds_503_and_invalid_inputs_are_400_class(nets):
    _, tn = nets
    eng = GenerationEngine(lambda: None, GenerationConfig(max_seq=32),
                           start=False)
    try:
        with pytest.raises(ShedError) as ei:
            eng.submit([1])
        assert ei.value.status == 503
        assert eng.status()["shed"] == {"unready": 1}
    finally:
        eng.shutdown()
    eng = GenerationEngine.for_model(tn, GenerationConfig(max_seq=32),
                                     start=False)
    try:
        for bad, kw in (([], {}), ([1], dict(max_new_tokens=0)),
                        ([1] * 30, dict(max_new_tokens=8)),
                        (["a", "b"], {})):
            with pytest.raises(InvalidInputError):
                eng.submit(bad, **kw)
    finally:
        eng.shutdown()


def test_decode_exception_fails_its_request_and_the_loop_survives(
        nets, monkeypatch):
    _, tn = nets
    orig = tn.generation_program
    fail = threading.Event()
    fail.set()

    def patched(kind):
        fn = orig(kind)
        if kind == "paged_decode" and fail.is_set():
            def boom(*a, **k):
                raise RuntimeError("injected decode fault")
            return boom
        return fn

    monkeypatch.setattr(tn, "generation_program", patched)
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=2, max_seq=32))
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=6, seed=9)
        with pytest.raises(RuntimeError, match="injected decode"):
            req.future.result(timeout=WAIT_S)
        rec = eng.last_decode_failure
        assert "injected decode fault" in rec["error"]
        occ = rec["occupancy"]
        assert occ["active"] == 1 and occ["max_slots"] == 2
        assert occ["paged"] is True
        events = [t["event"] for t in occ["trail"]]
        assert "block_alloc" in events
        assert any(t["event"] == "install" and t["request"] == req.id
                   for t in occ["trail"])
        assert req.id in " ".join(occ["occupants"].values())
        assert eng.status()["decode_errors"] == 1
        fail.clear()
        res = eng.generate([1, 2, 3], max_new_tokens=4, timeout=WAIT_S)
        assert res.finish == "length"
        assert eng.ring.active_slots == 0
    finally:
        eng.shutdown()


def test_hot_swap_migrates_without_mixing_versions(nets, monkeypatch):
    _, tn = nets
    net_b = params_from_jax(
        TransformerLM(**SMALL).init(device="cpu"),
        {k: {n: p.detach().numpy() * 1.07 for n, p in g.items()}
         for k, g in tn.params.items()})
    src = StaticSlotSource(tn)
    eng = GenerationEngine(
        src, GenerationConfig(max_slots=2, max_seq=32, block_size=4))
    parked, resume = threading.Event(), threading.Event()
    calls = {"n": 0}
    orig = tn.generation_program

    def gated(kind):
        fn = orig(kind)
        if kind != "paged_decode":
            return fn

        def stepped(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                parked.set()
                resume.wait(WAIT_S)
            return fn(*a, **kw)
        return stepped

    try:
        eng.warmup()
        eng.generate([3, 1, 4, 1, 5], max_new_tokens=2, timeout=WAIT_S)
        assert eng.ring.stats()["blocks_registered"] > 0
        monkeypatch.setattr(tn, "generation_program", gated)
        req = eng.submit([9, 2, 6], max_new_tokens=16, seed=5)
        assert parked.wait(WAIT_S)
        assert src.swap(net_b) == 2
        resume.set()
        res = req.future.result(timeout=WAIT_S)
        toks, vers = res.tokens, res.versions
        assert len(toks) == 16 and vers == sorted(vers)
        k = vers.index(2) if 2 in vers else len(toks)
        assert 0 < k < len(toks)
        assert toks[:k] == naive_greedy(tn, [9, 2, 6], k)
        assert toks[k:] == naive_greedy(net_b, [9, 2, 6] + toks[:k],
                                        len(toks) - k)
        assert any(t["event"] == "migrate" and t["request"] == req.id
                   for t in eng.ring.trail())
        assert eng.ring.stats()["blocks_registered"] <= 1
    finally:
        resume.set()
        eng.shutdown()


def test_exported_session_continues_bit_identically_elsewhere(nets):
    _, tn = nets
    kw = dict(max_new_tokens=12, temperature=0.9, top_k=8, seed=77)
    prompt = [6, 1, 6, 2]
    # engine a steps by hand (no decode thread): 1 prefill + 3 decodes;
    # its one slot keeps the second request in the join queue
    a = GenerationEngine.for_model(tn, GenerationConfig(max_slots=1,
                                                        max_seq=32),
                                   start=False)
    b = GenerationEngine.for_model(tn, GenerationConfig(max_slots=3,
                                                        max_seq=32))
    try:
        whole = b.generate(prompt, timeout=WAIT_S, **kw).tokens
        req = a.submit(prompt, **kw)
        queued = a.submit([1, 2], max_new_tokens=3)
        for _ in range(3):
            a._tick()
        assert len(req.out_tokens) == 4 and not req.future.done()
        states = a.export_sessions()
        assert [s_["tokens"] for s_ in states] == [whole[:4], []]
        for r in (req, queued):
            with pytest.raises(RuntimeError, match="exported"):
                r.future.result(timeout=WAIT_S)
        moved = b.import_session(states[0]).future.result(timeout=WAIT_S)
        assert moved.tokens == whole
        assert moved.versions == [1] * 12
        with pytest.raises(InvalidInputError):
            b.import_session({"prompt": [1]})
    finally:
        a.shutdown()
        b.shutdown()


def test_rewarm_during_active_decode_never_touches_live_kv(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=2, max_seq=32))
    try:
        eng.warmup()
        prompt = [3, 1, 4, 1]
        req = eng.submit(prompt, max_new_tokens=14)
        assert wait_until(lambda: len(req.out_tokens) >= 2)
        eng.warmup()
        res = req.future.result(timeout=WAIT_S)
        assert res.tokens == naive_greedy(tn, prompt, 14)
    finally:
        eng.shutdown()


def test_generate_timeout_cancels_and_frees_the_slot(nets):
    _, tn = nets
    eng = GenerationEngine.for_model(
        tn, GenerationConfig(max_slots=1, max_seq=32), start=False)
    try:
        with pytest.raises(FuturesTimeout):
            eng.generate([1, 2], max_new_tokens=4, timeout=0.05)
        eng._thread.start()
        assert wait_until(lambda: eng.queue_depth == 0)
        assert eng.ring is None or eng.ring.active_slots == 0
    finally:
        eng.shutdown()


# ------------------------------------------------------------- refusals
def _feed_forward_net():
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(JDense(n_out=4, activation="relu"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def test_refuses_a_feed_forward_stack_loudly():
    ff = _feed_forward_net()
    eng = GenerationEngine.for_model(ff, GenerationConfig(max_seq=16),
                                     start=False)
    try:
        with pytest.raises(ValueError, match="carry-capable"):
            eng.warmup()
    finally:
        eng.shutdown()
    eng = GenerationEngine.for_model(ff, GenerationConfig(max_seq=16))
    try:
        req = eng.submit([1, 2], max_new_tokens=2)
        with pytest.raises(ValueError, match="carry-capable"):
            req.future.result(timeout=WAIT_S)
    finally:
        eng.shutdown()


def test_refuses_moe_and_int8_kv_through_the_request(nets, monkeypatch):
    _, tn = nets
    monkeypatch.setattr(tatt.TransformerBlock, "AUX_LOSS", True,
                        raising=False)
    eng = GenerationEngine.for_model(tn, GenerationConfig(max_seq=32))
    try:
        req = eng.submit([1, 2], max_new_tokens=2)
        with pytest.raises(ValueError, match="row-independent"):
            req.future.result(timeout=WAIT_S)
    finally:
        eng.shutdown()
    monkeypatch.undo()
    # the int8 KV pool is ported (precision and memory slice): a request
    # through an int8-cache engine completes, and status reports the pool
    lm8 = TransformerLM(**SMALL).init(device="cpu")
    lm8.conf.defaults["precision"] = PrecisionPolicy(kv_dtype="int8")
    eng = GenerationEngine.for_model(lm8, GenerationConfig(max_seq=32))
    try:
        req = eng.submit([1, 2], max_new_tokens=2)
        out = req.future.result(timeout=WAIT_S)
        assert len(out.tokens) == 2
        assert eng.status()["kv"]["kv_dtype"] == "int8"
    finally:
        eng.shutdown()


def test_fresh_carry_capacity_forwarded_or_refused_loudly():
    block = tatt.TransformerBlock(n_in=8, n_heads=2, causal=True)
    carry = _fresh_carry(block, 2, 7, torch.device("cpu"))
    assert carry["k"].shape[2] == 7

    class LegacyKV:
        def init_carry(self, batch, dtype, device):
            return {"k": torch.zeros((batch, 2, 512, 4)),
                    "pos": torch.zeros((), dtype=torch.int32)}

    with pytest.raises(ValueError, match="ignored max_len"):
        _fresh_carry(LegacyKV(), 2, 64, torch.device("cpu"))


# --------------------------------------------------- serving integration
@pytest.mark.parametrize("as_dict", [False, True])
def test_serving_engine_generation(nets, as_dict):
    _, tn = nets
    cfg = dict(max_slots=2, max_seq=32, block_size=4)
    srv = ServingEngine(tn, device="cpu", max_batch_size=4,
                        generation=cfg if as_dict
                        else GenerationConfig(**cfg))
    try:
        assert srv.warmup() == len(srv.buckets) + len(
            srv.generation.buckets) + 1
        assert srv.ready()[0] is True
        prompt = [3, 1, 4]
        res = srv.generation.generate(prompt, max_new_tokens=6,
                                      timeout=WAIT_S)
        assert res.tokens == naive_greedy(tn, prompt, 6)
        assert res.versions == [1] * 6
        events = list(srv.generation.stream(prompt, max_new_tokens=6,
                                            timeout=WAIT_S))
        assert [e["token"] for e in events[:-1]] == res.tokens
        st = srv.generation_status()
        assert st["max_slots"] == 2 and st["warm"] is True
        assert srv.stats()["generation"]["kv"]["block_size"] == 4
        # the predict path is unchanged beside it
        row = np.eye(VOCAB, dtype=np.float32)[np.arange(32) % VOCAB]
        np.testing.assert_allclose(srv.predict(row),
                                   tn.output(row[None]).numpy()[0],
                                   atol=1e-6)
    finally:
        srv.shutdown()
    assert srv.ready()[0] is False and srv.slot is None
    plain = ServingEngine(tn, device="cpu", max_batch_size=4)
    try:
        assert plain.generation_status() is None and \
            plain.ready()[0] is True
    finally:
        plain.shutdown()
