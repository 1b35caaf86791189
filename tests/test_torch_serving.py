"""The port's ServingEngine on the CPU: mixed-size requests come back equal
to ``model.output``, batches are padded to the bucket ladder, and
admission sheds past ``queue_limit``."""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.shapes import serving_buckets as jax_buckets
from deeplearning4j_tpu_torch.data.shapes import serving_buckets
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.parallel.inference import InvalidInputError
from deeplearning4j_tpu_torch.serving.engine import (AdmissionController,
                                                     ServingEngine, ShedError,
                                                     _pad_rows_np)

VOCAB, SEQ = 16, 128
# rows may share a batch with other requests' rows, and CPU matmuls of
# other batch sizes sum in another order: measured over every bucket
# composition of these rows at 1-8 intra-op threads, the largest
# difference is 1.2e-7 (test_bucket_compositions_stay_within_atol)
ATOL = 1e-6
WAIT_S = 30.0


@pytest.fixture(scope="module")
def model():
    # one block of one 64-wide head: the flash path at t = 128
    return TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=64,
                         n_layers=1, n_heads=1).init(device="cpu")


def _rows(n, seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (n, SEQ))
    return np.eye(VOCAB, dtype=np.float32)[ids]


@pytest.fixture
def engine(model):
    eng = ServingEngine(model, device="cpu", max_batch_size=8)
    yield eng
    eng.shutdown()


@pytest.mark.parametrize("max_batch,ladder", [(1, None), (8, None),
                                              (12, None), (8, [4, 2, 2])])
def test_serving_buckets_match_reference(max_batch, ladder):
    assert serving_buckets(max_batch, ladder) == jax_buckets(max_batch,
                                                            ladder)


MIXED_SIZES = [1, 3, 5, 8, 2]


def test_mixed_size_requests_equal_model_output(model, engine, monkeypatch):
    requests = [_rows(n, seed) for seed, n in enumerate(MIXED_SIZES)]
    served = []             # (padded batch, served rows) per dispatch
    real = engine._forward

    def spy(batch, slot):
        out = real(batch, slot)
        served.append((batch.copy(), out.copy()))
        return out

    monkeypatch.setattr(engine, "_forward", spy)
    results = [None] * len(requests)
    errors = [None] * len(requests)

    def call(i):
        try:
            results[i] = engine.predict(requests[i], timeout=WAIT_S)
        except BaseException as e:     # re-raised below, with its cause
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    for e in errors:
        if e is not None:
            raise e
    for x, y in zip(requests, results):
        want = model.output(x).numpy()
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, atol=ATOL, rtol=0)
        # each row against the model's output on the batch it was
        # actually served in (the same rows in the same order)
        for row, got in zip(x, y):
            hits = [(b, i) for b, _ in served
                    for i in np.flatnonzero((b == row).all(axis=(1, 2)))]
            assert hits, "a served row is in no dispatched batch"
            b, i = hits[0]
            np.testing.assert_allclose(got, model.output(b).numpy()[i],
                                       atol=ATOL, rtol=0)
    single = engine.predict(requests[0][0])
    np.testing.assert_allclose(single, model.output(requests[0]).numpy()[0],
                               atol=ATOL, rtol=0)
    st = engine.stats()
    assert st["rows_served"] == sum(MIXED_SIZES) + 1
    assert 1 <= st["batches_dispatched"] <= sum(MIXED_SIZES) + 1


@pytest.mark.parametrize("threads", [1, 3, 6])
def test_bucket_compositions_stay_within_atol(model, threads):
    """The reproduction of the mixed-size test's suspect: the same rows
    in every bucket of the ladder, in shuffled compositions, against each
    request's own output."""
    rows = np.concatenate([_rows(n, s) for s, n in enumerate(MIXED_SIZES)])
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        alone = np.concatenate([model.output(_rows(n, s)).numpy()
                                for s, n in enumerate(MIXED_SIZES)])
        worst = 0.0
        rng = np.random.default_rng(threads)
        for _ in range(4):
            perm = rng.permutation(len(rows))
            for bucket in (1, 2, 4, 8):
                for i in range(0, len(perm), bucket):
                    idx = perm[i:i + bucket]
                    out = model.output(_pad_rows_np(rows[idx], bucket))
                    worst = max(worst, float(np.abs(
                        out.numpy()[:len(idx)] - alone[idx]).max()))
    finally:
        torch.set_num_threads(saved)
    assert worst <= ATOL, worst


def test_batches_pad_to_buckets(engine, monkeypatch):
    seen = []
    real = engine._forward

    def spy(batch, slot):
        seen.append(len(batch))
        return real(batch, slot)

    monkeypatch.setattr(engine, "_forward", spy)
    assert engine.warmup() == len(engine.buckets)
    assert seen == engine.buckets == [1, 2, 4, 8]
    seen.clear()
    out = engine.predict(_rows(3, 7))
    assert out.shape == (3, SEQ, VOCAB)
    assert seen and all(n in engine.buckets for n in seen)
    padded = _pad_rows_np(_rows(3, 7), 4)
    np.testing.assert_array_equal(padded[3], padded[2])


def test_admission_sheds_past_queue_limit(model):
    adm = AdmissionController(queue_limit=4)
    with pytest.raises(ShedError) as e:
        adm.admit(5, 0)
    assert e.value.status == 429 and adm.shed == 1
    adm.admit(4, 0)
    eng = ServingEngine(model, device="cpu", max_batch_size=2,
                        queue_limit=4)
    try:
        with pytest.raises(ShedError):
            eng.predict(_rows(5, 1))
        assert eng.stats()["shed"] == 1
        assert eng.predict(_rows(4, 2)).shape == (4, SEQ, VOCAB)
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.predict(_rows(1, 3))


def test_bad_feature_shape_is_a_client_error(engine):
    with pytest.raises(InvalidInputError):
        engine.predict(np.zeros((2, SEQ, VOCAB + 1), np.float32))
    with pytest.raises(InvalidInputError):
        engine.predict(np.zeros((2, SEQ - 1, VOCAB), np.float32))


def test_engine_and_model_device_must_agree(model):
    with pytest.raises(ValueError, match="model is on"):
        ServingEngine(model, device="meta")
