"""The port's threefry stream, token sampler, prefill ladders and latency
window held against the JAX package's on the same seeded inputs.

Threefry bits must equal ``jax.random.bits`` bit for bit; uniform draws
too; Gumbel noise agrees within 1e-6 (the last step is ``log``, rounded
by each library's own routine); ``sample_tokens`` must pick the same
tokens for greedy, temperature, top-k, top-p and mixed rows.  The
logits are scaled so no top-p boundary sits on an f32 tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.shapes import prefill_buckets as jax_prefill
from deeplearning4j_tpu.data.shapes import \
    suffix_prefill_buckets as jax_suffix
from deeplearning4j_tpu.generation.sampling import sample_tokens as jax_sample
from deeplearning4j_tpu.observability.quantiles import \
    LatencyWindow as JaxWindow
from deeplearning4j_tpu_torch.data.shapes import (prefill_buckets,
                                                  suffix_prefill_buckets)
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.generation.sampling import sample_tokens
from deeplearning4j_tpu_torch.observability.quantiles import LatencyWindow

GUMBEL_ATOL = 1e-6


def _keys(n, seed):
    k = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                             dtype=np.uint32)
    k[0] = (7, 3)
    k[1] = (0, 0)
    k[2] = (0xFFFFFFFF, 0xFFFFFFFF)
    return k


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_bits_of_the_published_key():
    got = _random.bits(_t([[7, 3]]), 4).tolist()[0]
    assert got == [771269580, 2590461243, 3066716433, 3196467460]


@pytest.mark.parametrize("n", [1, 4, 17, 1000, 8192])
def test_bits_and_uniform_equal_jax(n):
    keys = _keys(5, seed=n)
    want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                                jnp.uint32))
                     for k in keys]).astype(np.int64)
    np.testing.assert_array_equal(_random.bits(_t(keys), n).numpy(), want)
    tiny = float(np.finfo(np.float32).tiny)
    uw = np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(k), (n,), jnp.float32, minval=tiny)) for k in keys])
    np.testing.assert_array_equal(
        _random.uniform(_t(keys), n, tiny, 1.0).numpy(), uw)


@pytest.mark.parametrize("n", [17, 8192])
def test_gumbel_within_tolerance_of_jax(n):
    keys = _keys(6, seed=100 + n)
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,),
                                                  jnp.float32))
                     for k in keys])
    got = _random.gumbel(_t(keys), n).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=GUMBEL_ATOL, rtol=0)


def _sample_case(rows, vocab, seed, temp, top_k, top_p):
    rng = np.random.default_rng(seed)
    lp = (rng.standard_normal((rows, vocab)) * 3.0).astype(np.float32)
    keys = rng.integers(0, 2 ** 32, (rows, 2), dtype=np.uint32)
    args = (np.asarray(temp, np.float32), np.asarray(top_k, np.int32),
            np.asarray(top_p, np.float32))
    want = np.asarray(jax_sample(lp, keys, *args))
    got = sample_tokens(torch.from_numpy(lp), _t(keys),
                        *(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.int32
    return got.numpy(), want, lp


@pytest.mark.parametrize("case", ["greedy", "temperature", "top_k", "top_p",
                                  "mixed"])
def test_sample_tokens_equal_jax(case):
    rows, vocab = 48, 17
    rng = np.random.default_rng(3)
    temp = {"greedy": np.zeros(rows), "temperature": np.full(rows, 0.8),
            "top_k": np.full(rows, 1.2), "top_p": np.full(rows, 0.9),
            "mixed": rng.choice([0.0, 0.5, 0.9, 1.3], rows)}[case]
    top_k = {"top_k": np.full(rows, 4),
             "mixed": rng.choice([0, 1, 3, 5], rows)}.get(case,
                                                          np.zeros(rows))
    top_p = {"top_p": np.full(rows, 0.7),
             "mixed": rng.choice([1.0, 0.8, 0.5], rows)}.get(case,
                                                             np.ones(rows))
    got, want, lp = _sample_case(rows, vocab, 10 + len(case), temp, top_k,
                                 top_p)
    np.testing.assert_array_equal(got, want)
    if case == "greedy":
        np.testing.assert_array_equal(got, lp.argmax(-1))


def test_sample_tokens_equal_jax_at_full_vocab():
    rows = 16
    rng = np.random.default_rng(5)
    got, want, _ = _sample_case(rows, 8192, 21, rng.choice([0.0, 0.8], rows),
                                np.full(rows, 50), np.full(rows, 0.95))
    np.testing.assert_array_equal(got, want)


def test_sample_rows_are_independent_of_the_batch():
    rng = np.random.default_rng(4)
    lp = torch.from_numpy((rng.standard_normal((3, 17)) * 3)
                          .astype(np.float32))
    keys = _t(rng.integers(0, 2 ** 32, (3, 2), dtype=np.uint32))
    t = torch.tensor([0.8, 1.2, 0.0])
    k = torch.tensor([0, 5, 0], dtype=torch.int32)
    p = torch.tensor([0.9, 1.0, 1.0])
    full = sample_tokens(lp, keys, t, k, p)
    for i in range(3):
        alone = sample_tokens(lp[i:i + 1], keys[i:i + 1], t[i:i + 1],
                              k[i:i + 1], p[i:i + 1])
        assert int(alone[0]) == int(full[i])


def test_ties_break_toward_the_lower_index_as_jax():
    lp = np.zeros((2, 9), np.float32)
    lp[:, [2, 5, 7]] = 1.5
    keys = np.asarray([[1, 2], [3, 4]], np.uint32)
    args = (np.asarray([0.0, 1.0], np.float32), np.asarray([0, 2], np.int32),
            np.ones(2, np.float32))
    want = np.asarray(jax_sample(lp, keys, *args))
    got = sample_tokens(torch.from_numpy(lp), _t(keys),
                        *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 2


@pytest.mark.parametrize("max_len,block,ladder", [
    (256, 16, None), (48, 4, None), (8, 8, None), (4, 2, None),
    (512, 16, None), (64, 16, [32, 8, 8, 999]), (32, 4, None)])
def test_ladders_equal_jax(max_len, block, ladder):
    assert prefill_buckets(max_len, ladder) == jax_prefill(max_len, ladder)
    assert suffix_prefill_buckets(max_len, block, ladder) == \
        jax_suffix(max_len, block, ladder)


def test_ladder_refusals():
    with pytest.raises(ValueError):
        prefill_buckets(16, [999])
    with pytest.raises(ValueError):
        prefill_buckets(0)
    with pytest.raises(ValueError):
        suffix_prefill_buckets(16, 0)


def test_latency_window_equals_jax():
    rng = np.random.default_rng(9)
    mine, ref = LatencyWindow(64), JaxWindow(64)
    assert mine.snapshot() == ref.snapshot()
    for v in rng.exponential(1.0, 200):
        mine.observe(v)
        ref.observe(v)
    assert mine.snapshot() == ref.snapshot()
    assert len(mine) == len(ref) == 64 and mine.count == 200
    for q in (0.0, 0.5, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q)
