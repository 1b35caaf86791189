"""The port's threefry key stream and dropout configurations against
``jax.random`` and the JAX package's ``nn/conf/dropout.py``.

The port reproduces the production stream: x64 off, float32 uniforms.
The test conftest turns x64 on, and under it ``jax.random.bernoulli``
with a Python-float p draws float64 uniforms (other masks), so the JAX
side of every draw here runs under ``jax.enable_x64(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.utils import _random, serde

SEEDS = [0, 7, 123, 12345, 2 ** 31 + 5]
SHAPES = [(7,), (3, 5), (129,), (2, 3, 5, 7), (4, 1, 9, 3)]
# normal: sqrt(2)·erfinv(u) on the same float32 u; torch's erfinv and
# XLA's erf_inv are different float32 approximations, a few ulps apart
# (measured <= 8e-7 abs at |z| <= 4).  In the tails erfinv's slope grows
# (u within 2**-23 of ±1 gives |z| ~ 5.3), so the bound is relative there.
ATOL_NORMAL, RTOL_NORMAL = 2e-6, 1e-5


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_are_bit_equal(seed):
    k, tk = jax.random.PRNGKey(seed), _random.prng_key(seed)
    np.testing.assert_array_equal(_np(tk), np.asarray(k).astype(np.int64))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(
            _np(_random.split(tk, n)),
            np.asarray(jax.random.split(k, n)).astype(np.int64))
    for d in (0, 1, 7, 9, 10_000, 10_003, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _np(_random.fold_in(tk, d)),
            np.asarray(jax.random.fold_in(k, d)).astype(np.int64))
    # the fit step's succession: rng, key = split(rng), three times
    jr, tr = k, tk
    for _ in range(3):
        jr, jkey = jax.random.split(jr)
        tr, tkey = _random.split(tr)
        np.testing.assert_array_equal(_np(tkey),
                                      np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_and_bernoulli_are_bit_equal(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = _random.fold_in(_random.prng_key(seed), 3)
    np.testing.assert_array_equal(
        _np(_random.random_bits(tk, shape)),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(_np(_random.uniform(tk, shape)),
                                  np.asarray(jax.random.uniform(k, shape)))
    for p in (0.4, 0.5, 0.9, 0.95):
        np.testing.assert_array_equal(
            _np(_random.bernoulli(tk, p, shape)),
            np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_agrees_within_erfinv_rounding(shape):
    k, tk = jax.random.PRNGKey(11), _random.prng_key(11)
    np.testing.assert_allclose(_np(_random.normal(tk, shape)),
                               np.asarray(jax.random.normal(k, shape)),
                               atol=ATOL_NORMAL, rtol=RTOL_NORMAL)


def test_the_x64_stream_differs_as_recorded():
    """Under x64, JAX's bernoulli of a Python-float p draws float64
    uniforms: the masks differ from the production (x64 off) ones the
    port reproduces.  Recorded in ROADMAP.md queue 3, "Not faults"."""
    tk = _random.prng_key(123)
    with jax.enable_x64(True):
        m64 = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(123), 0.5,
                                              (8,)))
    got = _np(_random.bernoulli(tk, 0.5, (8,)))
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.bernoulli(jax.random.PRNGKey(123), 0.5,
                                             (8,))))
    assert not np.array_equal(got, m64)


def _pair(name, **kw):
    return getattr(jdrop, name)(**kw), getattr(tdrop, name)(**kw)


@pytest.mark.parametrize("shape", SHAPES[:4])
@pytest.mark.parametrize("name,kw", [("Dropout", {"p": 0.5}),
                                     ("Dropout", {"p": 0.9}),
                                     ("AlphaDropout", {"p": 0.95}),
                                     ("AlphaDropout", {"p": 0.8})])
def test_dropout_and_alpha_dropout_are_bit_equal(name, kw, shape):
    jd, td = _pair(name, **kw)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    key, tkey = jax.random.PRNGKey(5), _random.prng_key(5)
    want = np.asarray(jd.apply(key, jnp.asarray(x)))
    got = _np(td.apply(tkey, torch.tensor(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [("GaussianDropout", {"rate": 0.3}),
                                     ("GaussianNoise", {"stddev": 0.2})])
def test_gaussian_dropout_and_noise_agree_within_tolerance(name, kw):
    """x·(1 + std·z) and x + stddev·z: z within the normal's tolerance,
    scaled by at most std·|x| (|x| <= ~4)."""
    jd, td = _pair(name, **kw)
    x = np.random.default_rng(2).standard_normal((6, 33)).astype(np.float32)
    key, tkey = jax.random.PRNGKey(9), _random.prng_key(9)
    want = np.asarray(jd.apply(key, jnp.asarray(x)))
    got = _np(td.apply(tkey, torch.tensor(x)))
    np.testing.assert_allclose(got, want, atol=4 * ATOL_NORMAL,
                               rtol=RTOL_NORMAL)


def test_resolve_and_serde_read_the_jax_dropout_json():
    assert tdrop.resolve(None) is None
    assert tdrop.resolve(1.0) is None and tdrop.resolve(0.0) is None
    assert tdrop.resolve(0.4) == tdrop.Dropout(0.4)
    g = tdrop.GaussianNoise(0.3)
    assert tdrop.resolve(g) is g
    from deeplearning4j_tpu.utils import serde as jserde
    for obj in (jdrop.Dropout(0.7), jdrop.AlphaDropout(0.9),
                jdrop.GaussianDropout(0.2), jdrop.GaussianNoise(0.05)):
        back = serde.from_json(jserde.to_json(obj))
        assert type(back).__name__ == type(obj).__name__
        assert vars(back) == vars(obj)


def test_draws_run_on_the_key_device():
    tk = _random.prng_key(3, device="meta")
    assert _random.split(tk).device.type == "meta"
    assert _random.bernoulli(tk, 0.5, (4,)).device.type == "meta"
