"""The port's embedding steps (``nlp/elements.py``) and the threefry
``randint`` against the JAX package's, on inputs made with numpy from
seeds, on the CPU.

Tolerances:

* ``randint`` and ``split``: bit for bit with ``jax.random`` under x64
  off, including a span above 2**16 (there ``(2**16 mod span)**2`` wraps
  to 0 in uint32).
* The word2vec steps run on both ``_table_add`` branches (the module
  constant ``_DENSE_TABLE_MAX_V`` patched in both packages), JAX with x64
  off, f32 tables of entries up to ~1: the gathers and sigmoids are the
  same f32 ops, the dot products and duplicate sums run in other orders
  (XLA's dot vs torch's bmm; a one-hot product or a sorted scatter), a
  few f32 ulps per step over S = 4 steps: 2e-6 abs.  The negatives are
  the same bits, so the same rows train.
* GloVe at f64 tables (JAX's dtype under x64): ``log(xij)`` and the
  weight ``(xij / x_max) ** alpha`` are f32 on both sides and may differ
  by an f32 ulp (XLA's ``log``/``pow`` vs torch's), 6e-8 relative in the
  weight and 1.2e-7 in the squared gradients the AdaGrad histories sum
  (measured 1.24e-7): each table within 1e-6 of its largest entry, after
  one step and after 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import elements as je
from deeplearning4j_tpu_torch.nlp import elements as te
from deeplearning4j_tpu_torch.utils import _random as tr

V, D, B, K, C, S, W2 = 50, 8, 16, 3, 5, 4, 6
TOL_W2V = 2e-6
TOL_GLOVE = 1e-6


@pytest.fixture(params=["dense", "scatter"])
def branch(request, monkeypatch):
    """Both packages on one ``_table_add`` branch; the JAX step caches
    are cleared so the patched constant is traced."""
    if request.param == "scatter":
        monkeypatch.setattr(je, "_DENSE_TABLE_MAX_V", 0)
        monkeypatch.setattr(te, "_DENSE_TABLE_MAX_V", 0)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _tables(seed, n=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((V, D)) * 0.3).astype(dtype)
            for _ in range(n)]


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _check(j_out, t_out, tol):
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=tol)


def _rel_err(j_out, t_out):
    """max |port - jax| / max |jax| of the worst tensor."""
    return max(float(np.abs(b.numpy() - np.asarray(a)).max()
                     / max(np.abs(np.asarray(a)).max(), 1e-300))
               for a, b in zip(j_out, t_out))


def _labels(rng):
    """ctx, points/codes/code_mask, neg/neg_label/neg_mask of one batch;
    the last rows padded (mask 0), as the batcher emits them."""
    ctx = rng.integers(0, V, B).astype(np.int32)
    points = rng.integers(0, V, (B, C)).astype(np.int32)
    codes = rng.integers(0, 2, (B, C)).astype(np.float32)
    cmask = (rng.random((B, C)) < 0.8).astype(np.float32)
    cmask[-2:] = 0
    neg = rng.integers(0, V, (B, K + 1)).astype(np.int32)
    nl = np.zeros((B, K + 1), np.float32)
    nl[:, 0] = 1
    nm = (rng.random((B, K + 1)) < 0.9).astype(np.float32)
    nm[-2:] = 0
    return ctx, points, codes, cmask, neg, nl, nm


@pytest.mark.parametrize("span", [7, 5000, 65536, 100000, 2 ** 31 - 1])
def test_randint_is_jax_randint_bit_for_bit(span):
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(11)
        want = np.asarray(jax.random.randint(key, (3, 7), 2, span))
        keys = jax.random.split(jax.random.PRNGKey(5), S)
        want_rows = np.stack([np.asarray(jax.random.randint(
            k, (B, K), 0, span)) for k in keys])
        want_keys = np.asarray(keys)
    tkeys = tr.split(tr.prng_key(5), S)
    assert (tkeys.numpy() == want_keys.astype(np.int64)).all()
    got = tr.randint(tr.prng_key(11), (3, 7), 2, span)
    assert got.dtype == torch.int64
    assert (got.numpy() == want).all()
    assert (tr.randint(tkeys, (B, K), 0, span).numpy() == want_rows).all()


def test_randint_under_x64_is_another_stream():
    """The reason the tests run the JAX side with x64 off: x64 draws
    int64 from 64-bit words."""
    with jax.enable_x64(True):
        x64 = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 3),
                                            0, 100000))
    port = tr.randint(tr.prng_key(1), (2, 3), 0, 100000).numpy()
    assert not (x64 == port).all()


def test_table_add_matches_the_scatter(branch):
    rng = np.random.default_rng(1)
    tab = _tables(2, 1)[0]
    idx = rng.integers(0, V, (B, K + 1)).astype(np.int32)
    upd = rng.standard_normal((B, K + 1, D)).astype(np.float32)
    with jax.enable_x64(False):
        want = je._table_add(*_jax(tab, idx, upd))
    got = te._table_add(*_torch(tab), torch.from_numpy(idx).long(),
                        torch.from_numpy(upd))
    _check([want], [got], TOL_W2V)


def test_skipgram_step(branch):
    rng = np.random.default_rng(3)
    lab = _labels(rng)
    tabs = _tables(4)
    with jax.enable_x64(False):
        want = je.skipgram_step(*_jax(*tabs, *lab), np.float32(0.025))
    ctx, pts, cds, cm, neg, nl, nm = _torch(*lab)
    got = te.skipgram_step(*_torch(*tabs), ctx.long(), pts.long(), cds, cm,
                           neg.long(), nl, nm, float(np.float32(0.025)))
    _check(want, got, TOL_W2V)


def test_cbow_step(branch):
    rng = np.random.default_rng(5)
    lab = _labels(rng)
    ctxw = rng.integers(0, V, (B, W2)).astype(np.int32)
    cmask = (rng.random((B, W2)) < 0.7).astype(np.float32)
    tabs = _tables(6)
    with jax.enable_x64(False):
        want = je.cbow_step(*_jax(*tabs, ctxw, cmask, *lab[1:]),
                            np.float32(0.03))
    pts, cds, cm, neg, nl, nm = _torch(*lab[1:])
    got = te.cbow_step(*_torch(*tabs), torch.from_numpy(ctxw).long(),
                       torch.from_numpy(cmask), pts.long(), cds, cm,
                       neg.long(), nl, nm, float(np.float32(0.03)))
    _check(want, got, TOL_W2V)


def test_infer_step(branch):
    rng = np.random.default_rng(7)
    lab = _labels(rng)
    tabs = _tables(8, 2)
    vec = (rng.random(D).astype(np.float32) - 0.5) / D
    with jax.enable_x64(False):
        want = je.infer_step(*_jax(vec, *tabs, *lab[1:]), np.float32(0.02))
    pts, cds, cm, neg, nl, nm = _torch(*lab[1:])
    got = te.infer_step(torch.from_numpy(vec), *_torch(*tabs), pts.long(),
                        cds, cm, neg.long(), nl, nm, float(np.float32(0.02)))
    _check([want], [got], TOL_W2V)


def _block(rng):
    ctxs = rng.integers(0, V, (S, B)).astype(np.int32)
    cens = rng.integers(0, V, (S, B)).astype(np.int32)
    n_valids = np.array([B, B, B - 5, 3], np.int32)
    alphas = np.array([0.025, 0.02, 0.015, 0.01], np.float32)
    table = np.sort(rng.integers(0, V, 300)).astype(np.int32)
    return ctxs, cens, n_valids, alphas, table


def test_skipgram_steps_ns(branch):
    rng = np.random.default_rng(9)
    ctxs, cens, n_valids, alphas, table = _block(rng)
    tabs = _tables(10, 2)
    with jax.enable_x64(False):
        want = je.skipgram_steps_ns(
            *_jax(*tabs, table, ctxs, cens, n_valids),
            jax.random.PRNGKey(3), jnp.asarray(alphas), K)
    got = te.skipgram_steps_ns(*_torch(*tabs, table, ctxs, cens, n_valids),
                               tr.prng_key(3), torch.from_numpy(alphas), K)
    _check(want, got, TOL_W2V)


def test_cbow_steps_ns(branch):
    rng = np.random.default_rng(11)
    ctxs, cens, n_valids, alphas, table = _block(rng)
    ctxw = rng.integers(0, V, (S, B, W2)).astype(np.int32)
    cmask = (rng.random((S, B, W2)) < 0.7).astype(np.uint8)
    tabs = _tables(12, 2)
    with jax.enable_x64(False):
        want = je.cbow_steps_ns(
            *_jax(*tabs, table, ctxw, cmask, cens, n_valids),
            jax.random.PRNGKey(4), jnp.asarray(alphas), K)
    got = te.cbow_steps_ns(
        *_torch(*tabs, table, ctxw, cmask, cens, n_valids),
        tr.prng_key(4), torch.from_numpy(alphas), K)
    _check(want, got, TOL_W2V)


def _hs_tables(rng):
    pts = rng.integers(0, V, (V, C)).astype(np.int32)
    cds = rng.integers(0, 2, (V, C)).astype(np.uint8)
    msk = (rng.random((V, C)) < 0.8).astype(np.uint8)
    return pts, cds, msk


def test_skipgram_steps_hs(branch):
    rng = np.random.default_rng(13)
    ctxs, cens, n_valids, alphas, _ = _block(rng)
    hs = _hs_tables(rng)
    tabs = _tables(14, 2)
    with jax.enable_x64(False):
        want = je.skipgram_steps_hs(
            *_jax(*tabs, *hs, ctxs, cens, n_valids, alphas))
    pts, cds, msk = _torch(*hs)
    got = te.skipgram_steps_hs(*_torch(*tabs), pts.long(), cds, msk,
                               *_torch(ctxs, cens, n_valids, alphas))
    _check(want, got, TOL_W2V)


def test_cbow_steps_hs(branch):
    rng = np.random.default_rng(15)
    ctxs, cens, n_valids, alphas, _ = _block(rng)
    ctxw = rng.integers(0, V, (S, B, W2)).astype(np.int32)
    cmask = (rng.random((S, B, W2)) < 0.7).astype(np.uint8)
    hs = _hs_tables(rng)
    tabs = _tables(16, 2)
    with jax.enable_x64(False):
        want = je.cbow_steps_hs(
            *_jax(*tabs, *hs, ctxw, cmask, cens, n_valids, alphas))
    pts, cds, msk = _torch(*hs)
    got = te.cbow_steps_hs(*_torch(*tabs), pts.long(), cds, msk,
                           *_torch(ctxw, cmask, cens, n_valids, alphas))
    _check(want, got, TOL_W2V)


def _glove_inputs(rng, nb=None):
    shape = (B,) if nb is None else (nb, B)
    w = [(rng.random((V, D)) - 0.5) / D for _ in range(2)]
    b = [rng.standard_normal(V) * 0.01 for _ in range(2)]
    hist = [np.zeros((V, D)), np.zeros((V, D)), np.zeros(V), np.zeros(V)]
    rows = rng.integers(0, 10, shape).astype(np.int32)   # repeated rows
    cols = rng.integers(0, V, shape).astype(np.int32)
    xij = (rng.random(shape) * 150 + 0.2).astype(np.float32)
    return [*w, *b, *hist], rows, cols, xij


def _glove_hparams():
    return 0.05, 100.0, 0.75


@pytest.mark.parametrize("epoch", [False, True])
def test_glove_step_at_f64(branch, epoch):
    """A row repeated in the batch sees the history its repeats summed
    first (``hw.at[rows].add`` then ``hw[rows]``), in both packages."""
    rng = np.random.default_rng(17)
    tabs, rows, cols, xij = _glove_inputs(rng, 3 if epoch else None)
    lr, xm, ex = _glove_hparams()
    jfn, tfn = ((je.glove_epoch, te.glove_epoch) if epoch
                else (je.glove_step, te.glove_step))
    want = jfn(*_jax(*tabs, rows, cols, xij), jnp.float32(lr),
               jnp.float32(xm), jnp.float32(ex))
    assert np.asarray(want[0]).dtype == np.float64
    t = _torch(*tabs, rows, cols)
    got = tfn(*t[:8], t[8].long(), t[9].long(), torch.from_numpy(xij),
              *(float(np.float32(v)) for v in (lr, xm, ex)))
    assert _rel_err(want, got) <= TOL_GLOVE
