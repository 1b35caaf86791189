"""The port's fused BatchNorm apply (the kernel's plain version on the CPU)
against the JAX package's Pallas kernel run in interpret mode, and the
kernel rule ``supports`` against the JAX package's.

The CUDA kernel (``csrc/bn_apply.cu``) is held against the plain version
on the card by ``chip_smoke.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.normalization import \
    _bn_train_norm as jax_bn_train_norm
from deeplearning4j_tpu.ops import pallas_bn as jbn
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.ops import pallas_bn as tbn

EPS = 1e-5
# f32 on both sides with the same formulas.  The statistics are sums over
# 32 rows of |x| <~ 7 in another order: within 5e-7 abs (a few ulps of
# the mean's scale, measured 1.2e-7) plus 1e-6 relative (measured 3e-7
# on var ~4); scale, shift and y (|y| <~ 5) then move by a few ulps:
# 2e-6 abs.  The gradients sum over the 32 rows again and reach |g| ~ 10:
# 1e-5 abs.
ATOL_Y, ATOL_STATS, RTOL_STATS, ATOL_GRAD = 2e-6, 5e-7, 1e-6, 1e-5


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4, 2, c)).astype(np.float32) * 2.0 + 0.5
    g = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_bn_act_train_matches_pallas_interpret(c, act):
    x, g, b, dy = _inputs(c, c + (act == "relu"))
    assert tbn.supports(activation=act, shape=x.shape)
    assert jbn.supports(activation=act, shape=x.shape)

    def jax_fused(x_, g_, b_):
        return jbn.bn_act_train(x_, g_, b_, EPS, act, True)

    jy, jmean, jvar = jax_fused(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b))
    jgrads = jax.grad(lambda *a: jnp.sum(jax_fused(*a)[0] * dy),
                      (0, 1, 2))(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b))
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    ty, tmean, tvar = tbn.bn_act_train(tx, tg, tb, EPS, act)
    assert not tmean.requires_grad and not tvar.requires_grad
    tgrads = torch.autograd.grad((ty * torch.tensor(dy)).sum(), (tx, tg, tb))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL_Y, rtol=0)
    for got, want in ((tmean, jmean), (tvar, jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_STATS, rtol=RTOL_STATS)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("act", ["relu", "identity"])
def test_unfused_path_matches_jax(act):
    """``_bn_train_norm`` and its hand-derived backward, the path every
    shape outside ``supports`` takes."""
    x, g, b, dy = _inputs(96, 7)

    def ref(x_, g_, b_):
        y, _, _ = jax_bn_train_norm(x_, g_, b_, EPS)
        return jnp.maximum(y, 0) if act == "relu" else y

    jy = ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    jgrads = jax.grad(lambda *a: jnp.sum(ref(*a) * dy), (0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    ty, _, _ = tnorm.bn_train_norm(tx, tg, tb, EPS)
    if act == "relu":
        ty = torch.relu(ty)
    tgrads = torch.autograd.grad((ty * torch.tensor(dy)).sum(), (tx, tg, tb))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL_Y, rtol=0)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_GRAD, rtol=0)


def test_stats_are_one_pass_biased_and_clamped():
    # a constant channel: E[x²] − E[x]² may round below 0; it is clamped
    x = torch.full((16, 2), 3.1, dtype=torch.float32)
    x[:, 1] = torch.arange(16, dtype=torch.float32)
    mean, var, inv = tnorm._bn_stats(x, EPS)
    assert var[0].item() == 0.0 or var[0].item() > 0
    np.testing.assert_allclose(var[1].item(), np.var(np.arange(16)),
                               rtol=1e-6)      # biased: / n, not / (n − 1)
    np.testing.assert_allclose(inv.numpy(), 1 / np.sqrt(var.numpy() + EPS),
                               rtol=1e-6)


SHAPES = [(4, 4, 2, 64), (8, 128), (8, 96), (3, 64), (4, 3, 2, 64),
          (16, 64), (2048, 2048), (2, 1, 1, 2048), (4, 2, 2, 1024),
          (64, 112, 112, 64), (64, 7, 7, 2048), (1, 32), (5, 24), (128,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_supports_is_the_jax_rule(shape):
    for act, itemsize in itertools.product(
            ("relu", "identity", "tanh"), (2, 4, 8)):
        assert tbn.supports(activation=act, shape=shape,
                            itemsize=itemsize) == \
            jbn.supports(activation=act, shape=shape, itemsize=itemsize)
    assert tbn._lane_geometry(shape) == jbn._lane_geometry(shape)


def test_supports_cases():
    assert tbn.supports(activation="relu", shape=(4, 4, 2, 64))
    assert not tbn.supports(activation="tanh", shape=(8, 128))
    assert not tbn.supports(activation="relu", shape=(8, 96))
    assert not tbn.supports(activation="relu", shape=(3, 64))
    assert not tbn.supports(activation="relu", shape=(4, 3, 2, 64))
    assert tbn.supports(activation="relu", shape=(16, 64))
    assert tbn._tile_m(2048, 2048, 4) == 512
    with pytest.raises(ValueError, match="activation"):
        tbn.bn_act_train(torch.zeros(8, 128), torch.ones(128),
                         torch.zeros(128), EPS, "tanh")


def test_plain_apply_rounds_once():
    """bf16 input: the plain version computes in f32 and rounds once, as
    the kernel does (f32 FMA, one rounding to bf16)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((64, 32)), dtype=torch.bfloat16)
    s = torch.tensor(rng.standard_normal(32), dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal(32), dtype=torch.bfloat16)
    want = torch.relu(x.double() * s.double() + b.double()).to(torch.bfloat16)
    got = tbn.bn_apply(x, s, b, True)
    assert got.dtype == torch.bfloat16
    # f32 and f64 products of bf16 inputs are exact; one rounding of the
    # sum can differ from f64's only on a tie: 1 bf16 ulp at most
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().clamp(
        min=2 ** -126))) - 7)
    assert ((got.float() - want.float()).abs() <= ulp).all()


def test_kernel_door_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8, 64)
    ok = torch.zeros(64)
    tbn._check_kernel_inputs(x, ok, ok)
    bad = [((x.transpose(0, 1), ok, ok), "channels last"),
           ((x.double(), ok.double(), ok.double()), "float32 or bfloat16"),
           ((x, torch.zeros(32), ok), "scale"),
           ((x, ok, ok.to(torch.bfloat16)), "shift"),
           ((torch.zeros(2, tbn.max_channels(4) + 1),
             torch.zeros(tbn.max_channels(4) + 1),
             torch.zeros(tbn.max_channels(4) + 1)), "channels")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tbn._check_kernel_inputs(*args)
    # a tensor that is neither on the CPU nor on CUDA has no kernel
    meta = torch.zeros(8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tbn.bn_apply(meta, torch.zeros(64, device="meta"),
                     torch.zeros(64, device="meta"), False)
    assert tbn.launches["bn_apply"] == 0


@pytest.mark.parametrize("itemsize,dtype", [(4, torch.float32),
                                             (2, torch.bfloat16)])
def test_kernel_door_admits_every_shape_supports_admits(itemsize, dtype):
    """Where ``supports`` sends a BatchNormalization to the fused path,
    the kernel door takes it: every C the reference's rule admits at this
    itemsize, up to the widest (131,072 f32, 262,144 bf16, one 8-row tile
    within ``_tile_m``'s budget), passes ``_check_kernel_inputs``; one step
    of 128 channels beyond the widest, ``supports`` and the door refuse it
    alike."""
    widest = tbn.max_channels(itemsize)
    assert widest == {4: 131072, 2: 262144}[itemsize]
    assert tbn._tile_m(8, widest, itemsize) == 8
    assert tbn._tile_m(8, widest + 128, itemsize) is None
    channels = [1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 384, 2048, 29056 + 128,
                32768, widest // 2, widest - 128, widest]
    for c in channels:
        for m in (8, 64, 4096):
            if not tbn.supports(activation="relu", shape=(m, c),
                                itemsize=itemsize):
                continue
            x = torch.empty((m, c), dtype=dtype)
            scale = torch.empty(c, dtype=dtype)
            tbn._check_kernel_inputs(x, scale, scale)
    assert tbn.supports(activation="relu", shape=(64, widest),
                        itemsize=itemsize)
    beyond = widest + 128
    assert not tbn.supports(activation="relu", shape=(64, beyond),
                            itemsize=itemsize)
    x, scale = torch.empty((8, beyond), dtype=dtype), torch.empty(
        beyond, dtype=dtype)
    with pytest.raises(ValueError, match="channels"):
        tbn._check_kernel_inputs(x, scale, scale)


def _resnet50_geometries():
    """{(rows, channels, activation): layers} of ResNet50's BatchNorms at
    batch 64, as chip_smoke drives them."""
    from chip_smoke import bn_geometries
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    return bn_geometries(ResNet50().conf(), 64)


def _walk(p, m, c):
    """The kernel's index walk (csrc/bn_apply.cu ``bn_apply_kernel``) for
    every thread of plan ``p`` at once: returns, per row vector of the
    ``[m, c]`` view, how often it was visited and the row-vector channel
    index it was given."""
    row_vecs = c // p.vec
    n_vec = m * row_vecs
    stride = p.grid * tbn.THREADS
    v = np.arange(stride, dtype=np.int64)
    cv = v % row_vecs
    step = stride % row_vecs
    seen = np.zeros(n_vec, dtype=np.int64)
    chan = np.full(n_vec, -1, dtype=np.int64)

    live = v < n_vec
    while live.any():       # rounds of UNROLL vectors, the last predicated
        for u in range(tbn.UNROLL):
            idx = v + u * stride
            ok = live & (idx < n_vec)
            np.add.at(seen, idx[ok], 1)
            chan[idx[ok]] = cv[ok]
            if not p.fixed:                  # the rolling channel index
                cv[live] += step
                cv[live] -= np.where(cv[live] >= row_vecs, row_vecs, 0)
        v[live] += tbn.UNROLL * stride
        live = v < n_vec
    return seen, chan


def _plan_cases():
    geo = sorted(_resnet50_geometries())
    assert len(geo) == 9
    cases = [(m, c, True) for m, c, _ in geo]
    # ragged: tiny C, C not a multiple of the vector width, a wide C that
    # is not a multiple of 128, a C that no resident grid divides (the
    # rolling channel index), and the widest C the door takes in f32 and
    # in bf16 (each walked at both itemsizes)
    cases += [(1000, 3, False), (777, 100, False), (513, 102, False),
              (300, 36, False), (40, 29056, False),
              (3000, 4229, False), (64, 32768, False),
              (8, tbn.max_channels(4), False),
              (8, tbn.max_channels(2), False)]
    return cases


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("m,c,resnet", _plan_cases())
def test_plan_walk_visits_every_vector_once_with_its_channel(m, c, resnet,
                                                             itemsize):
    sms = 132
    p = tbn.plan(m, c, itemsize, sms)
    assert 1 <= p.grid <= sms * tbn.BLOCKS_PER_SM       # one resident wave
    assert p.vec == (16 // itemsize if c % (16 // itemsize) == 0 else 1)
    row_vecs = c // p.vec
    stride = p.grid * tbn.THREADS
    # fixed exactly where a resident grid makes the stride whole rows
    assert p.fixed == (row_vecs // np.gcd(row_vecs, tbn.THREADS)
                       <= sms * tbn.BLOCKS_PER_SM)
    if p.fixed:
        assert stride % row_vecs == 0
    if resnet:
        assert p.fixed          # every ResNet50 geometry keeps its channels
    # the walk at a reduced m: a few strides of each thread, ragged
    m_walk = min(m, 3 * stride * tbn.UNROLL // row_vecs + 7)
    seen, chan = _walk(p, m_walk, c)
    assert (seen == 1).all()
    assert (chan == np.arange(m_walk * row_vecs) % row_vecs).all()


def test_plan_falls_back_to_single_elements_and_rolls_where_it_must():
    assert tbn.plan(1024, 64, 4, 132, aligned=False).vec == 1
    assert tbn.plan(1024, 64, 2, 132).vec == 8
    # 4229 single elements: no grid of <= 528 blocks of 256 threads has a
    # stride that is a multiple of 4229
    p = tbn.plan(3000, 4229, 4, 132)
    assert p.vec == 1 and not p.fixed and p.grid == 132 * tbn.BLOCKS_PER_SM
    # small tensors get fewer blocks, so each thread has UNROLL vectors
    p = tbn.plan(64, 256, 4, 132)
    assert p.fixed and p.grid == 4
