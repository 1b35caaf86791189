"""The port's LSTM recurrence (the kernel's plain version on the CPU)
against the JAX package's Pallas kernel run in interpret mode, its
gradients against the VJP of the reference's scan, the kernel rule
``supports`` against the JAX package's, and the launch planner.

The CUDA kernel (``csrc/lstm_fwd.cu``) is held against the plain version
on the card by ``chip_smoke.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_lstm as jpl
from deeplearning4j_tpu_torch.ops import pallas_lstm as tpl

# Both sides run f32 with the same formulas; the h-term sums (h <= 40
# terms of |h·U| <~ 0.3) differ only in order, a few f32 ulps per step
# (measured <= 2.4e-7 over 16 steps): 2e-6 abs on ys, hT and cT.
ATOL_FWD = 2e-6
# Gradients through up to 16 steps, summed over batch and time (|g| up to
# ~10): 2e-6 of the largest |g| of each input plus 1e-7 abs.
RTOL_GRAD, ATOL_GRAD = 2e-6, 1e-7

# (batch, t, f, h, nonzero initial state): ragged batch, h not a multiple
# of 32, t = 1, batch 1
SHAPES = [(5, 6, 4, 12, True), (3, 16, 26, 16, False), (2, 8, 7, 40, True),
          (4, 1, 5, 12, True), (1, 3, 3, 33, False)]


def _inputs(b, t, f, h, nonzero, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    W = (rng.standard_normal((f, 4 * h)) * (2 / (f + 4 * h)) ** 0.5
         ).astype(np.float32)
    U = (rng.standard_normal((h, 4 * h)) * (2 / (5 * h)) ** 0.5
         ).astype(np.float32)
    bias = (0.1 * rng.standard_normal(4 * h)).astype(np.float32)
    scale = 0.5 if nonzero else 0.0
    h0 = (scale * rng.standard_normal((b, h))).astype(np.float32)
    c0 = (scale * rng.standard_normal((b, h))).astype(np.float32)
    return x, W, U, bias, h0, c0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}t{}f{}h{}".format(
    *s[:4]))
def test_forward_matches_pallas_interpret(shape):
    args = _inputs(*shape, seed=sum(shape[:4]))
    jys, jhT, jcT = jpl.lstm_forward(*(jnp.asarray(a) for a in args),
                                     interpret=True)
    tys, thT, tcT = tpl.lstm_forward(*(torch.from_numpy(a) for a in args))
    b, t, _, h, _ = shape
    assert tys.shape == (b, t, h) and thT.shape == tcT.shape == (b, h)
    for got, want in ((tys, jys), (thT, jhT), (tcT, jcT)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL_FWD, rtol=0)
    # the last step's h is hT
    np.testing.assert_array_equal(tys[:, -1].numpy(), thT.numpy())
    assert tpl.launches["lstm_fwd"] == 0        # the CPU takes the plain path


@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "b{}t{}f{}h{}".format(*s[:4]))
def test_fast_gradients_match_the_scan_vjp(shape):
    args = _inputs(*shape, seed=7 + sum(shape[:4]))
    b, t, _, h, _ = shape
    rng = np.random.default_rng(11)
    gys = rng.standard_normal((b, t, h)).astype(np.float32)
    ghT = rng.standard_normal((b, h)).astype(np.float32)
    gcT = rng.standard_normal((b, h)).astype(np.float32)
    _, vjp = jax.vjp(jpl._scan_impl, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(gys), jnp.asarray(ghT), jnp.asarray(gcT)))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    outs = tpl.lstm_forward_fast(*leaves)
    got = torch.autograd.grad(outs, leaves, (torch.from_numpy(gys),
                                             torch.from_numpy(ghT),
                                             torch.from_numpy(gcT)))
    for name, g, w in zip(("x", "W", "U", "b", "h0", "c0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=name,
                                   atol=RTOL_GRAD * np.abs(w).max()
                                   + ATOL_GRAD)


def test_fast_backward_differentiates_only_what_needs_it():
    x, W, U, bias, h0, c0 = (torch.from_numpy(a) for a in
                             _inputs(2, 4, 3, 8, True, seed=3))
    W.requires_grad_(True)
    ys, hT, cT = tpl.lstm_forward_fast(x, W, U, bias, h0, c0)
    (g,) = torch.autograd.grad(ys.sum(), (W,))
    ref = tpl.lstm_forward_plain(x, W, U, bias, h0, c0)[0]
    (want,) = torch.autograd.grad(ref.sum(), (W,))
    np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-7, rtol=0)
    # hT and cT unused: their cotangents are zeros, not an error
    assert hT.requires_grad and cT.requires_grad


def test_zero_steps_return_the_initial_state():
    x, W, U, bias, h0, c0 = (torch.from_numpy(a) for a in
                             _inputs(2, 1, 3, 8, True, seed=4))
    ys, hT, cT = tpl.lstm_forward_plain(x[:, :0], W, U, bias, h0, c0)
    assert ys.shape == (2, 0, 8)
    assert torch.equal(hT, h0) and torch.equal(cT, c0)


@pytest.mark.parametrize("peepholes,masked", list(itertools.product(
    (False, True), (False, True))))
def test_supports_is_the_jax_rule(peepholes, masked):
    for gate, act in itertools.product(("sigmoid", "hardsigmoid", "tanh"),
                                       ("tanh", "identity", "relu",
                                        "sigmoid")):
        kw = dict(peepholes=peepholes, gate_activation=gate, activation=act,
                  masked=masked)
        assert tpl.supports(**kw) == jpl.supports(**kw), kw
    assert tpl.supports(peepholes=False, gate_activation="sigmoid",
                        activation="tanh", masked=False)


def test_kernel_door_refuses_what_the_kernel_does_not_take(monkeypatch):
    x, W, U, bias, h0, c0 = (torch.from_numpy(a) for a in
                             _inputs(3, 4, 5, 8, True, seed=5))
    tpl._check_kernel_inputs(x, W, U, bias, h0, c0)
    bad = [((x[0], W, U, bias, h0, c0), r"\[batch, t, f\]"),
           ((x[:, :0], W, U, bias, h0, c0), "t >= 1"),
           ((x, W.double(), U, bias, h0, c0), "W must be float32"),
           ((x, W[:-1], U, bias, h0, c0), "W must be"),
           ((x, W, U, bias[:-1], h0, c0), "b must be"),
           ((x, W, U.t().contiguous().t(), bias, h0, c0), "U must be"),
           ((x, W, U, bias, h0[:2], c0), "h0 must be")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tpl._check_kernel_inputs(*args)
    c_nc = torch.zeros(8, 3).t()
    with pytest.raises(ValueError, match="c0 must be contiguous"):
        tpl._check_kernel_inputs(x, W, U, bias, h0, c_nc)

    # a tensor that is neither on the CPU nor on CUDA has no kernel, and
    # the door never falls back to the plain version
    def no_plain(*a):
        raise AssertionError("the door fell back to the plain version")

    monkeypatch.setattr(tpl, "lstm_forward_plain", no_plain)
    meta = [a.to("meta") for a in (x, W, U, bias, h0, c0)]
    with pytest.raises(ValueError, match="no kernel"):
        tpl.lstm_forward(*meta)
    assert tpl.launches["lstm_fwd"] == 0


# ------------------------------------------------------------------ planner
H100_SMS, H100_OPTIN = 132, 232448


def _h100_blocks_per_sm(rb, threads, smem):
    """Occupancy as the card reports it for this kernel: 228 KB of shared
    memory per SM with 1 KB reserved per block, 64K registers (the
    ptxas report: 45, 48 and 64 registers for rb 1, 2, 4, allocated per
    warp in units of 256), at most 2048 threads."""
    if smem > H100_OPTIN:
        return 0
    regs = {1: 48, 2: 48, 4: 64}[rb] * threads
    return min(233472 // (smem + 1024), 65536 // regs, 2048 // threads, 32)


@pytest.mark.parametrize("h", [1, 12, 100, 256, 512, 1000, 1024])
def test_planner_covers_the_door_on_an_h100(h):
    """Every h up to 1024, batch 1 to 128, t 1 to 256 gets a launch whose
    CTAs are all resident, cover every unit and row, and fit their
    shared memory."""
    for b, t in itertools.product((1, 5, 16, 32, 128), (1, 64, 256)):
        p = tpl.plan(b, h, t, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
        assert p.threads % p.hu == 0 and p.rows == p.rb * p.threads // p.hu
        units = -(-h // p.hu)
        assert p.grid == units * -(-b // p.rows)
        assert units * p.hu >= h and (p.grid // units) * p.rows >= b
        assert p.smem == tpl.smem_bytes(h, p.hu, p.rows, p.kc) <= H100_OPTIN
        assert p.kc == h or (p.kc % 32 == 0 and p.kc < h)
        assert p.grid <= H100_SMS * _h100_blocks_per_sm(p.rb, p.threads,
                                                        p.smem)


def test_planner_spreads_the_main_shape_and_raises_with_numbers():
    p = tpl.plan(128, 256, 64, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
    assert 64 <= p.grid <= H100_SMS       # one wave over most SMs
    with pytest.raises(ValueError, match=r"batch 256, h 2048.*"
                                         r"67108864 bytes.*132 SMs"):
        tpl.plan(256, 2048, 8, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
