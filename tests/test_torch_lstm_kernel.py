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


# SMs per GPC of the fake H100: a cluster's CTAs share one GPC.  With one
# CTA an SM it runs 15 clusters of 8 and 7 of 16, as the card reported.
H100_GPCS = (18,) * 6 + (16, 8)


def _h100_clusters_active(rows, cl, threads, smem):
    """Clusters of ``cl`` CTAs of the cluster tier the card runs at once,
    as cudaOccupancyMaxActiveClusters reports them: a cluster's CTAs sit
    in one GPC; an SM holds as many CTAs as 228 KB of shared memory (1 KB
    reserved a block), 64K registers (at most 128 a thread) and 2048
    threads allow."""
    if smem > H100_OPTIN:
        return 0
    per_sm = min(233472 // (smem + 1024), 65536 // (128 * threads),
                 2048 // threads)
    return sum(n * per_sm // cl for n in H100_GPCS)


def _cluster_plan(b, h, t):
    return tpl.plan(b, h, t, H100_SMS, H100_OPTIN, _h100_blocks_per_sm,
                    _h100_clusters_active)


def _check_cluster_plan(p, b, h):
    """The launch rules of ``lstm_fwd_cluster``, and a walk of the
    kernel's indices: each (row, unit) cell has one owner thread, and each
    column of the product one group per unit."""
    hp = -(-h // 4) * 4
    clusters = p.grid // p.cluster
    assert p.tier == "cluster" and p.grid == clusters * p.cluster
    assert p.cluster in tpl.CLUSTER_SIZES and p.cluster <= 16
    assert p.rb == p.rows and p.rows in tpl.CLUSTER_ROWS
    assert p.smem == tpl.cluster_smem_bytes(h, p.hu, p.rows, p.threads)
    assert tpl.ONE_CTA_PER_SM <= p.smem <= H100_OPTIN
    assert (p.cluster - 1) * p.hu < h <= p.cluster * p.hu
    assert (clusters - 1) * p.rows < b <= clusters * p.rows
    assert p.threads <= max(tpl.CLUSTER_THREADS) and p.threads % p.hu == 0
    assert p.kc % tpl.CLUSTER_K_STEP == 0
    assert (p.threads // p.hu) * p.kc >= hp
    assert p.rows * p.hu <= tpl.CLUSTER_CELLS * p.threads
    assert _h100_clusters_active(p.rows, p.cluster, p.threads, p.smem) >= 1
    # the cells: thread tid owns cells tid and tid + threads of its CTA
    cells = np.arange(tpl.CLUSTER_CELLS * p.threads)
    cells = cells[cells < p.rows * p.hu]
    owners = np.zeros((clusters * p.rows, p.cluster * p.hu), int)
    for c in range(clusters):
        for rank in range(p.cluster):
            np.add.at(owners, (c * p.rows + cells // p.hu,
                               rank * p.hu + cells % p.hu), 1)
    assert (owners[:b, :h] == 1).all()
    # the product: thread (g, u) sums columns [g·kc, g·kc + kc) of hp
    kb = np.minimum(np.arange(p.threads // p.hu) * p.kc, hp)
    cols = np.zeros(hp, int)
    for k0, k1 in zip(kb, np.minimum(kb + p.kc, hp)):
        cols[k0:k1] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("b,h,t", [(128, 256, 64), (1, 256, 64),
                                   (16, 256, 1), (32, 256, 256),
                                   (5, 100, 7)])
def test_planner_takes_the_cluster_tier_at_the_char_lstm_shapes(b, h, t):
    """The char-LSTM's output (batch 128), its batch-1 chain, a streaming
    call (batch 16, one step) and the long shape all run on clusters."""
    _check_cluster_plan(_cluster_plan(b, h, t), b, h)


def test_cluster_cost_model_pins_the_main_shapes():
    """At (batch, h, t) = (128, 256, 64) the cost model spreads the batch
    over 15 clusters of 8 CTAs, the most clusters of 8 the card runs at
    once (one wave), 9 rows and 32 units a CTA (128 KB of U): 288 cells,
    each with a thread of its own among 384, whose 8 column groups of 32
    columns are a whole number of the product loop's 16, and whose extra
    threads stage U sooner.  At batch 1 it takes one cluster of 16, whose
    CTAs read half as much U a step, with 8 groups of 32 columns: fewer
    partial sums for the one cell a unit.  A one-step call takes more
    threads to stage U.  The cluster tier's cost is less than half the
    grid tier's, whose every step pays a grid barrier."""
    p = _cluster_plan(128, 256, 64)
    assert p == tpl.Plan(9, 32, 384, 9, 32, 120, 204816, "cluster", 8)
    p1 = _cluster_plan(1, 256, 64)
    assert (p1.cluster, p1.rows, p1.grid, p1.hu, p1.threads, p1.kc) == \
        (16, 1, 16, 16, 128, 32)
    assert _cluster_plan(16, 256, 1).threads == 384
    g = tpl.plan(128, 256, 64, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
    active = _h100_clusters_active(p.rows, p.cluster, p.threads, p.smem)
    assert g.tier == "grid" and active == 15
    assert 2 * tpl._cluster_cost(p, 256, 64, active) < \
        tpl._cost(g, 256, 64, H100_SMS)


def test_cluster_ctas_ask_for_one_sm_each():
    """A CTA that needs little shared memory still asks for more than
    half an SM's, so a cluster never puts two of its CTAs on one SM."""
    p = _cluster_plan(32, 256, 256)
    used = tpl.cluster_smem_bytes(256, p.hu, p.rows, p.threads)
    assert p.smem == used == tpl.ONE_CTA_PER_SM
    assert 2 * (tpl.ONE_CTA_PER_SM + 1024) > 233472
    assert _h100_clusters_active(1, 16, 256, tpl.ONE_CTA_PER_SM) == 7


@pytest.mark.parametrize("b", [1, 32, 128])
def test_planner_takes_the_grid_tier_at_h_1024(b):
    """U [1024, 4096] f32 is 16 MiB: 1 MiB a CTA in a cluster of 16, more
    than a CTA's shared memory, so h = 1024 takes the grid barrier."""
    p = _cluster_plan(b, 1024, 16)
    assert p.tier == "grid" and p.cluster == 1
    assert p == tpl.plan(b, 1024, 16, H100_SMS, H100_OPTIN,
                         _h100_blocks_per_sm)


def test_widest_h_of_the_cluster_tier_on_an_h100():
    """The cluster tier takes h up to 472 at every batch (16 CTAs of 30
    units and 120 threads: 226,560 bytes of U, the rest h's buffers and
    the partial sums at one row a cluster, 232,272 in all); from 473 on
    the grid tier takes over."""
    for b in (1, 16, 128):
        assert _cluster_plan(b, 472, 8).tier == "cluster"
        assert _cluster_plan(b, 473, 8).tier == "grid"
    p = _cluster_plan(16, 472, 8)
    assert p.smem == 232272
    _check_cluster_plan(p, 16, 472)


@pytest.mark.parametrize("h", [1, 12, 100, 256, 472, 473, 512, 1000, 1024])
def test_planner_with_clusters_covers_the_door_on_an_h100(h):
    """With the card's clusters, every shape the grid tier takes
    (``test_planner_covers_the_door_on_an_h100``) still gets a launch:
    a cluster plan where one fits, else the grid plan, unchanged."""
    for b, t in itertools.product((1, 5, 16, 32, 128), (1, 64, 256)):
        p = _cluster_plan(b, h, t)
        grid = tpl.plan(b, h, t, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
        if p.tier == "cluster":
            _check_cluster_plan(p, b, h)
        else:
            assert p == grid


def test_launch_passes_each_tier_its_plan(monkeypatch):
    """``_launch`` calls the tier's entry point with the C signature's
    argument order (pointers, t, batch, h, then the plan)."""
    import contextlib
    import types
    calls = []

    def entry(name):
        return lambda *a: calls.append((name, a[7:])) or 0

    monkeypatch.setattr(tpl, "_kernel", entry)
    monkeypatch.setattr(tpl.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tpl.torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    t, b, h = 3, 5, 12
    xz, U = torch.zeros(t * b, 4 * h), torch.zeros(h, 4 * h)
    h0 = c0 = hT = cT = torch.zeros(b, h)
    ys = torch.zeros(t, b, h)
    pc = _cluster_plan(b, h, t)
    pg = tpl.plan(b, h, t, H100_SMS, H100_OPTIN, _h100_blocks_per_sm)
    tpl._launch(xz, U, h0, c0, ys, hT, cT, pc)
    tpl._launch(xz, U, h0, c0, ys, hT, cT, pg)
    assert calls == [
        ("lstm_fwd_cluster", (t, b, h, pc.rows, pc.cluster, pc.hu,
                              pc.threads, pc.kc, 7)),
        ("lstm_fwd", (t, b, h, pg.rb, pg.hu, pg.threads, pg.kc, 7))]
    assert len(tpl._ARGTYPES["lstm_fwd_cluster"]) == 7 + 9
    assert len(tpl._ARGTYPES["lstm_fwd"]) == 7 + 8


def test_layer_takes_the_plain_loop_where_the_card_has_no_launch(
        monkeypatch):
    """The reference's ``supports`` has no width rule; the port's planner
    finds no launch where U and the staged rows fit neither a cluster nor
    resident CTAs (h above 1024 on an H100).  There ``kernel_plan_exists``
    is False and ``LSTM(helper="pallas")`` runs its plain loop, as where
    ``supports`` is False, while ``device_plan`` (which ``lstm_forward``
    asks before a launch) still raises.  On a fake card of 4 SMs, 4 KB of shared memory
    a block and one CTA an SM, h = 32 has no launch (U alone is 16 KB,
    4 KB a CTA in a cluster of 4) and h = 8 has one."""
    from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
    card = torch.device("cuda", 0)
    monkeypatch.setattr(tpl, "_plans", {})
    # one CTA an SM in both tiers: clusters of at most 4 CTAs
    monkeypatch.setattr(tpl, "_card",
                        lambda device: (4, 4096, lambda rb, th, sm: 1,
                                        lambda rows, cl, th, sm: 4 // cl))
    exists = tpl.kernel_plan_exists
    asked = []

    def on_the_fake_card(batch, h, t, device):
        asked.append((batch, h, t, torch.device(device).type))
        return exists(batch, h, t, card)

    monkeypatch.setattr(tpl, "kernel_plan_exists", on_the_fake_card)
    fast_calls = []
    fast = tpl.lstm_forward_fast
    monkeypatch.setattr(tpl, "lstm_forward_fast",
                        lambda *a: fast_calls.append(a[2].shape[0]) or
                        fast(*a))
    assert exists(3, 32, 5, torch.device("cpu"))    # the plain twin on CPU
    for h, has_launch in ((8, True), (32, False)):
        assert exists(3, h, 5, card) == has_launch
        if not has_launch:
            with pytest.raises(ValueError, match="no launch keeps"):
                tpl.device_plan(3, h, 5, card)
        x, W, U, bias, _, _ = _inputs(3, 5, 4, h, False, seed=h)
        params = {"W": torch.from_numpy(W), "U": torch.from_numpy(U),
                  "b": torch.from_numpy(bias)}
        out = {}
        for helper in ("pallas", None):
            layer = trec.LSTM(n_in=4, n_out=h, activation="tanh",
                              helper=helper)
            out[helper], _ = layer.forward(params, {}, torch.from_numpy(x))
        assert asked[-1] == (3, h, 5, "cpu")
        if has_launch:
            assert fast_calls == [h]
            np.testing.assert_allclose(out["pallas"].detach().numpy(),
                                       out[None].detach().numpy(),
                                       atol=ATOL_FWD, rtol=0)
        else:
            assert fast_calls == [8]        # nothing more: the plain loop
            assert torch.equal(out["pallas"], out[None])
