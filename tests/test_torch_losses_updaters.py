"""The port's losses, updater arithmetic, gradient normalization and
regularization against the JAX package's (inputs from numpy seeds, f32 on
both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import _common as jcommon
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.schedules import FixedSchedule as JFixed
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu_torch.nn import _common as tcommon
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.schedules import FixedSchedule
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff

# Loss values are sums over [t, vocab] of log-softmax terms (~30 at
# these shapes) and means over the batch: f32 reordering gives ~1e-6
# relative.  Gradients are softmax - label, of order 1/b.
RTOL_LOSS = 1e-6
ATOL_GRAD = 1e-6
# Updater steps: the same f32 arithmetic in the same order; a step may
# round the parameter (|p| up to ~2) one ulp apart where XLA fuses a
# multiply-add: 2.5e-7 relative (two ulps) plus 1e-7 abs near zero.
ATOL_UPD, RTOL_UPD = 1e-7, 2.5e-7


def _logits_labels(seed=0, b=3, t=5, v=7, sparse=False):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((b, t, v)) * 2).astype(np.float32)
    ids = rng.integers(0, v, (b, t))
    y = ids if sparse else np.eye(v, dtype=np.float32)[ids]
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    return z, y, mask


def _jax_value_grad(name, z, y, mask, act, weights=None):
    kw = {} if weights is None else {"unit_weights": jnp.asarray(weights)}
    f = lambda zz: jlosses.get(name)(jnp.asarray(y), zz, act,
                                     None if mask is None
                                     else jnp.asarray(mask), **kw)
    v, g = jax.value_and_grad(f)(jnp.asarray(z))
    return float(v), np.asarray(g)


def _torch_value_grad(name, z, y, mask, act, weights=None):
    zz = torch.tensor(z, requires_grad=True)
    kw = {} if weights is None else {"unit_weights": torch.tensor(weights)}
    v = tlosses.get(name)(torch.as_tensor(y), zz, act,
                          None if mask is None else torch.tensor(mask), **kw)
    (g,) = torch.autograd.grad(v, zz)
    return v.item(), g.numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,act,sparse", [
    ("mcxent", "softmax", False),
    ("negativeloglikelihood", "softmax", False),
    ("mcxent", "identity", False),
    ("sparse_mcxent", "softmax", True),
])
def test_loss_value_and_grad_match_jax(name, act, sparse, masked):
    z, y, mask = _logits_labels(seed=len(name) + masked, sparse=sparse)
    if act == "identity":   # the clipped-probability path takes p in (0, 1)
        z = np.abs(z) / (np.abs(z).sum(-1, keepdims=True) + 1)
    m = mask if masked else None
    jv, jg = _jax_value_grad(name, z, y, m, act)
    tv, tg = _torch_value_grad(name, z, y, m, act)
    np.testing.assert_allclose(tv, jv, rtol=RTOL_LOSS)
    np.testing.assert_allclose(tg, jg, atol=ATOL_GRAD, rtol=0)


def test_loss_unit_weights_match_jax():
    z, y, mask = _logits_labels(seed=3)
    w = np.linspace(0.5, 2.0, 7).astype(np.float32)
    jv, jg = _jax_value_grad("mcxent", z, y, mask, "softmax", w)
    tv, tg = _torch_value_grad("mcxent", z, y, mask, "softmax", w)
    np.testing.assert_allclose(tv, jv, rtol=RTOL_LOSS)
    np.testing.assert_allclose(tg, jg, atol=ATOL_GRAD, rtol=0)


def test_output_layer_compute_loss_with_loss_weights():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    p = {"W": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(n_in=6, n_out=5, activation="softmax", loss="mcxent",
              loss_weights=[1.0, 2.0, 0.5, 1.0, 3.0])
    want = jff.OutputLayer(**kw).compute_loss(
        {"params": {k: jnp.asarray(v) for k, v in p.items()}},
        jnp.asarray(x), jnp.asarray(y))
    got = tff.OutputLayer(**kw).compute_loss(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
        torch.tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_LOSS)
    bad = tff.OutputLayer(**dict(kw, loss_weights=[1.0, 2.0]))
    with pytest.raises(ValueError, match="loss weights"):
        bad.compute_loss({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x), torch.tensor(y))


def test_loss_registry():
    assert tlosses.get("MCXENT") is tlosses.get("mcxent")
    with pytest.raises(NotImplementedError, match="not ported"):
        tlosses.get("mse")
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get("bogus")
    # every ported name exists in the reference under the same name
    assert set(tlosses.names()) <= set(jlosses.names())


def _grad_sequence(seed, shapes, n=5):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


@pytest.mark.parametrize("pair", [
    (jupd.Sgd(learning_rate=1e-2), tupd.Sgd(learning_rate=1e-2)),
    (jupd.Sgd(), tupd.Sgd()),
    (jupd.Nesterovs(learning_rate=1e-2, momentum=0.8),
     tupd.Nesterovs(learning_rate=1e-2, momentum=0.8)),
    (jupd.Adam(learning_rate=1e-2), tupd.Adam(learning_rate=1e-2)),
    (jupd.Adam(learning_rate=JFixed(3e-3), beta1=0.8, beta2=0.99,
               epsilon=1e-6),
     tupd.Adam(learning_rate=FixedSchedule(3e-3), beta1=0.8, beta2=0.99,
               epsilon=1e-6)),
], ids=["sgd", "sgd-default-lr", "nesterovs", "adam", "adam-fixed"])
def test_updater_steps_match_optax(pair):
    ju, tu = pair
    shapes = {"W": (4, 3), "b": (3,)}
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    tx = ju.to_optax()
    jp = {"layer_0": {k: jnp.asarray(v) for k, v in p0.items()}}
    jstate = tx.init(jp)
    groups = tcommon.build_tx(tu, {"layer_0": None},
                              {"layer_0": {k: torch.tensor(v)
                                           for k, v in p0.items()}})
    tp = {"layer_0": {k: torch.tensor(v) for k, v in p0.items()}}
    tstate = groups.init(tp)
    for g in _grad_sequence(1, shapes):
        jg = {"layer_0": {k: jnp.asarray(v) for k, v in g.items()}}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        groups.step(tp, {"layer_0": {k: torch.tensor(v)
                                     for k, v in g.items()}}, tstate)
        for k in shapes:
            np.testing.assert_allclose(tp["layer_0"][k].numpy(),
                                       np.asarray(jp["layer_0"][k]),
                                       atol=ATOL_UPD, rtol=RTOL_UPD)
    assert tstate["count"] == {"default": 5}


def test_build_tx_labels_match_reference():
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JD
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    params = {"layer_0": {"W": None, "b": None}, "layer_1": {"W": None,
                                                            "b": None}}
    confs = {"layer_0": DenseLayer(n_in=2, n_out=2),
             "layer_1": DenseLayer(n_in=2, n_out=2,
                                   updater=tupd.Adam(learning_rate=0.1),
                                   bias_updater=tupd.Sgd(learning_rate=1.0))}
    groups = tcommon.build_tx(tupd.Sgd(), confs, params)
    assert groups.labels == {"layer_0": {"W": "default", "b": "default"},
                             "layer_1": {"W": "layer_1/w", "b": "layer_1/b"}}
    assert isinstance(groups.transforms["layer_1/w"], tupd.Adam)
    assert isinstance(groups.transforms["layer_1/b"], tupd.Sgd)
    # the reference partitions the same way
    jconfs = {"layer_0": JD(n_in=2, n_out=2),
              "layer_1": JD(n_in=2, n_out=2,
                            updater=jupd.Adam(learning_rate=0.1),
                            bias_updater=jupd.Sgd(learning_rate=1.0))}
    jp = {k: {n: jnp.zeros(2) for n in g} for k, g in params.items()}
    st = jcommon.build_tx(jupd.Sgd(), jconfs, jp).init(jp)
    assert set(st.inner_states) == {"default", "frozen", "layer_1/w",
                                    "layer_1/b"}


@pytest.mark.parametrize("mode", [None, "none", "RenormalizeL2PerLayer",
                                  "RenormalizeL2PerParamType",
                                  "ClipElementWiseAbsoluteValue",
                                  "ClipL2PerLayer", "ClipL2PerParamType"])
@pytest.mark.parametrize("threshold", [0.05, 10.0])
def test_gradient_normalization_matches_reference(mode, threshold):
    rng = np.random.default_rng(2)
    g = {"W": (rng.standard_normal((5, 4)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal(4) * 0.3).astype(np.float32)}
    want = jcommon.apply_gradient_normalization(
        mode, threshold, {k: jnp.asarray(v) for k, v in g.items()})
    got = tcommon.apply_gradient_normalization(
        mode, threshold, {k: torch.tensor(v) for k, v in g.items()})
    for k in g:
        # one norm and one divide per leaf: a few f32 ulps
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=1e-6)


def test_gradient_normalization_all_per_layer_override():
    from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JD
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    rng = np.random.default_rng(3)
    g = {f"layer_{i}": {"W": rng.standard_normal((3, 3)).astype(np.float32)}
         for i in range(2)}
    kw = dict(gradient_normalization="ClipElementWiseAbsoluteValue",
              gradient_normalization_threshold=0.1)
    want = jcommon.apply_gradient_norm_all(
        {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in g.items()},
        {"layer_0": JD(**kw), "layer_1": JD()}, "ClipL2PerLayer", 0.5)
    got = tcommon.apply_gradient_norm_all(
        {k: {n: torch.tensor(a) for n, a in v.items()}
         for k, v in g.items()},
        {"layer_0": DenseLayer(**kw), "layer_1": DenseLayer()},
        "ClipL2PerLayer", 0.5)
    for k in g:
        np.testing.assert_allclose(got[k]["W"].numpy(),
                                   np.asarray(want[k]["W"]), atol=1e-7,
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        tcommon.apply_gradient_normalization("bogus", 1.0,
                                             {"W": torch.zeros(2)})


@pytest.mark.parametrize("coeffs", [dict(l2=1e-3), dict(l1=1e-2),
                                    dict(l1=1e-3, l2=1e-2, l1_bias=1e-2,
                                         l2_bias=1e-3), {}])
def test_regularization_score_matches_reference(coeffs):
    rng = np.random.default_rng(6)
    p = {"W": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    want = jff.DenseLayer(n_in=4, n_out=3, **coeffs).regularization_score(
        {k: jnp.asarray(v) for k, v in p.items()})
    got = tff.DenseLayer(n_in=4, n_out=3, **coeffs).regularization_score(
        {k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_constraints_and_training_noise_raise():
    lc = tff.DenseLayer(n_in=2, n_out=2, constraints=[{"max": 1.0}])
    with pytest.raises(NotImplementedError, match="constraints"):
        tcommon.apply_constraints_all({}, {"layer_0": lc})
    p = {"W": torch.zeros(2, 2), "b": torch.zeros(2)}
    x = torch.zeros(1, 2)
    noisy = tff.DenseLayer(n_in=2, n_out=2, weight_noise={"p": 0.1})
    dropped = tff.DenseLayer(n_in=2, n_out=2, dropout=0.5)
    for layer, field in ((noisy, "weight_noise"), (dropped, "dropout")):
        layer.apply(p, x)                    # inference: no effect
        with pytest.raises(NotImplementedError, match=field):
            layer.apply(p, x, train=True)
    # a retain probability of 1 (or 0) is dropout off, as in the reference
    tff.DenseLayer(n_in=2, n_out=2, dropout=1.0).apply(p, x, train=True)
