"""Training a small TransformerLM in the port against the JAX package.

vocab 32, seq 128, embed 128, 2 layers, 2 heads (head_dim 64): the port
takes the flash path at t = 128 ('auto'), so its gradients run the plain
flash backward; JAX on the CPU takes ``sdpa_reference`` and differentiates
it.  Both sides start from the JAX package's initialised params and
updater state (``params_from_jax``, ``updater_state_from_jax``).
Everything is float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import \
    INDArrayDataSetIterator as JArrayIterator
from deeplearning4j_tpu.models.zoo import TransformerLM as JaxTransformerLM
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.multilayer import _stack_loss as jax_stack_loss
from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                   ExistingDataSetIterator,
                                                   INDArrayDataSetIterator)
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.constraints import MaxNormConstraint
from deeplearning4j_tpu_torch.nn.conf.dropout import DropConnect
from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss
from deeplearning4j_tpu_torch.parallel.inference import InvalidInputError
from deeplearning4j_tpu_torch.utils.model_serializer import (
    params_from_jax, updater_state_from_jax)

SMALL = dict(vocab_size=32, seq_len=128, embed=128, n_layers=2, n_heads=2)
VOCAB, SEQ = SMALL["vocab_size"], SMALL["seq_len"]
# Loss: a sum over 128 steps of log-softmax terms (~600); f32 reordering
# (flash vs reference attention, other matmul tilings) moves it ~1e-7
# relative: 1e-6.
RTOL_LOSS = 1e-6
# Gradients: per leaf, 2e-5 of the leaf's largest |g| plus 2e-6 abs.  The
# two sides differentiate GELU and LayerNorm by different formulas and sum
# in other orders; through two blocks that reaches ~1e-5 of the largest
# |g| of a leaf.  The abs term is for mha_bk, whose gradient is 0 in exact
# arithmetic (the softmax ignores a per-row shift) and f32 noise of ~5e-7
# on both sides.
RTOL_GRAD, ATOL_GRAD = 2e-5, 2e-6
# Params after 5 Sgd steps at lr 1e-4: each step moves a param by
# lr·|g| <= 1e-2, and the gradients agree to ~1e-6 relative: 1e-6 abs.
ATOL_PARAMS = 1e-6
# Adam divides by sqrt(v): a gradient that is 0 in exact arithmetic
# (mha_bk) has noise of either sign on the two sides, which Adam turns
# into updates of ±lr.  The losses still agree closely: 1e-5 relative.
RTOL_LOSS_ADAM = 1e-5
SGD_LR = 1e-4


def _nets(sparse, ju, tu):
    jn = JaxTransformerLM(**SMALL, sparse_labels=sparse, updater=ju).init()
    tn = TransformerLM(**SMALL, sparse_labels=sparse,
                       updater=tu).init(device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    return jn, tn


def _batch(rng, sparse, n=3):
    ids = rng.integers(0, VOCAB, (n, SEQ))
    nxt = rng.integers(0, VOCAB, (n, SEQ))
    return ids, (nxt if sparse else np.eye(VOCAB, dtype=np.float32)[nxt])


def _assert_params_close(jn, tn, atol, noise_atol=None):
    """Every param within ``atol``; with ``noise_atol``, mha_bk (zero
    gradient in exact arithmetic) within that instead."""
    for k, group in jn.params.items():
        for n, a in group.items():
            tol = noise_atol if noise_atol and n == "mha_bk" else atol
            np.testing.assert_allclose(
                tn.params[k][n].detach().numpy(), np.asarray(a), atol=tol,
                rtol=0, err_msg=f"{k}/{n}")


@pytest.mark.parametrize("sparse", [True, False])
def test_step0_loss_and_every_gradient_match_jax(sparse):
    jn, tn = _nets(sparse, jupd.Sgd(learning_rate=SGD_LR),
                   tupd.Sgd(learning_rate=SGD_LR))
    ids, y = _batch(np.random.default_rng(0), sparse)

    def loss_fn(p):
        return jax_stack_loss(jn.conf, p, jn.state, jnp.asarray(ids),
                              jnp.asarray(y), train=True,
                              key=jax.random.PRNGKey(0))[0]

    jv, jg = jax.value_and_grad(loss_fn)(jn.params)
    params = tn._param_tree()
    keys = [(k, n) for k in params for n in params[k]]
    tv = _stack_loss(tn.conf, params, torch.as_tensor(ids),
                     torch.as_tensor(y), train=True)
    tg = torch.autograd.grad(tv, [params[k][n] for k, n in keys])
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL_LOSS)
    assert len(keys) == sum(len(g) for g in jn.params.values())
    for (k, n), g in zip(keys, tg):
        want = np.asarray(jg[k][n])
        tol = RTOL_GRAD * np.abs(want).max() + ATOL_GRAD
        np.testing.assert_allclose(g.numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"{k}/{n}")


@pytest.mark.parametrize("sparse", [True, False])
def test_five_sgd_fit_steps_match_jax(sparse):
    jn, tn = _nets(sparse, jupd.Sgd(learning_rate=SGD_LR),
                   tupd.Sgd(learning_rate=SGD_LR))
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(5):
        ids, y = _batch(rng, sparse)
        jn.fit(ids, y)
        tn.fit(ids, y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL_LOSS)
        _assert_params_close(jn, tn, ATOL_PARAMS)
        losses.append(tn.get_score())
    assert tn.iteration == 5 and losses[-1] < losses[0]
    # the per-step gradient stats are computed in the step, as in JAX
    np.testing.assert_allclose(
        float(tn._last_grad_stats["global_norm"]),
        float(jn._last_grad_stats["global_norm"]), rtol=1e-5)
    assert set(tn._last_grad_stats["layer_norms"]) == \
        set(jn._last_grad_stats["layer_norms"])


@pytest.mark.parametrize("sparse", [True, False])
def test_five_adam_fit_steps_losses_match_jax(sparse):
    jn, tn = _nets(sparse, jupd.Adam(learning_rate=1e-3),
                   tupd.Adam(learning_rate=1e-3))
    rng = np.random.default_rng(2)
    for _ in range(5):
        ids, y = _batch(rng, sparse)
        jn.fit(ids, y)
        tn.fit(ids, y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL_LOSS_ADAM)
    # every layer with params carries its updater (network defaults fill
    # layer fields), so each has its own group and step count, as in JAX
    assert tn.opt_state["count"] == {"default": 5, **{
        f"layer_{i}/w": 5 for i in (0, 2, 3, 4)}}


@pytest.mark.parametrize("pair", [
    (jupd.Adam(learning_rate=1e-3), tupd.Adam(learning_rate=1e-3)),
    (jupd.Nesterovs(learning_rate=SGD_LR, momentum=0.9),
     tupd.Nesterovs(learning_rate=SGD_LR, momentum=0.9)),
], ids=["adam", "nesterovs"])
def test_resume_from_jax_mid_training_state(pair):
    # JAX trains two steps; the port takes over params and optax state,
    # and the third step agrees
    ju, tu = pair
    jn = JaxTransformerLM(**SMALL, sparse_labels=True, updater=ju).init()
    rng = np.random.default_rng(3)
    for _ in range(2):
        jn.fit(*_batch(rng, True))
    tn = TransformerLM(**SMALL, sparse_labels=True, updater=tu).init(
        device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    updater_state_from_jax(tn, jax.tree_util.tree_map(np.asarray,
                                                      jn.opt_state))
    inner = jn.opt_state.inner_states["layer_4/w"].inner_state[0]
    for slot in tu.SLOTS:
        np.testing.assert_array_equal(
            tn.opt_state["slots"]["layer_4"]["W"][slot].numpy(),
            np.asarray(getattr(inner, slot)["layer_4"]["W"]))
    if isinstance(tu, tupd.Adam):
        assert tn.opt_state["count"]["layer_0/w"] == 2
    ids, y = _batch(rng, True)
    jn.fit(ids, y)
    tn.fit(ids, y)
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS)
    # Adam moves a param by about lr per step whatever |g| is: mha_bk, whose
    # gradient is noise, may land up to 2·lr apart; every other param
    # agrees to 1e-6
    _assert_params_close(jn, tn, ATOL_PARAMS, noise_atol=2e-3)


def test_fit_over_dataset_and_ragged_iterator_match_jax():
    jn, tn = _nets(True, jupd.Sgd(learning_rate=SGD_LR),
                   tupd.Sgd(learning_rate=SGD_LR))
    rng = np.random.default_rng(4)
    ids, y = _batch(rng, True, n=5)
    jn.fit(JDataSet(ids[:2], y[:2]))
    tn.fit(DataSet(ids[:2], y[:2]))
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS)
    # 5 rows in batches of 2: the last batch is ragged (1 row)
    jn.fit(JArrayIterator(ids, y, batch_size=2), epochs=2)
    tn.fit(INDArrayDataSetIterator(ids, y, batch_size=2), epochs=2)
    assert tn.last_batch_size == 1 and tn.iteration == 1 + 2 * 3
    np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                               rtol=RTOL_LOSS)
    _assert_params_close(jn, tn, ATOL_PARAMS)
    # score on a batch and on a DataSet, as the reference
    np.testing.assert_allclose(tn.score(x=ids, y=y), jn.score(x=ids, y=y),
                               rtol=RTOL_LOSS)
    np.testing.assert_allclose(tn.score(DataSet(ids, y)),
                               jn.score(JDataSet(ids, y)), rtol=RTOL_LOSS)
    # and the trained net still serves what JAX serves
    np.testing.assert_allclose(tn.output(ids[:2]).numpy(),
                               np.asarray(jn.output(ids[:2])), atol=1e-5,
                               rtol=0)


def test_fit_forms_and_label_mask():
    tn = TransformerLM(**SMALL, sparse_labels=True,
                       updater=tupd.Sgd(learning_rate=SGD_LR)).init(
                           device="cpu")
    rng = np.random.default_rng(5)
    ids, y = _batch(rng, True, n=4)
    lm = (rng.random((4, SEQ)) > 0.5).astype(np.float32)
    tn.fit((ids, y))
    tn.fit(ExistingDataSetIterator([DataSet(ids, y, labels_mask=lm)]))
    tn.fit(iter([(ids, y), (ids, y, None, lm)]), epochs=2)
    assert tn.iteration == 1 + 1 + 2 * 2 and tn.epoch == 4
    loss = tn.fit_batch((ids, y))
    assert isinstance(loss, float) and np.isfinite(loss)
    assert loss == tn.get_score() == tn.score()
    with pytest.raises(ValueError, match="iterator"):
        tn.fit(42)


def test_step_keeps_the_loss_on_the_device():
    tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    ids, y = _batch(np.random.default_rng(6), True)
    tn.fit(ids, y)
    assert isinstance(tn._score, torch.Tensor) and tn._score.ndim == 0
    assert not tn._score.requires_grad
    assert np.isfinite(tn.get_score())


def test_out_of_range_ids_raise_at_every_entry_point():
    tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    bad = np.full((2, SEQ), VOCAB, np.int64)
    y = np.zeros((2, SEQ), np.int64)
    for call in (lambda: tn.output(bad), lambda: tn.fit(bad, y),
                 lambda: tn.score(x=bad, y=y),
                 lambda: tn.fit(DataSet(bad - VOCAB - 1, y))):
        with pytest.raises(InvalidInputError, match="out of range"):
            call()
    assert tn.iteration == 0


@pytest.mark.parametrize("field,value", [("dropout", 0.5),
                                         ("weight_noise", DropConnect(p=0.5))])
def test_training_with_stochastic_regularization_raises(field, value):
    """Dropout (ported with the conv zoo slice) and weight noise (ported
    with the rest-of-training slice) train, draw from the network's key
    stream and leave inference alone; the stored weights stay un-noised
    (only the update moves them)."""
    tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    setattr(tn.layer_confs[2], field, value)
    ids, y = _batch(np.random.default_rng(7), True)
    out = tn.output(ids)                 # inference ignores it
    before = {k: {n: p.detach().clone() for n, p in g.items()}
              for k, g in tn.params.items()}
    rng0 = tn._rng.clone()
    tn.fit(ids, y)
    assert np.isfinite(tn.get_score()) and not torch.equal(tn._rng, rng0)
    assert not torch.equal(tn.params["layer_2"]["W1"],
                           before["layer_2"]["W1"])
    if field == "weight_noise":
        # an Sgd step: the stored W1 moved by -lr * its gradient, not by
        # a DropConnect mask (no weight was zeroed in place)
        assert torch.count_nonzero(tn.params["layer_2"]["W1"]) == \
            torch.count_nonzero(before["layer_2"]["W1"])
    tn2 = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    assert torch.equal(tn2.output(ids), out)     # inference ignored it


def test_unported_training_options_raise():
    ids, y = _batch(np.random.default_rng(8), True)
    # the sparse-embedding gradient is ported (training across ranks):
    # the LM trains its table in row space, untouched rows unchanged
    tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    tn.conf.layers[0].sparse_grad = True
    W0 = tn.params["layer_0"]["W"].detach().clone()
    ids = ids % (VOCAB // 2)         # half the vocabulary stays untouched
    tn.fit(ids, y)
    untouched = sorted(set(range(VOCAB)) - set(np.unique(ids).tolist()))
    assert np.isfinite(tn.get_score())
    assert torch.equal(tn.params["layer_0"]["W"][untouched], W0[untouched])
    # precision, remat and the legacy solvers are ported (precision and
    # memory slice): each is accepted and trains
    base = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    for what in ("precision", "remat", "lbfgs"):
        tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
        tn.load_params({k: {n: t.detach().numpy() for n, t in g.items()}
                        for k, g in base.params.items()})
        if what == "precision":
            tn.conf.defaults["precision"] = "bfloat16"
        elif what == "remat":
            tn.conf.defaults["cache_mode"] = "remat"
        else:
            tn.conf.defaults.update(optimization_algo="lbfgs",
                                    max_iterations=3)
        before = tn.params["layer_2"]["W1"].detach().clone()
        s0 = tn.score(x=ids, y=y)
        tn.fit(ids, y)
        assert np.isfinite(tn.get_score()), what
        assert not torch.equal(tn.params["layer_2"]["W1"], before), what
        # the masters stay f32 whatever the compute dtype
        assert all(p.dtype == torch.float32 for p in tn.params.parameters())
        if what == "lbfgs":
            assert tn.get_score() < s0
    # remat replays each layer's forward: the same loss and Sgd step as
    # the stored-activation step (on the card bit for bit, chip_smoke's
    # remat_memory; the CPU's threaded sums are not run-to-run exact, so
    # here within the f32 tolerances of this file)
    plain, remat = (TransformerLM(**SMALL, sparse_labels=True,
                                  updater=tupd.Sgd(learning_rate=SGD_LR)
                                  ).init(device="cpu") for _ in range(2))
    remat.conf.defaults["cache_mode"] = "remat"
    plain.fit(ids, y)
    remat.fit(ids, y)
    np.testing.assert_allclose(remat.get_score(), plain.get_score(),
                               rtol=RTOL_LOSS)
    for k, g in plain.params.items():
        for n, t in g.items():
            np.testing.assert_allclose(remat.params[k][n].detach().numpy(),
                                       t.detach().numpy(), rtol=0,
                                       atol=ATOL_PARAMS, err_msg=f"{k}/{n}")
    # constraints are ported (rest-of-training slice): after the step the
    # block's W1 columns hold MaxNorm(0.5), and the step equals the
    # unconstrained step with the constraint applied after it
    tn = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    free = TransformerLM(**SMALL, sparse_labels=True).init(device="cpu")
    tn.conf.layers[2].constraints = [MaxNormConstraint(max_norm=0.5)]
    tn.fit(ids, y)
    free.fit(ids, y)
    w1 = tn.params["layer_2"]["W1"].detach()
    assert float(torch.linalg.vector_norm(w1, dim=0).max()) <= 0.5 + 1e-6
    want = MaxNormConstraint(max_norm=0.5).apply(
        free.params["layer_2"]["W1"].detach())
    torch.testing.assert_close(w1, want, rtol=0, atol=0)
    # tBPTT through attention carries the KV cache now: a one-hot batch
    # longer than the chunk trains chunk by chunk instead of raising
    tn = TransformerLM(**SMALL).init(device="cpu")
    tn.conf.backprop_type = "tbptt"
    tn.conf.tbptt_fwd_length = SEQ // 2
    eye = np.eye(VOCAB, dtype=np.float32)
    tn.fit(eye[ids], eye[y])
    assert tn.iteration == 2 and np.isfinite(tn.get_score())


def test_features_mask_trains_as_jax():
    jn, tn = _nets(True, jupd.Sgd(learning_rate=SGD_LR),
                   tupd.Sgd(learning_rate=SGD_LR))
    rng = np.random.default_rng(9)
    for _ in range(2):
        ids, y = _batch(rng, True)
        m = (rng.random((3, SEQ)) > 0.2).astype(np.float32)
        m[:, 0] = 1.0
        jn.fit(ids, y, mask=m)
        tn.fit(ids, y, mask=m)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=RTOL_LOSS)
    _assert_params_close(jn, tn, ATOL_PARAMS)
