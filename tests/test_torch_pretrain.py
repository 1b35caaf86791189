"""Pretraining layers (AutoEncoder, RBM, VariationalAutoencoder), the
reconstruction distributions and ``MultiLayerNetwork.pretrain`` of the
port against the JAX package, on the same numpy inputs and weights.

Tolerances:
- float64 (losses, gradients, distributions, generation): 1e-10 — the
  same formulas, rounded in another order; the VAE's noise from the port's
  float64 ``normal`` agrees with JAX's within a few ulps.
- float32 runs (``jax.enable_x64(False)``, the JAX package's production
  setting, so that a float keep-probability draws float32 uniforms on
  both sides): losses within 1e-5 relative, Sgd params within 1e-6 abs,
  Adam params within 1e-5 abs (Adam divides by the gradient's size).
- RBM Gibbs samples: bitwise at these sizes; a sample flips only where a
  uniform lies within rounding of its probability, and the tests count
  the flips and require none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import InputType, MultiLayerNetwork, \
    NeuralNetConfiguration
from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.nn.conf import variational as jv
from deeplearning4j_tpu.nn.conf.updaters import Adam, Sgd
from deeplearning4j_tpu.nn.layers import pretrain as jp
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer
from deeplearning4j_tpu.utils.gradient_check import check_gradients as jcheck
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.data import dataset as tds
from deeplearning4j_tpu_torch.nn.conf import variational as tv
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import pretrain as tp
from deeplearning4j_tpu_torch.nn.multilayer import \
    MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.gradient_check import \
    check_gradients as tcheck
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

TOL64 = 1e-10
RTOL32_LOSS, ATOL32_SGD, ATOL32_ADAM = 1e-5, 1e-6, 1e-5


def _data(seed=0, n=16, f=8):
    rng = np.random.default_rng(seed)
    return (rng.random((n, f)) > 0.5).astype(np.float64), \
        rng.standard_normal((n, f))


def _dists(pkg):
    comp = (pkg.CompositeReconstructionDistribution()
            .add(4, pkg.BernoulliReconstructionDistribution())
            .add(2, pkg.GaussianReconstructionDistribution())
            .add(2, pkg.ExponentialReconstructionDistribution()))
    return {"bernoulli": pkg.BernoulliReconstructionDistribution(),
            "gaussian": pkg.GaussianReconstructionDistribution(
                activation="tanh"),
            "exponential": pkg.ExponentialReconstructionDistribution(),
            "composite": comp,
            "loss_mse": pkg.LossFunctionWrapper(loss="mse",
                                                activation="sigmoid"),
            "loss_xent": pkg.LossFunctionWrapper(loss="xent",
                                                 activation="sigmoid")}


def _x_for(name, xb, xg):
    if name in ("bernoulli", "loss_xent"):
        return xb
    if name == "exponential":
        return np.abs(xg)
    if name == "composite":
        return np.concatenate([xb[:, :4], xg[:, :2], np.abs(xg[:, 2:4])], 1)
    return xg


_AE = dict(n_in=8, n_out=5, activation="sigmoid", weight_init="xavier",
           bias_init=0.1)
_VAE = dict(n_in=8, n_out=3, encoder_layer_sizes=[10, 7],
            decoder_layer_sizes=[9], activation="tanh", weight_init="xavier",
            bias_init=0.1, num_samples=2)
LAYERS = {
    "ae_mse_sparse": (lambda m: m.AutoEncoder(
        corruption_level=0.0, visible_loss="mse", sparsity=0.1, **_AE), "g"),
    "ae_xent": (lambda m: m.AutoEncoder(corruption_level=0.0,
                                        visible_loss="xent", **_AE), "b"),
    "rbm_k2": (lambda m: m.RBM(k=2, **_AE), "b"),
    "rbm_gaussian": (lambda m: m.RBM(k=1, visible_unit="gaussian", **_AE),
                     "g"),
    "vae_composite": (lambda m: m.VariationalAutoencoder(
        reconstruction_distribution=_dists(
            jv if m is jp else tv)["composite"], **_VAE), "c"),
    "vae_gaussian": (lambda m: m.VariationalAutoencoder(
        reconstruction_distribution=_dists(
            jv if m is jp else tv)["gaussian"], **_VAE), "g"),
}


def _layer_pair(name, dtype):
    make, kind = LAYERS[name]
    jl, tl = make(jp), make(tp)
    jl.dtype = tl.dtype = dtype
    xb, xg = _data()
    x = {"b": xb, "g": xg, "c": _x_for("composite", xb, xg)}[kind]
    return jl, tl, _init_params(tl), x


def _init_params(tl):
    """Fresh params of a port layer as numpy: the JAX side takes them
    (JAX's own ``init`` would compile a program per weight shape)."""
    made = tl.init(torch.Generator().manual_seed(3), None, "cpu")
    return {k: v.numpy() for k, v in made.items()}


def _loss_and_grads(jl, tl, jparams, x, jkey, tkey, dt):
    jpar = {k: jnp.asarray(np.asarray(v), dt) for k, v in jparams.items()}
    jx = jnp.asarray(x, dt)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jl.pretrain_loss(
        {"params": p, "state": {}}, jx, key=jkey, train=jkey is not None)))(
            jpar)
    tdt = torch.float64 if dt == jnp.float64 else torch.float32
    tpar = {k: torch.tensor(np.asarray(v), dtype=tdt).requires_grad_(True)
            for k, v in jpar.items()}
    tloss = tl.pretrain_loss(tpar, torch.tensor(x, dtype=tdt), key=tkey,
                             train=tkey is not None)
    tg = dict(zip(tpar, torch.autograd.grad(tloss, list(tpar.values()))))
    return float(jloss), tloss.item(), jg, tg


# (layer, keyed): a key draws the corruption mask, the Gibbs samples and
# the VAE's noise; without one the VAE's noise is 0
F64_CASES = [("ae_mse_sparse", False), ("ae_xent", False), ("rbm_k2", True),
             ("rbm_gaussian", True), ("vae_composite", True),
             ("vae_gaussian", False)]


@pytest.mark.parametrize("name,keyed", F64_CASES)
def test_pretrain_loss_and_gradient_f64(name, keyed):
    jl, tl, jparams, x = _layer_pair(name, "float64")
    jkey = jax.random.PRNGKey(5) if keyed else None
    tkey = _random.prng_key(5) if keyed else None
    jloss, tloss, jg, tg = _loss_and_grads(jl, tl, jparams, x, jkey, tkey,
                                           jnp.float64)
    assert abs(jloss - tloss) <= TOL64 * max(1.0, abs(jloss))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=TOL64, rtol=0, err_msg=k)


def _gibbs_flips(jl, tl, jparams, x, key):
    """Flips between the two packages' Gibbs samples (h, then v) of one
    step from ``key``, float32."""
    jpar = {k: jnp.asarray(np.asarray(v), jnp.float32)
            for k, v in jparams.items()}
    jx = jnp.asarray(x, jnp.float32)

    @jax.jit
    def chain(p, v, k):
        kh, kv = jax.random.split(k)
        h = jax.random.bernoulli(kh, jax.nn.sigmoid(v @ p["W"] + p["b"]))
        h = h.astype(jnp.float32)
        return h, jax.random.bernoulli(kv, jax.nn.sigmoid(
            h @ p["W"].T + p["vb"])).astype(jnp.float32)

    jh, jv2 = chain(jpar, jx, key)
    tpar = {k: torch.tensor(np.asarray(v)) for k, v in jpar.items()}
    th, tv2 = tl.gibbs_step(tpar, torch.tensor(np.asarray(jx)),
                            torch.tensor(np.asarray(key).astype(np.int64)))
    return int((th.numpy() != np.asarray(jh)).sum()), \
        int((tv2.numpy() != np.asarray(jv2)).sum())


@pytest.mark.parametrize("name", ["ae_xent_corrupt", "rbm_k2",
                                  "vae_gaussian"])
def test_pretrain_loss_f32_keyed(name):
    """float32 with x64 off: the AutoEncoder's corruption mask (a float
    keep probability), the RBM's Gibbs samples and the VAE's noise."""
    with jax.enable_x64(False):
        if name == "ae_xent_corrupt":
            jl = jp.AutoEncoder(corruption_level=0.4, visible_loss="xent",
                                **_AE)
            tl = tp.AutoEncoder(corruption_level=0.4, visible_loss="xent",
                                **_AE)
            x = _data()[0]
            jparams = _init_params(tl)
        else:
            jl, tl, jparams, x = _layer_pair(name, "float32")
        x = x.astype(np.float32)
        key = jax.random.PRNGKey(11)
        jloss, tloss, jg, tg = _loss_and_grads(
            jl, tl, jparams, x, key,
            torch.tensor(np.asarray(key).astype(np.int64)), jnp.float32)
        if name == "rbm_k2":
            flips = _gibbs_flips(jl, tl, jparams, x,
                                 jax.random.fold_in(key, 0))
            assert flips == (0, 0)
    assert abs(jloss - tloss) <= RTOL32_LOSS * max(1.0, abs(jloss))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(_dists(jv)))
def test_reconstruction_distribution(name):
    jd, td = _dists(jv)[name], _dists(tv)[name]
    xb, xg = _data(1)
    x = _x_for(name, xb, xg)
    rng = np.random.default_rng(2)
    pre = rng.standard_normal((x.shape[0], jd.dist_params_size(8)))
    assert td.dist_params_size(8) == jd.dist_params_size(8)
    tx, tpre = torch.tensor(x), torch.tensor(pre)

    @jax.jit
    def jax_side(a, z):
        rows = jax.vmap(lambda ai, zi: jd.neg_log_prob(
            ai[None], zi[None], False))(a, z)
        return (jd.neg_log_prob(a, z, True), jd.neg_log_prob(a, z, False),
                rows, jd.mean(z), jd.sample(jax.random.PRNGKey(4), z))

    avg, total, rows, mean, sample = (np.asarray(v) for v in jax_side(
        jnp.asarray(x), jnp.asarray(pre)))
    for want, got in ((avg, td.neg_log_prob(tx, tpre, True)),
                      (total, td.neg_log_prob(tx, tpre, False)),
                      (rows, td.neg_log_prob(tx, tpre, per_example=True)),
                      (mean, td.mean(tpre)),
                      (sample, td.sample(_random.prng_key(4), tpre))):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL64,
                                   rtol=TOL64)
    assert jd.has_loss_function() == td.has_loss_function()


def test_vae_generation_and_reconstruction_probability():
    jl, tl, jparams, x = _layer_pair("vae_composite", "float64")
    tpar = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    z = np.random.default_rng(5).standard_normal((6, 3))

    @jax.jit
    def jax_side(p, zz, xx):
        v = {"params": p, "state": {}}
        return (jl.generate_at_mean_given_z(v, zz),
                jl.generate_random_given_z(v, zz, jax.random.PRNGKey(2)),
                jl.reconstruction_probability(v, xx, jax.random.PRNGKey(9),
                                              num_samples=4),
                jl.apply(v, xx)[0])

    want = [np.asarray(v) for v in jax_side(jparams, jnp.asarray(z),
                                            jnp.asarray(x))]
    tz, tx = torch.tensor(z), torch.tensor(x)
    got = [tl.generate_at_mean_given_z(tpar, tz),
           tl.generate_random_given_z(tpar, tz, _random.prng_key(2)),
           tl.reconstruction_probability(tpar, tx, _random.prng_key(9),
                                         num_samples=4),
           # the supervised forward: q(z|x)'s mean through pzx_activation
           tl.apply(tpar, tx)]
    assert got[2].shape == (x.shape[0],)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL64, rtol=TOL64)


def _stack_conf(comp_pkg, updater_vae):
    comp = (comp_pkg.CompositeReconstructionDistribution()
            .add(6, comp_pkg.BernoulliReconstructionDistribution())
            .add(4, comp_pkg.GaussianReconstructionDistribution()))
    return (NeuralNetConfiguration.builder().seed(7)
            .updater(Sgd(learning_rate=0.1)).activation("sigmoid").list()
            .layer(jp.AutoEncoder(n_out=10, corruption_level=0.3,
                                  visible_loss="xent"))
            .layer(jp.RBM(n_out=10, k=1))
            .layer(jp.VariationalAutoencoder(
                n_out=3, encoder_layer_sizes=[8], decoder_layer_sizes=[8],
                reconstruction_distribution=comp, updater=updater_vae))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())


def _jax_net(conf, tree):
    """The JAX package's network for ``conf`` with the params ``tree``
    (numpy), its updater built (its ``init`` would compile a program per
    weight shape)."""
    jn = MultiLayerNetwork(conf)
    jn.params = {k: {n: jnp.asarray(v) for n, v in g.items()}
                 for k, g in tree.items()}
    jn.state = {k: {} for k in tree}
    jn._tx = jn._build_tx()
    jn.opt_state = jn._tx.init(jn.params)
    return jn


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A JAX-written container (AE, RBM, VAE with a Composite
    distribution, output layer; weights made by the port from a seed),
    its JAX network, and a batch."""
    conf = _stack_conf(jv, Adam(learning_rate=0.01))
    tn = TMLN(MultiLayerConfiguration.from_json(conf.to_json()),
              device="cpu").init()
    tree = {k: {n: p.detach().numpy().copy() for n, p in g.items()}
            for k, g in tn.params.items()}
    with jax.enable_x64(False):
        jn = _jax_net(conf, tree)
        path = str(tmp_path_factory.mktemp("pre") / "stack.zip")
        write_model(jn, path)
    x = (np.random.default_rng(0).random((40, 12)) > 0.5).astype(np.float32)
    return path, tree, x


def _pair(path, tree):
    """A fresh JAX network with the container's params (pretraining
    donates them) and the port's network read from the container, both
    on the key stream ``PRNGKey(7)``."""
    jn = _jax_net(_stack_conf(jv, Adam(learning_rate=0.01)), tree)
    tn = load_reference_model(path, device="cpu")
    assert torch.equal(tn._rng, torch.tensor(
        np.asarray(jn._rng).astype(np.int64)))
    return jn, tn


def _assert_params(jn, tn, atol):
    for k, group in jn.params.items():
        for n, v in group.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(v), atol=atol, rtol=0,
                                       err_msg=f"{k}/{n}")


def test_reference_container_loads_and_pretrains(stack):
    """The container reads back as its classes; outputs and the score
    agree; then ``pretrain`` of the whole stack through
    ``MultipleEpochsIterator`` (AE and RBM by Sgd, the VAE by its own Adam)
    gives the same params, score and iteration count."""
    path, tree, x = stack
    with jax.enable_x64(False):
        jn, tn = _pair(path, tree)
        assert [type(lc).__name__ for lc in tn.conf.layers] == \
            ["AutoEncoder", "RBM", "VariationalAutoencoder", "OutputLayer"]
        dist = tn.conf.layers[2].reconstruction_distribution
        assert type(dist).__name__ == "CompositeReconstructionDistribution"
        np.testing.assert_allclose(tn.output(x).numpy(),
                                   np.asarray(jn.output(x)), atol=1e-6)
        y = np.eye(2, dtype=np.float32)[np.arange(40) % 2]
        assert abs(tn.score(x=x, y=y) - jn.score(x=x, y=y)) <= \
            RTOL32_LOSS * abs(jn.score(x=x, y=y))
        jit = jds.INDArrayDataSetIterator(x, y, 10)
        tit = tds.INDArrayDataSetIterator(x, y, 10)
        jn.pretrain(jds.MultipleEpochsIterator(2, jit))
        tn.pretrain(tds.MultipleEpochsIterator(2, tit))
    assert tn.iteration == jn.iteration == 24
    assert abs(tn.get_score() - jn.get_score()) <= \
        RTOL32_LOSS * abs(jn.get_score())
    for k in ("layer_0", "layer_1"):
        for n, v in jn.params[k].items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(v), atol=ATOL32_SGD)
    for n, v in jn.params["layer_2"].items():
        np.testing.assert_allclose(tn.params["layer_2"][n].detach().numpy(),
                                   np.asarray(v), atol=ATOL32_ADAM)
    # the output layer is not pretrainable: untouched on both sides
    _assert_params(jn, tn, atol=ATOL32_ADAM)
    # fresh updater state for fine-tuning, as in the JAX package
    assert all(c == 0 for c in tn.opt_state["count"].values())


def _forms(pkg, x, y):
    """Every input form ``_pretrain_batches`` takes, as (form, batches
    kind): the whole array at once, or two halves."""
    halves = [(x[:16], y[:16]), (x[16:], y[16:])]
    return {
        "array": (x, "whole"), "tuple": ((x, y), "whole"),
        "dataset": (pkg.DataSet(x, y), "whole"),
        # (the JAX package's INDArrayDataSetIterator carries a
        # ``features`` array, which its _pretrain_batches takes for a
        # single DataSet: an iterator without one is compared)
        "iterator": (pkg.ExistingDataSetIterator(
            [pkg.DataSet(a, b) for a, b in halves]), "halves"),
        "list": ([a for a, _ in halves], "halves"),
        "generator": ((a for a, _ in halves), "halves")}


@pytest.fixture(scope="module")
def jax_pretrained_rbm(stack):
    """The JAX package's params and iteration count after
    ``pretrain_layer(1, ..., epochs=2)`` of the RBM (over the AE's frozen
    features), from the whole array and from a generator of two
    halves."""
    path, tree, x = stack
    x, y = x[:32], np.zeros((32, 2), np.float32)
    out = {}
    with jax.enable_x64(False):
        for form in ("array", "generator"):
            jn, _ = _pair(path, tree)
            data, kind = _forms(jds, x, y)[form]
            jn.pretrain_layer(1, data, epochs=2)
            out[kind] = jn
    return out


@pytest.mark.parametrize("form", ["array", "tuple", "dataset", "iterator",
                                  "generator", "list"])
def test_pretrain_layer_input_forms(stack, jax_pretrained_rbm, form):
    """One ``pretrain_layer`` of the RBM from every input form, 2 epochs:
    the JAX package's params and iterations (a bare generator is kept
    for the second epoch); the listeners see every iteration."""
    path, tree, x = stack
    x, y = x[:32], np.zeros((32, 2), np.float32)
    data, kind = _forms(tds, x, y)[form]
    jn = jax_pretrained_rbm[kind]
    tn = load_reference_model(path, device="cpu")
    listened = []

    class Count:
        def iteration_done(self, model, iteration, epoch):
            listened.append(iteration)

    tn.set_listeners(Count())
    tn.pretrain_layer(1, data, epochs=2)
    assert tn.iteration == jn.iteration == listened[-1]
    assert listened == list(range(1, tn.iteration + 1))
    _assert_params(jn, tn, atol=ATOL32_SGD)
    # a non-pretrainable layer is a no-op
    tn.pretrain_layer(3, x)
    assert tn.iteration == jn.iteration


def test_pretrain_array_iterator_steps_per_batch(stack):
    """The port's INDArrayDataSetIterator goes batch by batch (3 batches
    of 40 rows at 16), reset before each epoch."""
    path, tree, x = stack
    tn = load_reference_model(path, device="cpu")
    tn.pretrain_layer(0, tds.INDArrayDataSetIterator(
        x, np.zeros((40, 2), np.float32), 16), epochs=2)
    assert tn.iteration == 6 and np.isfinite(tn.get_score())


def test_pretrain_config_json_round_trip():
    js = _stack_conf(jv, Adam(learning_rate=0.01)).to_json()
    read = MultiLayerConfiguration.from_json(js)
    assert read.to_json() == js
    assert [getattr(lc, "PRETRAINABLE", False) for lc in read.layers] == \
        [True, True, True, False]


def test_check_gradients_matches_jax(stack, capsys):
    """``check_gradients`` on the container's net (AE, RBM, VAE with a
    Composite distribution, output layer), float64: the same verdict and
    the same elements checked (the subset drawn from the same seed)."""
    path, tree, _ = stack
    jn, tn = _pair(path, tree)
    r = np.random.default_rng(3)
    x = (r.random((6, 12)) > 0.5).astype(np.float64)
    y = np.eye(2)[r.integers(0, 2, 6)]
    want = jcheck(jn, x, y, subset=4, print_results=True)
    jout = capsys.readouterr().out
    got = tcheck(tn, x, y, subset=4, print_results=True)
    tout = capsys.readouterr().out

    def checked(out):
        return [line.split(":")[0].split("param ")[1]
                for line in out.splitlines() if "param " in line]

    assert got == want is True
    assert checked(tout) == checked(jout) and len(checked(tout)) > 50
