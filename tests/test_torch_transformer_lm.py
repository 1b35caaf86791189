"""A small TransformerLM built and initialised by the JAX package, written
with ``write_model``, read by the port, and run on both sides.

vocab 32, seq 128, embed 128, 2 heads (head_dim 64), 2 layers: the
attention takes the flash path in the port ('auto' at t >= 128) and the
reference path in JAX on the CPU, so this also holds the port's plain
flash forward against the reference attention end to end.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JaxTransformerLM
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (
    CorruptModelError, load_reference_model, params_from_jax)

SMALL = dict(vocab_size=32, seq_len=128, embed=128, n_layers=2, n_heads=2)
# softmax probabilities after two f32 blocks, sums in another order
ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_net():
    return JaxTransformerLM(**SMALL).init()


@pytest.fixture(scope="module")
def model_zip(jax_net, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_lm") / "lm.zip"
    write_model(jax_net, str(path))
    return path


def _tree(jax_net):
    return jax.tree_util.tree_map(np.asarray, jax_net.params)


def _batch(seed=0, n=3):
    ids = np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                               (n, SMALL["seq_len"]))
    return ids, np.eye(SMALL["vocab_size"], dtype=np.float32)[ids]


def test_loaded_zip_matches_jax_output(jax_net, model_zip):
    net = load_reference_model(model_zip, device="cpu")
    assert net.num_params() == jax_net.num_params()
    ids, one_hot = _batch()
    want = np.asarray(jax_net.output(one_hot))
    got = net.output(one_hot).numpy()
    assert got.shape == (3, SMALL["seq_len"], SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(net.output(ids).numpy(), want, atol=ATOL,
                               rtol=0)


def test_params_from_jax_matches_jax_output(jax_net):
    net = params_from_jax(TransformerLM(**SMALL).init(device="cpu"),
                          _tree(jax_net))
    _, one_hot = _batch(seed=1, n=2)
    want = np.asarray(jax_net.output(one_hot))
    np.testing.assert_allclose(net.output(one_hot).numpy(), want,
                               atol=ATOL, rtol=0)


def test_conf_round_trips_through_both_readers(jax_net):
    conf = MultiLayerConfiguration.from_json(jax_net.conf.to_json())
    mine = TransformerLM(**SMALL).conf()
    assert [type(lc).__name__ for lc in conf.layers] == \
        [type(lc).__name__ for lc in mine.layers]
    net = MultiLayerNetwork(conf, device="cpu")
    assert net.param_spec() == MultiLayerNetwork(mine, device="cpu") \
        .param_spec()


def test_fresh_init_is_seeded_and_finite():
    a = TransformerLM(**SMALL).init(device="cpu")
    b = TransformerLM(**SMALL).init(device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    _, one_hot = _batch(n=1)
    y = a.output(one_hot)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y.sum(-1), torch.ones(1, SMALL["seq_len"]))


def test_param_tree_mismatch_raises(jax_net):
    net = TransformerLM(**SMALL).init(device="cpu")
    tree = _tree(jax_net)
    bad_shape = {k: dict(v) for k, v in tree.items()}
    bad_shape["layer_0"]["W"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(net, bad_shape)
    missing = {k: dict(v) for k, v in tree.items()}
    del missing["layer_2"]["mha_Wq"]
    with pytest.raises(ValueError, match="names"):
        params_from_jax(net, missing)
    with pytest.raises(ValueError, match="unknown groups"):
        params_from_jax(net, {**tree, "layer_9": {}})


def test_unported_class_and_corrupt_zip_raise(jax_net, tmp_path):
    # every updater is ported since the rest-of-training slice, and the
    # precision policy since the precision and memory slice: a class the
    # port still lacks (a pretraining layer) raises when read
    js = jax_net.conf.to_json().replace('"Adam"', '"PrecisionPolicy"', 1)
    read = MultiLayerConfiguration.from_json(js)
    assert any(type(lc.updater).__name__ == "PrecisionPolicy"
               for lc in read.layers)
    js = jax_net.conf.to_json().replace('"Adam"', '"AutoEncoder"', 1)
    with pytest.raises(ValueError, match="not ported"):
        MultiLayerConfiguration.from_json(js)
    bad = tmp_path / "bad.zip"
    bad.write_bytes(b"not a zip")
    with pytest.raises(CorruptModelError):
        load_reference_model(bad, device="cpu")
