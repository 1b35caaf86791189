"""Two repairs of the port against the JAX package:

- a ComputationGraph built without declared input types loads from the
  JAX package's container and trains as the JAX graph does (types stay
  None past an untyped input; the layers keep their explicit n_in);
- every refusal left in the port names its current ROADMAP item.

Tolerance for the graph: 1e-6 absolute on outputs, step-0 gradients and
the params after one Sgd step (f32 on both sides, sums of 4-5 terms in
another order: ~1e-7).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.computation_graph import \
    _graph_loss as j_graph_loss
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer as JOut
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.computation_graph import _graph_loss
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers.feedforward import \
    EmbeddingSequenceLayer
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

ATOL = 1e-6


def _untyped_graph():
    return (JNNC.builder().seed(1).updater(JSgd(learning_rate=0.1))
            .graph_builder().add_inputs("in")
            .add_layer("d", JDense(n_in=4, n_out=5, activation="tanh"), "in")
            .add_layer("out", JOut(n_in=5, n_out=3, activation="softmax",
                                   loss="mcxent"), "d")
            .set_outputs("out").build())


def test_graph_without_input_types_loads_and_trains_as_jax(tmp_path):
    conf = _untyped_graph()
    assert not conf.input_types
    jn = JCG(conf).init()
    path = str(tmp_path / "untyped.zip")
    write_model(jn, path)
    tn = load_reference_model(path, device="cpu")
    assert tn.conf.vertex_input_types == {"d": [None], "out": [None]}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x)), atol=ATOL, rtol=0)
    # step-0 gradients
    jg = jax.grad(lambda p: j_graph_loss(
        jn.conf, p, jn.state, [jnp.asarray(x)], [jnp.asarray(y)],
        train=True, key=None)[0])(jn.params)
    params = tn._param_tree()
    keys = [(k, n) for k in params for n in params[k]]
    loss, _ = _graph_loss(tn.conf, params, tn.state, [torch.tensor(x)],
                          [torch.tensor(y)], train=True)
    tg = torch.autograd.grad(loss, [params[k][n] for k, n in keys])
    for (k, n), g in zip(keys, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k][n]),
                                   atol=ATOL, rtol=0, err_msg=f"{k}/{n}")
    # one updater step
    jn.fit([x], [y])
    tn.fit([x], [y])
    np.testing.assert_allclose(tn.get_score(), jn.get_score(), rtol=1e-6)
    for k, g in jn.params.items():
        for n, a in g.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), atol=ATOL, rtol=0,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("case", ["sparse_grad", "moe", "ring", "ulysses",
                                  "keras_h5"])
def test_every_remaining_refusal_names_its_roadmap_item(case, tmp_path):
    """What stays refused, and what the model-axes slice ported in place
    of a refusal.  The sparse-embedding gradient is ported: what stays
    refused is the JAX package's own rule, a sparse-gradient vertex in a
    ComputationGraph, and a tensor-parallel ``param_rule`` with ZeRO-1
    (the JAX package's refusal).  MoE is ported: a block with
    ``moe_experts`` builds, and only a wrapper of several ranks refuses
    it (item 8).  Ring and Ulysses attention are ported: outside a mesh
    the ``seq`` axis is unbound, as in JAX.  The zoo's Keras-HDF5 branch
    of ``pretrained`` is ported (item 9 d): a file that is not HDF5
    beyond its signature raises the reader's ``Hdf5FormatError``, as the
    JAX package does on the same bytes, and a Keras file that the JAX
    package wrote loads with the JAX package's outputs."""
    if case == "sparse_grad":
        from deeplearning4j_tpu_torch.nn.computation_graph import \
            _build_graph_train_step
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper
        lc = EmbeddingSequenceLayer(n_in=4, n_out=2, sparse_grad=True)
        conf = SimpleNamespace(
            defaults={}, vertices={"emb": SimpleNamespace(layer=lc)},
            network_outputs=[], topological_order=["emb"])
        with pytest.raises(ValueError, match="vertex 'emb': sparse_grad"):
            _build_graph_train_step(conf, None)
        with pytest.raises(ValueError,
                           match="shard_optimizer_state=True is only "
                                 "supported with replicated params"):
            ParallelWrapper(None, param_rule=lambda *a: None,
                            shard_optimizer_state=True)
    elif case == "moe":
        block = tatt.TransformerBlock(n_in=8, moe_experts=2)
        assert block.AUX_LOSS
        from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
        names = set(block.init(torch.Generator(),
                               InputType.recurrent(8, 4), "meta"))
        assert {"router", "w1", "b1", "w2", "b2"} <= names
        from deeplearning4j_tpu_torch.parallel import wrapper
        net = tzoo.TransformerLM(vocab_size=7, seq_len=4, embed=8,
                                 n_layers=1, n_heads=2,
                                 moe_experts=2).init(device="cpu")
        assert wrapper._has_aux_loss(net)
    elif case in ("ring", "ulysses"):
        q = torch.zeros(1, 1, 4, 8)
        with pytest.raises(NameError, match="unbound axis name: 'seq'"):
            tatt._run_attention(q, q, q, impl=case, causal=True)
    else:
        from deeplearning4j_tpu.modelimport import (
            Hdf5FormatError as JHdf5FormatError, export_keras_sequential)
        from deeplearning4j_tpu.models import zoo as jzoo
        from deeplearning4j_tpu_torch.modelimport import Hdf5FormatError
        h5 = tmp_path / "w.h5"
        h5.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(8))
        with pytest.raises(JHdf5FormatError) as jerr:
            jzoo.ResNet50().pretrained(str(h5))
        with pytest.raises(Hdf5FormatError) as terr:
            tzoo.ResNet50().pretrained(str(h5), device="cpu")
        assert str(terr.value) == str(jerr.value)
        kw = dict(num_classes=3, input_shape=(8, 8, 3))
        src = jzoo.SimpleCNN(**kw).init()
        real = tmp_path / "simplecnn.h5"
        export_keras_sequential(src, str(real))
        x = np.random.default_rng(3).standard_normal(
            (2, 8, 8, 3)).astype(np.float32)
        want = np.asarray(jzoo.SimpleCNN(**kw).pretrained(str(real)).output(x))
        got = tzoo.SimpleCNN(**kw).pretrained(str(real), device="cpu")
        np.testing.assert_allclose(got.output(x).numpy(), want, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(want, np.asarray(src.output(x)),
                                   atol=1e-6, rtol=0)
