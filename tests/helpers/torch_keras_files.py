"""Shared by ``tests/test_torch_modelimport.py`` and
``tests/test_torch_keras_export_zoo.py``: Keras-style HDF5 files written by
the JAX package's own writer (as its own import tests write them), and
the checks that an imported port network holds the JAX importer's
params bit for bit."""
import json

import numpy as np

from deeplearning4j_tpu import modelimport as jmi

# Outputs of the same f32 params through two libraries' kernels (matrix
# products and convolutions summing in another order): 1e-5 abs at
# activations of order 1.
ATOL_OUT = 1e-5


def keras_file(layers, weights, extra_root_attrs=None):
    """A Keras-style save file, written by the JAX package's writer:
    model_config JSON attr + /model_weights/<layer>/<name> datasets with
    layer_names/weight_names (as the JAX package's own import tests)."""
    tree = {"model_weights": {}}
    attrs = {"/": {"model_config":
                   json.dumps({"class_name": "Sequential", "config": layers}),
                   "keras_version": "2.1.6", "backend": "tensorflow",
                   **(extra_root_attrs or {})},
             "/model_weights": {"layer_names":
                                [l["config"]["name"] for l in layers]}}
    for lname, wdict in weights.items():
        tree["model_weights"][lname] = {f"{n}:0": arr
                                        for n, arr in wdict.items()}
        attrs[f"/model_weights/{lname}"] = {
            "weight_names": [f"{lname}/{n}:0" for n in wdict]}
    return jmi.Hdf5Writer().write(tree, attrs)


def dense(name, units, activation, input_shape=None, use_bias=True):
    cfg = {"name": name, "units": units, "activation": activation,
           "use_bias": use_bias}
    if input_shape:
        cfg["batch_input_shape"] = [None] + list(input_shape)
    return {"class_name": "Dense", "config": cfg}


def randn(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def zeros(*shape):
    return np.zeros(shape, np.float32)


def first(y):
    return y[0] if isinstance(y, (list, tuple)) else y


def host_params(net):
    return {k: {n: np.asarray(v) for n, v in g.items()}
            for k, g in net.params.items()}


def assert_params_bit_equal(jnet, tnet):
    jp = host_params(jnet)
    tp = {k: {n: p.detach().numpy() for n, p in g.items()}
          for k, g in tnet.params.items()}
    assert {k for k, g in jp.items() if g} == {k for k, g in tp.items() if g}
    for k, g in jp.items():
        assert sorted(g) == sorted(tp.get(k, {})), k
        for n, a in g.items():
            b = tp[k][n]
            assert a.dtype == b.dtype and a.shape == b.shape, (k, n)
            assert np.array_equal(a, b), (k, n)
    for k, g in jnet.state.items():
        for n, a in g.items():
            assert np.array_equal(np.asarray(a), tnet.state[k][n].numpy()), \
                (k, n)
