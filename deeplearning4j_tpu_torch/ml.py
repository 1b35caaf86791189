"""Pipeline Estimator/Model wrappers (port of ``ml.py``; scikit-learn-style
duck-typed API).

Reference ``dl4j-spark-ml``: ``SparkDl4jNetwork.scala`` /
``AutoEncoder.scala`` wrap networks as Spark ``ml.Pipeline`` stages
(Estimator.fit → Model.transform).  The TPU build targets the Python
ecosystem's equivalent contract — sklearn's ``fit``/``predict``/
``transform``/``get_params``/``set_params`` — without importing sklearn
(duck typing is the whole protocol), so the wrappers drop into sklearn
pipelines and cross-validators when sklearn is present.  The networks
train on ``device`` (default ``"cuda"``, a param of each stage);
predictions come back as host numpy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["NetworkEstimator", "NetworkModel", "AutoEncoderEstimator"]


def _host(a) -> np.ndarray:
    """A host array from a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class _ParamsMixin:
    _PARAM_NAMES = ()

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(f"unknown param '{k}' for "
                                 f"{type(self).__name__}")
            setattr(self, k, v)
        return self


class NetworkModel(_ParamsMixin):
    """Fitted model stage: predict/transform (reference
    ``SparkDl4jModel.transform``)."""

    _PARAM_NAMES = ("batch_size",)

    def __init__(self, network, batch_size: int = 128):
        self.network = network
        self.batch_size = batch_size

    def _batched(self, x, fn) -> np.ndarray:
        x = np.asarray(x)
        outs = [_host(fn(x[i:i + self.batch_size]))
                for i in range(0, len(x), self.batch_size)]
        return np.concatenate(outs) if outs else np.zeros((0,))

    def predict_proba(self, x) -> np.ndarray:
        out = self._batched(x, self.network.output)
        return out

    def predict(self, x) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=-1)

    def transform(self, x) -> np.ndarray:
        """Spark-ML naming: transform == predict_proba for classifiers."""
        return self.predict_proba(x)

    def score(self, x, y) -> float:
        """Mean accuracy (sklearn classifier contract); y may be class
        indices or one-hot."""
        y = np.asarray(y)
        if y.ndim > 1:
            y = np.argmax(y, axis=-1)
        return float(np.mean(self.predict(x) == y))


class NetworkEstimator(_ParamsMixin):
    """Unfitted stage: holds a config factory, fit() trains a fresh net
    (reference ``SparkDl4jNetwork`` Estimator)."""

    _PARAM_NAMES = ("epochs", "batch_size", "num_classes", "device")

    def __init__(self, conf_factory: Callable[[], Any], epochs: int = 5,
                 batch_size: int = 128, num_classes: Optional[int] = None,
                 device="cuda"):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.device = device

    def _build(self):
        from .nn.conf.multi_layer import MultiLayerConfiguration
        from .nn.computation_graph import ComputationGraph
        from .nn.multilayer import MultiLayerNetwork
        conf = self.conf_factory()
        if isinstance(conf, MultiLayerConfiguration):
            return MultiLayerNetwork(conf, device=self.device).init()
        if hasattr(conf, "network_inputs"):
            return ComputationGraph(conf, device=self.device).init()
        return conf  # already a network

    def fit(self, x, y=None) -> NetworkModel:
        net = self._build()
        x = np.asarray(x, np.float32)
        if y is None:
            raise ValueError("NetworkEstimator.fit needs labels y")
        y = np.asarray(y)
        if y.ndim == 1:  # class indices → one-hot
            n_cls = self.num_classes or int(y.max()) + 1
            y = np.eye(n_cls, dtype=np.float32)[y.astype(int)]
        from .data.dataset import INDArrayDataSetIterator
        it = INDArrayDataSetIterator(x, y.astype(np.float32),
                                     self.batch_size)
        net.fit(it, epochs=self.epochs)
        return NetworkModel(net, batch_size=self.batch_size)


class AutoEncoderEstimator(_ParamsMixin):
    """Unsupervised stage (reference ``AutoEncoder.scala``): pretrains an
    autoencoder stack, transform() yields the encoded representation."""

    _PARAM_NAMES = ("epochs", "batch_size", "encode_layer", "device")

    def __init__(self, conf_factory: Callable[[], Any], epochs: int = 5,
                 batch_size: int = 128, encode_layer: int = 0,
                 device="cuda"):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.encode_layer = encode_layer
        self.device = device

    def fit(self, x, y=None) -> "AutoEncoderEstimator._Model":
        from .nn.multilayer import MultiLayerNetwork
        net = MultiLayerNetwork(self.conf_factory(),
                                device=self.device).init()
        x = np.asarray(x, np.float32)
        batches = [x[i:i + self.batch_size]
                   for i in range(0, len(x), self.batch_size)]
        net.pretrain(batches, epochs=self.epochs)
        return AutoEncoderEstimator._Model(net, self.encode_layer,
                                           self.batch_size)

    class _Model(_ParamsMixin):
        _PARAM_NAMES = ("batch_size",)

        def __init__(self, network, encode_layer: int, batch_size: int):
            self.network = network
            self.encode_layer = encode_layer
            self.batch_size = batch_size

        def transform(self, x) -> np.ndarray:
            x = np.asarray(x, np.float32)
            outs = []
            for i in range(0, len(x), self.batch_size):
                acts = self.network.feed_forward(x[i:i + self.batch_size])
                outs.append(_host(acts[self.encode_layer]))
            return np.concatenate(outs) if outs else np.zeros((0,))
