"""Single-layer distributed training (port of ``parallel/layer.py``;
reference ``dl4j-spark/.../spark/impl/layer/SparkDl4jLayer.java:48`` +
``IterativeReduceFlatMap.java`` — train ONE layer's parameters across
partitions, averaging per pass).

The "cluster" is a :class:`TrainingMaster` (threaded replicas standing
in for Spark executors); the layer is wrapped in a one-layer
``MultiLayerNetwork`` so the normal train step drives it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .master import ParameterAveragingTrainingMaster, TrainingMaster

__all__ = ["DistributedLayerTrainer"]


class DistributedLayerTrainer:
    """SparkDl4jLayer role: ``fit`` a single output layer distributed, then
    ``predict`` with it."""

    def __init__(self, layer_conf, input_size: int,
                 master: Optional[TrainingMaster] = None, seed: int = 0,
                 updater=None, device="cuda"):
        from ..nn.conf.input_type import InputType
        from ..nn.conf.multi_layer import NeuralNetConfiguration
        from ..nn.multilayer import MultiLayerNetwork
        builder = NeuralNetConfiguration.builder().seed(seed)
        if updater is not None:
            builder = builder.updater(updater)
        conf = (builder.list()
                .layer(layer_conf)
                .set_input_type(InputType.feed_forward(input_size))
                .build())
        self.net = MultiLayerNetwork(conf, device=device).init()
        self.master = master or ParameterAveragingTrainingMaster(num_workers=2)

    def fit(self, iterator, epochs: int = 1) -> "DistributedLayerTrainer":
        """``fitDataSet(JavaRDD<DataSet>)`` role (SparkDl4jLayer.java:105)."""
        for _ in range(epochs):
            if hasattr(iterator, "reset"):
                iterator.reset()
            self.master.fit(self.net, iterator)
        return self

    def predict(self, features) -> np.ndarray:
        """``predict(Matrix)`` role (SparkDl4jLayer.java:169)."""
        out = self.net.output(np.asarray(features, np.float32))
        return out.detach().cpu().numpy()
