"""Sources, transforms and rank jobs for the port's input-pipeline tests.

The ETL workers of ``data/pipeline.MultiprocessETLIterator`` are spawned
and unpickle their ``source_factory`` and ``transform`` by module path,
so these live in a module that imports numpy and the port's ``data``
package only (no jax, no torch) at its top.  ``prefetch_mesh_job`` runs
on gloo ranks (``torch_ranks.run_ranks``) and imports the port's
networks (torch) inside.
"""
import numpy as np

from deeplearning4j_tpu_torch.data.dataset import (DataSet, DataSetIterator,
                                                   INDArrayDataSetIterator)

IMAGE_SHAPE = (6, 6, 2)


def images(n: int, seed: int):
    """``n`` images [n, 6, 6, 2] and one-hot labels of 3 classes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + IMAGE_SHAPE).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def image_source(n: int = 44, batch: int = 8, seed: int = 3):
    """A shuffled array iterator over ``images(n, seed)``."""
    x, y = images(n, seed)
    return INDArrayDataSetIterator(x, y, batch, shuffle=True, seed=seed)


def doubling(feats, rng):
    """A transform whose output is twice the rows where its draw says so:
    the batches that outgrow a slab sized for the plain batch."""
    out = feats * np.float32(rng.standard_normal())
    return np.concatenate([out, out]) if rng.random() < 0.5 else out


class FailingSource(DataSetIterator):
    """Three batches, then an error raised inside the source."""

    def batch(self):
        return 4

    def __iter__(self):
        x, y = images(12, 0)
        for i in range(0, 12, 4):
            yield DataSet(x[i:i + 4], y[i:i + 4])
        raise_inside_the_source()


def raise_inside_the_source():
    raise ValueError("the source broke at batch 3")


def failing_source():
    return FailingSource()


def module_probe():
    """One batch whose features say whether this process has loaded
    torch and jax: ``[[torch?, jax?]]`` as 0/1 (an ETL worker must
    load neither)."""
    import sys
    flags = [float(m in sys.modules) for m in ("torch", "jax")]
    return INDArrayDataSetIterator(np.asarray([flags], np.float32),
                                   np.ones((1, 1), np.float32), 1)


PREFETCH_BATCHES = (8, 8, 11)


def _conv_bn(dev):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(Sgd(learning_rate=0.1)).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu", helper="pallas"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(*IMAGE_SHAPE)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def prefetch_mesh_job(rank, world, payload):
    """The conv-BN net under ``ParallelWrapper`` at dp ``world``, fed the
    host batches, then (from the same weights) the mesh prefetcher over
    the same batches.  Returns both runs' params, state, losses and
    ``last_batch_size``, as numpy."""
    from deeplearning4j_tpu_torch.data.dataset import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.pipeline import DevicePrefetchIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
    mesh = make_mesh(device="cpu")
    batches = [DataSet(*images(n, 10 + i))
               for i, n in enumerate(PREFETCH_BATCHES)]
    first = _conv_bn("cpu")
    tree = {k: {n: p.detach().numpy().copy() for n, p in g.items()}
            for k, g in first.params.items()}
    out = {"tree": tree}
    for name in ("host", "prefetch"):
        net = first if name == "host" else _conv_bn("cpu").load_params(tree)
        feed = ExistingDataSetIterator(batches)
        if name == "prefetch":
            feed = DevicePrefetchIterator(feed, depth=2, mesh=mesh)
        losses = []

        class Losses:
            def iteration_done(self, model, iteration, epoch):
                losses.append(float(model.get_score()))

            def on_epoch_start(self, model):
                pass

            def on_epoch_end(self, model):
                pass

        net.set_listeners(Losses())
        ParallelWrapper(net, mesh).fit(feed)
        out[name] = {
            "losses": losses, "last_batch_size": net.last_batch_size,
            "params": {k: {n: p.detach().numpy().copy()
                           for n, p in g.items()}
                       for k, g in net.params.items()},
            "state": {k: {n: t.numpy().copy() for n, t in g.items()}
                      for k, g in net.state.items()}}
    return out
