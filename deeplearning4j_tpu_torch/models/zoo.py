"""Zoo models (port of ``models/zoo.py``): the conv zoo (``LeNet``,
``SimpleCNN``, ``AlexNet``, ``VGG16``, ``VGG19``, ``ResNet50``,
``GoogLeNet``, ``InceptionResNetV1``, ``FaceNetNN4Small2``),
``TextGenerationLSTM``, ``TransformerLM``, ``ALL_MODELS`` and
``ModelSelector``.

Each model has the JAX zoo model's fields, defaults, layers, vertex
names and updater; ``conf()`` gives its configuration and
``init(device=...)`` the network with fresh seeded parameters (torch's
numbers, not JAX's: parity runs load the JAX package's).  ``pretrained``
loads a local native zip (``load_reference_model``) or a Keras HDF5
file, which ``import_pretrained`` imports (``modelimport/keras``) and
transplants onto the zoo model's own network.  ``compute_dtype`` sets
the precision knob in the defaults where the JAX zoo does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, List, Optional, Tuple

from ..nn.computation_graph import ComputationGraph
from ..nn.conf.computation_graph import (ComputationGraphConfiguration,
                                         ElementWiseVertex, GraphBuilder,
                                         L2NormalizeVertex, MergeVertex,
                                         ScaleVertex)
from ..nn.conf.input_type import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.updaters import Adam, Nesterovs, UpdaterConf
from ..nn.layers.attention import PositionalEncodingLayer, TransformerBlock
from ..nn.layers.base import LayerConf
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.feedforward import (ActivationLayer, CenterLossOutputLayer,
                                     DenseLayer, DropoutLayer,
                                     EmbeddingSequenceLayer, OutputLayer)
from ..nn.layers.normalization import (BatchNormalization,
                                       LocalResponseNormalization)
from ..nn.layers.pooling import GlobalPoolingLayer
from ..nn.layers.recurrent import LSTM, RnnOutputLayer
from ..nn.multilayer import MultiLayerNetwork


def _conv_block(g: GraphBuilder, name: str, inp: str, n_out: int, kernel,
                stride=(1, 1), act: Optional[str] = None,
                mode: str = "same") -> str:
    """Add a conv layer vertex; act=None inherits the builder default."""
    g.add_layer(name, ConvolutionLayer(
        n_out=n_out, kernel_size=kernel, stride=stride,
        convolution_mode=mode, activation=act), inp)
    return name


def _max_pool(g: GraphBuilder, name: str, inp: str, kernel=(3, 3),
              stride=(2, 2)) -> str:
    g.add_layer(name, SubsamplingLayer(
        pooling_type="max", kernel_size=kernel, stride=stride,
        convolution_mode="same"), inp)
    return name


def _with_compute_dtype(dt: Optional[str], defaults: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """``defaults`` with ``compute_dtype`` first where ``dt`` is set, as
    the JAX zoo's builder writes it."""
    return {"compute_dtype": dt, **defaults} if dt else defaults


def _pretrained(model, weights_path: Optional[str], device):
    """``pretrained`` of any zoo model: a native zip written by the JAX
    package's ``write_model`` (or the port), read by
    ``load_reference_model``, or a Keras HDF5 file (by its signature),
    through ``import_pretrained``."""
    path = weights_path or os.environ.get("DL4J_TPU_PRETRAINED_DIR")
    if not path:
        raise FileNotFoundError(
            f"no pretrained weights available for {type(model).__name__}; "
            "pass weights_path or set DL4J_TPU_PRETRAINED_DIR")
    if os.path.isdir(path):
        path = os.path.join(path, f"{type(model).__name__.lower()}.zip")
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"\x89HDF":
        return model.import_pretrained(path, device=device)
    from ..utils.model_serializer import load_reference_model
    return load_reference_model(path, device=device)


def _import_pretrained(model, keras_path, device):
    """``import_pretrained`` of any zoo model: the Keras file imported
    through the import bridge, its params and state grafted layer for
    layer onto the zoo model's own network (so its updater, dtype and
    configuration stay the zoo's)."""
    from ..modelimport.keras import import_keras_model
    imported = import_keras_model(keras_path, device=device)
    target = model.init(device=device)
    _transplant_params(imported, target,
                       what=f"{type(model).__name__} <- {keras_path}")
    return target


def _ordered_stateful_keys(model) -> List[str]:
    """Keys of the layers or vertices holding params or state, in
    execution order: topological order for a ComputationGraph, layer
    index for a MultiLayerNetwork."""
    from ..nn.precision import SCALE_STATE_KEY
    has = {k for k, g in model.params.items() if len(g)}
    has |= {k for k, v in model.state.items()
            if v and k != SCALE_STATE_KEY}
    order = getattr(model.conf, "topological_order", None)
    if order:
        return [k for k in order if k in has]
    return sorted(has, key=lambda k: int(k.split("_")[-1]))


def _transplant_params(src, dst, what: str = "") -> None:
    """Copy params and state (BN running statistics) from ``src`` onto
    ``dst`` by execution order, with shape checks: a mismatch raises
    naming the layer rather than truncating.  Params and state ride the
    same layer pairing, so a source layer without some optional state
    cannot shift later layers' running statistics onto the wrong target
    (state names one side lacks keep the target's values)."""
    import torch
    src_layers = _ordered_stateful_keys(src)
    dst_layers = _ordered_stateful_keys(dst)
    if len(src_layers) != len(dst_layers):
        raise ValueError(
            f"transplant {what}: source has {len(src_layers)} "
            f"param/state-bearing layers, target {len(dst_layers)} — "
            "architectures differ")
    for sk, dk in zip(src_layers, dst_layers):
        sp = dict(src.params[sk].items()) if sk in src.params else {}
        dp = dict(dst.params[dk].items()) if dk in dst.params else {}
        if set(sp) != set(dp):
            raise ValueError(f"transplant {what}: layer {dk} params "
                             f"{sorted(dp)} != source {sorted(sp)}")
        for name in sp:
            if tuple(sp[name].shape) != tuple(dp[name].shape):
                raise ValueError(
                    f"transplant {what}: {dk}.{name} shape "
                    f"{tuple(dp[name].shape)} != source "
                    f"{tuple(sp[name].shape)}")
            with torch.no_grad():
                dp[name].copy_(sp[name])
        ss, ds = src.state.get(sk) or {}, dst.state.get(dk) or {}
        for name, val in ss.items():
            if name not in ds:
                continue              # optional state the target lacks
            if tuple(val.shape) != tuple(ds[name].shape):
                raise ValueError(
                    f"transplant {what}: {dk} state '{name}' shape "
                    f"{tuple(ds[name].shape)} != source {tuple(val.shape)}")
            ds[name] = val.to(device=ds[name].device,
                              dtype=ds[name].dtype).clone()


def _inception_block(g: GraphBuilder, name: str, inp: str, c1: int, c3r: int,
                     c3: int, c5r: int, c5: int, pp: int) -> str:
    """GoogLeNet-style inception module: 1x1 / 3x3 / 5x5 / pool-projection
    branches merged on the channel axis."""
    a = _conv_block(g, f"{name}_1x1", inp, c1, (1, 1))
    b = _conv_block(g, f"{name}_3x3r", inp, c3r, (1, 1))
    b = _conv_block(g, f"{name}_3x3", b, c3, (3, 3))
    d = _conv_block(g, f"{name}_5x5r", inp, c5r, (1, 1))
    d = _conv_block(g, f"{name}_5x5", d, c5, (5, 5))
    g.add_layer(f"{name}_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
        convolution_mode="same"), inp)
    p = _conv_block(g, f"{name}_poolproj", f"{name}_pool", pp, (1, 1))
    g.add_vertex(name, MergeVertex(), a, b, d, p)
    return name


@dataclass
class ZooModel:
    """Base of the conv zoo models (reference ``ZooModel``): fields and
    defaults as the JAX package's; ``model_type`` is ``ModelSelector``'s
    filter key.  ``pretrained`` reads a native zip or a Keras HDF5 file,
    ``import_pretrained`` a Keras HDF5 file."""
    model_type: ClassVar[str] = "cnn"
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)   # (h, w, c)
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self):
        raise NotImplementedError

    def _stack(self, layers: List[LayerConf], defaults: Dict[str, Any],
               itype: InputType) -> MultiLayerConfiguration:
        """A layer stack as the JAX package's ``ListBuilder`` makes it:
        layers named ``layer{i}``, ``compute_dtype`` first in the
        defaults where it is set (the JAX zoo's ``_builder``)."""
        defaults = _with_compute_dtype(self.compute_dtype, defaults)
        for i, lc in enumerate(layers):
            if lc.name is None:
                lc.name = f"layer{i}"
        return MultiLayerConfiguration(layers=layers, input_type=itype,
                                       defaults=defaults, seed=self.seed)

    def _graph(self, default_updater: UpdaterConf) -> GraphBuilder:
        """A graph builder with the conv graphs' defaults (relu, relu
        init) and one NHWC input ``in``.  As in the JAX zoo, these graphs
        (GoogLeNet, InceptionResNetV1, FaceNetNN4Small2) take no
        ``compute_dtype``: a caller sets a policy on ``conf().defaults``."""
        h, w, c = self.input_shape
        g = GraphBuilder({"activation": "relu", "weight_init": "relu",
                          "updater": self.updater or default_updater},
                         seed=self.seed)
        g.add_inputs("in").set_input_types(InputType.convolutional(h, w, c))
        return g

    def init(self, device="cuda"):
        """The network on ``device`` with fresh seeded parameters."""
        conf = self.conf()
        cls = ComputationGraph if isinstance(
            conf, ComputationGraphConfiguration) else MultiLayerNetwork
        return cls(conf, device=device).init()

    def pretrained(self, weights_path: Optional[str] = None, device="cuda"):
        """The network from local pretrained weights (the JAX zoo's
        ``pretrained``; the reference downloads, this reads a file):
        ``weights_path``, or ``DL4J_TPU_PRETRAINED_DIR``; a directory
        means ``<class name, lower case>.zip`` inside it.  A Keras HDF5
        file (found by its signature) goes to ``import_pretrained``."""
        return _pretrained(self, weights_path, device)

    def import_pretrained(self, keras_path, device="cuda"):
        """The network with the weights of a Keras HDF5 file (the JAX
        zoo's ``import_pretrained``): imported through
        ``modelimport.keras.import_keras_model``, then its params and
        state grafted by execution order onto this model's fresh network,
        which keeps the zoo's updater, dtype and configuration."""
        return _import_pretrained(self, keras_path, device)


@dataclass
class LeNet(ZooModel):
    """LeNet-5 (reference ``LeNet.java``): flat 28x28x1 input reshaped to
    NHWC by the automatic preprocessor, as the reference's
    ``InputType.convolutionalFlat``."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (28, 28, 1)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return self._stack(
            [ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                              convolution_mode="same"),
             SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                              stride=(2, 2)),
             ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                              convolution_mode="same"),
             SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                              stride=(2, 2)),
             DenseLayer(n_out=500),
             OutputLayer(n_out=self.num_classes, activation="softmax",
                         loss="mcxent")],
            {"updater": self.updater or Nesterovs(learning_rate=0.01,
                                                  momentum=0.9),
             "activation": "relu", "weight_init": "xavier"},
            InputType.convolutional_flat(h, w, c))


@dataclass
class SimpleCNN(ZooModel):
    """Compact CNN with BatchNormalization (reference ``SimpleCNN.java``)."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (48, 48, 3)

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape

        def conv(n):
            return ConvolutionLayer(n_out=n, kernel_size=(3, 3),
                                    convolution_mode="same")

        def pool():
            return SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2))
        return self._stack(
            [conv(16), BatchNormalization(), conv(16), BatchNormalization(),
             pool(),
             conv(32), BatchNormalization(), conv(32), BatchNormalization(),
             pool(),
             DropoutLayer(dropout=0.5),
             DenseLayer(n_out=256),
             OutputLayer(n_out=self.num_classes, activation="softmax",
                         loss="mcxent")],
            {"updater": self.updater or Adam(learning_rate=1e-3),
             "activation": "relu", "weight_init": "relu"},
            InputType.convolutional(h, w, c))


@dataclass
class AlexNet(ZooModel):
    """AlexNet, one tower (reference ``AlexNet.java``): LRN after the
    first two convolutions, dropout 0.5 on both dense layers."""

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape

        def conv(n, k, stride=(1, 1)):
            return ConvolutionLayer(n_out=n, kernel_size=k, stride=stride,
                                    convolution_mode="same")

        def pool():
            return SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                    stride=(2, 2))
        return self._stack(
            [conv(96, (11, 11), (4, 4)), LocalResponseNormalization(),
             pool(),
             conv(256, (5, 5)), LocalResponseNormalization(), pool(),
             conv(384, (3, 3)), conv(384, (3, 3)), conv(256, (3, 3)),
             pool(),
             DenseLayer(n_out=4096, dropout=0.5),
             DenseLayer(n_out=4096, dropout=0.5),
             OutputLayer(n_out=self.num_classes, activation="softmax",
                         loss="mcxent")],
            {"updater": self.updater or Nesterovs(learning_rate=1e-2,
                                                  momentum=0.9),
             "activation": "relu", "weight_init": "relu", "l2": 5e-4},
            InputType.convolutional(h, w, c))


def _vgg_blocks(cfg) -> List[LayerConf]:
    """cfg: (number of 3x3 convolutions, channels) per block, each block
    ending in a 2x2 max pool."""
    layers: List[LayerConf] = []
    for n, ch in cfg:
        for _ in range(n):
            layers.append(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                           convolution_mode="same"))
        layers.append(SubsamplingLayer(pooling_type="max",
                                       kernel_size=(2, 2), stride=(2, 2)))
    return layers


@dataclass
class VGG16(ZooModel):
    """VGG-16 (reference ``VGG16.java``): dropout 0.5 on both dense
    layers."""
    BLOCKS: ClassVar[Tuple] = ((2, 64), (2, 128), (3, 256), (3, 512),
                               (3, 512))

    def conf(self) -> MultiLayerConfiguration:
        h, w, c = self.input_shape
        return self._stack(
            _vgg_blocks(self.BLOCKS) + [
                DenseLayer(n_out=4096, dropout=0.5),
                DenseLayer(n_out=4096, dropout=0.5),
                OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent")],
            {"updater": self.updater or Nesterovs(learning_rate=1e-2,
                                                  momentum=0.9),
             "activation": "relu", "weight_init": "xavier"},
            InputType.convolutional(h, w, c))


@dataclass
class VGG19(VGG16):
    """VGG-19 (reference ``VGG19.java``)."""
    BLOCKS: ClassVar[Tuple] = ((2, 64), (2, 128), (4, 256), (4, 512),
                               (4, 512))


@dataclass
class TransformerLM:
    """Decoder-only transformer LM: embedding, positional encoding,
    ``n_layers`` pre-norm causal blocks, softmax head over the
    vocabulary.  Same fields and configuration as the JAX zoo model."""
    model_type: ClassVar[str] = "rnn"
    vocab_size: int = 256
    seq_len: int = 128
    embed: int = 256
    n_layers: int = 4
    n_heads: int = 8
    attn_impl: str = "auto"
    flash_min_seq: Optional[int] = None
    moe_experts: int = 0
    sparse_labels: bool = False
    seed: int = 123
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> MultiLayerConfiguration:
        layers = [EmbeddingSequenceLayer(n_out=self.embed),
                  PositionalEncodingLayer()]
        layers += [TransformerBlock(n_heads=self.n_heads, causal=True,
                                    attn_impl=self.attn_impl,
                                    flash_min_seq=self.flash_min_seq,
                                    moe_experts=self.moe_experts)
                   for _ in range(self.n_layers)]
        loss = "sparse_mcxent" if self.sparse_labels else "mcxent"
        layers.append(RnnOutputLayer(n_out=self.vocab_size,
                                     activation="softmax", loss=loss))
        for i, lc in enumerate(layers):
            lc.name = f"layer{i}"
        return MultiLayerConfiguration(
            layers=layers,
            input_type=InputType.recurrent(self.vocab_size, self.seq_len),
            defaults=_with_compute_dtype(self.compute_dtype, {
                "updater": self.updater or Adam(learning_rate=3e-4),
                "weight_init": "xavier"}),
            seed=self.seed)

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network on ``device`` with fresh seeded parameters."""
        return MultiLayerNetwork(self.conf(), device=device).init()

    def pretrained(self, weights_path: Optional[str] = None, device="cuda"):
        """The network from local pretrained weights (see
        ``ZooModel.pretrained``)."""
        return _pretrained(self, weights_path, device)

    def import_pretrained(self, keras_path, device="cuda"):
        """The zoo network with the weights of a Keras HDF5 file (see
        ``ZooModel.import_pretrained``)."""
        return _import_pretrained(self, keras_path, device)


@dataclass
class ResNet50:
    """ResNet-50: conv/identity bottleneck blocks as a ComputationGraph
    with element-wise residual adds, NHWC.  Same fields, graph and vertex
    names as the JAX zoo model (reference ``model/ResNet50.java``)."""
    model_type: ClassVar[str] = "cnn"
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)   # (h, w, c)
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> ComputationGraphConfiguration:
        h, w, c = self.input_shape
        defaults = {"activation": "relu", "weight_init": "relu",
                    "updater": self.updater or
                    Nesterovs(learning_rate=1e-1, momentum=0.9)}
        if self.compute_dtype:
            defaults["compute_dtype"] = self.compute_dtype
        g = GraphBuilder(defaults, seed=self.seed)
        g.add_inputs("in").set_input_types(InputType.convolutional(h, w, c))

        def conv_bn(name, inp, n_out, kernel, stride=(1, 1), act="relu"):
            x = _conv_block(g, name, inp, n_out, kernel, stride,
                            act="identity")
            g.add_layer(f"{name}_bn", BatchNormalization(activation=act), x)
            return f"{name}_bn"

        def bottleneck(name, inp, filters, stride, project):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, f1, (1, 1), stride)
            x = conv_bn(f"{name}_b", x, f2, (3, 3))
            x = conv_bn(f"{name}_c", x, f3, (1, 1), act="identity")
            sc = conv_bn(f"{name}_sc", inp, f3, (1, 1), stride,
                         act="identity") if project else inp
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
            g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return f"{name}_out"

        x = conv_bn("conv1", "in", 64, (7, 7), (2, 2))
        x = _max_pool(g, "pool1", x)
        stages = [(3, (64, 64, 256), (1, 1)),
                  (4, (128, 128, 512), (2, 2)),
                  (6, (256, 256, 1024), (2, 2)),
                  (3, (512, 512, 2048), (2, 2))]
        for si, (blocks, filters, stride) in enumerate(stages):
            for bi in range(blocks):
                x = bottleneck(f"s{si}b{bi}", x, filters,
                               stride if bi == 0 else (1, 1), bi == 0)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        return g.build()

    def init(self, device="cuda") -> ComputationGraph:
        """The graph on ``device`` with fresh seeded parameters."""
        return ComputationGraph(self.conf(), device=device).init()

    def pretrained(self, weights_path: Optional[str] = None, device="cuda"):
        """The network from local pretrained weights (see
        ``ZooModel.pretrained``)."""
        return _pretrained(self, weights_path, device)

    def import_pretrained(self, keras_path, device="cuda"):
        """The zoo network with the weights of a Keras HDF5 file (see
        ``ZooModel.import_pretrained``)."""
        return _import_pretrained(self, keras_path, device)



@dataclass
class GoogLeNet(ZooModel):
    """GoogLeNet / Inception-v1 (reference ``GoogLeNet.java``): nine
    inception modules, global average pooling, dropout 0.4."""

    def conf(self) -> ComputationGraphConfiguration:
        g = self._graph(Adam(learning_rate=1e-3))
        x = _conv_block(g, "conv1", "in", 64, (7, 7), (2, 2))
        x = _max_pool(g, "pool1", x)
        x = _conv_block(g, "conv2r", x, 64, (1, 1))
        x = _conv_block(g, "conv2", x, 192, (3, 3))
        x = _max_pool(g, "pool2", x)
        x = _inception_block(g, "i3a", x, 64, 96, 128, 16, 32, 32)
        x = _inception_block(g, "i3b", x, 128, 128, 192, 32, 96, 64)
        x = _max_pool(g, "pool3", x)
        x = _inception_block(g, "i4a", x, 192, 96, 208, 16, 48, 64)
        x = _inception_block(g, "i4b", x, 160, 112, 224, 24, 64, 64)
        x = _inception_block(g, "i4c", x, 128, 128, 256, 24, 64, 64)
        x = _inception_block(g, "i4d", x, 112, 144, 288, 32, 64, 64)
        x = _inception_block(g, "i4e", x, 256, 160, 320, 32, 128, 128)
        x = _max_pool(g, "pool4", x)
        x = _inception_block(g, "i5a", x, 256, 160, 320, 32, 128, 128)
        x = _inception_block(g, "i5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "dropout")
        g.set_outputs("out")
        return g.build()


@dataclass
class InceptionResNetV1(ZooModel):
    """Inception-ResNet v1, the JAX package's compact rendition
    (reference ``InceptionResNetV1.java``): stem, scaled residual
    inception blocks A/B/C with reductions, an L2-normalised embedding
    and a softmax head."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (160, 160, 3)
    blocks_a: int = 5
    blocks_b: int = 10
    blocks_c: int = 5
    embedding_size: int = 128

    def conf(self) -> ComputationGraphConfiguration:
        g = self._graph(Adam(learning_rate=1e-3))

        def conv(name, inp, n_out, kernel, stride=(1, 1), act="relu"):
            return _conv_block(g, name, inp, n_out, kernel, stride, act=act)

        def res_block(name, inp, branches, channels, scale=0.17):
            """out = relu(in + scale * conv1x1(concat(branches)))."""
            outs = []
            for i, spec in enumerate(branches):
                x = inp
                for j, (n_out, kernel) in enumerate(spec):
                    x = conv(f"{name}_br{i}_{j}", x, n_out, kernel)
                outs.append(x)
            if len(outs) > 1:
                g.add_vertex(f"{name}_cat", MergeVertex(), *outs)
                cat = f"{name}_cat"
            else:
                cat = outs[0]
            up = conv(f"{name}_up", cat, channels, (1, 1), act="identity")
            g.add_vertex(f"{name}_scale", ScaleVertex(scale_factor=scale), up)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                         inp, f"{name}_scale")
            g.add_layer(f"{name}", ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        x = conv("stem1", "in", 32, (3, 3), (2, 2))
        x = conv("stem2", x, 64, (3, 3))
        x = _max_pool(g, "stempool", x)
        x = conv("stem3", x, 128, (3, 3), (2, 2))
        x = conv("stem4", x, 256, (3, 3), (2, 2))
        for i in range(self.blocks_a):
            x = res_block(f"a{i}", x,
                          [[(32, (1, 1))],
                           [(32, (1, 1)), (32, (3, 3))],
                           [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], 256)
        x = conv("redA", x, 384, (3, 3), (2, 2))
        for i in range(self.blocks_b):
            x = res_block(f"b{i}", x,
                          [[(128, (1, 1))],
                           [(128, (1, 1)), (128, (1, 7)), (128, (7, 1))]],
                          384, scale=0.10)
        x = conv("redB", x, 512, (3, 3), (2, 2))
        for i in range(self.blocks_c):
            x = res_block(f"c{i}", x,
                          [[(192, (1, 1))],
                           [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]],
                          512, scale=0.20)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "embeddings")
        g.set_outputs("out")
        return g.build()


@dataclass
class FaceNetNN4Small2(ZooModel):
    """FaceNet NN4-small2 style embedding net (reference
    ``FaceNetNN4Small2.java``): inception trunk, L2-normalised embedding,
    center-loss softmax head."""
    num_classes: int = 100
    input_shape: Tuple[int, int, int] = (96, 96, 3)
    embedding_size: int = 128

    def conf(self) -> ComputationGraphConfiguration:
        g = self._graph(Adam(learning_rate=1e-3))
        x = _conv_block(g, "conv1", "in", 64, (7, 7), (2, 2))
        x = _max_pool(g, "pool1", x)
        x = _conv_block(g, "conv2", x, 192, (3, 3))
        x = _max_pool(g, "pool2", x)
        x = _inception_block(g, "i3a", x, 64, 96, 128, 16, 32, 32)
        x = _inception_block(g, "i3b", x, 64, 96, 128, 32, 64, 64)
        x = _max_pool(g, "pool3", x)
        x = _inception_block(g, "i4a", x, 256, 96, 192, 32, 64, 128)
        x = _inception_block(g, "i4e", x, 160, 112, 224, 24, 64, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                             activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.num_classes, activation="softmax", loss="mcxent",
            alpha=0.9, lambda_=5e-3), "embeddings")
        g.set_outputs("out")
        return g.build()


@dataclass
class TextGenerationLSTM:
    """Char-level text generation LSTM (reference
    ``TextGenerationLSTM.java:34``): two tanh LSTM layers of ``hidden``
    units and a softmax ``RnnOutputLayer`` over ``num_classes``
    characters; Adam(2e-3), xavier init, element-wise gradient clipping
    at 10.  Same fields and configuration as the JAX zoo model.  The
    LSTMs' ``helper`` is left unset: a caller that wants the Hopper kernel
    sets ``helper="pallas"`` on each ``LSTM`` of ``conf()``."""
    model_type: ClassVar[str] = "rnn"
    num_classes: int = 26          # vocab size
    timesteps: int = 40
    hidden: int = 256
    seed: int = 123
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> MultiLayerConfiguration:
        return MultiLayerConfiguration(
            layers=[LSTM(n_out=self.hidden, activation="tanh"),
                    LSTM(n_out=self.hidden, activation="tanh"),
                    RnnOutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent")],
            input_type=InputType.recurrent(self.num_classes, self.timesteps),
            defaults=_with_compute_dtype(self.compute_dtype, {
                "updater": self.updater or Adam(learning_rate=2e-3),
                "weight_init": "xavier",
                "gradient_normalization": "clipelementwiseabsolutevalue",
                "gradient_normalization_threshold": 10.0}),
            seed=self.seed)

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network on ``device`` with fresh seeded parameters."""
        return MultiLayerNetwork(self.conf(), device=device).init()

    def pretrained(self, weights_path: Optional[str] = None, device="cuda"):
        """The network from local pretrained weights (see
        ``ZooModel.pretrained``)."""
        return _pretrained(self, weights_path, device)

    def import_pretrained(self, keras_path, device="cuda"):
        """The zoo network with the weights of a Keras HDF5 file (see
        ``ZooModel.import_pretrained``)."""
        return _import_pretrained(self, keras_path, device)


ALL_MODELS = [LeNet, SimpleCNN, AlexNet, VGG16, VGG19, ResNet50, GoogLeNet,
              InceptionResNetV1, FaceNetNN4Small2, TextGenerationLSTM,
              TransformerLM]


class ModelSelector:
    """Select zoo models by name or type (reference ``ModelSelector``)."""

    @staticmethod
    def select(*names, **init_kwargs) -> Dict[str, Any]:
        """``names``: model class names (any case), a model type ("cnn",
        "rnn") or "all"; returns ``{name: instance}``, not initialised."""
        by_name = {cls.__name__.lower(): cls for cls in ALL_MODELS}
        out = {}
        for name in names:
            key = name.lower()
            if key == "all":
                out.update({cls.__name__: cls(**init_kwargs)
                            for cls in ALL_MODELS})
            elif key in ("cnn", "rnn"):
                out.update({cls.__name__: cls(**init_kwargs)
                            for cls in ALL_MODELS
                            if cls.model_type == key})
            elif key in by_name:
                out[by_name[key].__name__] = by_name[key](**init_kwargs)
            else:
                raise ValueError(
                    f"unknown zoo model '{name}'; available: "
                    f"{sorted(by_name)} or 'all'/'cnn'/'rnn'")
        return out
