"""Zoo models (port of ``models/zoo.py``): ``TransformerLM``,
``ResNet50`` and ``TextGenerationLSTM`` so far."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..nn.computation_graph import ComputationGraph
from ..nn.conf.computation_graph import (ComputationGraphConfiguration,
                                         ElementWiseVertex, GraphBuilder)
from ..nn.conf.input_type import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.updaters import Adam, Nesterovs, UpdaterConf
from ..nn.layers.attention import PositionalEncodingLayer, TransformerBlock
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.feedforward import (ActivationLayer, EmbeddingSequenceLayer,
                                     OutputLayer)
from ..nn.layers.normalization import BatchNormalization
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


@dataclass
class TransformerLM:
    """Decoder-only transformer LM: embedding, positional encoding,
    ``n_layers`` pre-norm causal blocks, softmax head over the
    vocabulary.  Same fields and configuration as the JAX zoo model."""
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
        if self.compute_dtype:
            raise NotImplementedError("compute_dtype (precision policies) "
                                      "is not ported yet")
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
            defaults={"updater": self.updater or Adam(learning_rate=3e-4),
                      "weight_init": "xavier"},
            seed=self.seed)

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network on ``device`` with fresh seeded parameters."""
        return MultiLayerNetwork(self.conf(), device=device).init()


@dataclass
class ResNet50:
    """ResNet-50: conv/identity bottleneck blocks as a ComputationGraph
    with element-wise residual adds, NHWC.  Same fields, graph and vertex
    names as the JAX zoo model (reference ``model/ResNet50.java``)."""
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (224, 224, 3)   # (h, w, c)
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> ComputationGraphConfiguration:
        if self.compute_dtype:
            raise NotImplementedError("compute_dtype (precision policies) "
                                      "is not ported yet")
        h, w, c = self.input_shape
        g = GraphBuilder({"activation": "relu", "weight_init": "relu",
                          "updater": self.updater or
                          Nesterovs(learning_rate=1e-1, momentum=0.9)},
                         seed=self.seed)
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


@dataclass
class TextGenerationLSTM:
    """Char-level text generation LSTM (reference
    ``TextGenerationLSTM.java:34``): two tanh LSTM layers of ``hidden``
    units and a softmax ``RnnOutputLayer`` over ``num_classes``
    characters; Adam(2e-3), xavier init, element-wise gradient clipping
    at 10.  Same fields and configuration as the JAX zoo model.  The
    LSTMs' ``helper`` is left unset: a caller that wants the Hopper kernel
    sets ``helper="pallas"`` on each ``LSTM`` of ``conf()``."""
    num_classes: int = 26          # vocab size
    timesteps: int = 40
    hidden: int = 256
    seed: int = 123
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> MultiLayerConfiguration:
        if self.compute_dtype:
            raise NotImplementedError("compute_dtype (precision policies) "
                                      "is not ported yet")
        return MultiLayerConfiguration(
            layers=[LSTM(n_out=self.hidden, activation="tanh"),
                    LSTM(n_out=self.hidden, activation="tanh"),
                    RnnOutputLayer(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent")],
            input_type=InputType.recurrent(self.num_classes, self.timesteps),
            defaults={"updater": self.updater or Adam(learning_rate=2e-3),
                      "weight_init": "xavier",
                      "gradient_normalization":
                          "clipelementwiseabsolutevalue",
                      "gradient_normalization_threshold": 10.0},
            seed=self.seed)

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network on ``device`` with fresh seeded parameters."""
        return MultiLayerNetwork(self.conf(), device=device).init()
