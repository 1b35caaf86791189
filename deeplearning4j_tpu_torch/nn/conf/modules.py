"""Reusable graph-construction blocks (port of ``nn/conf/modules.py``).

Reference ``nn/conf/module/GraphBuilderModule.java``: a unit that appends a
named sub-graph of layers to a GraphBuilder and returns the output vertex
name.  The zoo's conv, inception and residual units follow this contract;
these classes let users compose the same blocks in their own graphs, with
the vertex names and layer settings of the JAX package's blocks.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..layers.feedforward import ActivationLayer
from ..layers.normalization import BatchNormalization
from .computation_graph import ElementWiseVertex, GraphBuilder, MergeVertex

__all__ = ["GraphBuilderModule", "ConvBnBlock", "ResidualBlock",
           "InceptionBlock"]


class GraphBuilderModule:
    """add_layers(builder, name, *inputs) -> output vertex name (reference
    ``GraphBuilderModule.addLayers``)."""

    def add_layers(self, g: GraphBuilder, name: str, *inputs: str) -> str:
        raise NotImplementedError


class ConvBnBlock(GraphBuilderModule):
    """conv → batchnorm(+activation) (the zoo's conv_bn unit)."""

    def __init__(self, n_out: int, kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), activation: str = "relu",
                 mode: str = "same"):
        self.n_out = n_out
        self.kernel = kernel
        self.stride = stride
        self.activation = activation
        self.mode = mode

    def add_layers(self, g: GraphBuilder, name: str, *inputs: str) -> str:
        g.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=self.n_out, kernel_size=self.kernel, stride=self.stride,
            convolution_mode=self.mode, activation="identity",
            has_bias=False), *inputs)
        g.add_layer(f"{name}_bn",
                    BatchNormalization(activation=self.activation),
                    f"{name}_conv")
        return f"{name}_bn"


class ResidualBlock(GraphBuilderModule):
    """Bottleneck residual unit (ResNet50's building block): 1x1 → 3x3 →
    1x1 with an identity or projected shortcut and a post-add ReLU."""

    def __init__(self, filters: Tuple[int, int, int],
                 stride: Tuple[int, int] = (1, 1), project: bool = False):
        self.filters = filters
        self.stride = stride
        self.project = project

    def add_layers(self, g: GraphBuilder, name: str, *inputs: str) -> str:
        f1, f2, f3 = self.filters
        inp = inputs[0]
        x = ConvBnBlock(f1, (1, 1), self.stride).add_layers(g, f"{name}_a",
                                                            inp)
        x = ConvBnBlock(f2, (3, 3)).add_layers(g, f"{name}_b", x)
        x = ConvBnBlock(f3, (1, 1), activation="identity").add_layers(
            g, f"{name}_c", x)
        if self.project:
            sc = ConvBnBlock(f3, (1, 1), self.stride,
                             activation="identity").add_layers(
                g, f"{name}_sc", inp)
        else:
            sc = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"


class InceptionBlock(GraphBuilderModule):
    """GoogLeNet inception unit: 1x1 / 3x3(reduced) / 5x5(reduced) /
    pool-proj branches concatenated on channels."""

    def __init__(self, c1: int, c3r: int, c3: int, c5r: int, c5: int,
                 pool_proj: int):
        self.c1, self.c3r, self.c3 = c1, c3r, c3
        self.c5r, self.c5, self.pool_proj = c5r, c5, pool_proj

    def add_layers(self, g: GraphBuilder, name: str, *inputs: str) -> str:
        inp = inputs[0]
        b1 = ConvBnBlock(self.c1, (1, 1)).add_layers(g, f"{name}_b1", inp)
        r3 = ConvBnBlock(self.c3r, (1, 1)).add_layers(g, f"{name}_b3r", inp)
        b3 = ConvBnBlock(self.c3, (3, 3)).add_layers(g, f"{name}_b3", r3)
        r5 = ConvBnBlock(self.c5r, (1, 1)).add_layers(g, f"{name}_b5r", inp)
        b5 = ConvBnBlock(self.c5, (5, 5)).add_layers(g, f"{name}_b5", r5)
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
            convolution_mode="same"), inp)
        bp = ConvBnBlock(self.pool_proj, (1, 1)).add_layers(
            g, f"{name}_bp", f"{name}_pool")
        g.add_vertex(f"{name}_concat", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_concat"
