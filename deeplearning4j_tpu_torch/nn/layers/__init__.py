"""Layer configs/implementations of the PyTorch port (reference
``nn/conf/layers`` + ``nn/layers``; port of the JAX package's
``nn/layers/``).

The JAX package's names resolve here on first access (PEP 562): the
layer modules import one another and ``nn/conf``, so importing them all
whenever one is imported would tie those imports into a cycle.
"""
import importlib

_EXPORTS = {
    "attention": ("LayerNormLayer", "MultiHeadAttention",
                  "PositionalEncodingLayer", "TransformerBlock"),
    "base": ("BaseLayerConf", "LayerConf"),
    "convolution": ("Convolution1DLayer", "ConvolutionLayer",
                    "Subsampling1DLayer", "SubsamplingLayer", "Upsampling1D",
                    "Upsampling2D", "ZeroPaddingLayer"),
    "feedforward": ("ActivationLayer", "CenterLossOutputLayer", "DenseLayer",
                    "DropoutLayer", "EmbeddingLayer",
                    "EmbeddingSequenceLayer", "LossLayer", "OutputLayer"),
    "misc": ("FrozenLayer",),
    "moe": ("MixtureOfExpertsLayer",),
    "normalization": ("BatchNormalization", "LocalResponseNormalization"),
    "objdetect": ("Yolo2OutputLayer",),
    "pooling": ("GlobalPoolingLayer",),
    "pretrain": ("AutoEncoder", "RBM", "VariationalAutoencoder"),
    "recurrent": ("Bidirectional", "GravesBidirectionalLSTM", "GravesLSTM",
                  "LastTimeStep", "LSTM", "RnnOutputLayer", "SimpleRnn"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [
    "ActivationLayer", "AutoEncoder", "BaseLayerConf", "BatchNormalization",
    "Bidirectional", "CenterLossOutputLayer", "Convolution1DLayer",
    "ConvolutionLayer", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer",
    "FrozenLayer", "GlobalPoolingLayer", "GravesBidirectionalLSTM",
    "GravesLSTM", "LastTimeStep", "LayerConf", "LayerNormLayer",
    "LocalResponseNormalization", "LossLayer", "LSTM",
    "MixtureOfExpertsLayer", "MultiHeadAttention",
    "OutputLayer", "PositionalEncodingLayer", "RBM", "RnnOutputLayer",
    "SimpleRnn", "TransformerBlock",
    "Subsampling1DLayer", "SubsamplingLayer", "Upsampling1D", "Upsampling2D",
    "VariationalAutoencoder", "Yolo2OutputLayer", "ZeroPaddingLayer",
]


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
