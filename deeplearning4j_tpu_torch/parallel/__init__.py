"""parallel of the PyTorch port: ``ParallelInference`` (the rest of the
JAX package's ``parallel/`` is ROADMAP item 8)."""
from .inference import InferenceMode, InvalidInputError, ParallelInference

__all__ = ["ParallelInference", "InferenceMode", "InvalidInputError"]
