"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

Each module mirrors its counterpart in the JAX package by path.  The
port imports torch and numpy only; it never imports jax or the JAX
package.  Entry points take ``device=`` and default to ``"cuda"``.

The package exports the JAX package's user surface (``MultiLayerNetwork``,
``ComputationGraph``, the configurations, ``InputType``,
``PrecisionPolicy``, ``observability``), each imported on first access
(PEP 562), so a process that imports one submodule (a spawned worker,
an ETL process, a Kafka consumer) loads no more than that submodule
needs.  ``persistent_cache_status``/``wire_persistent_cache`` wire the
kernels' build cache (``nn/compile_cache``): with
``DL4J_TPU_COMPILE_CACHE=<dir>`` set, importing the package points it at
that directory, as the JAX package wires its XLA cache at import.
"""
import importlib
import os

__version__ = "0.1.0"

_WHERE = {
    "observability": (".observability", None),
    "InputType": (".nn.conf.input_type", "InputType"),
    "MultiLayerConfiguration": (".nn.conf.multi_layer",
                                "MultiLayerConfiguration"),
    "NeuralNetConfiguration": (".nn.conf.multi_layer",
                               "NeuralNetConfiguration"),
    "ComputationGraphConfiguration": (".nn.conf.computation_graph",
                                      "ComputationGraphConfiguration"),
    "ComputationGraph": (".nn.computation_graph", "ComputationGraph"),
    "MultiLayerNetwork": (".nn.multilayer", "MultiLayerNetwork"),
    "PrecisionPolicy": (".nn.precision", "PrecisionPolicy"),
    "persistent_cache_status": (".nn.compile_cache",
                                "persistent_cache_status"),
    "wire_persistent_cache": (".nn.compile_cache", "wire_persistent_cache"),
}

__all__ = [
    "ComputationGraph",
    "ComputationGraphConfiguration",
    "InputType",
    "MultiLayerConfiguration",
    "NeuralNetConfiguration",
    "MultiLayerNetwork",
    "PrecisionPolicy",
    "observability",
    "persistent_cache_status",
    "wire_persistent_cache",
]


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod, attr = _WHERE[name]
    module = importlib.import_module(mod, __name__)
    return module if attr is None else getattr(module, attr)


if os.environ.get("DL4J_TPU_COMPILE_CACHE"):
    # imports no torch: nn/compile_cache loads torch inside its functions
    importlib.import_module(".nn.compile_cache", __name__) \
        .wire_persistent_cache()


def __dir__():
    return sorted(set(globals()) | set(__all__))
