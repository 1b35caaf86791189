"""parallel of the PyTorch port: meshes of ranks over
``torch.distributed`` and the ZeRO-3 layout rule, ``ParallelWrapper``
(data and tensor parallelism) and the ZeRO-3 ``ShardedTrainer``, the
multi-process bootstrap and ``ElasticTrainer``, quantized gradient
sharing and its wire format, the in-process training masters and the
process masters over ``TcpMessageBroker`` (``MultiprocessMaster``),
``DistributedLayerTrainer``, ``ParallelInference``, and the model axes:
sequence (ring and Ulysses attention), pipeline (GPipe) and expert
parallelism over differentiable collectives, the 3D demo and the dry
run.

Exports resolve on first use: ``nn`` imports ``parallel.inference``, and
the trainers import ``nn``.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "EncodedGradientsAccumulator": "accumulation",
    "EncodingHandler": "accumulation",
    "bitmap_decode": "accumulation", "bitmap_encode": "accumulation",
    "threshold_decode": "accumulation", "threshold_encode": "accumulation",
    "RemoteGradientSharing": "remote",
    "decode_message_bytes": "remote", "encode_message_bytes": "remote",
    "ElasticTrainer": "distributed", "global_device_mesh": "distributed",
    "initialize_distributed": "distributed",
    "InferenceMode": "inference", "InvalidInputError": "inference",
    "ParallelInference": "inference",
    "DistributedLayerTrainer": "layer",
    "ParameterAveragingTrainingMaster": "master",
    "SharedGradientsTrainingMaster": "master", "TrainingMaster": "master",
    "TrainingMasterStats": "master", "tree_average": "master",
    "MultiprocessMaster": "master_mp",
    "DATA_AXIS": "mesh", "MODEL_AXIS": "mesh", "SEQ_AXIS": "mesh",
    "Mesh": "mesh", "make_mesh": "mesh", "place_sharded": "mesh",
    "shard_batch": "mesh", "shard_params": "mesh", "zero3_spec": "mesh",
    "ShardedTrainer": "sharded", "param_bytes": "sharded",
    "per_device_param_bytes": "sharded",
    "ParallelWrapper": "wrapper", "megatron_dense_rule": "wrapper",
    "GradientExchange": "exchange", "TensorParallelExchange": "exchange",
    "P": "mesh", "Axis": "mesh", "Grid": "mesh", "make_grid": "mesh",
    "resolve_axis": "mesh",
    "gpipe": "pipeline", "stack_stage_params": "pipeline",
    "ring_self_attention": "sequence", "ulysses_attention": "sequence",
    "init_moe_params": "expert", "make_moe_train_step": "expert",
    "moe_ffn": "expert",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
