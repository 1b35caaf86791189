"""parallel of the PyTorch port: the data-parallel mesh and its ZeRO-3
layout rule, ``ParallelWrapper`` and the ZeRO-3 ``ShardedTrainer`` over
``torch.distributed``, the multi-process bootstrap and ``ElasticTrainer``,
quantized gradient sharing and its wire format, the in-process training
masters, ``DistributedLayerTrainer`` and ``ParallelInference``.  The
process masters, tensor, sequence, pipeline and expert parallelism wait
for ROADMAP queue 1, item 8.

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
    "DATA_AXIS": "mesh", "MODEL_AXIS": "mesh", "SEQ_AXIS": "mesh",
    "Mesh": "mesh", "make_mesh": "mesh", "place_sharded": "mesh",
    "shard_batch": "mesh", "shard_params": "mesh", "zero3_spec": "mesh",
    "ShardedTrainer": "sharded", "param_bytes": "sharded",
    "per_device_param_bytes": "sharded",
    "ParallelWrapper": "wrapper", "megatron_dense_rule": "wrapper",
    "GradientExchange": "exchange",
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
