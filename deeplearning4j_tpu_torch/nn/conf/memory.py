"""Pre-training memory estimation (port of ``nn/conf/memory.py``;
reference ``nn/conf/memory/``: ``MemoryReport.java``,
``LayerMemoryReport.java``, ``NetworkMemoryReport.java``,
``MemoryUseMode.java``).

Two tiers:

1. **Analytic report** (``memory_report`` / ``memory_report_graph``),
   the JAX package's arithmetic field for field: exact for parameters,
   gradients, updater state and the low-precision parameter copy; an
   upper bound for the layer-boundary activations of a training step.
2. **Device report** (``device_memory_report``), in place of the JAX
   package's compiled tier (``xla_memory_report``, XLA's buffer
   assignment): the CUDA caching allocator's own count around one real
   training step (``torch.cuda.memory_allocated`` before,
   ``max_memory_allocated`` during).  ``None`` off the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .input_type import InputType

__all__ = ["LayerMemoryReport", "NetworkMemoryReport", "MemoryUseMode",
           "memory_report", "memory_report_graph", "device_memory_report"]


class MemoryUseMode:
    INFERENCE = "INFERENCE"
    TRAINING = "TRAINING"


def _elems(itype: InputType) -> int:
    return int(np.prod([d for d in itype.shape(1)[1:]]))


@dataclass
class LayerMemoryReport:
    """Per-layer estimate, in ELEMENTS (multiply by dtype width for bytes)."""
    layer_name: str
    layer_type: str
    n_params: int
    activation_elems_per_example: int
    # updater state multiplier: sgd=0, momentum/rmsprop=1, adam=2 slots/param
    updater_state_elems: int = 0


_UPDATER_SLOTS = {"Sgd": 0, "Nesterovs": 1, "Adam": 2, "AdamW": 2,
                  "AdaMax": 2, "AdaGrad": 1, "AdaDelta": 2, "RmsProp": 1,
                  "Nadam": 2, "AmsGrad": 3}


@dataclass
class NetworkMemoryReport:
    """Whole-network roll-up (reference ``NetworkMemoryReport.java``).

    Byte accounting (training):
      params (f32 masters) + gradients (f32) + updater state
      + low-precision parameter copy when ``compute_dtype`` is bf16/f16
      + batch x layer-boundary activations in the compute dtype (an upper
        bound; remat recomputes only interior intermediates this term
        never counted, so it does not change the bound).
    """
    layer_reports: List[LayerMemoryReport]
    model_class: str
    param_bytes: int = 4            # master params / grads / updater state
    activation_bytes: int = 4       # compute dtype width
    mixed_precision: bool = False   # separate low-precision param copy
    remat: bool = False             # cache_mode("remat")

    @property
    def total_params(self) -> int:
        return sum(r.n_params for r in self.layer_reports)

    @property
    def total_updater_elems(self) -> int:
        return sum(r.updater_state_elems for r in self.layer_reports)

    @property
    def activation_elems_per_example(self) -> int:
        return sum(r.activation_elems_per_example for r in self.layer_reports)

    def static_bytes(self) -> int:
        """The bytes that live before any step: f32 master params and
        updater state (what making the network and its updater state
        allocates)."""
        return (self.total_params + self.total_updater_elems) \
            * self.param_bytes

    def total_memory_bytes(self, batch: int,
                           mode: str = MemoryUseMode.TRAINING) -> int:
        p = self.total_params
        if mode == MemoryUseMode.TRAINING:
            b = p * self.param_bytes * 2                   # params + grads
            b += self.total_updater_elems * self.param_bytes
            if self.mixed_precision:
                b += p * self.activation_bytes             # low-precision copy
            # layer-boundary activations: per-layer checkpointing (remat)
            # keeps exactly these, so the bound is unchanged by remat
            acts = self.activation_elems_per_example * batch
            b += acts * self.activation_bytes
            return b
        # inference: params + the two widest consecutive activations.  The
        # inference path does not cast to the compute dtype (only the
        # train step does), so everything is priced at the param width.
        acts = [r.activation_elems_per_example for r in self.layer_reports]
        peak_acts = max((acts[i] + acts[i + 1]
                         for i in range(len(acts) - 1)),
                        default=acts[0] if acts else 0)
        return (p + peak_acts * batch) * self.param_bytes

    def to_string(self, batch: int = 32) -> str:
        lines = [f"Network memory report ({self.model_class}), "
                 f"batch={batch}, params {self.param_bytes}B, "
                 f"activations {self.activation_bytes}B"
                 + (", remat" if self.remat else ""),
                 f"{'layer':<24}{'type':<24}{'params':>12}{'act/ex':>12}"]
        for r in self.layer_reports:
            lines.append(f"{r.layer_name:<24}{r.layer_type:<24}"
                         f"{r.n_params:>12}{r.activation_elems_per_example:>12}")
        lines.append(f"total params: {self.total_params} "
                     f"(+{self.total_updater_elems} updater elems)")
        for mode in (MemoryUseMode.INFERENCE, MemoryUseMode.TRAINING):
            mb = self.total_memory_bytes(batch, mode) / 2**20
            bound = " (upper bound)" if mode == MemoryUseMode.TRAINING else ""
            lines.append(f"estimated {mode.lower()} memory: "
                         f"{mb:.1f} MiB{bound}")
        return "\n".join(lines)


def _updater_slots(conf) -> int:
    upd = conf.defaults.get("updater")
    name = type(upd).__name__ if upd is not None else "Sgd"
    return _UPDATER_SLOTS.get(name, 1)


def _dtype_fields(conf) -> Dict:
    cdtype = conf.defaults.get("compute_dtype")
    low = cdtype in ("bfloat16", "float16")
    return {"param_bytes": 4,
            "activation_bytes": 2 if low else 4,
            "mixed_precision": low,
            "remat": conf.defaults.get("cache_mode") == "remat"}


def memory_report(conf, model_class: str = "MultiLayerNetwork"
                  ) -> NetworkMemoryReport:
    """Build a report from a built MultiLayerConfiguration (needs
    ``layer_input_types`` resolved, i.e. after ``.build()``)."""
    if (not conf.layer_input_types
            or any(t is None for t in conf.layer_input_types)):
        raise ValueError("configuration has no resolved input types; "
                         "build it with .set_input_type(...)")
    slots = _updater_slots(conf)
    reports = []
    for i, layer in enumerate(conf.layers):
        itype = conf.layer_input_types[i]
        otype = layer.output_type(itype)
        n_params = layer.n_params(itype)
        reports.append(LayerMemoryReport(
            layer_name=layer.name or f"layer_{i}",
            layer_type=type(layer).__name__,
            n_params=n_params,
            activation_elems_per_example=_elems(otype),
            updater_state_elems=n_params * slots))
    return NetworkMemoryReport(reports, model_class, **_dtype_fields(conf))


def memory_report_graph(conf, model_class: str = "ComputationGraph"
                        ) -> NetworkMemoryReport:
    """Report for a built ComputationGraphConfiguration: every vertex's
    output counts toward the activation term (resolve() must have run)."""
    if not conf.vertex_input_types:
        raise ValueError("graph configuration is not resolved; build it "
                         "with input types set")
    slots = _updater_slots(conf)
    reports = []
    for name, node in conf.vertices.items():
        itypes = conf.vertex_input_types.get(name)
        if not itypes or any(t is None for t in itypes):
            continue
        ot = node.output_type(itypes)
        layer = getattr(node, "layer", None)
        n_params = 0
        if layer is not None:
            it = itypes[0]
            pre = getattr(node, "preprocessor", None)
            if pre is not None:
                it = pre.output_type(it)
            n_params = layer.n_params(it)
        reports.append(LayerMemoryReport(
            layer_name=name,
            layer_type=type(layer or node).__name__,
            n_params=n_params,
            activation_elems_per_example=_elems(ot),
            updater_state_elems=n_params * slots))
    return NetworkMemoryReport(reports, model_class, **_dtype_fields(conf))


def device_memory_report(model, features, labels
                         ) -> Optional[Dict[str, int]]:
    """The CUDA allocator's count around ONE real training step of
    ``model`` (``fit(features, labels)``; the step is taken and kept):
    ``{allocated_before_bytes, peak_bytes, step_peak_bytes,
    allocated_after_bytes}``, where ``step_peak_bytes = peak -
    before`` is what the step itself needed at its peak.  ``None`` when
    the network is not on a CUDA device (the allocator counts nothing
    else)."""
    dev = model.device
    if dev.type != "cuda":
        return None
    if not model.params:
        model.init()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model.fit(features, labels)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"allocated_before_bytes": int(before), "peak_bytes": int(peak),
            "step_peak_bytes": int(peak - before),
            "allocated_after_bytes": int(torch.cuda.memory_allocated(dev))}
