"""Sequential network (port of ``nn/multilayer.py``: init, output,
num_params).

The forward is a plain Python loop over the layers.  The JAX package
runs identical repeated blocks under ``lax.scan``; PyTorch runs eagerly
and needs no such fold.  Parameters live in one ``nn.ParameterDict`` per
layer, keyed ``layer_i`` and named as in the JAX package, so a JAX
checkpoint maps onto them one to one.  Inference only: training
(loss, updaters, fit) comes in a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .conf.multi_layer import MultiLayerConfiguration


class MultiLayerNetwork(nn.Module):
    """``MultiLayerNetwork(conf, device="cuda").init()`` then ``output``."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        conf.resolve()
        self.conf = conf
        self.layer_confs = conf.layers
        self.params = nn.ModuleDict()

    def _set_params(self, groups: Mapping[str, Dict[str, torch.Tensor]]):
        self.params = nn.ModuleDict({
            key: nn.ParameterDict({
                name: nn.Parameter(t, requires_grad=False)
                for name, t in group.items()})
            for key, group in groups.items()})

    def init(self) -> "MultiLayerNetwork":
        """Fresh parameters from a ``torch.Generator`` seeded with the
        configuration's seed (torch's numbers, not JAX's)."""
        gen = torch.Generator().manual_seed(self.conf.seed)
        self._set_params({
            f"layer_{i}": lc.init(gen, self.conf.layer_input_types[i],
                                  self.device)
            for i, lc in enumerate(self.layer_confs)})
        return self

    def param_spec(self) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        """``{layer_i: {name: (shape, dtype)}}`` without allocating."""
        gen = torch.Generator()
        meta = torch.device("meta")
        return {f"layer_{i}": {n: (tuple(t.shape), t.dtype) for n, t in
                               lc.init(gen, self.conf.layer_input_types[i],
                                       meta).items()}
                for i, lc in enumerate(self.layer_confs)}

    def load_params(self, tree: Mapping[str, Mapping[str, Any]]
                    ) -> "MultiLayerNetwork":
        """Install a JAX-layout param tree ``{layer_i: {name: array}}``.
        Names and shapes must match exactly; a layer without params may
        be absent."""
        spec = self.param_spec()
        extra = sorted(set(tree) - set(spec))
        if extra:
            raise ValueError(f"param tree has unknown groups {extra}")
        groups = {}
        for key, want in spec.items():
            got = tree.get(key, {})
            if set(got) != set(want):
                raise ValueError(
                    f"{key}: param names {sorted(got)} != expected "
                    f"{sorted(want)}")
            group = {}
            for name, (shape, dtype) in want.items():
                arr = np.asarray(got[name])
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}/{name}: shape {arr.shape} != "
                                     f"expected {shape}")
                group[name] = torch.tensor(arr, dtype=dtype, device=self.device)
            groups[key] = group
        self._set_params(groups)
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.params:
            raise RuntimeError("network has no params: call init() or "
                               "load_params() first")
        h = x
        for i, lc in enumerate(self.layer_confs):
            h = lc.apply(self.params[f"layer_{i}"], h)
        return h

    def output(self, x) -> torch.Tensor:
        """Inference forward on a batch (numpy array or tensor); the
        result stays on the network's device."""
        with torch.inference_mode():
            return self(torch.as_tensor(x, device=self.device))
