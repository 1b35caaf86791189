"""Parameter constraints, applied after each update (port of
``nn/conf/constraints.py``): ``MaxNormConstraint``,
``MinMaxNormConstraint``, ``NonNegativeConstraint`` and
``UnitNormConstraint``.

Norms run over every axis but the last (the output unit), as in the JAX
package: a dense ``[n_in, n_out]`` kernel has one norm per column, a
conv kernel ``[kh, kw, c_in, c_out]`` one per output channel; a 1-D
param's norm is its absolute value.  The networks call ``apply`` under
``torch.no_grad()`` after the updaters (``nn/_common
.apply_constraints_all``) on the params each constraint's
``apply_to_weights`` / ``apply_to_biases`` selects.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils.serde import register_serde

_EPS = 1e-8


def _unit_norms(w: torch.Tensor) -> torch.Tensor:
    if w.ndim <= 1:
        return torch.abs(w)
    return torch.sqrt(torch.sum(w * w, dim=tuple(range(w.ndim - 1)),
                                keepdim=True))


@dataclass
class LayerConstraint:
    apply_to_weights: bool = True
    apply_to_biases: bool = False

    def apply(self, param: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError


@register_serde
@dataclass
class MaxNormConstraint(LayerConstraint):
    max_norm: float = 2.0

    def apply(self, param):
        n = _unit_norms(param)
        return param * torch.clamp(self.max_norm / (n + _EPS), max=1.0)


@register_serde
@dataclass
class MinMaxNormConstraint(LayerConstraint):
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0

    def apply(self, param):
        n = _unit_norms(param)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1 - self.rate) * n
        return param * (target / (n + _EPS))


@register_serde
@dataclass
class NonNegativeConstraint(LayerConstraint):
    def apply(self, param):
        return torch.clamp(param, min=0.0)


@register_serde
@dataclass
class UnitNormConstraint(LayerConstraint):
    def apply(self, param):
        return param / (_unit_norms(param) + _EPS)
