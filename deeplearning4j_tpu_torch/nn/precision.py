"""Mixed-precision policy (port of ``nn/precision.py``).

One conf-level object holds the whole dtype story of a network:

  - ``param_dtype``   master params and updater state (f32: the updaters
    accumulate in full precision whatever the compute dtype)
  - ``compute_dtype`` forward and backward math (bf16 / f16)
  - ``keep_f32``      layer classes whose math stays f32 inside a
    low-precision stack (default: BatchNormalization); the loss
    reductions always run f32 (``nn/losses`` widens low-precision
    pre-outputs at entry)
  - ``overrides``     per-layer dtype by layer name
  - ``loss_scale``    ``None`` | a fixed float | ``"dynamic"``: the loss is
    multiplied by the scale before the backward and the gradients
    unscaled after it; non-finite gradients skip the update (params,
    updater state, layer state and tBPTT carries unchanged) and halve the
    scale, while ``growth_interval`` finite steps in a row double it.
    f16 defaults to dynamic.
  - ``kv_dtype``      storage of the paged generation cache (``"int8"``:
    per-token, per-head absmax codes; ``generation/cache.py``).

The dynamic-scale state rides in the network's ``state`` under
``SCALE_STATE_KEY`` (three scalars: ``scale`` f32, ``good_steps`` and
``overflow_steps`` int32), so it is checkpointed and loaded with the
rest of the state, and a JAX checkpoint's scale sequence continues here.

The JAX package traces the scale, unscale, check and skip into its one
train-step program; here they are eager torch ops on the network's
device, the same arithmetic: ``unscale_and_check`` multiplies by
``1 / scale`` (an f32 reciprocal) and tests every gradient leaf with
``isfinite``; ``next_scale_state`` is the JAX package's with
``jnp.where`` as ``torch.where``.  The skip itself differs in form: the
JAX step computes the update and then selects the old values, while the
port's train step reads the finiteness flag on the host once a step
(its updaters' step counts are host integers) and, on an overflow, does
not run the update at all.  The result is the same: nothing the step
would have changed moves.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.serde import register_serde

#: reserved key in the network ``state`` for the loss-scale state
SCALE_STATE_KEY = "__precision__"

_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "mixed_bfloat16": "bfloat16",
    "f16": "float16", "fp16": "float16", "float16": "float16",
    "mixed_float16": "float16",
    "f32": "float32", "fp32": "float32", "float32": "float32",
}

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


def _canon_dtype(dt: Optional[str]) -> Optional[str]:
    if dt is None:
        return None
    s = str(dt).lower()
    return _ALIASES.get(s, s)


def torch_dtype(dt: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype of a policy dtype name (None stays None)."""
    return None if dt is None else TORCH_DTYPES[_canon_dtype(dt)]


@register_serde
@dataclass
class PrecisionPolicy:
    """Conf-level mixed-precision policy (see module docstring)."""
    compute_dtype: Optional[str] = None      # None/float32 = full precision
    param_dtype: str = "float32"
    loss_scale: Optional[Any] = None         # None | float | "dynamic"
    initial_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200
    keep_f32: Tuple[str, ...] = ("BatchNormalization",)
    overrides: Optional[Dict[str, str]] = None   # layer name -> dtype
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        self.compute_dtype = _canon_dtype(self.compute_dtype)
        self.param_dtype = _canon_dtype(self.param_dtype) or "float32"
        if self.kv_dtype is not None:
            kd = str(self.kv_dtype).lower()
            kd = {"i8": "int8", "int8": "int8"}.get(kd, _canon_dtype(kd))
            if kd not in ("int8", "float32"):
                raise ValueError(
                    f"kv_dtype must be None, 'float32' or 'int8', got "
                    f"{self.kv_dtype!r}")
            self.kv_dtype = None if kd == "float32" else kd

    # ----------------------------------------------------------- queries
    @property
    def active(self) -> bool:
        return self.compute_dtype not in (None, "float32")

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def scaled(self) -> bool:
        return self.loss_scale is not None

    def layer_dtype(self, lc) -> Optional[str]:
        """Compute dtype for one layer conf: per-name override, else f32
        for keep_f32 classes (wrappers resolved through
        ``hyperparam_conf``), else the stack compute dtype.  ``None`` when
        the policy is inactive."""
        if not self.active:
            return None
        name = getattr(lc, "name", None)
        if self.overrides and name in self.overrides:
            return _canon_dtype(self.overrides[name])
        from ._common import hyperparam_conf
        hc = hyperparam_conf(lc) or lc
        kinds = {type(hc).__name__, type(lc).__name__}
        if kinds & set(self.keep_f32):
            return "float32"
        return self.compute_dtype


def named_policy(name: str) -> PrecisionPolicy:
    """Policy from a shorthand string: ``'bfloat16'``/``'bf16'`` (no
    scaling), ``'float16'``/``'f16'``/``'mixed_float16'`` (dynamic
    scaling), ``'float32'`` (inactive)."""
    dt = _canon_dtype(name)
    if dt not in ("bfloat16", "float16", "float32"):
        raise ValueError(
            f"unknown precision '{name}' — use 'bfloat16', 'float16', "
            "'float32', or a PrecisionPolicy(...)")
    scale = "dynamic" if dt == "float16" else None
    return PrecisionPolicy(compute_dtype=None if dt == "float32" else dt,
                           loss_scale=scale)


def resolve(defaults: Dict[str, Any]) -> Optional[PrecisionPolicy]:
    """Resolved policy for a conf's ``defaults`` dict, or ``None`` for a
    full-precision net.  A bare ``compute_dtype`` string (the pre-policy
    knob) resolves to a plain bf16/f16 policy."""
    p = defaults.get("precision")
    if isinstance(p, str):
        p = named_policy(p)
    if p is None:
        cd = _canon_dtype(defaults.get("compute_dtype"))
        if cd and cd != "float32":
            p = PrecisionPolicy(compute_dtype=cd)
    if p is None or not p.active:
        return None
    if p.compute_dtype == "float16" and p.loss_scale is None:
        # fp16 without scaling underflows small gradients: dynamic is
        # the only safe default
        p = dataclasses.replace(p, loss_scale="dynamic")
    return p


def kv_cache_dtype(defaults: Dict[str, Any]) -> Optional[str]:
    """KV-cache storage dtype for a conf's ``defaults``: ``"int8"`` when
    the precision policy asks for a quantized cache, else None.  Read
    even when compute runs full precision: an f32 net can carry an int8
    cache."""
    p = defaults.get("precision")
    if isinstance(p, str):
        p = named_policy(p)
    return getattr(p, "kv_dtype", None)


# ------------------------------------------------------------- step helpers
def init_scale_state(policy: Optional[PrecisionPolicy], device=None):
    """Loss-scale state for ``state[SCALE_STATE_KEY]`` (``None`` when the
    policy needs none).  Fixed-scale policies carry it too, so the skip
    bookkeeping (``overflow_steps``) is observable."""
    if policy is None or not policy.scaled:
        return None
    init = policy.initial_scale if policy.dynamic else float(policy.loss_scale)
    return {"scale": torch.tensor(init, dtype=torch.float32, device=device),
            "good_steps": torch.tensor(0, dtype=torch.int32, device=device),
            "overflow_steps": torch.tensor(0, dtype=torch.int32,
                                           device=device)}


def unscale_and_check(grads, scale: torch.Tensor):
    """Undo the loss scale on a ``{layer: {name: tensor}}`` gradient tree
    (in place of its entries) and report whether every floating leaf is
    finite, as a 0-d bool tensor on the device (no host sync)."""
    inv = 1.0 / scale
    checks = []
    for group in grads.values():
        for name, g in group.items():
            if g.is_floating_point():
                g = g * inv
                group[name] = g
                checks.append(torch.isfinite(g).all())
    if not checks:
        return grads, torch.ones((), dtype=torch.bool, device=scale.device)
    return grads, torch.stack(checks).all()


def next_scale_state(policy: PrecisionPolicy, ls: Dict[str, torch.Tensor],
                     finite: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The loss-scale state after one step whose gradients were
    ``finite`` (a 0-d bool tensor)."""
    scale, good = ls["scale"], ls["good_steps"]
    one = torch.ones_like(good)
    zero = torch.zeros_like(good)
    overflow = ls["overflow_steps"] + torch.where(finite, zero, one)
    if not policy.dynamic:
        return {"scale": scale, "good_steps": good,
                "overflow_steps": overflow}
    good = torch.where(finite, good + 1, zero)
    grow = finite & (good >= policy.growth_interval)
    scale = torch.where(
        grow, scale * policy.growth_factor,
        torch.where(finite, scale, scale * policy.backoff_factor))
    # never scale below 1 (pointless) or above f32 range
    scale = torch.clamp(scale, 1.0, 2.0 ** 60)
    good = torch.where(grow, zero, good)
    return {"scale": scale, "good_steps": good, "overflow_steps": overflow}
