"""Device choice for the port's entry points.

Entry points default to ``"cuda"``.  Without a usable GPU they raise
instead of running on the CPU behind the caller's back; the caller asks
for the CPU explicitly with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deeplearning4j_tpu_torch runs on CUDA by default, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


_CONSTANTS: dict = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small tensor of host constants (a configuration's list of
    floats) on ``device``, made once per (values, dtype, device) and kept.
    A layer reads it inside a train step without copying from the host
    again, which a captured CUDA graph cannot do."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        # a normal tensor even when first asked for under inference_mode:
        # training reads it too
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.as_tensor(list(values), dtype=dtype,
                                                  device=device)
    return t
