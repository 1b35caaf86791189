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
