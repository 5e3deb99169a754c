"""The device rule of the port's entry points.

``None`` means the card: an engine, a server or ``init`` called without
a device runs on CUDA, and raises when no card is present instead of
carrying on, slowly and silently, on the CPU. The CPU is used only when
the caller names it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
