"""The device the entry points make their tensors on: the card, unless the
caller asks for another.  There is no fallback: without a CUDA device the
default raises, and the CPU (every kernel wrapper's plain PyTorch version)
is reached only by asking for it."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device on a machine
    without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: pass device='cpu' for the plain PyTorch versions")
    return dev
