"""The yardstick's arithmetic: the card's peaks and the bound of a call.

Copied from `chip_smoke.py` (`BYTES_PER_S`, `F32_OPS_PER_S`, `nbytes`,
`roofline`), so that no later change of the smoke moves the benchmark's
yardstick.  Peaks: NVIDIA H100 SXM data sheet, the memory rate and the
float32 rate outside the tensor cores, at the full 700 W power limit.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def nbytes(*xs) -> int:
    """Bytes of the tensors among `xs`."""
    import torch

    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def roofline(moved: int, t_ops: float) -> dict:
    """The bound of a call that moves `moved` bytes and computes for
    `t_ops` ms at the card's peak rates."""
    t_bytes = 1e3 * moved / BYTES_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=moved)
