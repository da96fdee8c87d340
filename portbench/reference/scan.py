"""The plain reference of an inclusive SUM scan over the rank axis.

``reference_scan`` sums in float64, so its own rounding is far below any
float32 result's; ``control_scan`` is the same scan computed in bfloat16,
the step below the float32 the configurations state, which a sound float32
scan has to beat by a wide margin.
"""

from __future__ import annotations

import torch

#: columns a block: the float64 copy of a (p, n) input stays small
BLOCK_COLS = 1 << 22


def reference_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``(p, n)`` rows in float64, in column blocks."""
    out = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for c in range(0, x.shape[1], BLOCK_COLS):
        out[:, c:c + BLOCK_COLS] = torch.cumsum(x[:, c:c + BLOCK_COLS].double(), 0)
    return out


def control_scan(x: torch.Tensor) -> torch.Tensor:
    """The same scan with every operand and partial sum rounded to bfloat16,
    returned as float32 like the program's result."""
    acc = x[0].to(torch.bfloat16)
    rows = [acc]
    for r in range(1, x.shape[0]):
        acc = acc + x[r].to(torch.bfloat16)
        rows.append(acc)
    return torch.stack(rows).float()


def scan_error(got: torch.Tensor, x: torch.Tensor) -> float:
    """``max |got - ref| / max |ref|`` of a scan's result ``got`` of input
    ``x``."""
    worst, scale = 0.0, 0.0
    for c in range(0, x.shape[1], BLOCK_COLS):
        ref = torch.cumsum(x[:, c:c + BLOCK_COLS].double(), 0)
        diff = (got[:, c:c + BLOCK_COLS].double() - ref).abs().max()
        worst = max(worst, float(diff))
        scale = max(scale, float(ref.abs().max()))
    return worst / scale if scale > 0 else float("inf")
