"""Operations and bytes the roofline and ``mfu`` readers count.

A model's FLOPs come from its configuration's widths alone, never from what
the program dispatches, so that a fusion or a new kernel leaves the
yardstick where it was. A multiply-add is two operations.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference import peaks
from portbench.reference.mamba2 import widths


def mamba2_forward_flops(c: Dict, batch: int, seq: int, head_positions: int) -> float:
    """One forward over ``batch`` rows of ``seq`` tokens, the LM head at
    ``head_positions`` positions a row (``seq`` in training, 1 in a
    prefill, which needs the last position's logits only).

    A layer, a token: the in projections ``2 d (2 di + 2 N + H)``, the
    depthwise conv ``2 W (di + 2 N)``, the out projection ``2 di d``. A
    chunk of ``Q`` tokens: the causal half of ``C B^T`` (``Q (Q + 1) / 2``
    pairs, ``2 N`` each) and of the weighted sum into the outputs (``2 H P``
    a pair), the chunk's state ``2 Q H P N``, the outputs from the state
    entering the chunk ``2 Q H P N``, and the state passing ``2 H P N``.
    The LM head ``2 d V`` a position, over the real vocabulary."""
    w = widths(c)
    d, di, N, H, P, W, L, V = (w[k] for k in ("d", "di", "N", "H", "P", "W", "L", "V"))
    Q = min(w["Q"], seq)
    chunks = seq // Q
    per_token = 2 * d * (2 * di + 2 * N + H) + 2 * W * (di + 2 * N) + 2 * di * d
    pairs = Q * (Q + 1) // 2
    per_chunk = pairs * (2 * N + 2 * H * P) + 4 * Q * H * P * N + 2 * H * P * N
    layers = L * batch * (seq * per_token + chunks * per_chunk)
    return float(layers + 2 * d * V * batch * head_positions)


def mamba2_train_flops(c: Dict, batch: int, seq: int) -> float:
    """A training step: the forward and a backward of twice its cost."""
    return 3.0 * mamba2_forward_flops(c, batch, seq, seq)


def scan_bytes(ranks: int, count: int, itemsize: int) -> float:
    """An inclusive scan of ``ranks`` rows of ``count`` elements on one
    card: every input byte read once, every result byte written once."""
    return 2.0 * ranks * count * itemsize


def scan_bound_s(ranks: int, count: int, itemsize: int) -> float:
    return scan_bytes(ranks, count, itemsize) / peaks.HBM_BYTES_S

