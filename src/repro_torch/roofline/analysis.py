"""Roofline analysis of a counted step (the port's counterpart of
``repro.roofline.analysis``).

Three terms per step, in seconds, from an op count
(:mod:`repro_torch.roofline.op_cost`) split over ``n_chips``:

    compute    = FLOPs_per_device / peak FLOP/s of the card
    memory     = HBM bytes_per_device / HBM bandwidth
    collective = collective wire bytes a rank sends / link bandwidth

The card's figures replace the reference's TPU constants. They are NVIDIA's
data-sheet peaks, not measurements: the H100 SXM5 80GB (the card the port
runs on, at its 700 W power limit) is 989e12 FLOP/s dense in bf16 and
fp16, 67e12 in float32 on the CUDA cores (TF32 stays off), 3.35e12 B/s of
HBM3 and 450e9 B/s of NVLink a direction (900 GB/s both ways). A card set
below 700 W runs slower than these under load. :data:`CARDS` holds them by
card name, beside the H100 PCIe's and the H200's; :data:`PEAK_FLOPS`,
:data:`HBM_BW` and :data:`LINK_BW` are the H100 SXM5's, the reference's
names.

:func:`kernel_cost` is the analytic charge of each of K1-K5 (bytes in
plus bytes out, and the kernel's FLOPs), which the kernel wrappers record
under a :class:`~repro_torch.roofline.op_cost.CostMode` and which
``chip_smoke.py``'s bounds divide by the card's rates: the kernel table's
bound and a step's bound come from one count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.roofline.op_cost import Cost, op_cost


@dataclasses.dataclass(frozen=True)
class Card:
    """One card's data-sheet peaks; ``name`` is matched as a substring of
    ``torch.cuda.get_device_name()``."""

    name: str
    hbm_bw: float                 # bytes/s
    link_bw: float                # bytes/s a direction, one card's NVLink
    peak_flops: Dict[str, float]  # dense FLOP/s by dtype name


#: most specific name first (``"H100 PCIe"`` before ``"H100"``)
CARDS: Tuple[Card, ...] = (
    Card("H200", 4.8e12, 450e9,
         {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}),
    Card("H100 PCIe", 2.0e12, 300e9,
         {"bfloat16": 756e12, "float16": 756e12, "float32": 51e12}),
    Card("H100", 3.35e12, 450e9,
         {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}),
)
#: the H100 SXM5 80GB, the card a roofline is taken against by default
H100 = CARDS[2]
PEAK_FLOPS = H100.peak_flops["bfloat16"]   # bf16 per card
HBM_BW = H100.hbm_bw                       # bytes/s
LINK_BW = H100.link_bw                     # bytes/s a direction


def card_for(name: str) -> Card:
    """The :data:`CARDS` row whose name ``name`` contains (raises for a
    card not on record)."""
    for card in CARDS:
        if card.name in name:
            return card
    raise RuntimeError(f"no data-sheet figures on record for {name!r}")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def mem_bandwidth(name: str) -> float:
    """HBM bytes/s of the card named ``name``."""
    return card_for(name).hbm_bw


def peak_flops(name: str, dtype) -> float:
    """Dense FLOP/s of the card named ``name`` in ``dtype``."""
    return card_for(name).peak_flops[dtype_name(dtype)]


@dataclasses.dataclass
class Roofline:
    """The reference's ``Roofline`` over one card's figures (``card``,
    ``dtype`` pick the peak; the H100 SXM5 in bf16 by default)."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    n_chips: int
    card: Card = H100
    dtype: str = "bfloat16"

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.card.peak_flops[self.dtype]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.card.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.card.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "n_chips": self.n_chips,
        }


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# The kernels' own cost
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call's FLOPs and bytes (each input read once, each output
    written once), and the dtype its FLOPs run in."""

    flops: float
    bytes: float
    dtype: str

    def bound(self, card: Card = H100) -> Tuple[float, str]:
        """(seconds, ``"bytes"`` or ``"operations"``): the least time
        ``card`` could take, the larger of the two."""
        by_bytes = self.bytes / card.hbm_bw
        by_ops = (self.flops / card.peak_flops[self.dtype]
                  if self.flops else 0.0)
        return (by_ops, "operations") if by_ops > by_bytes else (
            by_bytes, "bytes")


def visible_pairs(Sq: int, Skv: int, *, causal: bool, window: int,
                  q_offset: int) -> int:
    """(query, key) pairs the attention masks leave visible."""
    total = 0
    for q in range(q_offset, q_offset + Sq):
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = min(Skv - 1, q) if causal else Skv - 1
        total += max(0, hi - lo + 1)
    return total


def _rounds(p: int) -> int:
    """The doubling rounds of a comm phase over ``p`` ranks."""
    r, d = 0, 1
    while d < p:
        r, d = r + 1, d * 2
    return r


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name(dtype))).element_size()


def kernel_cost(kernel: str, **shape) -> KernelCost:
    """The analytic cost of one call of a kernel, whichever implementation
    runs it:

    * ``"k1"`` / ``"k2"`` (``phase``, a ``PhaseKind`` name, ``p``,
      ``numel``: every element of the
      stacked leaves, ``dtype``): the leaves read, the result written (two
      results for FUSED_SCAN_TOTAL); one combine an element a round (two
      for FUSED_SCAN_TOTAL);
    * ``"k3"`` (``rows``, ``length``, ``dtype``, ``reverse``): the rows read
      and written once; one combine an element;
    * ``"k4"`` (``rows``, ``time``, ``width``, ``dtype``, ``h0``): ``a`` and
      ``b`` read, ``h`` written (and ``h0`` read); a multiply and an add an
      element;
    * ``"k5"`` (``bh``, ``sq``, ``skv``, ``d``, ``dtype``, ``causal``,
      ``window``, ``q_offset``): q, k, v read, the output written; 4 x d
      FLOPs a visible (query, key) pair (two matmuls).
    """
    dt = dtype_name(shape["dtype"])
    size = _itemsize(dt)
    if kernel in ("k1", "k2"):
        n = shape["numel"]
        outs = 2 if shape["phase"] == "FUSED_SCAN_TOTAL" else 1
        return KernelCost(float(outs * n * _rounds(shape["p"])),
                          float((1 + outs) * n * size), dt)
    if kernel == "k3":
        n = shape["rows"] * shape["length"]
        return KernelCost(float(n), float(2 * n * size), dt)
    if kernel == "k4":
        n = shape["rows"] * shape["time"] * shape["width"]
        h0 = shape["rows"] * shape["width"] if shape.get("h0") else 0
        return KernelCost(float(2 * n), float((3 * n + h0) * size), dt)
    if kernel == "k5":
        bh, sq, skv, d = shape["bh"], shape["sq"], shape["skv"], shape["d"]
        pairs = visible_pairs(sq, skv, causal=shape["causal"],
                              window=shape["window"],
                              q_offset=shape["q_offset"])
        return KernelCost(float(4 * bh * d * pairs),
                          float((2 * bh * sq * d + 2 * bh * skv * d) * size),
                          dt)
    if kernel == "k6":
        bc, Q, H = shape["batch"] * shape["chunks"], shape["chunk"], shape["heads"]
        P, N = shape["head_dim"], shape["state"]
        pairs = Q * (Q + 1) // 2
        flops = 2 * bc * H * P * (pairs + Q * N)
        read = bc * (Q * Q + Q * H * P + Q * N) * size + 4 * bc * H * (Q + P * N)
        return KernelCost(float(flops), float(read + 4 * bc * Q * H * P), dt)
    raise ValueError(f"unknown kernel {kernel!r}")


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


def analyze(cost: Cost, n_chips: int, *, card: Card = H100,
            dtype: str = "bfloat16") -> Roofline:
    """The roofline of a count that holds the work of ``n_chips`` ranks:
    FLOPs and bytes split evenly over them, collectives as counted (per
    rank)."""
    return Roofline(
        flops_per_device=cost.flops / n_chips,
        bytes_per_device=cost.bytes / n_chips,
        collective_bytes=cost.total_coll_bytes,
        n_chips=n_chips,
        card=card,
        dtype=dtype,
    )


def analyze_step(fn: Callable, args: Sequence, n_chips: int = 1, *,
                 card: Card = H100, dtype: str = "bfloat16"):
    """Run ``fn(*args)`` once under a ``CostMode`` (the counterpart of
    ``analyze_hlo``): ``(Roofline, Cost)``."""
    _, cost = op_cost(fn, *args)
    return analyze(cost, n_chips, card=card, dtype=dtype), cost
