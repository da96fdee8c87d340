"""Persistent tuning table: measured latencies, per-point winners, and the
least-squares-fitted LinkModel (PyTorch port of
``repro.offload.tuning_cache``).

The NetFPGA paper leaves ``algo_type`` to the host runtime's "intelligent
selection"; this module is where that intelligence persists. The autotuner
(:mod:`repro_torch.offload.tuner`) records micro-benchmark latencies for
every (coll, algorithm, p, payload) grid point, this cache reduces them to

  * ``winners`` — the measured-fastest applicable algorithm per grid point,
    consulted first by ``select_algorithm`` (nearest grid point in log2
    space when the query falls off-grid);
  * ``fitted`` — alpha/beta/gamma solved from the measurements against
    :func:`repro_torch.core.selector.cost_features`, used for points too far
    from any measurement;
  * ``split_winners`` — the measured-fastest logical axis order per
    (coll, mesh shape, payload), consulted by ``plan_axis_order``;
  * ``fusion_winners`` / ``schedule_winners`` — the measured (fused?,
    chunks) schedule per (coll, mesh shape, payload), consulted by
    ``choose_optimization`` / ``choose_schedule``;
  * ``backend_winners`` — the measured-fastest *lowering backend* per
    (coll, mesh shape, payload), from ``tune_schedule`` racing the
    op-per-round default against the fused kernel (K1), consulted by
    ``choose_backend`` (``make_descriptor(backend="auto")``);

and round-trips the whole table through JSON with the reference's schema
(:data:`SCHEMA_VERSION`), so one tuning run serves every later process on
the same card (``$REPRO_TORCH_TUNING_TABLE`` or an explicit ``load``).

The table's ``backend`` field is the fingerprint of the device it was
measured on: ``torch-cuda:<device name>:sm_<major><minor>:<machine>`` for a
card, ``torch-cpu:<machine>`` for the CPU. It can never equal a fingerprint
of the reference's (``tpu:…``, ``gpu:…``, ``cpu:…``), so a port table and a
JAX table never mix: :meth:`TuningCache.merge` raises across packages and
:meth:`TuningCache.load_compatible` warns and returns ``None``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import platform
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.selector import (
    LinkModel,
    cost_features,
    set_active_tuning,
)
from repro_torch.core.trees import checked_device

SCHEMA_VERSION = 1

#: env var pointing at a tuning table to auto-load at launch (the port's own,
#: so one shell can point each package at its own table)
TUNING_TABLE_ENV = "REPRO_TORCH_TUNING_TABLE"

# Queries farther than this (in |log2| distance on p and payload combined)
# from every measured grid point fall through to the fitted model.
_MAX_GRID_DISTANCE = 3.0


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One micro-benchmark sample: median seconds for a full collective."""

    coll: str            # "scan" | "exscan" | "reduce" | "allreduce" | "barrier"
    algo: str
    p: int
    payload_bytes: int
    seconds: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Measurement":
        return Measurement(
            coll=str(d["coll"]),
            algo=str(d["algo"]),
            p=int(d["p"]),
            payload_bytes=int(d["payload_bytes"]),
            seconds=float(d["seconds"]),
        )


@dataclasses.dataclass(frozen=True)
class SplitMeasurement:
    """One planned-collective sample: median seconds for a whole plan run
    with a specific logical axis order over a specific mesh shape."""

    coll: str
    sizes: Tuple[int, ...]   # physical mesh-axis sizes, outermost first
    order: Tuple[int, ...]   # logical level -> physical axis index
    payload_bytes: int
    seconds: float

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["sizes"] = list(self.sizes)
        d["order"] = list(self.order)
        return d

    @staticmethod
    def from_json(d: dict) -> "SplitMeasurement":
        return SplitMeasurement(
            coll=str(d["coll"]),
            sizes=tuple(int(v) for v in d["sizes"]),
            order=tuple(int(v) for v in d["order"]),
            payload_bytes=int(d["payload_bytes"]),
            seconds=float(d["seconds"]),
        )


@dataclasses.dataclass(frozen=True)
class FusionMeasurement:
    """One plan-schedule sample: median seconds of a whole planned
    collective with the pass pipeline on (``optimized=True``) or off and a
    specific payload chunk count, for one (coll, mesh shape, payload). The
    reduction over these is the measured (fused, chunks) schedule winner
    that ``choose_schedule``/``choose_optimization`` consult.

    ``chunks`` defaults to 1 so tables written before chunked streaming
    existed load unchanged (same schema version); ``backend`` (the
    *lowering* backend name — "" for the mode default, "pallas" for the
    fused-kernel lowering, distinct from the table-level hardware
    fingerprint) likewise defaults to "" so pre-registry tables load
    unchanged."""

    coll: str
    sizes: Tuple[int, ...]
    optimized: bool
    payload_bytes: int
    seconds: float
    chunks: int = 1
    backend: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["sizes"] = list(self.sizes)
        return d

    @staticmethod
    def from_json(d: dict) -> "FusionMeasurement":
        return FusionMeasurement(
            coll=str(d["coll"]),
            sizes=tuple(int(v) for v in d["sizes"]),
            optimized=bool(d["optimized"]),
            payload_bytes=int(d["payload_bytes"]),
            seconds=float(d["seconds"]),
            chunks=int(d.get("chunks", 1)),
            backend=str(d.get("backend", "")),
        )


class TuningCache:
    """Measurements + winners + fitted model, with JSON persistence.

    ``backend`` is the fingerprint of the device the measurements come
    from; without it, the fingerprint of ``device`` (the current CUDA
    device unless the caller passes ``"cpu"``)."""

    def __init__(
        self,
        *,
        backend: Optional[str] = None,
        device: "torch.device | str" = "cuda",
    ):
        self.backend = backend or device_fingerprint(device)
        self.measurements: List[Measurement] = []
        self.split_measurements: List[SplitMeasurement] = []
        self.fusion_measurements: List[FusionMeasurement] = []
        self._winners: Dict[Tuple[str, int, int], str] = {}
        self._split_winners: Dict[
            Tuple[str, Tuple[int, ...], int], Tuple[int, ...]
        ] = {}
        self._fusion_winners: Dict[
            Tuple[str, Tuple[int, ...], int], bool
        ] = {}
        self._schedule_winners: Dict[
            Tuple[str, Tuple[int, ...], int], Tuple[bool, int]
        ] = {}
        self._backend_winners: Dict[
            Tuple[str, Tuple[int, ...], int], str
        ] = {}
        self._fitted: Optional[LinkModel] = None

    # -- recording ---------------------------------------------------------

    def record(
        self, coll: str, algo: str, p: int, payload_bytes: int, seconds: float
    ) -> None:
        self.measurements.append(
            Measurement(coll, algo, int(p), int(payload_bytes), float(seconds))
        )
        self._winners = {}  # invalidate
        self._fitted = None

    def record_split(
        self,
        coll: str,
        sizes: Sequence[int],
        order: Sequence[int],
        payload_bytes: int,
        seconds: float,
    ) -> None:
        self.split_measurements.append(
            SplitMeasurement(
                coll,
                tuple(int(s) for s in sizes),
                tuple(int(i) for i in order),
                int(payload_bytes),
                float(seconds),
            )
        )
        self._split_winners = {}  # invalidate

    def record_fusion(
        self,
        coll: str,
        sizes: Sequence[int],
        optimized: bool,
        payload_bytes: int,
        seconds: float,
        chunks: int = 1,
        backend: str = "",
    ) -> None:
        self.fusion_measurements.append(
            FusionMeasurement(
                coll,
                tuple(int(s) for s in sizes),
                bool(optimized),
                int(payload_bytes),
                float(seconds),
                int(chunks),
                str(backend),
            )
        )
        self._fusion_winners = {}  # invalidate
        self._schedule_winners = {}
        self._backend_winners = {}

    def record_schedule(
        self,
        coll: str,
        sizes: Sequence[int],
        optimized: bool,
        chunks: int,
        payload_bytes: int,
        seconds: float,
        backend: str = "",
    ) -> None:
        """One (fused?, chunks) schedule variant sample — the generalized
        form of :meth:`record_fusion` the chunk-aware tuner writes.
        ``backend`` is the lowering backend the sample ran under ("" for
        the mode default)."""
        self.record_fusion(
            coll, sizes, optimized, payload_bytes, seconds, chunks=chunks,
            backend=backend,
        )

    # -- merging -----------------------------------------------------------

    def merge(self, other: "TuningCache") -> "TuningCache":
        """Fold another table's measurements into this one, in place.

        Only tables measured on the *same* backend fingerprint may merge —
        latencies from different hardware are not comparable, and a merged
        table silently mixing them would mis-rank every selection — so a
        mismatch raises. Same-key samples (identical coll/algo/p/payload, or
        coll/sizes/order/payload for splits) keep the lower measured cost:
        re-measurement can only sharpen a winner, never regress it. The
        merged table round-trips through :meth:`save`/:meth:`load_compatible`
        like any single-host table, which is what lets a registry serve one
        pod-wide table assembled from many workers' partial tuning runs.
        """
        if other.backend != self.backend:
            raise ValueError(
                f"cannot merge tuning tables across backends: this table "
                f"was measured on {self.backend!r}, the other on "
                f"{other.backend!r}"
            )
        best: Dict[Tuple[str, str, int, int], Measurement] = {}
        for m in (*self.measurements, *other.measurements):
            key = (m.coll, m.algo, m.p, m.payload_bytes)
            cur = best.get(key)
            if cur is None or m.seconds < cur.seconds:
                best[key] = m
        self.measurements = [best[k] for k in sorted(best)]
        best_split: Dict[
            Tuple[str, Tuple[int, ...], Tuple[int, ...], int],
            SplitMeasurement,
        ] = {}
        for s in (*self.split_measurements, *other.split_measurements):
            key = (s.coll, s.sizes, s.order, s.payload_bytes)
            cur = best_split.get(key)
            if cur is None or s.seconds < cur.seconds:
                best_split[key] = s
        self.split_measurements = [best_split[k] for k in sorted(best_split)]
        best_fusion: Dict[
            Tuple[str, Tuple[int, ...], bool, int, str, int],
            FusionMeasurement,
        ] = {}
        for f in (*self.fusion_measurements, *other.fusion_measurements):
            key = (
                f.coll, f.sizes, f.optimized, f.chunks, f.backend,
                f.payload_bytes,
            )
            cur = best_fusion.get(key)
            if cur is None or f.seconds < cur.seconds:
                best_fusion[key] = f
        self.fusion_measurements = [
            best_fusion[k] for k in sorted(best_fusion)
        ]
        self._winners = {}
        self._split_winners = {}
        self._fusion_winners = {}
        self._schedule_winners = {}
        self._backend_winners = {}
        self._fitted = None
        return self

    # -- reductions --------------------------------------------------------

    @property
    def winners(self) -> Dict[Tuple[str, int, int], str]:
        if not self._winners and self.measurements:
            best: Dict[Tuple[str, int, int], Tuple[float, str]] = {}
            for m in self.measurements:
                key = (m.coll, m.p, m.payload_bytes)
                cur = best.get(key)
                if cur is None or (m.seconds, m.algo) < cur:
                    best[key] = (m.seconds, m.algo)
            self._winners = {k: algo for k, (_, algo) in best.items()}
        return self._winners

    @property
    def split_winners(
        self,
    ) -> Dict[Tuple[str, Tuple[int, ...], int], Tuple[int, ...]]:
        if not self._split_winners and self.split_measurements:
            best: Dict[
                Tuple[str, Tuple[int, ...], int],
                Tuple[float, Tuple[int, ...]],
            ] = {}
            for m in self.split_measurements:
                key = (m.coll, m.sizes, m.payload_bytes)
                cur = best.get(key)
                if cur is None or (m.seconds, m.order) < cur:
                    best[key] = (m.seconds, m.order)
            self._split_winners = {
                k: order for k, (_, order) in best.items()
            }
        return self._split_winners

    @property
    def schedule_winners(
        self,
    ) -> Dict[Tuple[str, Tuple[int, ...], int], Tuple[bool, int]]:
        """(coll, sizes, payload) -> measured-fastest (optimized, chunks).

        Ties break toward the optimized form (the pass pipeline never adds
        communication rounds), then toward fewer chunks (the simpler
        schedule; C=1 is the exact legacy lowering). Only default-backend
        rows compete here: the (optimized, chunks) winner keeps meaning
        "fastest op-per-round schedule" regardless of what the fused-kernel
        lowering measured — the backend choice is a separate reduction
        (:attr:`backend_winners`)."""
        if not self._schedule_winners and self.fusion_measurements:
            best: Dict[
                Tuple[str, Tuple[int, ...], int], Tuple[float, int, int]
            ] = {}
            for m in self.fusion_measurements:
                if m.backend:
                    continue
                key = (m.coll, m.sizes, m.payload_bytes)
                cand = (m.seconds, 0 if m.optimized else 1, m.chunks)
                cur = best.get(key)
                if cur is None or cand < cur:
                    best[key] = cand
            self._schedule_winners = {
                k: (flag == 0, chunks)
                for k, (_, flag, chunks) in best.items()
            }
        return self._schedule_winners

    @property
    def backend_winners(
        self,
    ) -> Dict[Tuple[str, Tuple[int, ...], int], str]:
        """(coll, sizes, payload) -> measured-fastest lowering backend.

        All rows compete across backends; ties break toward "" (the mode
        default — the op-per-round lowering is the reference semantics and
        needs no capability check). Populated only when at least one
        non-default row exists for the grid point, so a table tuned before
        the registry never steers ``backend="auto"``."""
        if not self._backend_winners and self.fusion_measurements:
            pts_with_alt = {
                (m.coll, m.sizes, m.payload_bytes)
                for m in self.fusion_measurements
                if m.backend
            }
            best: Dict[
                Tuple[str, Tuple[int, ...], int], Tuple[float, int, str]
            ] = {}
            for m in self.fusion_measurements:
                key = (m.coll, m.sizes, m.payload_bytes)
                if key not in pts_with_alt:
                    continue
                cand = (m.seconds, 1 if m.backend else 0, m.backend)
                cur = best.get(key)
                if cur is None or cand < cur:
                    best[key] = cand
            self._backend_winners = {
                k: name for k, (_, _, name) in best.items()
            }
        return self._backend_winners

    def backend_winner(
        self, coll: str, sizes: Sequence[int], payload_bytes: int
    ) -> Optional[str]:
        """Measured-fastest lowering backend for this exact mesh shape at
        the nearest measured payload (log2 distance), or None when no
        backend race was ever recorded for the shape —
        ``choose_backend`` then keeps the mode default."""
        sizes = tuple(int(s) for s in sizes)
        best: Optional[Tuple[float, str]] = None
        for (c, gs, gm), name in self.backend_winners.items():
            if c != coll or gs != sizes:
                continue
            dist = abs(
                math.log2(max(payload_bytes, 1)) - math.log2(max(gm, 1))
            )
            if best is None or dist < best[0]:
                best = (dist, name)
        if best is None or best[0] > 4 * _MAX_GRID_DISTANCE:
            return None
        return best[1]

    @property
    def fusion_winners(
        self,
    ) -> Dict[Tuple[str, Tuple[int, ...], int], bool]:
        """(coll, sizes, payload) -> the fused half of the schedule winner
        (kept for callers that only care about the optimizer flag)."""
        if not self._fusion_winners and self.fusion_measurements:
            self._fusion_winners = {
                k: opt for k, (opt, _) in self.schedule_winners.items()
            }
        return self._fusion_winners

    def schedule_winner(
        self, coll: str, sizes: Sequence[int], payload_bytes: int
    ) -> Optional[Tuple[bool, int]]:
        """Measured-fastest (optimized, chunks) schedule for this exact mesh
        shape at the nearest measured payload (log2 distance), or None when
        the shape was never schedule-tuned — ``choose_schedule`` then falls
        back to the plan cost model."""
        sizes = tuple(int(s) for s in sizes)
        best: Optional[Tuple[float, Tuple[bool, int]]] = None
        for (c, gs, gm), win in self.schedule_winners.items():
            if c != coll or gs != sizes:
                continue
            dist = abs(
                math.log2(max(payload_bytes, 1)) - math.log2(max(gm, 1))
            )
            if best is None or dist < best[0]:
                best = (dist, win)
        if best is None or best[0] > 4 * _MAX_GRID_DISTANCE:
            return None
        return best[1]

    def fusion_winner(
        self, coll: str, sizes: Sequence[int], payload_bytes: int
    ) -> Optional[bool]:
        """Measured fused-vs-unfused winner for this exact mesh shape at
        the nearest measured payload (log2 distance), or None when the
        shape was never fusion-tuned — ``choose_optimization`` then falls
        back to the plan cost model."""
        win = self.schedule_winner(coll, sizes, payload_bytes)
        return None if win is None else win[0]

    def fitted_model(self) -> Optional[LinkModel]:
        """Least-squares (alpha, beta, gamma) over the inclusive-scan
        measurements; None until enough samples exist."""
        if self._fitted is None:
            rows, targets = [], []
            for m in self.measurements:
                if m.coll != "scan":
                    continue
                try:
                    rows.append(cost_features(m.algo, m.p, m.payload_bytes))
                except ValueError:
                    continue
                targets.append(m.seconds)
            if len(rows) >= 3:
                coef, *_ = np.linalg.lstsq(
                    np.asarray(rows, dtype=np.float64),
                    np.asarray(targets, dtype=np.float64),
                    rcond=None,
                )
                # a negative fitted constant means the feature is noise at
                # this backend's scale; clamp to a tiny positive epsilon so
                # the model stays physical (and ties still break on steps).
                a, b, g = (max(float(c), 1e-12) for c in coef)
                self._fitted = LinkModel(alpha=a, beta=b, gamma=g, ring=True)
        return self._fitted

    # -- selector interface ------------------------------------------------

    def lookup(
        self, p: int, payload_bytes: int, coll: str = "scan"
    ) -> Optional[str]:
        """Measured winner at the nearest grid point, or None when the query
        is too far from everything measured (off-grid -> fitted model)."""
        table = self.winners
        best: Optional[Tuple[float, str]] = None
        for (c, gp, gm), algo in table.items():
            if c != coll:
                continue
            dist = abs(math.log2(max(p, 1)) - math.log2(max(gp, 1))) + 0.25 * abs(
                math.log2(max(payload_bytes, 1)) - math.log2(max(gm, 1))
            )
            if best is None or dist < best[0]:
                best = (dist, algo)
        if best is None or best[0] > _MAX_GRID_DISTANCE:
            return None
        return best[1]

    def split_winner(
        self, coll: str, sizes: Sequence[int], payload_bytes: int
    ) -> Optional[Tuple[int, ...]]:
        """Measured-fastest logical axis order for this exact mesh shape, at
        the nearest measured payload (log2 distance); None when this shape
        (or coll) was never split-tuned — the planner then falls back to the
        fitted cost model."""
        sizes = tuple(int(s) for s in sizes)
        best: Optional[Tuple[float, Tuple[int, ...]]] = None
        for (c, gs, gm), order in self.split_winners.items():
            if c != coll or gs != sizes:
                continue
            dist = abs(
                math.log2(max(payload_bytes, 1)) - math.log2(max(gm, 1))
            )
            if best is None or dist < best[0]:
                best = (dist, order)
        if best is None or best[0] > 4 * _MAX_GRID_DISTANCE:
            return None
        return best[1]

    # -- persistence -------------------------------------------------------

    def to_json(self) -> dict:
        fitted = self.fitted_model()
        return {
            "schema_version": SCHEMA_VERSION,
            "backend": self.backend,
            "measurements": [m.to_json() for m in self.measurements],
            "split_measurements": [
                m.to_json() for m in self.split_measurements
            ],
            "fusion_measurements": [
                m.to_json() for m in self.fusion_measurements
            ],
            "winners": [
                {"coll": c, "p": p, "payload_bytes": m, "algo": algo}
                for (c, p, m), algo in sorted(self.winners.items())
            ],
            "fitted": None
            if fitted is None
            else {
                "alpha": fitted.alpha,
                "beta": fitted.beta,
                "gamma": fitted.gamma,
                "ring": fitted.ring,
            },
        }

    def save(self, path: "str | Path") -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2))
        return path

    @classmethod
    def load(cls, path: "str | Path") -> "TuningCache":
        d = json.loads(Path(path).read_text())
        if d.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"tuning table {path} has schema {d.get('schema_version')}, "
                f"expected {SCHEMA_VERSION}"
            )
        cache = cls(backend=d.get("backend"))
        for m in d.get("measurements", []):
            cache.measurements.append(Measurement.from_json(m))
        for m in d.get("split_measurements", []):
            cache.split_measurements.append(SplitMeasurement.from_json(m))
        for m in d.get("fusion_measurements", []):
            cache.fusion_measurements.append(FusionMeasurement.from_json(m))
        f = d.get("fitted")
        if f is not None:
            cache._fitted = LinkModel(
                alpha=float(f["alpha"]),
                beta=float(f["beta"]),
                gamma=float(f["gamma"]),
                ring=bool(f.get("ring", True)),
            )
        return cache

    @classmethod
    def load_compatible(
        cls, path: "str | Path", *, device: "torch.device | str" = "cuda"
    ) -> "Optional[TuningCache]":
        """Load a table only if it was measured on a device like ``device``.

        Ambient tables (``$REPRO_TORCH_TUNING_TABLE``) travel with home
        directories and container images; silently applying constants
        measured on another card, on the CPU, or by the JAX package would
        mis-rank every schedule. On a fingerprint mismatch this warns and
        returns None so callers fall back to the static constants;
        ``load()`` keeps the strict raise-on-schema-only behavior for
        explicitly named tables.
        """
        cache = cls.load(path)
        current = device_fingerprint(device)
        if cache.backend != current:
            warnings.warn(
                f"tuning table {path} was measured on backend "
                f"{cache.backend!r} but this process runs on {current!r}; "
                "ignoring it (static cost constants stay active). Re-run "
                "the autotuner on this backend to regenerate it.",
                RuntimeWarning,
                stacklevel=2,
            )
            return None
        return cache

    # -- activation --------------------------------------------------------

    def activate(self) -> "TuningCache":
        """Make this table the one ``select_algorithm`` consults."""
        set_active_tuning(self)
        return self


def deactivate() -> None:
    set_active_tuning(None)


def load_default_table(
    device: "torch.device | str" = "cuda",
) -> Optional[TuningCache]:
    """Load + activate the table named by ``$REPRO_TORCH_TUNING_TABLE``, if
    any.

    Fingerprint-checked against ``device``: a table measured on another
    device (or by the JAX package) is ignored, with a warning, rather than
    activated.
    """
    path = os.environ.get(TUNING_TABLE_ENV)
    if not path or not Path(path).exists():
        return None
    cache = TuningCache.load_compatible(path, device=device)
    return cache.activate() if cache is not None else None


def device_fingerprint(device: "torch.device | str" = "cuda") -> str:
    """The fingerprint of the device a table is measured on or used with:
    ``torch-cuda:<name>:sm_<major><minor>:<machine>`` for a card (the
    current one for a bare ``"cuda"``; raises without CUDA),
    ``torch-cpu:<machine>`` for the CPU."""
    device = checked_device(device, "a CUDA tuning fingerprint")
    if device.type == "cpu":
        return f"torch-cpu:{platform.machine()}"
    if device.type != "cuda":
        raise ValueError(f"no tuning fingerprint for device {device}")
    major, minor = torch.cuda.get_device_capability(device)
    return (
        f"torch-cuda:{torch.cuda.get_device_name(device)}:"
        f"sm_{major}{minor}:{platform.machine()}"
    )
