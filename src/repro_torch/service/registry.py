"""Shared tuning-table registry: tune once per backend, inherit everywhere
(counterpart of ``repro.service.registry``).

The ROADMAP's "remote tuning-table sharing" item: the JSON tuning table used
to be strictly per-machine, so every worker in a pod re-measured the same
grid. The registry keys merged tables by **backend fingerprint**
(:func:`repro_torch.offload.tuning_cache.device_fingerprint`:
``torch-cuda:<name>:sm_<cc>:<machine>`` or ``torch-cpu:<machine>``, the
same string :meth:`~repro_torch.offload.tuning_cache.TuningCache.
load_compatible` checks) and
folds each published table into the entry for its fingerprint via
:meth:`TuningCache.merge` — lower measured cost wins per grid point, and
cross-fingerprint merges are structurally impossible because the fingerprint
*is* the key. A worker (or the broker) then fetches the one merged table for
its own backend and activates it, inheriting split/algorithm winners that
other workers measured.

Two backings, one interface:

  * :class:`TuningRegistry` — in-process dict; the broker's default.
  * :class:`FileTuningRegistry` — one JSON file per fingerprint under a
    shared directory (NFS / persistent volume), so the merge survives the
    process and crosses host boundaries. Publishes are read-merge-write with
    an atomic rename; last-writer-wins races lose at most the slower of two
    concurrent measurements, never the table.

The port's registry holds the port's tables only: it publishes no table
without a ``torch-`` fingerprint, never reads or lists a JAX table a shared
directory may also hold, and names its default directory with its own
``$REPRO_TORCH_TUNING_REGISTRY`` (the reference reads
``$REPRO_TUNING_REGISTRY``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.offload.tuning_cache import (
    FusionMeasurement,
    Measurement,
    SplitMeasurement,
    TuningCache,
    device_fingerprint,
)

#: env var naming a shared registry directory to use by default (the
#: port's own; the reference reads ``REPRO_TUNING_REGISTRY``)
TUNING_REGISTRY_ENV = "REPRO_TORCH_TUNING_REGISTRY"

#: every fingerprint of the port starts with this; no JAX one does
_PORT_PREFIX = "torch-"


def _check_port_table(backend: str) -> None:
    if not str(backend).startswith(_PORT_PREFIX):
        raise ValueError(
            f"tuning table fingerprint {backend!r} is not the port's "
            f"(want {_PORT_PREFIX}...): JAX tables never enter this registry"
        )


def _copy(cache: TuningCache) -> TuningCache:
    """Value-copy through the JSON schema (what persistence round-trips)."""
    d = cache.to_json()
    clone = TuningCache(backend=cache.backend)
    clone.measurements = [
        Measurement.from_json(m) for m in d["measurements"]
    ]
    clone.split_measurements = [
        SplitMeasurement.from_json(m) for m in d["split_measurements"]
    ]
    clone.fusion_measurements = [
        FusionMeasurement.from_json(m) for m in d["fusion_measurements"]
    ]
    return clone


class TuningRegistry:
    """Dict-backed registry of merged tuning tables, keyed by fingerprint."""

    def __init__(self) -> None:
        self._tables: Dict[str, TuningCache] = {}

    def publish(self, cache: TuningCache) -> TuningCache:
        """Merge a table into its fingerprint's entry; return the merged
        table (a copy — the caller's table is never aliased)."""
        _check_port_table(cache.backend)
        entry = self._tables.get(cache.backend)
        if entry is None:
            merged = _copy(cache)
        else:
            merged = entry.merge(_copy(cache))
        self._tables[cache.backend] = merged
        return _copy(merged)

    def fetch(
        self,
        backend: Optional[str] = None,
        *,
        device: "torch.device | str" = "cuda",
    ) -> Optional[TuningCache]:
        """The merged table for a fingerprint (default: ``device``'s, the
        card unless the caller passes ``"cpu"``), or None when nothing was
        ever published for it."""
        backend = backend or device_fingerprint(device)
        entry = self._tables.get(backend)
        return _copy(entry) if entry is not None else None

    def backends(self) -> List[str]:
        return sorted(self._tables)


def _slug(backend: str) -> str:
    """Filesystem-safe name for one fingerprint (readable prefix + hash)."""
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", backend)[:48]
    digest = hashlib.blake2s(backend.encode("utf-8")).hexdigest()[:10]
    return f"{safe}-{digest}"


class FileTuningRegistry(TuningRegistry):
    """Registry persisted as one JSON table per fingerprint in a directory."""

    def __init__(self, root: "str | Path"):
        super().__init__()
        self.root = Path(root)

    def _path(self, backend: str) -> Path:
        return self.root / f"{_slug(backend)}.json"

    def publish(self, cache: TuningCache) -> TuningCache:
        _check_port_table(cache.backend)
        path = self._path(cache.backend)
        merged = _copy(cache)
        if path.exists():
            existing = TuningCache.load(path)
            if existing.backend != cache.backend:  # hash-collision guard
                raise ValueError(
                    f"registry file {path} holds backend "
                    f"{existing.backend!r}, expected {cache.backend!r}"
                )
            merged = existing.merge(merged)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(path.parent), prefix=path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged.to_json(), f, indent=2)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._tables[cache.backend] = merged
        return _copy(merged)

    def fetch(
        self,
        backend: Optional[str] = None,
        *,
        device: "torch.device | str" = "cuda",
    ) -> Optional[TuningCache]:
        backend = backend or device_fingerprint(device)
        if not backend.startswith(_PORT_PREFIX):
            return None
        path = self._path(backend)
        if not path.exists():
            return None
        cache = TuningCache.load(path)
        if cache.backend != backend:  # hash-collision guard
            raise ValueError(
                f"registry file {path} holds backend "
                f"{cache.backend!r}, expected {backend!r}"
            )
        self._tables[backend] = cache
        return _copy(cache)

    def backends(self) -> List[str]:
        found = set(self._tables)
        if self.root.exists():
            for p in self.root.glob("*.json"):
                try:
                    backend = str(json.loads(p.read_text())["backend"])
                except (ValueError, KeyError):
                    continue
                if backend.startswith(_PORT_PREFIX):
                    found.add(backend)
        return sorted(found)


def default_registry() -> Optional[FileTuningRegistry]:
    """The registry named by ``$REPRO_TORCH_TUNING_REGISTRY``, if set."""
    root = os.environ.get(TUNING_REGISTRY_ENV)
    return FileTuningRegistry(root) if root else None


__all__ = [
    "FileTuningRegistry",
    "TUNING_REGISTRY_ENV",
    "TuningRegistry",
    "default_registry",
]
