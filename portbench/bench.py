"""Find a cell's files by name and run it once.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  general generator and runner, ``workloads/<kind>.py``;
* ``limits/<cell>.json``: the limit of each number that decides ``correct``;
* ``metrics/<metric>.py``: each metric's reader, ``read(run) -> float | None``.

A later cell, mix, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no process of a run may hold (the JAX
#: package is ``repro``; the port, ``repro_torch``, only begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def use_port() -> None:
    """Put the port's source folder first on ``sys.path``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported
                                  else [])]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config, mix,
                limits, e2e, per_layer)


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` as a module; a name may hold dots."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_module(kind: str):
    return importlib.import_module(f"portbench.workloads.{kind}")


def family_modules(family: str):
    """A model family's bridge to the program and its plain reference."""
    return (importlib.import_module(f"portbench.families.{family}"),
            importlib.import_module(f"portbench.reference.{family}"))


# ---------------------------------------------------------------------------
# What a run measured
# ---------------------------------------------------------------------------


@dataclass
class Measured:
    """One run's window, as the metric readers see it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    latencies_s: List[float] = field(default_factory=list)
    units: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    #: one summary a chip (:func:`portbench.trace.summarize`), traced runs
    traces: List[Dict[str, Any]] = field(default_factory=list)
    #: per-call constants the readers need (bytes, FLOPs, ranks)
    facts: Dict[str, Any] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    failed: int = 0


@dataclass
class Check:
    """One number that decides ``correct``, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def worst(checks: List[Check]) -> List[Check]:
    """One check a name, the largest value (several samples)."""
    by: Dict[str, Check] = {}
    for c in checks:
        old = by.get(c.name)
        if old is None or not (old.value >= c.value):  # NaN wins
            by[c.name] = c
    return list(by.values())


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


def timed_window(wl, seconds: float,
                 annotate: Optional[Callable[[str], Any]] = None) -> Measured:
    """Call ``wl.call(i)`` back to back for ``seconds``, each call timed on
    the host clock from its start to its result being ready
    (``wl.ready()``), then wait for all the work (``wl.drain()``)."""
    import contextlib

    first = wl.calls_done
    wl.plan_samples(seconds)
    lat: List[float] = []
    i = 0
    start = time.perf_counter()
    while True:
        with (annotate("portbench.call") if annotate else contextlib.nullcontext()):
            t = time.perf_counter()
            wl.call(first + i)
            wl.ready()
            lat.append(time.perf_counter() - t)
        i += 1
        if wl.stop(i, time.perf_counter() - start >= seconds):
            break
    wl.drain()
    window_s = time.perf_counter() - start
    wl.calls_done = first + i
    return Measured(window_s=window_s, calls=i, latencies_s=lat,
                    units=wl.units(i), facts=wl.facts())


def run_local(wl, seconds: float, trace: bool, t0: float) -> "tuple[Measured, List[Check]]":
    """Set up, measure and check one workload in this process. ``t0`` is
    the process's start on ``time.perf_counter``."""
    from portbench import trace as tr

    wl.setup()
    # what set-up made stays alive through the window: move it out of the
    # collector's reach, so that a collection in the window scans only
    # what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    window_epoch = time.time()
    measured = timed_window(wl, seconds)
    if trace:
        # the profiler slows the host: the traced windows come after the
        # measured one and give only what the card did a call
        span = min(float(seconds), float(wl.mix.get("trace_seconds", seconds)))
        label = min(span, float(wl.mix.get("label_seconds", span)))
        measured.traces = [tr.traced(wl, span, label)]
    measured.setup_s = setup_s
    measured.facts["window_epoch"] = window_epoch
    measured.memory_peak_bytes = wl.memory_peak()
    measured.counters = wl.counters()
    measured.failed = wl.failures()
    gc.unfreeze()
    wl.release()
    checks = wl.check()
    return measured, checks


def metrics_of(cell: Cell, measured: Measured, trace: bool) -> Dict[str, Any]:
    """The cell's end-to-end metrics (untraced run) or per-layer ones
    (traced run), each from its reader; a reader with nothing to read
    returns None and the metric is left out."""
    out: Dict[str, Any] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(measured)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, measured: Measured, checks: List[Check],
                trace: bool, device: Dict[str, Any]) -> Dict[str, Any]:
    from portbench import trace as tr

    checks = worst(checks)
    bad = sum(not c.ok for c in checks)
    dev = dict(device)
    dev["memory_peak_bytes"] = int(measured.memory_peak_bytes)
    line: Dict[str, Any] = {
        "correct": bool(checks) and bad == 0 and measured.failed == 0,
        "attempted": int(measured.calls),
        "failed": int(measured.failed + bad),
        "metrics": metrics_of(cell, measured, trace),
        "device": dev,
    }
    if trace and measured.traces:
        dev["busy_s"] = sum(t["busy_s"] for t in measured.traces) / len(measured.traces)
        dev["window_s"] = sum(t["window_s"] for t in measured.traces) / len(measured.traces)
        line["breakdown"] = tr.breakdown(measured.traces)
    line["counters"] = measured.counters
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line
