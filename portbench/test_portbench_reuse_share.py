"""The ``reuse_share.scan`` reader, on span counters set by hand."""

from __future__ import annotations

import pytest

from portbench import bench

KNOWN = {"engine.offload": (200, 9_000_000), "engine.reuse": (198, 40_000)}


def metric(name, run):
    return bench.load_module("metrics", name).read(run)


@pytest.mark.parametrize("totals, want", [
    (KNOWN, 99.0),
    # dispatches of which none took the prepared path read 0, not absent
    ({"engine.offload": (200, 9_000_000)}, 0.0),
    # no dispatch
    ({}, None),
], ids=["share", "none_prepared", "no_dispatch"])
def test_reuse_share_reads_the_span_counters(monkeypatch, totals, want):
    from repro_torch.obs import tracing
    monkeypatch.setattr(tracing, "span_totals", lambda: totals)
    got = metric("reuse_share.scan", None)
    assert got == (pytest.approx(want) if want is not None else None)


def test_reuse_share_is_absent_without_a_prepared_path(monkeypatch):
    # the parent's engine lacks PREPARED_MAX
    from repro_torch.obs import tracing
    from repro_torch.offload import engine
    monkeypatch.setattr(tracing, "span_totals", lambda: KNOWN)
    monkeypatch.delattr(engine, "PREPARED_MAX")
    assert metric("reuse_share.scan", None) is None


def test_reuse_share_is_absent_without_span_counters(monkeypatch):
    from repro_torch.obs import tracing
    monkeypatch.delattr(tracing, "span_totals")
    assert metric("reuse_share.scan", None) is None
