"""The chunked SSD's two readers, ``ssd_k6_share.prefill`` (span counters
set by hand) and ``ssd_device_ms.prefill`` (synthetic traced runs), with
the cases where each reads nothing: no ``ssd.block`` (a model without
Mamba2 layers, or a program without the span), no K6 kernel in the trace
(the parent's eager chunk output, a model without Mamba2 layers)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import bench


def metric(name, run):
    return bench.load_module("metrics", name).read(run)


@pytest.mark.parametrize("totals, want", [
    ({"ssd.block": (264, 9_000_000), "k6.call": (264, 300_000)}, 100.0),
    ({"ssd.block": (240, 9_000_000), "k6.call": (60, 100_000)}, 25.0),
    # Mamba2 layers of which none ran on K6 read 0, not absent
    ({"ssd.block": (240, 9_000_000)}, 0.0),
    # K6 calls without an SSD block (a kernel test) and no spans at all
    ({"k6.call": (4, 100_000)}, None),
    ({}, None),
], ids=["all", "quarter", "none_on_k6", "no_block", "nothing"])
def test_ssd_k6_share_reads_the_span_counters(monkeypatch, totals, want):
    from repro_torch.obs import tracing
    monkeypatch.setattr(tracing, "span_totals", lambda: totals)
    got = metric("ssd_k6_share.prefill", None)
    assert got == (pytest.approx(want) if want is not None else None)


def test_ssd_k6_share_is_absent_without_span_counters(monkeypatch):
    from repro_torch.obs import tracing
    monkeypatch.delattr(tracing, "span_totals")
    assert metric("ssd_k6_share.prefill", None) is None


K6 = "void (anonymous namespace)::k6_ssd_chunk_kernel<__nv_bfloat16>(...)"


def _run(kernels, calls):
    return SimpleNamespace(traces=[{"calls": calls, "kernels": kernels}])


@pytest.mark.parametrize("kernels, calls, want", [
    # 4 prefills, 9 layers each at 2.5 ms: 22.5 ms a call
    ({K6: [36, 0.090, "kernel"], "ampere_bf16_gemm": [40, 1.0, "kernel"]},
     4, 22.5),
    ({K6: [240, 0.120, "kernel"]}, 10, 12.0),
    # no K6 kernel: the parent's eager chunk output, or a cell without SSD
    ({"elementwise_kernel": [900, 2.0, "kernel"],
      "Memcpy k6_ssd_chunk": [1, 0.5, "gpu_memcpy"]}, 4, None),
    ({K6: [36, 0.090, "kernel"]}, 0, None),
], ids=["granite", "mamba2", "absent", "no_calls"])
def test_ssd_device_ms_reads_the_k6_kernel(kernels, calls, want):
    got = metric("ssd_device_ms.prefill", _run(kernels, calls))
    assert got == (pytest.approx(want) if want is not None else None)


def test_ssd_device_ms_is_absent_without_a_trace():
    assert metric("ssd_device_ms.prefill", SimpleNamespace(traces=[])) is None
