"""``repro_torch.offload.profiling`` and the engine's telemetry producers
against ``repro.offload.profiling`` / ``repro.offload.engine``.

* ``parse_device_us`` on hand-written chrome traces in ``torch.profiler``'s
  format gives the exact interval union (no tolerance: the numbers are
  sums of the trace's own) of the device events whose ``correlation``
  matches a CUDA runtime/driver call that started inside the annotation:
  overlapping, nested and outside-window kernels, memcpy and memset
  events, correlations that match and that don't, device timestamps that
  run past the window (kept whole), plain and gzip files.
* On the CPU ``profile_offload`` has no device event: ``source == "wall"``
  with ``parse_failed`` counted; a profiler session already running gives
  ``trace_start_failed`` (and is not ended by the attempt).
* The same sequence of ``record_dispatch``, ``record_device_latency`` and
  ``record_profiler_fallback`` calls gives the same ``snapshot()`` in both
  packages (latency means to rel 1e-12).
"""

import gzip
import json
import math

import numpy as np
import pytest
import torch

from repro.offload import engine as jengine
from repro_torch.obs import metrics as tmetrics
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import engine as tengine
from repro_torch.offload import profiling as tprof

TAG = "repro_offload:scan:p8"
REL = 1e-12


def _x(name, cat, ts, dur, corr=None, **args):
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


def _trace():
    """A window [1000, 1100] on the host clock; device work on the GPU's
    clock, some of it past the window's end."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "h"}},
        _x(TAG, "user_annotation", 1000.0, 100.0),
        _x(TAG, "gpu_user_annotation", 1005.0, 300.0),  # never the anchor
        # inside the window: launches with correlations 1-5
        _x("cudaLaunchKernel", "cuda_runtime", 1010.0, 4.0, 1),
        _x("cudaLaunchKernelExC", "cuda_runtime", 1020.0, 4.0, 2),
        _x("cuLaunchKernel", "cuda_driver", 1030.0, 4.0, 3),
        _x("cudaMemcpyAsync", "cuda_runtime", 1040.0, 4.0, 4),
        _x("cudaMemsetAsync", "cuda_runtime", 1099.5, 0.4, 5),
        _x("cudaStreamSynchronize", "cuda_runtime", 1050.0, 40.0, 6),
        # outside the window: launched before and after it
        _x("cudaLaunchKernel", "cuda_runtime", 900.0, 4.0, 7),
        _x("cudaLaunchKernel", "cuda_runtime", 1200.0, 4.0, 8),
        # device events (GPU clock): overlapping 1 and 2, nested 3 in 1
        _x("k1_register_kernel", "kernel", 1012.0, 10.0, 1),
        _x("k2_cluster_kernel", "kernel", 1018.0, 10.0, 2),
        _x("inner", "kernel", 1013.0, 2.0, 3),
        _x("Memcpy HtoD", "gpu_memcpy", 1040.0, 3.0, 4),
        # launched at the window's end, runs past it: counted whole
        _x("Memset", "gpu_memset", 1101.0, 5.0, 5),
        # launched outside the window, runs inside it: not the window's
        _x("early", "kernel", 1001.0, 50.0, 7),
        _x("late", "kernel", 1090.0, 50.0, 8),
        # a kernel with no launch in this trace, one with no correlation
        _x("orphan", "kernel", 1030.0, 5.0, 99),
        _x("uncorrelated", "kernel", 1030.0, 5.0),
        # a host op that overlaps everything: not device work
        _x("aten::add", "cpu_op", 1000.0, 100.0),
    ]}


# union of [1012, 1022] + [1018, 1028] + [1013, 1015] = [1012, 1028] = 16,
# [1040, 1043] = 3, [1101, 1106] = 5
WANT = (24.0, 5)


@pytest.mark.parametrize("packed", [False, True], ids=["json", "gzip"])
def test_parse_device_us_exact_union(tmp_path, packed):
    raw = json.dumps(_trace()).encode()
    path = tmp_path / ("t.json.gz" if packed else "t.json")
    path.write_bytes(gzip.compress(raw) if packed else raw)
    got = tprof.parse_device_us(str(path), TAG)
    assert got == WANT


def test_parse_device_us_none_cases(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace()))
    assert tprof.parse_device_us(str(path), "repro_offload:nothing") is None
    # an annotation that launched nothing on the device
    quiet = {"traceEvents": [_x(TAG, "user_annotation", 0.0, 10.0),
                             _x("k", "kernel", 1.0, 1.0, 1)]}
    path.write_text(json.dumps(quiet))
    assert tprof.parse_device_us(str(path), TAG) is None
    path.write_text("{not json")
    assert tprof.parse_device_us(str(path), TAG) is None
    assert tprof.parse_device_us(str(tmp_path / "missing.json"), TAG) is None


def test_window_picks_the_host_annotation():
    events = _trace()["traceEvents"]
    anchor = tprof.find_annotation(events, TAG)
    assert anchor["cat"] == "user_annotation"
    names = sorted(e["name"] for e in tprof.window_device_events(events, TAG))
    assert names == ["Memcpy HtoD", "Memset", "inner", "k1_register_kernel",
                     "k2_cluster_kernel"]
    # without a user_annotation copy, the first host event of the name
    only_gpu = [e for e in events if e.get("cat") != "user_annotation"]
    assert tprof.find_annotation(only_gpu, TAG) is None


def _dispatch(eng, p=8, n=16):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32))
    desc = eng.make_descriptor("SCAN", axes=(1, p), payload_bytes=4 * n,
                               algorithm="hillis_steele", backend="pallas",
                               chunks=1)
    return desc, x


def test_profile_offload_on_the_cpu_is_wall_with_its_reason(tmp_path):
    eng = TEngine(device="cpu")
    desc, x = _dispatch(eng)
    timing = eng.profile_offload(desc, x, trace_dir=str(tmp_path))
    assert timing.source == "wall" and timing.events == 0
    assert timing.fallback_reason == "parse_failed"
    assert timing.device_us == timing.wall_us > 0
    assert timing.trace_path is not None  # the CPU trace was kept
    snap = eng.telemetry.snapshot()
    assert snap["profiler_fallbacks"] == 1
    assert snap["profiler_fallback_reasons"] == {"parse_failed": 1}
    assert snap["latency_source_by_coll"]["scan"] == "wall"
    assert snap["dispatches"] == 2  # the warmup and the profiled dispatch
    assert "repro_engine_profiler_fallbacks_total" in (
        tmetrics.render_prometheus())


def test_a_running_profiler_session_is_trace_start_failed():
    from torch.profiler import ProfilerActivity, profile

    eng = TEngine(device="cpu")
    desc, x = _dispatch(eng)
    with profile(activities=[ProfilerActivity.CPU]):
        timing = eng.profile_offload(desc, x, warmup=0)
        assert torch.autograd._profiler_enabled()  # not ended by the attempt
    assert timing.source == "wall"
    assert timing.fallback_reason == "trace_start_failed"
    assert eng.telemetry.profiler_fallback_reasons == {"trace_start_failed": 1}


def _sequence(tel):
    tel.record_dispatch("scan", 2e-5)
    tel.record_dispatch("scan", None)
    tel.record_dispatch("reduce", 4e-5)
    tel.record_profiler_fallback("scan", "parse_failed")
    tel.record_device_latency("scan", 3e-5, source="wall")
    tel.record_device_latency("scan", 5e-5, source="wall")
    tel.record_device_latency("scan", 1e-6, source="profiler")  # evicts wall
    tel.record_device_latency("scan", 9e-5, source="wall")  # dropped
    tel.record_device_latency("scan", 3e-6, source="profiler")
    tel.record_device_latency("reduce", 7e-6, source="wall")
    tel.record_profiler_fallback("reduce", "trace_start_failed")
    tel.record_backend_fallback("scan", "multi_axis_mesh")
    tel.record_dispatch("allreduce", 1e-5)
    return tel.snapshot()


def test_same_calls_same_snapshot():
    got = _sequence(tengine.EngineTelemetry())
    want = _sequence(jengine.EngineTelemetry())
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert math.isclose(got[key], value, rel_tol=REL), key
        elif key in ("latency_by_coll_us", "device_latency_by_coll_us"):
            assert set(got[key]) == set(value)
            for coll in value:
                assert math.isclose(got[key][coll], value[coll],
                                    rel_tol=REL), (key, coll)
        else:
            assert got[key] == value, key
    assert got["latency_source_by_coll"] == {"scan": "profiler",
                                             "reduce": "wall",
                                             "allreduce": "wall"}
    assert math.isclose(got["device_latency_by_coll_us"]["scan"], 2.0,
                        rel_tol=REL)


def test_device_event_rule_is_a_stated_set():
    assert tprof.DEVICE_EVENT_CATS == {"kernel", "gpu_memcpy", "gpu_memset"}
    assert tprof.ANNOTATION_PREFIX == "repro_offload"
