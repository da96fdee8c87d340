"""The engine's launch path and the meshes of the port against the
reference.

Pairs: ``repro_torch.launch.offload_runtime`` vs
``repro.launch.offload_runtime`` (``tests/test_planner.py``'s remesh tests
mirrored: a re-mesh re-plans and re-tunes, a detached hook does not fire;
the re-tune grid ``_remesh_ps`` equal to the reference's), the tuning-table
resolution order (explicit path, ``$REPRO_TORCH_TUNING_TABLE``, the port's
default cache path), a foreign fingerprint ignored with a warning, the CLI;
``repro_torch.launch.mesh`` vs ``repro.launch.mesh`` (the smoke mesh, the
production mesh raising on one process). Every engine runs on the CPU.
"""

import importlib
import json

import pytest
import torch

from repro_torch.core.selector import get_active_tuning, set_active_tuning
from repro_torch.launch import offload_runtime as R
from repro_torch.offload import TuningCache
from repro_torch.runtime.fault import notify_remesh, plan_remesh


@pytest.fixture(autouse=True)
def _no_ambient_table(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNING_TABLE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_TRACE", raising=False)
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    before = get_active_tuning()
    set_active_tuning(None)
    yield
    set_active_tuning(before)


def _scan(eng):
    x = torch.ones((4, 2), dtype=torch.float32)
    return eng.offload(eng.make_descriptor("SCAN", p=4, payload_bytes=8), x)


def test_remesh_triggers_replan_and_retune():
    """tests/test_planner.py:508 on the port."""
    eng = R.build_offload_engine(retune_on_remesh=True,
                                 remesh_tune_budget_s=0.05, device="cpu")
    try:
        _scan(eng)
        assert eng.cache_size() == 1
        before = get_active_tuning()
        # planning alone is a pure feasibility query — nothing invalidated
        assert plan_remesh(4, 2, lost_hosts=1) == (2, 2)
        assert eng.cache_size() == 1
        # *adopting* the plan fires the listeners
        notify_remesh((4, 2), (2, 2))
        assert eng.cache_size() == 0
        assert eng.telemetry.snapshot()["cache_size"] == 0
        after = get_active_tuning()
        assert after is not None and after is not before
        assert len(after.measurements) >= 1
        assert after.backend.startswith("torch-cpu")
    finally:
        R.detach_remesh_hook(eng)


def test_detached_hook_no_longer_fires():
    """tests/test_planner.py:545 on the port."""
    eng = R.build_offload_engine(retune_on_remesh=True,
                                 remesh_tune_budget_s=0.05, device="cpu")
    R.detach_remesh_hook(eng)
    _scan(eng)
    notify_remesh((4, 2), (2, 2))
    assert eng.cache_size() == 1  # untouched


@pytest.mark.parametrize("axes", [(2,), (4, 2), (2, 2, 2), (16, 16), (3, 1)])
def test_remesh_grid_matches_the_reference(axes):
    ref = importlib.import_module("repro.launch.offload_runtime")
    assert R._remesh_ps(axes) == ref._remesh_ps(axes)


def _table(path, seconds):
    cache = TuningCache(device="cpu")
    cache.record("scan", "sequential", 4, 64, seconds)
    return cache.save(path)


def _active_seconds():
    active = get_active_tuning()
    return None if active is None else active.measurements[0].seconds


def test_table_resolution_order(tmp_path, monkeypatch):
    explicit = _table(tmp_path / "explicit.json", 1.0)
    ambient = _table(tmp_path / "ambient.json", 2.0)
    _table(R.default_table_path(), 3.0)
    R.build_offload_engine(tuning_table=explicit, retune_on_remesh=False,
                           device="cpu")
    assert _active_seconds() == 1.0
    monkeypatch.setenv("REPRO_TORCH_TUNING_TABLE", str(ambient))
    R.build_offload_engine(tuning_table=explicit, retune_on_remesh=False,
                           device="cpu")
    assert _active_seconds() == 1.0  # the explicit path wins
    R.build_offload_engine(retune_on_remesh=False, device="cpu")
    assert _active_seconds() == 2.0  # then the env var
    monkeypatch.delenv("REPRO_TORCH_TUNING_TABLE")
    R.build_offload_engine(retune_on_remesh=False, device="cpu")
    assert _active_seconds() == 3.0  # then the default path


def test_missing_tables_raise(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        R.build_offload_engine(tuning_table=tmp_path / "none.json",
                               retune_on_remesh=False, device="cpu")
    monkeypatch.setenv("REPRO_TORCH_TUNING_TABLE", str(tmp_path / "gone.json"))
    with pytest.raises(FileNotFoundError, match="REPRO_TORCH_TUNING_TABLE"):
        R.build_offload_engine(retune_on_remesh=False, device="cpu")


@pytest.mark.parametrize("where", ["env", "default"])
def test_foreign_fingerprint_is_ignored_with_a_warning(tmp_path, monkeypatch,
                                                       where):
    path = tmp_path / "foreign.json" if where == "env" else R.default_table_path()
    _table(path, 4.0)
    d = json.loads(path.read_text())
    d["backend"] = "cpu:TFRT_CPU_0"  # a JAX platform's fingerprint
    path.write_text(json.dumps(d))
    if where == "env":
        monkeypatch.setenv("REPRO_TORCH_TUNING_TABLE", str(path))
    with pytest.warns(RuntimeWarning, match="ignoring it"):
        R.build_offload_engine(retune_on_remesh=False, device="cpu")
    assert get_active_tuning() is None


def test_autotune_if_missing_writes_the_ports_default_path(tmp_path):
    assert not R.default_table_path().exists()
    R.build_offload_engine(autotune_if_missing=True, tune_budget_s=0.05,
                           retune_on_remesh=False, device="cpu")
    saved = TuningCache.load(R.default_table_path())
    assert saved.backend.startswith("torch-cpu")
    assert get_active_tuning() is not None


def test_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert R.default_table_path() == (tmp_path / ".cache" / "repro_torch"
                                      / "tuning_table.json")
    assert R.TRACE_ENV == "REPRO_TORCH_TRACE"


def test_trace_env_installs_a_tracer(monkeypatch):
    from repro_torch.obs import tracing

    monkeypatch.setenv("REPRO_TORCH_TRACE", "1")
    before = tracing.get_tracer()
    try:
        eng = R.build_offload_engine(retune_on_remesh=False, device="cpu")
        assert tracing.get_tracer().enabled
        _scan(eng)
        assert any(s.name == "engine.offload"
                   for s in tracing.get_tracer().spans())
    finally:
        tracing.set_tracer(before)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.build_offload_engine(retune_on_remesh=False)


def test_service_over_the_engine(tmp_path):
    broker = R.build_offload_service(registry=tmp_path / "reg",
                                     retune_on_remesh=False, device="cpu")
    try:
        eng = broker.engine
        desc = eng.make_descriptor("SCAN", p=4, payload_bytes=8)
        x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
        out = broker.client("t").submit(desc, x).result(timeout=60.0)
        assert torch.equal(out, torch.cumsum(x, 0))
    finally:
        broker.stop()


def test_cli_trace_dashboard_and_tune(tmp_path, capsys):
    from repro_torch.obs import events as obs_events

    out = tmp_path / "table.json"
    try:
        R.main(["--device", "cpu", "--trace", str(tmp_path / "t.json"),
                "--dashboard", "--tune", "--budget-s", "0.05", "--iters",
                "1", "--out", str(out), "--flight-record",
                str(tmp_path / "fr.json")])
    finally:
        obs_events.set_auto_dump_path(None)  # --flight-record arms it
    text = capsys.readouterr().out
    assert "merged trace written" in text and "tuning table written" in text
    assert (tmp_path / "t.json").exists() and (tmp_path / "fr.json").exists()
    assert TuningCache.load(out).backend.startswith("torch-cpu")
    with pytest.raises(SystemExit):
        R.main(["--device", "cpu"])  # nothing to do


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------


def test_launch_exports_the_references_names():
    import repro.launch as ref
    import repro_torch.launch as port

    for name in ("make_production_mesh", "make_smoke_mesh",
                 "production_topology", "build_offload_engine", "get_engine"):
        assert hasattr(ref, name) and hasattr(port, name), name


@pytest.mark.parametrize("ranks", [1, 4])
def test_smoke_mesh_is_all_data(ranks):
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding import make_topology

    mesh = make_smoke_mesh(ranks, device="cpu")
    assert mesh.shape == (ranks, 1) and mesh.axis_names == ("data", "model")
    assert mesh.coresident and mesh.device == torch.device("cpu")
    topo = make_topology(mesh)
    assert topo.dp_size == ranks and topo.model_size == 1


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_raises_short_of_ranks(multi_pod, need, monkeypatch):
    ref = importlib.import_module("repro.launch.mesh")

    from repro_torch.launch.mesh import (
        make_production_mesh,
        production_shape,
        production_topology,
    )

    # the reference's shape and axes, without asking JAX for 256 devices
    monkeypatch.setattr(ref.jax, "make_mesh", lambda shape, axes: (shape, axes))
    assert production_shape(multi_pod=multi_pod) == \
        ref.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match=f"needs {need} ranks.*{need - 1} short"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="short"):
        production_topology(multi_pod=multi_pod, device="cpu")
