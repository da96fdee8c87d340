"""The port's dry run (``repro_torch.launch.dryrun``, counterpart of
``repro.launch.dryrun``) and the paper's setup (``repro_torch.configs.
paper8``).

Mamba2-130m at full width on the ``meta`` device, one counted training
step at ``train_4k`` on a co-resident mesh of the production shape:
the record carries every key of the reference's (its
``src/repro/launch/dryrun.py:75-105``), sane roofline terms and a useful
share of the counted FLOPs in (0, 1.05]; the two-pod mesh has 512 chips and
no more argument bytes a device. The reference's dry run is not run here:
it compiles for 512 placeholder devices.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro.configs import paper8 as r_paper8
from repro_torch.configs import paper8 as p_paper8
from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parents[1]

#: the reference's record keys (``src/repro/launch/dryrun.py:75-105``)
RECORD_KEYS = {
    "arch", "shape", "mesh", "n_chips", "kind", "lower_s", "compile_s",
    "memory", "roofline", "collectives", "raw_cost_analysis",
    "model_flops_total", "useful_flops_ratio", "params_total",
    "params_active", "opt",
}
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes",
               "temp_size_bytes", "generated_code_size_bytes"}
ROOFLINE_KEYS = {"flops_per_device", "bytes_per_device",
                 "collective_bytes_per_device", "t_compute_s",
                 "t_memory_s", "t_collective_s", "bottleneck", "n_chips"}


def _listing(root: Path):
    """Every file under ``root`` with its mtime (bytecode caches aside)."""
    return sorted((str(p.relative_to(root)), p.stat().st_mtime_ns)
                  for p in root.rglob("*") if "__pycache__" not in p.parts)


@pytest.fixture(scope="module")
def single():
    """One run with the CLI's default output directory."""
    before = _listing(REPO / "benchmarks")
    rec = dryrun.run_cell("mamba2-130m", "train_4k", "single")
    return rec, before


def test_the_record_has_the_reference_keys(single):
    rec, _ = single
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["collectives"]) == {"counts", "wire_bytes"}
    assert rec["compile_s"] is None and rec["lower_s"] > 0


def test_single_pod_roofline_is_sane(single):
    rec, _ = single
    r = rec["roofline"]
    assert rec["n_chips"] == r["n_chips"] == 256 and rec["kind"] == "train"
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_flops_ratio"] <= 1.05
    # the sequence-parallel mixer's scan and cache collectives, per rank
    counts = rec["collectives"]["counts"]
    assert counts["collective-permute"] > 0 and counts["all-reduce"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_size_bytes"] and 0 < mem["output_size_bytes"]
    assert mem["temp_size_bytes"] > 0
    assert rec["raw_cost_analysis"]["flops"] > 0


def test_records_go_to_build_and_nothing_under_benchmarks(single):
    rec, before = single
    path = dryrun.ART_DIR / "mamba2-130m__train_4k__single.json"
    assert dryrun.ART_DIR == REPO / "build" / "dryrun_torch"
    assert json.loads(path.read_text())["arch"] == rec["arch"]
    assert _listing(REPO / "benchmarks") == before


def test_two_pods_hold_512_chips_and_no_more_bytes_a_device(single,
                                                           tmp_path):
    rec, _ = single
    multi = dryrun.run_cell("mamba2-130m", "train_4k", "multi", tmp_path)
    assert multi["n_chips"] == multi["roofline"]["n_chips"] == 512
    assert (multi["memory"]["argument_size_bytes"]
            <= rec["memory"]["argument_size_bytes"])
    assert (tmp_path / "mamba2-130m__train_4k__multi.json").exists()


def test_cli_exits_1_on_an_unknown_arch(tmp_path, capsys):
    rc = dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                      "--out", str(tmp_path)])
    assert rc == 1
    assert "[FAIL] no-such-arch x train_4k x single" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


def test_paper8_equals_the_reference():
    assert (dataclasses.asdict(p_paper8.CONFIG)
            == dataclasses.asdict(r_paper8.CONFIG))
    assert ([f.name for f in dataclasses.fields(p_paper8.PaperSetup)]
            == [f.name for f in dataclasses.fields(r_paper8.PaperSetup)])
