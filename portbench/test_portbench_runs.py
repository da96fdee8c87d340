"""Whole runs of the one-card cells on the CPU at tiny sizes: the harness's
look for a card skipped, everything else as on the chip. A sound run comes
out correct; a run with a fault planted in the timed path, or with the
control (the reference in the next precision down) in the program's place,
does not."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import bench, control, faults
from portbench.bench import ROOT
from portbench.run import execute, parse

SEED = 4_294_967_311  # more than 32 bits: a run takes any whole number
#: the faults each cell's timed path can have
FAULTS = {
    "osu8-scan-64MiB": ("unchanged", "half", "altered"),
    "mamba2-130m-train-2k": ("unchanged", "half"),
    "mamba2-130m-prefill-4k": ("unchanged", "half", "altered"),
}


def run(cell, trace=0, fault=None):
    line, _ = execute(cell, SEED, 0.3, trace, device="cpu", fault=fault)
    return line


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(tiny_cell, name, trace):
    cell = tiny_cell(name)
    line = run(cell, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # a CPU run has no device: only the host-clock metrics are there
    assert set(line["metrics"]) <= want
    if not trace:
        assert {"setup_s"} < set(line["metrics"])
    json.dumps(line)


@pytest.mark.parametrize("name, fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n]])
def test_fault_comes_out_incorrect(tiny_cell, name, fault):
    line = run(tiny_cell(name), fault=fault)
    assert not line["correct"], line["checks"]
    # the fault is taken out with the program: the next run is sound
    assert run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_control_comes_out_incorrect(tiny_cell, name):
    cell = tiny_cell(name)
    got = control.readings(cell, SEED, 0.3, control=True, device="cpu")
    assert any(got[k] > cell.limits[k] for k in got), got


@pytest.mark.parametrize("name, fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n]])
def test_fault_from_the_window_on_comes_out_incorrect(tiny_cell, name, fault):
    """What is compared is what the window produced: a fault that starts
    only once set-up has warmed the program up is caught too."""
    cell = tiny_cell(name)
    wl = bench.workload_module(cell.mix["kind"]).make(cell, SEED, "cpu")
    wl.setup()
    undo = faults.apply(fault)
    try:
        bench.timed_window(wl, 0.3)
        wl.release()
        checks = bench.worst(wl.check())
    finally:
        undo()
    assert not all(c.ok for c in checks), checks


def test_training_window_holds_its_compared_steps(tiny_cell):
    from portbench.workloads.train import FIRST_STEPS

    cell = tiny_cell("mamba2-130m-train-2k")
    wl = bench.workload_module("train").make(cell, SEED, "cpu")
    wl.setup()
    # a window shorter than a step still runs the steps that are compared
    measured = bench.timed_window(wl, 0.0)
    assert measured.calls == FIRST_STEPS
    wl.release()
    assert len(wl.first["loss"]) == FIRST_STEPS
    assert set(wl.first["grad"]) == set(wl.first["moved"]) == set(wl.w0)
    assert all(c.ok for c in wl.check())


def test_run_takes_no_fault_from_its_command_line():
    args = ["--workload", "osu8-scan-64MiB", "--seed", "1", "--seconds", "1"]
    assert parse(args).trace == 0
    with pytest.raises(SystemExit):
        parse(args + ["--fault", "half"])


def test_run_refuses_a_machine_without_enough_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "osu8-scan-64MiB",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a cell's real run needs the card")
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "osu8-scan-64MiB",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
