"""What a run may load and where it may run: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package; the port,
whose name only begins with it, is what runs), and no run without the
program beside the benchmark."""

from __future__ import annotations

import shutil
import subprocess
import sys

from portbench import bench
from portbench.bench import ROOT


def test_forbidden_names_are_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping", "os"]) == []
    assert bench.forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib.xla", "repro.core"]


PROBE = """
import sys, dataclasses
sys.path.insert(0, {root!r})
from portbench import bench
bench.use_port()
import portbench.run, portbench.control, portbench.faults, portbench.trace
from portbench.conftest import shrink
from portbench.workloads import scan, train, prefill
for folder in ("metrics",):
    import json
    spec = json.load(open({root!r} + "/BENCHMARK.json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        bench.load_module(folder, m["name"])
line, _ = portbench.run.execute(shrink(bench.load_cell("osu8-scan-64MiB")), 1, 0.1, 1, device="cpu")
assert line["correct"], line
line, _ = portbench.run.execute(shrink(bench.load_cell("mamba2-130m-prefill-4k")), 1, 0.1, 0, device="cpu")
assert line["correct"], line
print("FORBIDDEN", bench.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout[-2000:]


def test_benchmark_alone_does_not_run(tmp_path):
    """A folder with only ``BENCHMARK.json`` and the benchmark's files has
    no program to run: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "osu8-scan-64MiB",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
