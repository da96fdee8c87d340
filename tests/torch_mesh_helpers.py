"""Shared pieces of the mesh parity tests (``test_torch_mesh_*.py``): the
reference's mesh paths run in a subprocess on 8 forced host devices (the
device count is fixed when jax starts, so not in the test process), and
the module-level torch thread setting."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: every spawn (gloo ranks, the reference's subprocess) is killed after this
SPAWN_TIMEOUT_S = 120

_PRELUDE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.sharding.specs import make_topology, use_topology
with open(sys.argv[1], "rb") as fh:
    IN = pickle.load(fh)
OUT = {}


def mesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
"""

_EPILOGUE = r"""
with open(sys.argv[2], "wb") as fh:
    pickle.dump(jax.tree.map(np.asarray, OUT), fh)
print("ALL-OK")
"""


def run_reference(body: str, inputs, workdir: Path):
    """Run ``body`` (reference code filling ``OUT`` from ``IN``, with
    ``mesh(shape)`` giving a mesh of forced host devices) in a subprocess;
    returns its ``OUT`` as numpy arrays."""
    workdir.mkdir(parents=True, exist_ok=True)
    src, dst = workdir / "in.pkl", workdir / "out.pkl"
    with open(src, "wb") as fh:
        pickle.dump(inputs, fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + body + _EPILOGUE, str(src), str(dst)],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    with open(dst, "rb") as fh:
        return pickle.load(fh)


def run_module(module: str, *args: str) -> str:
    """``python -m module *args`` with the port on the path; its stdout,
    after asserting it exited 0 and printed ALL-OK."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], env=env, capture_output=True,
        text=True, timeout=2 * SPAWN_TIMEOUT_S, cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return proc.stdout
