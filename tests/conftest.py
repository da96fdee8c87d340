import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def run_check_module(module: str, *args: str, timeout: int = 420) -> str:
    """Run a repro.testing.* module in a fresh subprocess (multi-device
    checks need xla_force_host_platform_device_count set before jax import,
    which the already-initialized test process can't do)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=str(REPO),
    )
    if proc.returncode != 0 or "ALL-OK" not in proc.stdout:
        raise AssertionError(
            f"{module} failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout[-4000:]}\n"
            f"--- stderr ---\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


@pytest.fixture(scope="session")
def subprocess_runner():
    return run_check_module


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card; the test skips itself without one",
    )
