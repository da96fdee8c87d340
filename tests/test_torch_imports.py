"""Import hygiene of the PyTorch port: ``repro_torch`` never imports JAX or
the JAX reference package (``repro``), at run time or in its source."""

import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = _modules()
    for mod in ("repro_torch.kernels.fused_collective", "repro_torch.compat",
                "repro_torch.kernels.spmd_collective",
                "repro_torch.testing.spmd_check",
                "repro_torch.obs", "repro_torch.obs.metrics",
                "repro_torch.obs.events", "repro_torch.obs.tracing",
                "repro_torch.obs.export",
                "repro_torch.offload.tuning_cache",
                "repro_torch.offload.tuner",
                "repro_torch.offload.profiling",
                "repro_torch.testing.obs_check",
                "repro_torch.testing.fusion_check",
                "repro_torch.runtime", "repro_torch.runtime.chaos",
                "repro_torch.runtime.fault", "repro_torch.runtime.straggler",
                "repro_torch.offload.reliability", "repro_torch.obs.health",
                "repro_torch.obs.dashboard", "repro_torch.service",
                "repro_torch.service.broker", "repro_torch.service.telemetry",
                "repro_torch.service.registry",
                "repro_torch.testing.chaos_check",
                "repro_torch.testing.service_check",
                "repro_torch.testing.health_check"):
        assert mod in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'repro' or n.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_no_source_file_imports_jax_or_the_reference():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
        r"|from\s+(jax|jaxlib|repro)(\.|\s)(?!_torch))",
        re.MULTILINE,
    )
    offenders = []
    for path in sorted(PKG.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]:
        for match in pattern.finditer(path.read_text()):
            offenders.append(f"{path}: {match.group(0).strip()}")
    assert offenders == []
    # the pattern itself catches what it must
    assert pattern.search("import jax.numpy as jnp")
    assert pattern.search("from repro.core import packet")
    assert pattern.search("import repro")
    assert not pattern.search("from repro_torch.core import packet")
    assert not pattern.search("import repro_torch")


def test_model_and_serving_modules_are_covered():
    """The model substrate and the serving path are among the modules the
    import checks above load and scan."""
    mods = _modules()
    for mod in ("repro_torch.perf_flags", "repro_torch.configs",
                "repro_torch.configs.base", "repro_torch.configs.mamba2_130m",
                "repro_torch.configs.smollm_360m", "repro_torch.sharding",
                "repro_torch.sharding.specs", "repro_torch.models",
                "repro_torch.models.layers", "repro_torch.models.mamba",
                "repro_torch.models.moe", "repro_torch.models.transformer",
                "repro_torch.models.encdec", "repro_torch.models.model",
                "repro_torch.serving", "repro_torch.serving.engine",
                "repro_torch.launch", "repro_torch.launch.serve",
                "repro_torch.interop"):
        assert mod in mods, mod
    from repro_torch.interop import model_params_from_numpy

    assert callable(model_params_from_numpy)
