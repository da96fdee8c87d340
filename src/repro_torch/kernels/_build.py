"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build runs on first use, from the sources in this package only, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``);
the library name carries a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads the library already there.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # no contraction of a*b + c into an FMA: the SSD/flash/prod combines
    # must round like the plain version (the sources also use __fmul_rn /
    # __fadd_rn, this guards any expression they miss)
    "-fmad=false",
    # a __device__ function called from host code compiles to a stub that
    # exits the process; refuse it at build time
    "-Werror", "cross-execution-space-call",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _stream_of(device_index: int) -> int:
    """The current CUDA stream of a device, as a raw pointer."""
    return torch.cuda.current_stream(device_index).cuda_stream


# PyTorch's own accessors where the build has them (a CUDA build does): the
# raw current stream of a device and the current device, without building
# Python objects. A launch reads the stream at call time, never caches it:
# under a CUDA graph's capture it is the capturing stream
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _stream_of)
current_device = getattr(torch._C, "_cuda_getDevice",
                         torch.cuda.current_device)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path("/usr/local/cuda/bin/nvcc")
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
            "cannot be built on this machine"
        )
    return nvcc


def _target(name: str) -> Path:
    # the digest covers the shared headers too: an edited header rebuilds
    # every source
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _spawn(name: str) -> "Tuple[Path, Path, subprocess.Popen | None]":
    """Start nvcc for one source unless its library is already built;
    returns (library, temporary output, process or None)."""
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(
    name: str, out: Path, tmp: Path, proc: "subprocess.Popen | None"
) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source at once (one nvcc each, all started
    together); returns the library paths."""
    started = [(n, *_spawn(n)) for n in names]
    for n, out, tmp, proc in started:
        _finish(n, out, tmp, proc)
    return {n: out for n, out, _, _ in started}


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build that produced the current library, or "" if it was loaded from
    an earlier build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
