"""K3, the on-chip block scan: inclusive or exclusive add / max / mul prefix
scan along the last axis of a 2-D ``(R, L)`` tensor (PyTorch/CUDA counterpart
of ``repro.kernels.prefix_scan``).

The paper offloads the inter-node scan to the NIC; this is the intra-node
half. :func:`scan_rows` is the wrapper: a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.ref_prefix_scan`), as a ``meta`` one does
(shapes alone, for a counted dry run), a CUDA tensor launches
``csrc/prefix_scan.cu`` (one block a row, the carry in a register across the
row's column tiles, the exclusive shift done in the kernel) or raises.
``reverse=True`` scans each row back to front, for the add scan only (the
kernel's instantiation for it mirrors its loads and stores; the plain version
flips).

:class:`PrefixScan` is the scan as a ``torch.autograd.Function``: the
gradient of an add scan is the add scan of the incoming gradient run back to
front, inclusive or exclusive as the forward was, so K3 computes its own
backward on the card (the plain version both ways on the CPU).
:func:`repro_torch.kernels.ops.prefix_scan` takes it under autograd, and
raises ``NotImplementedError`` for a ``max`` or ``mul`` scan of a tensor
that requires grad: those have no backward here.

:data:`launches` counts every kernel launch; :data:`reverse_launches` counts
the back-to-front ones among them, which on the training path are the
Function's backward.

Under a :class:`~repro_torch.roofline.op_cost.CostMode` each call of
:func:`scan_rows`, the one place K3 launches (forward, its recomputation
and the Function's backward alike), counts as one K3 charge at K3's own
cost, whichever implementation runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_prefix_scan, scan_identity
from repro_torch.roofline.op_cost import charged

#: kernel launches since import (the main path's proof that it ran K3)
launches = 0
#: the back-to-front launches among :data:`launches` (K3's backward)
reverse_launches = 0

_OP_CODES = {"add": 0, "max": 1, "mul": 2}
_DTYPE_CODES = {
    torch.int32: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float16: 3,
    torch.int8: 4,
}
#: elements a thread scans per tile (``ITEMS`` in the source)
_ITEMS = 4
_MAX_THREADS = 256


def block_threads(length: int) -> int:
    """Threads a block: enough for one tile to cover a short row, a power of
    two in [32, 256]."""
    need = -(-length // _ITEMS)
    threads = 32
    while threads < need and threads < _MAX_THREADS:
        threads *= 2
    return threads


def _library() -> ctypes.CDLL:
    lib = _build.load_library("prefix_scan")
    fn = lib.k3_prefix_scan
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, op: str, exclusive: bool,
            reverse: bool) -> torch.Tensor:
    global launches, reverse_launches
    if op not in _OP_CODES:
        raise ValueError(f"unknown op {op!r}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the scan kernel takes {sorted(map(str, _DTYPE_CODES))}; got {x.dtype}"
        )
    x = x.contiguous()
    R, L = x.shape
    y = torch.empty_like(x)
    if R == 0 or L == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.k3_prefix_scan(
            _OP_CODES[op], _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
            R, L, int(exclusive), int(reverse),
            float(scan_identity(op, x.dtype)), block_threads(L), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"prefix scan kernel launch failed (code {rc}) for op={op} "
            f"dtype={x.dtype} shape={(R, L)} reverse={reverse}"
        )
    launches += 1
    reverse_launches += int(reverse)
    return y


def scan_rows(
    x: torch.Tensor, *, op: str = "add", exclusive: bool = False,
    reverse: bool = False,
) -> torch.Tensor:
    """Scan every row of a 2-D tensor, back to front with ``reverse`` (an
    add scan only): the plain version for a CPU (or ``meta``) tensor, the
    CUDA kernel for a CUDA tensor (no fallback between the two). The result
    carries no autograd history; a gradient goes through
    :class:`PrefixScan`."""
    if x.ndim != 2:
        raise ValueError(f"expected 2D (rows, length), got {tuple(x.shape)}")
    if reverse and op != "add":
        raise ValueError(f"only the add scan runs back to front; got {op!r}")
    if x.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no scan kernel for device {x.device}")
    with charged("k3", rows=x.shape[0], length=x.shape[1], dtype=x.dtype,
                 reverse=reverse):
        if x.device.type == "cuda":
            return _launch(x, op, exclusive, reverse)
        if reverse:
            return ref_prefix_scan(x.flip(-1), op,
                                   exclusive=exclusive).flip(-1)
        return ref_prefix_scan(x, op, exclusive=exclusive)


class PrefixScan(torch.autograd.Function):
    """An add scan of the rows of a 2-D tensor whose gradient is K3 run back
    to front (:func:`scan_rows` both ways, so the CPU takes the plain
    version both ways)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, exclusive: bool) -> torch.Tensor:
        ctx.exclusive = exclusive
        with torch.no_grad():
            return scan_rows(x.detach(), op="add", exclusive=exclusive)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (scan_rows(grad.contiguous(), op="add",
                          exclusive=ctx.exclusive, reverse=True), None)
