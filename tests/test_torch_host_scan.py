"""Parity of ``repro_torch.core.host_scan`` (the host-orchestrated "software
MPI" baseline and its single-launch counterpart) with
``repro.core.host_scan``.

``host_scan`` runs the same schedule arithmetic as ``sim_scan`` with a
dispatch and a host sync per hop, so it is held bitwise equal to the
reference's ``host_scan`` for sum and max on int32 and float32, for every
algorithm and p in {1, 2, 5, 8}. Hop lists are compared as lists. On the
CPU the timers return wall-clock seconds of eager runs; the CUDA graph form
of ``time_offloaded_scan`` runs only on a GPU (``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import algorithms as j_alg
from repro_torch.core import algorithms as t_alg
from repro_torch.core import scan_collective as t_scan
from test_torch_interop import assert_same, rng_values, to_both

# the packages export the function under the module's name
j_host = importlib.import_module("repro.core.host_scan")
t_host = importlib.import_module("repro_torch.core.host_scan")

ALGOS = sorted(t_alg.ALGORITHMS)
PS = [1, 2, 5, 8]


def test_the_port_has_every_reference_algorithm():
    assert ALGOS == sorted(j_alg.ALGORITHMS)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_schedule_trace_matches_reference(algorithm):
    for p in PS + [3, 16]:
        want = [[tuple(e) for e in step] for step in j_host.schedule_trace(algorithm, p)]
        got = [[tuple(e) for e in step] for step in t_host.schedule_trace(algorithm, p)]
        assert got == want, (algorithm, p)


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("p", PS)
def test_host_scan_bitwise_equal_to_reference(algorithm, p):
    rng = np.random.default_rng(ALGOS.index(algorithm) * 10 + p)
    for opname in ("sum", "max"):
        for dtype in (np.int32, np.float32):
            x = rng_values(rng, (p, 6), dtype)
            jx, tx = to_both(x)
            if algorithm == "invertible_doubling" and opname == "max":
                # max has no inverse: both refuse the schedule
                with pytest.raises(ValueError):
                    j_host.host_scan(jx, opname, p, algorithm=algorithm)
                with pytest.raises(ValueError):
                    t_host.host_scan(tx, opname, p, algorithm=algorithm)
                continue
            want = j_host.host_scan(jx, opname, p, algorithm=algorithm)
            got = t_host.host_scan(tx, opname, p, algorithm=algorithm)
            what = f"{algorithm} p={p} {opname} {dtype.__name__}"
            assert_same(want, got, what=what)
            same = t_scan.sim_scan(tx, opname, p, algorithm=algorithm)
            assert torch.equal(got, same), what


def test_host_scan_takes_pair_payloads():
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.5, size=(5, 3)).astype(np.float32)
    b = rng.standard_normal((5, 3)).astype(np.float32)
    (ja, jb), (ta, tb) = to_both((a, b))
    want = j_host.host_scan((ja, jb), "ssd", 5, algorithm="binomial_tree")
    got = t_host.host_scan((ta, tb), "ssd", 5, algorithm="binomial_tree")
    assert_same(want, got, rtol=1e-6, atol=1e-6, what="ssd pair")


@pytest.mark.parametrize("algorithm", ["sequential", "binomial_tree", "sklansky"])
def test_offloaded_scan_equals_sim_scan_on_cpu(algorithm):
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(2))
    replay, out = t_host.offloaded_scan(x, "sum", 8, algorithm=algorithm)
    want = t_scan.sim_scan(x, "sum", 8, algorithm=algorithm)
    assert torch.equal(out, want)
    assert torch.equal(replay(), want)


def test_timers_return_positive_seconds_on_cpu():
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(3))
    for fn in (t_host.time_host_scan, t_host.time_offloaded_scan):
        t = fn(x, "sum", 8, algorithm="recursive_doubling", iters=3)
        assert isinstance(t, float) and t > 0.0


def test_sim_backend_keeps_index_tensors_and_values():
    """The index cache: one pair of tensors per permutation, made on the
    first call, and every result bitwise equal to a fresh backend's."""
    backend = t_alg.SimBackend(5, "cpu")
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(4))
    perm = [(1, 3), (1, 4), (0, 2)]
    first = backend.permute(x, perm)
    cached = backend._index_tensors([tuple(e) for e in perm])
    again = backend.permute(x, perm)
    assert backend._index_tensors(perm) is cached
    assert len(backend._indices) == 1
    assert torch.equal(first, again)
    assert torch.equal(first, t_alg.SimBackend(5, "cpu").permute(x, perm))
    backend.permute(x, [(0, 1), (1, 2), (2, 3), (3, 4)])  # a shift: no indices
    assert len(backend._indices) == 1


def test_core_exports_the_reference_names():
    import repro.core as jc
    import repro_torch.core as tc

    for name in ("host_scan", "schedule_trace", "time_host_scan",
                 "time_offloaded_scan"):
        assert name in jc.__all__ and name in tc.__all__
        assert getattr(tc, name) is getattr(t_host, name)
