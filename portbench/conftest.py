"""Fixtures of the benchmark's CPU tests: a cell of ``BENCHMARK.json`` cut
to a size the CPU runs in a second, its widths, sequence and payload small,
everything else (the mix's kind, the configuration's form, the limits) as
the chip runs it."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import bench

#: a Mamba2 small enough for the CPU, every mechanism of the full one kept
TINY_MODEL = {"d_model": 64, "n_layer": 2, "d_state": 16, "headdim": 16,
              "chunk_size": 16, "vocab_size": 500}
TINY_BYTES = 4096


def shrink(cell: bench.Cell) -> bench.Cell:
    if cell.mix["kind"] == "scan":
        return dataclasses.replace(cell, mix={**cell.mix, "bytes_per_rank": TINY_BYTES})
    return dataclasses.replace(cell, config={**cell.config, **TINY_MODEL},
                               mix={**cell.mix, "seq_len": 64, "batch": 2})


@pytest.fixture
def tiny_cell():
    bench.use_port()

    def make(name: str) -> bench.Cell:
        return shrink(bench.load_cell(name))

    return make


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
