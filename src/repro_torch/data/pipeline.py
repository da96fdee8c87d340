"""Synthetic sharded data pipeline with scan-based packing (port of
``repro.data.pipeline``, a copy: the reference's module is numpy alone, and
the port imports nothing of the JAX package).

Deterministic seeded token streams, sharded per host (host_id/host_count
emulate a multi-host layout). Variable-length documents are packed into
fixed-length training sequences using EXCLUSIVE PREFIX-SCAN offsets — the
paper's primitive running in the data layer, on the host in numpy. Batches
are numpy arrays, bit for bit the reference's for the same
:class:`DataConfig`; the training step moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    host_count: int = 1
    mean_doc_len: int = 512
    pad_id: int = 0
    eos_id: int = 1


def document_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Infinite stream of variable-length synthetic documents for this host.

    Documents are incrementing mod-vocab runs from a random start (a bigram-
    learnable structure, so training losses demonstrably decrease) with 10%
    uniform noise tokens (so the loss floor is not zero).
    """
    rng = np.random.default_rng(cfg.seed * 1000003 + cfg.host_id)
    lo, hi = 2, cfg.vocab_size
    span = hi - lo
    while True:
        n = int(np.clip(rng.geometric(1.0 / cfg.mean_doc_len), 8, 8 * cfg.mean_doc_len))
        start = rng.integers(0, span)
        doc = (lo + (start + np.arange(n)) % span).astype(np.int32)
        noise = rng.random(n) < 0.1
        doc[noise] = rng.integers(lo, hi, size=int(noise.sum()), dtype=np.int32)
        doc[-1] = cfg.eos_id
        yield doc


def pack_documents(docs: List[np.ndarray], seq_len: int, pad_id: int = 0):
    """Pack docs into one (n_seqs, seq_len) matrix via exclusive-scan offsets.

    Offsets of each document in the flat packed stream are the exclusive
    prefix sum of document lengths — MPI_Exscan semantics on the host.
    Returns (packed, segment_ids) where segment_ids mark document boundaries.
    """
    lens = np.array([len(d) for d in docs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])  # exclusive scan
    total = int(lens.sum())
    n_seqs = -(-total // seq_len)
    flat = np.full(n_seqs * seq_len, pad_id, dtype=np.int32)
    seg = np.zeros(n_seqs * seq_len, dtype=np.int32)
    for i, (d, off) in enumerate(zip(docs, offsets)):
        flat[off : off + len(d)] = d
        seg[off : off + len(d)] = i + 1
    return flat.reshape(n_seqs, seq_len), seg.reshape(n_seqs, seq_len)


def batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite {tokens, labels} batches (this host's slice of global batch)."""
    local_batch = cfg.global_batch // cfg.host_count
    assert local_batch * cfg.host_count == cfg.global_batch, (
        cfg.global_batch, cfg.host_count)
    stream = document_stream(cfg)
    buf: List[np.ndarray] = []
    ready: List[np.ndarray] = []
    while True:
        while len(ready) < local_batch:
            # accumulate enough docs to pack at least one full row
            need = cfg.seq_len + 1
            acc = 0
            buf = []
            while acc < need * 2:
                d = next(stream)
                buf.append(d)
                acc += len(d)
            packed, _ = pack_documents(buf, cfg.seq_len + 1, cfg.pad_id)
            ready.extend(list(packed))
        rows = np.stack(ready[:local_batch])
        ready = ready[local_batch:]
        yield {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }
