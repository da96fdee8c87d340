"""Scan-collective schedules over a stacked rank axis (PyTorch port of
``repro.core.algorithms``).

Each algorithm from the paper is a *schedule*: a fixed sequence of
(permutation, combine) steps. On the NetFPGA these were hardware state machines
selected by the offload packet's ``algo_type`` field; here they are pure
functions over an abstract :class:`Backend`, so the identical schedule runs

  * per rank inside the port's ``shard_map`` (:class:`SpmdBackend`, over the
    named axes of :mod:`repro_torch.compat`: co-resident ranks on one device,
    or one rank per ``torch.distributed`` process), or
  * on the single-device simulator (:class:`SimBackend`), where every pytree
    leaf carries a leading rank axis of size ``p`` and a permute is a row
    shuffle with zero fill on rows that receive nothing.

All schedules carry ``(value, valid)`` pairs: a missing in-edge delivers
zeros, so an arriving ``valid == 0`` marks "no message", which makes every
schedule correct for arbitrary operators and non-power-of-two rank counts. For
operators whose identity is the zero tree (``op.zero_identity``, e.g. sum) the
masking is skipped entirely.

Fidelity notes (paper section III):
  * ``sequential``     — Open MPI's default; p-1 single-hop steps.
  * ``recursive_doubling`` — MPICH's pairwise-exchange butterfly with the
    partner<j conditional accumulate (paper II-B2).
  * ``hillis_steele``  — the send-only distance-doubling variant.
  * ``binomial_tree``  — the two-phase up/down sweep (paper II-B3, III-D).
  * ``sklansky``       — log2(p) steps where one boundary rank *multicasts* to
    an entire half-block (the paper's Ethernet multicast, Fig. 3).
  * ``invertible_doubling`` — hillis-steele whose *exclusive* form recovers
    the answer locally via the operator inverse (the subtraction trick).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.operators import AssocOp
from repro_torch.core.trees import resolve_device, tree_leaves, tree_map

PyTree = Any
Perm = List[Tuple[int, int]]

#: schedules whose chunked (pipelined) form is implemented round-by-round;
#: other algorithms chunk at whole-schedule granularity (chunk-major).
DOUBLING_ALGORITHMS = frozenset({"hillis_steele", "invertible_doubling"})


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class Backend:
    """Minimal comm interface a schedule needs: rank id + permute."""

    p: int

    def rank(self):  # pragma: no cover - interface
        raise NotImplementedError

    def permute(self, tree: PyTree, perm: Perm) -> PyTree:  # pragma: no cover
        raise NotImplementedError


def split_multicast(perm: Perm) -> List[Perm]:
    """Split a one-to-many permutation into unique-source sub-permutations.

    A per-rank permute (``lax.ppermute`` in the reference, one send per rank
    here) takes unique sources AND destinations, so the paper's NIC-style
    multicast (one payload, many receivers) is decomposed: the i-th
    destination of each source lands in sub-permutation i. Each destination
    appears once overall, so with zero fill the receiver-side merge is a
    plain sum.
    """
    buckets: List[Perm] = []
    seen: dict = {}
    for src, dst in perm:
        i = seen.get(src, 0)
        seen[src] = i + 1
        while len(buckets) <= i:
            buckets.append([])
        buckets[i].append((src, dst))
    return buckets


class SpmdBackend(Backend):
    """Runs per rank inside :func:`repro_torch.compat.shard_map`; a permute
    is one exchange over the named axis's rank group (a row gather for
    co-resident ranks, ``batch_isend_irecv`` between processes)."""

    def __init__(self, axis_name: str, axis_size: "int | None" = None):
        from repro_torch import compat

        self.axis_name = axis_name
        if axis_size is None:
            axis_size = compat.axis_size(axis_name)
        self.p = int(axis_size)

    def rank(self):
        from repro_torch import compat

        return compat.axis_index(self.axis_name)

    def permute(self, tree: PyTree, perm: Perm) -> PyTree:
        from repro_torch import compat

        if not perm:
            return tree_map(torch.zeros_like, tree)
        ranks = compat.mesh_of(self.axis_name).ranks
        parts = [
            ranks.ppermute(tree, self.axis_name, sp)
            for sp in split_multicast(list(perm))
        ]
        out = parts[0]
        for part in parts[1:]:
            out = tree_map(torch.add, out, part)
        return out


def as_contiguous_shift(perm: Perm, p: int) -> Optional[int]:
    """Recognize ``perm`` as a dense shift of the rank range.

    Returns ``d`` when ``perm`` is exactly ``[(i, i + d) for i in
    range(p - d)]`` (``d > 0``, shift toward higher ranks) or ``[(i, i + d)
    for i in range(-d, p)]`` (``d < 0``, shift toward lower ranks) in any
    pair order, else ``None``. Every doubling-schedule round and every
    structural EXSCAN shift is of this form.
    """
    if not perm:
        return None
    deltas = {dst - src for src, dst in perm}
    if len(deltas) != 1:
        return None
    d = deltas.pop()
    if d == 0:
        return None
    srcs = sorted(src for src, _ in perm)
    want = list(range(p - d)) if d > 0 else list(range(-d, p))
    if srcs != want or len(perm) != len(srcs):
        return None
    return d


class SimBackend(Backend):
    """Single-device simulator: every pytree leaf carries a leading rank axis.

    Missing in-edges deliver zeros. A contiguous shift (every doubling round,
    every structural EXSCAN shift) is one slice copy; any other permutation
    is one gather/scatter over index tensors. Both give identical values.

    The index tensors are made once per permutation and kept on the backend:
    a later call with the same permutation copies nothing from the host, so
    a schedule run once can then be captured into a CUDA graph. A round's
    destinations are unique, so a permutation is the *set* of its pairs:
    repeated or reordered pairs (a chaos wrapper's duplicates and reversed
    rounds) give the same rows and share one entry. At most
    ``MAX_CACHED_PERMS`` entries are kept; a permutation past them (a chaos
    run's silent drops leave arbitrary subsets) gets its index tensors made
    for the call and dropped.
    """

    MAX_CACHED_PERMS = 256

    def __init__(self, p: int, device: "torch.device | str"):
        self.p = int(p)
        self.device = resolve_device(device)
        self._indices = {}

    def rank(self):
        return torch.arange(self.p, dtype=torch.int32, device=self.device)

    def _index_tensors(self, perm: Perm) -> Tuple[torch.Tensor, torch.Tensor]:
        key = tuple(sorted({(int(s), int(t)) for s, t in perm}))
        got = self._indices.get(key)
        if got is None:
            got = (
                torch.tensor([s for s, _ in key], device=self.device),
                torch.tensor([t for _, t in key], device=self.device),
            )
            if len(self._indices) < self.MAX_CACHED_PERMS:
                self._indices[key] = got
        return got

    def permute(self, tree: PyTree, perm: Perm) -> PyTree:
        perm = list(dict.fromkeys((int(s), int(t)) for s, t in perm))
        p = self.p
        d = as_contiguous_shift(perm, p)
        if d is None and perm:
            src, dst = self._index_tensors(perm)

        def shuffle(a):
            out = torch.zeros_like(a)
            if d is not None:
                if d > 0:
                    out[d:] = a[: p - d]
                else:
                    out[: p + d] = a[-d:]
            elif perm:
                out[dst] = a[src]
            return out

        return tree_map(shuffle, tree)


# ---------------------------------------------------------------------------
# Masked combine plumbing
# ---------------------------------------------------------------------------


def _bwhere(cond, a, b):
    """tree-where with a rank-shaped (scalar or (p,)) condition broadcast."""

    def leaf(x, y):
        c = cond
        extra = x.ndim - c.ndim
        if extra > 0:
            c = c.reshape(c.shape + (1,) * extra)
        return torch.where(c, x, y)

    return tree_map(leaf, a, b)


def _combine_lr(op: AssocOp, lv, lval, rv, rval):
    """Masked combine with *l* the earlier-prefix operand.

    valid flags are float32 (0/1) so they travel through permutes and
    arriving zero-fill naturally reads as "no message".
    """
    both = (lval > 0.5) & (rval > 0.5)
    merged = op.combine(lv, rv)
    keep_l = _bwhere(lval > 0.5, lv, rv)
    return _bwhere(both, merged, keep_l), torch.maximum(lval, rval)


def _ones_flag(backend: Backend):
    r = backend.rank()
    return torch.ones(r.shape, dtype=torch.float32, device=r.device)


def num_steps(p: int) -> int:
    return max(0, math.ceil(math.log2(p))) if p > 1 else 0


def doubling_strides(p: int) -> Tuple[int, ...]:
    """Exchange distances (1, 2, 4, ...) of one distance-doubling schedule."""
    return tuple(1 << k for k in range(num_steps(p)))


def phase_round_count(kind: str, p: int, *, inclusive: bool = True) -> int:
    """Communication rounds a single-kernel (fused) lowering of one plan
    phase performs.

    ``kind`` is a :class:`repro_torch.offload.planner.PhaseKind` name. SCAN
    counts the structural entry shift of the exclusive form;
    FUSED_SCAN_TOTAL counts its entry (exclusive) or exit (inclusive)
    single-hop shift, i.e. :func:`scan_total_step_count`; TOTAL/BARRIER are
    the pow2 butterfly.
    """
    if p <= 1:
        return 0
    if kind == "SCAN":
        return num_steps(p) + (0 if inclusive else 1)
    if kind == "FUSED_SCAN_TOTAL":
        return num_steps(p) + 1
    if kind in ("TOTAL", "BARRIER"):
        return num_steps(p)
    return 0


# ---------------------------------------------------------------------------
# Schedules. Each returns the INCLUSIVE scan; exclusive handling lives in
# scan_collective (structural shift or inverse-op recovery).
# ---------------------------------------------------------------------------


def sequential(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """Open MPI's linear algorithm: p-1 steps, one single-hop message each."""
    p = backend.p
    if p == 1:
        return x
    rank = backend.rank()
    acc = x
    for s in range(1, p):
        recv = backend.permute(acc, [(s - 1, s)])
        is_dst = rank == s
        merged = op.combine(recv, acc)
        acc = _bwhere(is_dst, merged, acc)
    return acc


def sequential_pipelined(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """Ring variant: every rank forwards every step (p-1 steps, stride-1).

    Raw contributions are *relayed* around the ring: at step s rank j receives
    x_{j-s}, which precedes its current window [j-s+1, j], so each step folds
    in exactly one new term.
    """
    p = backend.p
    if p == 1:
        return x
    perm = [(i, i + 1) for i in range(p - 1)]
    if op.zero_identity:
        acc = x
        relay = x
        for _ in range(p - 1):
            relay = backend.permute(relay, perm)
            acc = op.combine(relay, acc)
        return acc
    acc_v, acc_f = x, _ones_flag(backend)
    rel_v, rel_f = x, acc_f
    for _ in range(p - 1):
        rel_v, rel_f = backend.permute((rel_v, rel_f), perm)
        acc_v, acc_f = _combine_lr(op, rel_v, rel_f, acc_v, acc_f)
    return acc_v


def hillis_steele(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """Distance-doubling send-only scan: ceil(log2 p) steps of stride 2^k."""
    p = backend.p
    if p == 1:
        return x
    if op.zero_identity:
        acc = x
        for k in range(num_steps(p)):
            d = 1 << k
            perm = [(i, i + d) for i in range(p - d)]
            recv = backend.permute(acc, perm)
            acc = op.combine(recv, acc)
        return acc
    acc_v, acc_f = x, _ones_flag(backend)
    for k in range(num_steps(p)):
        d = 1 << k
        perm = [(i, i + d) for i in range(p - d)]
        rv, rf = backend.permute((acc_v, acc_f), perm)
        acc_v, acc_f = _combine_lr(op, rv, rf, acc_v, acc_f)
    return acc_v


def recursive_doubling(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """MPICH's pairwise-exchange butterfly (paper II-B2).

    Maintains ``result`` (the answer) and ``partial`` (the running block
    total). Step k exchanges ``partial`` with partner j^2^k; ranks whose
    partner is lower fold the received block into both.
    """
    p = backend.p
    if p == 1:
        return x
    rank = backend.rank()
    one = _ones_flag(backend)
    res_v, res_f = x, one
    par_v, par_f = x, one
    for k in range(num_steps(p)):
        d = 1 << k
        perm = [(j, j ^ d) for j in range(p) if (j ^ d) < p]
        rv, rf = backend.permute((par_v, par_f), perm)
        partner_lower = (rank & d) != 0  # partner = rank ^ d < rank
        got = rf > 0.5
        # partner < j: received block precedes ours -> fold into result+partial
        fold = partner_lower & got
        nres_v, nres_f = _combine_lr(op, rv, rf, res_v, res_f)
        res_v = _bwhere(fold, nres_v, res_v)
        res_f = torch.where(fold, nres_f, res_f)
        # partial always absorbs the partner block, ordered by rank
        lo_v, _ = _combine_lr(op, rv, rf, par_v, par_f)   # partner lower
        hi_v, _ = _combine_lr(op, par_v, par_f, rv, rf)   # partner higher
        par_v = _bwhere(partner_lower & got, lo_v, _bwhere(got, hi_v, par_v))
        par_f = torch.where(got, torch.maximum(par_f, rf), par_f)
    return res_v


def binomial_tree(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """The paper's two-phase binomial/Brent-Kung schedule (II-B3, III-D).

    Up-phase: rank j with j & (2^(k+1)-1) == 2^(k+1)-1 receives from j-2^k and
    accumulates. Down-phase: complete ranks j & (2^k - 1) == 2^k - 1 send
    their inclusive prefix to j + 2^(k-1); out-of-range sends drop.
    """
    p = backend.p
    if p == 1:
        return x
    K = num_steps(p)
    acc_v, acc_f = x, _ones_flag(backend)
    # Up-sweep.
    for k in range(K):
        mask = (1 << (k + 1)) - 1
        d = 1 << k
        perm = [
            (j - d, j)
            for j in range(p)
            if (j & mask) == mask and j - d >= 0
        ]
        if not perm:
            continue
        rv, rf = backend.permute((acc_v, acc_f), perm)
        got = rf > 0.5
        nv, nf = _combine_lr(op, rv, rf, acc_v, acc_f)
        acc_v = _bwhere(got, nv, acc_v)
        acc_f = torch.where(got, nf, acc_f)
    # Down-sweep.
    for k in range(K, 0, -1):
        mask = (1 << k) - 1
        d = 1 << (k - 1)
        perm = [
            (j, j + d)
            for j in range(p)
            if (j & mask) == mask and j + d < p
        ]
        if not perm:
            continue
        rv, rf = backend.permute((acc_v, acc_f), perm)
        got = rf > 0.5
        nv, nf = _combine_lr(op, rv, rf, acc_v, acc_f)
        acc_v = _bwhere(got, nv, acc_v)
        acc_f = torch.where(got, nf, acc_f)
    return acc_v


def sklansky(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """Sklansky's divide-and-conquer scan with one-to-many permutes.

    Step k: in each block of 2^(k+1), the last rank of the left half
    multicasts its inclusive prefix to every rank of the right half.
    """
    p = backend.p
    if p == 1:
        return x
    acc_v, acc_f = x, _ones_flag(backend)
    for k in range(num_steps(p)):
        half = 1 << k
        block = half << 1
        perm: Perm = []
        for start in range(0, p, block):
            src = start + half - 1
            if src >= p:
                continue
            for dst in range(start + half, min(start + block, p)):
                perm.append((src, dst))
        if not perm:
            continue
        rv, rf = backend.permute((acc_v, acc_f), perm)
        got = rf > 0.5
        nv, nf = _combine_lr(op, rv, rf, acc_v, acc_f)
        acc_v = _bwhere(got, nv, acc_v)
        acc_f = torch.where(got, nf, acc_f)
    return acc_v


def invertible_doubling(backend: Backend, x: PyTree, op: AssocOp) -> PyTree:
    """Inclusive form is hillis-steele; the payoff is in the exclusive form,
    which ``scan_collective`` derives locally via ``op.inverse``."""
    if op.inverse is None:
        raise ValueError(
            "invertible_doubling requires an operator with an inverse "
            f"(op={op.name!r} has none)"
        )
    return hillis_steele(backend, x, op)


def scan_total_schedule(
    backend: Backend, x: PyTree, op: AssocOp, *, inclusive: bool = True
) -> Tuple[PyTree, PyTree]:
    """Fused scan + total: ``(prefix scan of x, full reduction of x)`` from
    ONE schedule of ``ceil(log2 p) + 1`` rounds (the planner's
    ``FUSED_SCAN_TOTAL`` phase).

    Each doubling step carries two permutes in opposite directions: the
    prefix stream extends left (plain hillis-steele), the suffix stream
    extends right. After ceil(log2 p) steps every rank holds its complete
    prefix and suffix, so ``total_r = prefix[0..r] (+) suffix[r+1..]``
    (inclusive; one extra single-hop shift) or ``prefix[0..r-1] (+)
    suffix[r..]`` (exclusive). Correct for any associative operator and
    any p.
    """
    p = backend.p
    if p == 1:
        y = x if inclusive else op.identity_like(x)
        return y, x
    if op.zero_identity:
        if inclusive:
            pre = x
        else:
            pre = backend.permute(x, [(i, i + 1) for i in range(p - 1)])
        suf = x
        for k in range(num_steps(p)):
            d = 1 << k
            rv = backend.permute(pre, [(i, i + d) for i in range(p - d)])
            pre = op.combine(rv, pre)
            sv = backend.permute(suf, [(i + d, i) for i in range(p - d)])
            suf = op.combine(suf, sv)
        if inclusive:
            sv = backend.permute(suf, [(i + 1, i) for i in range(p - 1)])
            return pre, op.combine(pre, sv)
        total = op.combine(pre, suf)
        rank = backend.rank()
        return _bwhere(rank != 0, pre, op.identity_like(x)), total
    one = _ones_flag(backend)
    if inclusive:
        pre_v, pre_f = x, one
    else:
        # structural shift: rank r starts from x_{r-1}; rank 0 starts empty
        pre_v, pre_f = backend.permute(
            (x, one), [(i, i + 1) for i in range(p - 1)]
        )
    suf_v, suf_f = x, one
    for k in range(num_steps(p)):
        d = 1 << k
        rv, rf = backend.permute(
            (pre_v, pre_f), [(i, i + d) for i in range(p - d)]
        )
        pre_v, pre_f = _combine_lr(op, rv, rf, pre_v, pre_f)
        sv, sf = backend.permute(
            (suf_v, suf_f), [(i + d, i) for i in range(p - d)]
        )
        suf_v, suf_f = _combine_lr(op, suf_v, suf_f, sv, sf)
    if inclusive:
        # total = prefix[0..r] (+) suffix[r+1..]; last rank keeps its prefix
        sv, sf = backend.permute(
            (suf_v, suf_f), [(i + 1, i) for i in range(p - 1)]
        )
        total, _ = _combine_lr(op, pre_v, pre_f, sv, sf)
        return pre_v, total
    # exclusive: prefix covers [0..r-1], same-rank suffix covers [r..p-1]
    total, _ = _combine_lr(op, pre_v, pre_f, suf_v, suf_f)
    rank = backend.rank()
    y = _bwhere(rank != 0, pre_v, op.identity_like(x))
    return y, total


def scan_total_step_count(p: int) -> int:
    """Rounds of the fused schedule (the planner's cost-model alpha term)."""
    return num_steps(p) + 1 if p > 1 else 0


# ---------------------------------------------------------------------------
# Chunked payload streaming: split the payload into C contiguous chunks and
# software-pipeline them across exchange steps. Chunk c runs round r at
# pipeline step t = c + r. Each chunk runs the identical per-round schedule on
# its slice, and every registered operator combines elementwise, so the
# concatenated chunked result is bitwise-equal to the unchunked schedule.
# ---------------------------------------------------------------------------


def chunk_bounds(n: int, chunks: int) -> List[int]:
    """Contiguous chunk boundaries: ``chunks + 1`` offsets into ``range(n)``."""
    return [n * c // chunks for c in range(chunks + 1)]


def chunkable(tree: PyTree, chunks: int, *, min_ndim: int = 1) -> bool:
    """True when every leaf can be split into ``chunks`` nonempty contiguous
    blocks along its last axis and all leaves agree on that axis size.

    ``min_ndim`` guards against chunking the wrong axis: the sim backend
    stacks a leading rank axis onto every leaf, so a scalar-per-rank payload
    is a 1-D leaf whose *last* axis is the rank axis — callers there pass
    ``min_ndim=2`` so such payloads fall back to the unchunked schedule.
    """
    if chunks <= 1:
        return False
    leaves = tree_leaves(tree)
    if not leaves:
        return False
    if any(leaf.ndim < min_ndim for leaf in leaves):
        return False
    lens = {leaf.shape[-1] for leaf in leaves}
    return len(lens) == 1 and lens.pop() >= chunks


def split_chunks(tree: PyTree, chunks: int) -> List[PyTree]:
    """Split every leaf along its last axis into ``chunks`` contiguous slices."""
    n = tree_leaves(tree)[0].shape[-1]
    bounds = chunk_bounds(n, chunks)
    return [
        tree_map(lambda a, c=c: a[..., bounds[c]:bounds[c + 1]], tree)
        for c in range(chunks)
    ]


def concat_chunks(parts: Sequence[PyTree]) -> PyTree:
    """Inverse of :func:`split_chunks`: concatenate along the last axis."""
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *leaves: torch.cat(leaves, dim=-1), *parts)


def _set_chunk_context(backend: Backend, chunk: int, rnd: int) -> None:
    """Tag the backend's next permutes with (chunk, per-chunk round) — the
    tracing backend picks this up for per-(round, chunk) span attribution."""
    setter = getattr(backend, "set_chunk_context", None)
    if setter is not None:
        setter(chunk, rnd)


def _pipeline(
    backend: Backend,
    states: List[Any],
    round_fns: Sequence[Callable[[Any, int], Any]],
) -> List[Any]:
    """Run every chunk through ``round_fns`` in software-pipeline order.

    ``states[c]`` is chunk c's schedule state; ``round_fns[r](state, c)``
    advances one chunk by one round. Step t serves chunk c at round
    ``t - c``.
    """
    chunks = len(states)
    rounds = len(round_fns)
    for t in range(rounds + chunks - 1):
        for c in range(max(0, t - rounds + 1), min(chunks, t + 1)):
            r = t - c
            _set_chunk_context(backend, c, r)
            states[c] = round_fns[r](states[c], c)
    _set_chunk_context(backend, -1, -1)
    return states


def chunked_scan_schedule(
    backend: Backend,
    x: PyTree,
    op: AssocOp,
    *,
    chunks: int,
    shift_first: bool = False,
    identity: Optional[PyTree] = None,
) -> PyTree:
    """Chunked, pipelined doubling scan (hillis_steele round structure).

    With ``shift_first`` the structural EXSCAN shift is the first pipelined
    round. ``identity`` (non-zero-identity operators only) replaces rank 0's
    shifted-in zeros before the doubling rounds, mirroring ``sim_scan``.
    Callers apply any final rank-0 masking to the concatenated result.
    """
    p = backend.p
    if p == 1 or chunks <= 1 or not chunkable(x, chunks):
        raise ValueError(
            "chunked_scan_schedule needs p > 1 and a chunkable payload; "
            "callers fall back to the unchunked schedule"
        )
    lg = num_steps(p)
    rank = backend.rank()
    masked = not op.zero_identity

    def shift_round(state, c):
        perm = [(i, i + 1) for i in range(p - 1)]
        if not masked:
            return backend.permute(state, perm)
        val, flag = state
        val = backend.permute(val, perm)
        val = _bwhere(rank != 0, val, ident_parts[c])
        return val, flag

    def doubling(k: int):
        d = 1 << k
        perm = [(i, i + d) for i in range(p - d)]

        def rnd(state, c):
            if masked:
                rv, rf = backend.permute(state, perm)
                return _combine_lr(op, rv, rf, state[0], state[1])
            recv = backend.permute(state, perm)
            return op.combine(recv, state)

        return rnd

    if masked and shift_first and identity is None:
        raise ValueError(
            "non-zero-identity shift_first needs the identity tree to fill "
            "rank 0 (sim_scan always provides it)"
        )
    parts = split_chunks(x, chunks)
    ident_parts = (
        split_chunks(identity, chunks) if identity is not None else None
    )
    if masked:
        one = _ones_flag(backend)
        states: List[Any] = [(part, one) for part in parts]
    else:
        states = list(parts)
    round_fns: List[Callable[[Any, int], Any]] = []
    if shift_first:
        round_fns.append(shift_round)
    round_fns.extend(doubling(k) for k in range(lg))
    states = _pipeline(backend, states, round_fns)
    if masked:
        states = [v for v, _ in states]
    return concat_chunks(states)


def chunked_scan_total_schedule(
    backend: Backend,
    x: PyTree,
    op: AssocOp,
    *,
    chunks: int,
    inclusive: bool = True,
) -> Tuple[PyTree, PyTree]:
    """Chunked, pipelined form of :func:`scan_total_schedule`; returns
    ``(scan, total)`` bitwise equal to the unchunked fused schedule."""
    p = backend.p
    if p == 1 or chunks <= 1 or not chunkable(x, chunks):
        raise ValueError(
            "chunked_scan_total_schedule needs p > 1 and a chunkable "
            "payload; callers fall back to the unchunked schedule"
        )
    lg = num_steps(p)
    rank = backend.rank()
    lean = op.zero_identity
    one = None if lean else _ones_flag(backend)

    def entry_shift(state, c):
        pre, suf = state
        perm = [(i, i + 1) for i in range(p - 1)]
        return backend.permute(pre, perm), suf

    def doubling(k: int):
        d = 1 << k
        up = [(i, i + d) for i in range(p - d)]
        down = [(i + d, i) for i in range(p - d)]

        def rnd(state, c):
            pre, suf = state
            if lean:
                pre = op.combine(backend.permute(pre, up), pre)
                suf = op.combine(suf, backend.permute(suf, down))
            else:
                rv, rf = backend.permute(pre, up)
                pre = _combine_lr(op, rv, rf, pre[0], pre[1])
                sv, sf = backend.permute(suf, down)
                suf = _combine_lr(op, suf[0], suf[1], sv, sf)
            return pre, suf

        return rnd

    def exit_fetch(state, c):
        pre, suf = state
        perm = [(i + 1, i) for i in range(p - 1)]
        if lean:
            total = op.combine(pre, backend.permute(suf, perm))
        else:
            sv, sf = backend.permute(suf, perm)
            total, _ = _combine_lr(op, pre[0], pre[1], sv, sf)
        return pre, total

    parts = split_chunks(x, chunks)
    if lean:
        states: List[Any] = [(part, part) for part in parts]
    else:
        states = [((part, one), (part, one)) for part in parts]
    round_fns: List[Callable[[Any, int], Any]] = []
    if not inclusive:
        round_fns.append(entry_shift)
    round_fns.extend(doubling(k) for k in range(lg))
    if inclusive:
        round_fns.append(exit_fetch)
    states = _pipeline(backend, states, round_fns)

    if inclusive:
        if lean:
            scans = [pre for pre, _ in states]
        else:
            scans = [pre_vf[0] for pre_vf, _ in states]
        totals = [total for _, total in states]
        return concat_chunks(scans), concat_chunks(totals)
    scans, totals = [], []
    for pre, suf in states:
        if lean:
            totals.append(op.combine(pre, suf))
            scans.append(pre)
        else:
            total, _ = _combine_lr(op, pre[0], pre[1], suf[0], suf[1])
            totals.append(total)
            scans.append(pre[0])
    scan = concat_chunks(scans)
    y = _bwhere(rank != 0, scan, op.identity_like(x))
    return y, concat_chunks(totals)


def run_chunked(
    fn: Callable[[PyTree], PyTree],
    tree: PyTree,
    chunks: int,
    *,
    min_ndim: int = 1,
) -> PyTree:
    """Chunk-major fallback: run a whole schedule per chunk and concatenate."""
    if chunks <= 1 or not chunkable(tree, chunks, min_ndim=min_ndim):
        return fn(tree)
    return concat_chunks([fn(part) for part in split_chunks(tree, chunks)])


ALGORITHMS = {
    "sequential": sequential,
    "sequential_pipelined": sequential_pipelined,
    "hillis_steele": hillis_steele,
    "recursive_doubling": recursive_doubling,
    "binomial_tree": binomial_tree,
    "sklansky": sklansky,
    "invertible_doubling": invertible_doubling,
}


def get_algorithm(name: str):
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algo_type {name!r}; known: {sorted(ALGORITHMS)}"
        ) from None


def algorithm_step_count(name: str, p: int) -> int:
    """Latency in schedule steps — used by the selector's alpha term."""
    if p <= 1:
        return 0
    lg = num_steps(p)
    return {
        "sequential": p - 1,
        "sequential_pipelined": p - 1,
        "hillis_steele": lg,
        "recursive_doubling": lg,
        "binomial_tree": 2 * lg,
        "sklansky": lg,
        "invertible_doubling": lg,
    }[name]
