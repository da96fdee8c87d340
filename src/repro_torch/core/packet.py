"""The offload descriptor — software analogue of the paper's Fig. 1 packet.

A numpy-only copy of ``repro.core.packet``: the port keeps its own wire
format so it never imports the JAX package, and the words it encodes are
byte-identical to the reference's (``tests/test_torch_packet.py``).

The NetFPGA consumed a UDP packet whose payload carried the collective
descriptor (comm_id, comm_size, coll_type, algo_type, node_type, msg_type,
rank, root, operation, data_type, count). The Ethernet/IP/UDP framing has no
counterpart on one GPU; we keep the descriptor itself: it is how
the framework names, logs, and selects compiled collective schedules, and the
encode/decode round-trip keeps the format "self-describing" as the paper
intends. ``node_type`` is derived from (rank, comm_size) inside the SPMD
program — the hardware-side derivation the paper lists as future work is
trivial in software, so we do it.

Beyond the paper's single 8-host ring, the descriptor carries a topology
encoding: ``axes`` (per-mesh-axis sizes, outermost first, up to
:data:`MAX_AXES`) and ``split`` (the planner's chosen logical axis order, a
permutation of the axis indices). A multi-axis descriptor names a *planned*
hierarchical collective — the phase structure is derived from (coll_type,
axes, split) by ``repro_torch.offload.planner`` — while keeping the wire contract:
the whole request, topology included, round-trips through ``encode``/
``decode`` and cache-keys the compiled schedule. The 16th word is the
schedule-flags word: bit 0 is the ``optimized`` flag (1 iff the
plan-optimizer pass pipeline in ``repro_torch.offload.passes`` runs for this
request) and the remaining bits carry the lowering-backend id
(:data:`_WIRE_BACKENDS`; 0 = the mode default, so every pre-backend
encoding keeps its exact bytes), so brokered, cached, and remote
dispatches agree on the compiled schedule's shape. When chunked streaming
is requested (``chunks > 1``) a 17th word carries the payload chunk count;
unchunked descriptors keep the 16-word encoding unchanged. Legacy 10-word
descriptors (no topology) decode as single-axis requests; 15-word
descriptors (topology, pre-optimizer) decode with the flags off.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import zlib

import numpy as np


class IntegrityError(RuntimeError):
    """A checksummed payload or descriptor failed verification.

    Raised by :func:`decode_checked` (descriptor wire words). ``request``
    optionally names the poisoned broker request (``"tenant#seqno"``) when
    the failure is attributable to one, as in the reference.
    """

    def __init__(self, message: str, *, request: "str | None" = None):
        super().__init__(message)
        self.request = request


class CollType(enum.IntEnum):
    SCAN = 0       # MPI_Scan
    EXSCAN = 1     # MPI_Exscan
    REDUCE = 2
    ALLREDUCE = 3
    BARRIER = 4


class AlgoType(enum.IntEnum):
    SEQUENTIAL = 0
    SEQUENTIAL_PIPELINED = 1
    HILLIS_STEELE = 2
    RECURSIVE_DOUBLING = 3
    BINOMIAL_TREE = 4
    SKLANSKY = 5
    INVERTIBLE_DOUBLING = 6


class NodeType(enum.IntEnum):
    LEAF = 0
    INTERNAL = 1
    ROOT = 2


class MsgType(enum.IntEnum):
    OFFLOAD_REQUEST = 0
    PARTIAL = 1
    RESULT = 2
    ACK = 3        # the paper's back-to-back flow-control packet


class WireOp(enum.IntEnum):
    SUM = 0
    PROD = 1
    MAX = 2
    MIN = 3
    SSD = 4
    FLASH = 5


class WireDType(enum.IntEnum):
    INT32 = 0
    FLOAT32 = 1
    BFLOAT16 = 2
    FLOAT16 = 3
    INT8 = 4


#: most mesh axes a descriptor can encode (inner, outer, pod)
MAX_AXES = 3

#: encoded word counts: legacy single-axis, topology-carrying, the
#: optimizer-flagged layout, and the chunked-streaming layout (each one
#: extra word; see ``encode``)
_LEGACY_WORDS = 10
_TOPO_WORDS = _LEGACY_WORDS + MAX_AXES + 2  # n_axes + sizes + split index
_OPT_WORDS = _TOPO_WORDS + 1                # + schedule-flags word
_CHUNK_WORDS = _OPT_WORDS + 1               # + payload chunk count word

#: lowering-backend names encodable in the schedule-flags word's high bits
#: (index = wire id). Id 0 is "" — "whatever the dispatch mode's default
#: backend is" — so descriptors that don't name a backend encode exactly as
#: they did before the registry existed. The wire table is append-only.
_WIRE_BACKENDS = ("", "pallas")


def split_index(order: "tuple[int, ...]") -> int:
    """Lexicographic rank of an axis-order permutation (wire encoding)."""
    n = len(order)
    perms = list(itertools.permutations(range(n)))
    try:
        return perms.index(tuple(order))
    except ValueError:
        raise ValueError(
            f"split {order!r} is not a permutation of range({n})"
        ) from None


def split_from_index(idx: int, n_axes: int) -> "tuple[int, ...]":
    """Inverse of :func:`split_index`."""
    perms = list(itertools.permutations(range(n_axes)))
    if not 0 <= idx < len(perms):
        raise ValueError(
            f"split index {idx} out of range for {n_axes} axes "
            f"({math.factorial(n_axes)} permutations)"
        )
    return perms[idx]


_ALGO_NAMES = {
    AlgoType.SEQUENTIAL: "sequential",
    AlgoType.SEQUENTIAL_PIPELINED: "sequential_pipelined",
    AlgoType.HILLIS_STEELE: "hillis_steele",
    AlgoType.RECURSIVE_DOUBLING: "recursive_doubling",
    AlgoType.BINOMIAL_TREE: "binomial_tree",
    AlgoType.SKLANSKY: "sklansky",
    AlgoType.INVERTIBLE_DOUBLING: "invertible_doubling",
}
_ALGO_IDS = {v: k for k, v in _ALGO_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class CollectiveDescriptor:
    """Fig. 1 descriptor fields (transport framing dropped) + topology.

    ``axes`` is empty for single-axis (legacy) requests. When set, it holds
    the physical mesh-axis sizes outermost-first; ``prod(axes)`` must equal
    ``comm_size`` and ``split`` — a permutation of ``range(len(axes))`` —
    records which physical axis the planner placed at each logical level
    (level 0 outermost in global rank order, last level innermost).
    """

    comm_id: int = 0
    comm_size: int = 1
    coll_type: CollType = CollType.SCAN
    algo_type: str = "recursive_doubling"
    rank: int = 0
    root: int = 0
    operation: WireOp = WireOp.SUM
    data_type: WireDType = WireDType.FLOAT32
    count: int = 1
    msg_type: MsgType = MsgType.OFFLOAD_REQUEST
    axes: "tuple[int, ...]" = ()
    split: "tuple[int, ...]" = ()
    optimized: bool = False
    #: payload chunk count for chunked streaming (1 = whole-payload rounds;
    #: the wire layout only grows the extra word when chunks > 1, so every
    #: pre-chunking descriptor keeps its exact byte encoding)
    chunks: int = 1
    #: lowering-backend request ("" = the dispatch mode's default). Names
    #: must be wire-encodable (:data:`_WIRE_BACKENDS`); like ``optimized``
    #: it shapes the compiled schedule, so it is topology-only and travels
    #: in the schedule-flags word's high bits.
    backend: str = ""

    def __post_init__(self):
        if self.optimized and not self.axes:
            raise ValueError(
                "optimized flag requires a multi-axis topology (the plan "
                "optimizer runs on planned collectives only)"
            )
        if self.backend:
            if not self.axes:
                raise ValueError(
                    "backend request requires a multi-axis (planned) "
                    "topology; single-axis requests use the mode default"
                )
            if self.backend not in _WIRE_BACKENDS:
                raise ValueError(
                    f"backend {self.backend!r} is not wire-encodable; "
                    f"known: {', '.join(n or '<default>' for n in _WIRE_BACKENDS)}"
                )
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.chunks > 1 and not self.axes:
            raise ValueError(
                "chunked streaming requires a multi-axis (planned) "
                "descriptor; single-axis requests always run unchunked"
            )
        if self.axes:
            if len(self.axes) > MAX_AXES:
                raise ValueError(
                    f"at most {MAX_AXES} mesh axes encodable; got {self.axes}"
                )
            if math.prod(self.axes) != self.comm_size:
                raise ValueError(
                    f"axes {self.axes} do not factor comm_size="
                    f"{self.comm_size}"
                )
            split = self.split or tuple(range(len(self.axes)))
            if sorted(split) != list(range(len(self.axes))):
                raise ValueError(
                    f"split {split!r} is not a permutation of the "
                    f"{len(self.axes)} axes"
                )
            object.__setattr__(self, "split", tuple(split))
        elif self.split:
            raise ValueError("split given without axes")

    def normalized(self) -> "CollectiveDescriptor":
        """This request with the per-rank fields zeroed: every rank of a
        communicator, and every repeat request, shares one normalized form.
        Both the engine's schedule-cache key and the broker's coalescing
        group key derive from it — requests fuse iff they would share a
        compiled schedule."""
        return dataclasses.replace(
            self, rank=0, msg_type=MsgType.OFFLOAD_REQUEST
        )

    @property
    def node_type(self) -> NodeType:
        """Derived role in the binomial tree (paper left this to software)."""
        p, j = self.comm_size, self.rank
        if p <= 1:
            return NodeType.ROOT
        if j == p - 1:
            return NodeType.ROOT
        # leaf iff it never receives in the up-phase: lowest bit of j is 0
        return NodeType.LEAF if (j & 1) == 0 else NodeType.INTERNAL

    def encode(self) -> np.ndarray:
        """Pack to a uint32 word vector (round-trippable, logged by launch).

        Layout: the 10 legacy descriptor words, then [n_axes, size_0,
        size_1, size_2, split_index] (zero-padded past n_axes), then the
        schedule-flags word: bit 0 is the "optimized" flag (1 iff the
        plan-optimizer pass pipeline runs for this request) and the high
        bits the lowering-backend wire id — both shape the compiled
        schedule, so brokered and cached dispatches must agree on them and
        they travel on the wire like every other schedule-shaping field.
        Default-backend requests keep bit 1+ zero, i.e. their exact
        pre-registry bytes. When ``chunks > 1`` a 17th word carries the
        chunk count; unchunked requests keep the 16-word layout
        byte-for-byte, so existing logged and cached encodings stay valid.
        """
        sizes = list(self.axes) + [0] * (MAX_AXES - len(self.axes))
        split = split_index(self.split) if self.axes else 0
        flags = int(self.optimized) | (
            _WIRE_BACKENDS.index(self.backend) << 1
        )
        words = [
            self.comm_id,
            self.comm_size,
            int(self.coll_type),
            int(_ALGO_IDS[self.algo_type]),
            self.rank,
            self.root,
            int(self.operation),
            int(self.data_type),
            self.count,
            int(self.msg_type),
            len(self.axes),
            *sizes,
            split,
            flags,
        ]
        if self.chunks > 1:
            words.append(self.chunks)
        return np.asarray(words, dtype=np.uint32)

    @staticmethod
    def decode(words: np.ndarray) -> "CollectiveDescriptor":
        w = [int(v) for v in np.asarray(words, dtype=np.uint32)]
        if len(w) not in (_LEGACY_WORDS, _TOPO_WORDS, _OPT_WORDS,
                          _CHUNK_WORDS):
            raise ValueError(
                f"descriptor must be {_LEGACY_WORDS} (legacy), "
                f"{_TOPO_WORDS} (topology), {_OPT_WORDS} (optimizer "
                f"flag), or {_CHUNK_WORDS} (chunked) words; got {len(w)}"
            )
        axes: "tuple[int, ...]" = ()
        split: "tuple[int, ...]" = ()
        if len(w) >= _TOPO_WORDS and w[_LEGACY_WORDS]:
            n = w[_LEGACY_WORDS]
            axes = tuple(w[_LEGACY_WORDS + 1 : _LEGACY_WORDS + 1 + n])
            split = split_from_index(w[_LEGACY_WORDS + 1 + MAX_AXES], n)
        flags = w[_OPT_WORDS - 1] if len(w) >= _OPT_WORDS else 0
        optimized = bool(flags & 1)
        backend_id = flags >> 1
        if backend_id >= len(_WIRE_BACKENDS):
            raise ValueError(
                f"unknown lowering-backend wire id {backend_id} in the "
                f"schedule-flags word (know 0..{len(_WIRE_BACKENDS) - 1})"
            )
        chunks = max(1, w[_CHUNK_WORDS - 1]) if len(w) == _CHUNK_WORDS else 1
        return CollectiveDescriptor(
            comm_id=w[0],
            comm_size=w[1],
            coll_type=CollType(w[2]),
            algo_type=_ALGO_NAMES[AlgoType(w[3])],
            rank=w[4],
            root=w[5],
            operation=WireOp(w[6]),
            data_type=WireDType(w[7]),
            count=w[8],
            msg_type=MsgType(w[9]),
            axes=axes,
            split=split,
            optimized=optimized,
            chunks=chunks,
            backend=_WIRE_BACKENDS[backend_id],
        )


def wire_checksum(words: np.ndarray) -> int:
    """CRC32 over a descriptor word vector (the modeled frame FCS).

    The NetFPGA's Ethernet frames carried a hardware FCS; software
    transports that re-frame the descriptor (files, sockets, logs) lose
    it, so :func:`encode_checked` re-appends one as a trailing uint32
    word. Any single-bit flip over the checked words fails verification —
    which plain ``decode`` cannot promise, since flips in fields like
    ``comm_id`` or ``count`` decode silently into a different-but-valid
    descriptor.
    """
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return zlib.crc32(w.tobytes()) & 0xFFFFFFFF


def encode_checked(desc: CollectiveDescriptor) -> np.ndarray:
    """``desc.encode()`` plus a trailing CRC32 word (see
    :func:`wire_checksum`)."""
    words = desc.encode()
    return np.concatenate(
        [words, np.asarray([wire_checksum(words)], dtype=np.uint32)]
    )


def decode_checked(words: np.ndarray) -> CollectiveDescriptor:
    """Verify and strip the trailing CRC32 word, then ``decode``.

    Raises :class:`IntegrityError` on checksum mismatch (corruption) and
    ``ValueError`` on structurally invalid remainders — never returns a
    descriptor that differs from the one originally encoded.
    """
    w = np.asarray(words, dtype=np.uint32)
    if w.size < _LEGACY_WORDS + 1:
        raise ValueError(
            f"checked descriptor needs at least {_LEGACY_WORDS + 1} words "
            f"(payload + CRC); got {w.size}"
        )
    payload, crc = w[:-1], int(w[-1])
    expect = wire_checksum(payload)
    if crc != expect:
        raise IntegrityError(
            f"descriptor wire checksum mismatch: got {crc:#010x}, "
            f"expected {expect:#010x} over {payload.size} words"
        )
    return CollectiveDescriptor.decode(payload)
