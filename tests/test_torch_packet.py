"""Parity of ``repro_torch.core.packet`` with ``repro.core.packet``: the
descriptor wire words are byte-identical over the cases of
``tests/test_wire_format.py`` (10/15/16/17-word layouts, optimizer flag,
chunk word, backend id, checked encode), and each package decodes the
other's words."""

import itertools

import numpy as np
import pytest

from repro.core import packet as jp
from repro_torch.core import packet as tp


def _legacy_words():
    return np.asarray(
        [7, 8, int(jp.CollType.EXSCAN), 4, 3, 5, int(jp.WireOp.MAX),
         int(jp.WireDType.BFLOAT16), 33, int(jp.MsgType.PARTIAL)],
        dtype=np.uint32,
    )


def _pair(**fields):
    """The same descriptor built in both packages."""
    def build(mod):
        f = dict(fields)
        for key, enum_name in (("coll_type", "CollType"),
                               ("operation", "WireOp"),
                               ("data_type", "WireDType"),
                               ("msg_type", "MsgType")):
            if key in f:
                f[key] = getattr(mod, enum_name)(int(f[key]))
        return mod.CollectiveDescriptor(**f)

    return build(jp), build(tp)


def _assert_words(j, t):
    wj, wt = j.encode(), t.encode()
    assert wj.dtype == wt.dtype == np.uint32
    np.testing.assert_array_equal(wt, wj)
    assert wt.tobytes() == wj.tobytes()
    # each package decodes the other's words to its own equal descriptor
    assert tp.CollectiveDescriptor.decode(wj) == t
    assert jp.CollectiveDescriptor.decode(wt) == j


def test_layout_constants_match():
    for name in ("_LEGACY_WORDS", "_TOPO_WORDS", "_OPT_WORDS", "_CHUNK_WORDS",
                 "MAX_AXES", "_WIRE_BACKENDS", "_ALGO_NAMES"):
        assert getattr(tp, name) == getattr(jp, name), name
    for enum_name in ("CollType", "AlgoType", "NodeType", "MsgType",
                      "WireOp", "WireDType"):
        assert ({m.name: int(m) for m in getattr(tp, enum_name)}
                == {m.name: int(m) for m in getattr(jp, enum_name)})


def test_legacy_10_word_decode_reencodes_identically():
    words = _legacy_words()
    j = jp.CollectiveDescriptor.decode(words)
    t = tp.CollectiveDescriptor.decode(words)
    assert t.algo_type == j.algo_type == "binomial_tree"
    assert t.node_type == j.node_type
    _assert_words(j, t)


@pytest.mark.parametrize("n_axes", [1, 2, 3])
@pytest.mark.parametrize("optimized", [False, True])
def test_topology_words_all_splits(n_axes, optimized):
    sizes = {1: (8,), 2: (2, 4), 3: (2, 2, 2)}[n_axes]
    for order in itertools.permutations(range(n_axes)):
        j, t = _pair(
            comm_size=int(np.prod(sizes)), coll_type=jp.CollType.ALLREDUCE,
            algo_type="hillis_steele", count=64, axes=sizes, split=order,
            optimized=optimized,
        )
        _assert_words(j, t)
        # the 15-word prefix decodes the same in both
        prefix = j.encode()[:jp._TOPO_WORDS]
        assert (tp.CollectiveDescriptor.decode(prefix).encode().tobytes()
                == jp.CollectiveDescriptor.decode(prefix).encode().tobytes())


@pytest.mark.parametrize("length", [10, 15, 16, 17])
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("chunks", [1, 4])
def test_truncated_layouts_decode_identically(length, optimized, chunks):
    j, t = _pair(comm_size=8, coll_type=jp.CollType.SCAN,
                 algo_type="hillis_steele", count=16, axes=(2, 4),
                 split=(0, 1), optimized=optimized, chunks=chunks)
    _assert_words(j, t)
    words = j.encode()
    if length > len(words):
        return  # an unchunked encoding has no 17th word to slice
    bj = jp.CollectiveDescriptor.decode(words[:length])
    bt = tp.CollectiveDescriptor.decode(words[:length])
    _assert_words(bj, bt)


@pytest.mark.parametrize("backend", ["", "pallas"])
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("chunks", [1, 2])
def test_backend_flag_words(backend, optimized, chunks):
    j, t = _pair(comm_size=8, coll_type=jp.CollType.SCAN,
                 algo_type="hillis_steele", count=16, axes=(2, 4),
                 split=(1, 0), optimized=optimized, chunks=chunks,
                 backend=backend)
    _assert_words(j, t)
    assert len(t.encode()) == (17 if chunks > 1 else 16)


@pytest.mark.parametrize("coll", list(jp.CollType))
@pytest.mark.parametrize("op", list(jp.WireOp))
def test_every_coll_and_op_checked_encode(coll, op):
    j, t = _pair(comm_id=3, comm_size=16, coll_type=coll,
                 algo_type="recursive_doubling", rank=5, root=2,
                 operation=op, data_type=jp.WireDType.INT8, count=1024,
                 axes=(4, 4), split=(1, 0))
    _assert_words(j, t)
    cj, ct = jp.encode_checked(j), tp.encode_checked(t)
    np.testing.assert_array_equal(ct, cj)
    assert tp.wire_checksum(j.encode()) == jp.wire_checksum(j.encode())
    assert tp.decode_checked(cj) == t
    bad = cj.copy()
    bad[4] ^= 1
    with pytest.raises(tp.IntegrityError):
        tp.decode_checked(bad)


@pytest.mark.parametrize("length", [0, 1, 9, 11, 14, 18, 32])
def test_malformed_lengths_rejected_by_both(length):
    words = np.ones(length, dtype=np.uint32)
    with pytest.raises(ValueError) as ej:
        jp.CollectiveDescriptor.decode(words)
    with pytest.raises(ValueError) as et:
        tp.CollectiveDescriptor.decode(words)
    assert str(et.value) == str(ej.value)


def test_invalid_descriptors_rejected_by_both():
    for fields in (
        dict(comm_size=8, optimized=True),
        dict(comm_size=8, count=16, backend="pallas"),
        dict(comm_size=8, count=16, axes=(2, 4), backend="netfpga"),
        dict(comm_size=9, count=4, axes=(2, 4)),
        dict(comm_size=8, chunks=2),
    ):
        with pytest.raises(ValueError) as ej:
            jp.CollectiveDescriptor(**fields)
        with pytest.raises(ValueError) as et:
            tp.CollectiveDescriptor(**fields)
        assert str(et.value) == str(ej.value)
