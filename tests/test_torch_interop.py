"""Shared helpers of the ``test_torch_*`` parity tests — one numpy input, made
from a seed, fed to both the JAX reference (``repro``) and the PyTorch port
(``repro_torch``) on the CPU, and their outputs compared as numpy."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from torch.utils import _pytree as torch_tree

from repro_torch.interop import payload_from_numpy, payload_to_numpy

BF16 = ml_dtypes.bfloat16
#: the five wire dtypes, numpy side
WIRE_DTYPES = (np.int32, np.float32, BF16, np.float16, np.int8)


def to_both(tree_np):
    """numpy pytree -> (jax pytree, torch pytree on the CPU)."""
    jx = jax.tree.map(jnp.asarray, tree_np)
    return jx, payload_from_numpy(tree_np, "cpu")


def _np_leaves_jax(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _np_leaves_torch(tree):
    return torch_tree.tree_flatten(payload_to_numpy(tree))[0]


def _widen(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32) if a.dtype in (BF16, np.float16) else a


def assert_same(jax_out, torch_out, *, rtol: float = 0.0, atol: float = 0.0,
                what: str = ""):
    """Leaves equal in shape and dtype; values bitwise equal (NaN == NaN)
    when ``rtol == atol == 0``, else within the stated tolerance."""
    ja = _np_leaves_jax(jax_out)
    to = _np_leaves_torch(torch_out)
    assert len(ja) == len(to), what
    for a, b in zip(ja, to):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        a, b = _widen(a), _widen(b)
        if rtol == 0 and atol == 0:
            np.testing.assert_array_equal(b, a, err_msg=what)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)


def rng_values(rng, shape, dtype, *, kind: str = "normal"):
    """Seeded values of one wire dtype (ints span the wrap range)."""
    if dtype == np.int8:
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    if dtype == np.int32:
        hi = 4 if kind == "prod" else 1 << 30
        return rng.integers(-hi, hi, size=shape).astype(np.int32)
    if kind == "prod":
        x = rng.uniform(0.8, 1.25, size=shape)
    else:
        x = rng.standard_normal(shape)
    return x.astype(np.float32).astype(dtype)


# ---------------------------------------------------------------------------
# repro_torch.interop itself
# ---------------------------------------------------------------------------


def test_payloads_round_trip_bit_for_bit():
    rng = np.random.default_rng(0)
    single = {dt: rng_values(rng, (4, 3), dt) for dt in WIRE_DTYPES}
    for dt, x in single.items():
        back = payload_to_numpy(payload_from_numpy(x, "cpu"))
        assert back.dtype == x.dtype
        assert back.tobytes() == x.tobytes()
    ssd = (single[np.float32], single[np.float32] * 2)
    flash = (single[BF16], single[BF16], single[BF16])
    for tree in (ssd, flash):
        back = payload_to_numpy(payload_from_numpy(tree, "cpu"))
        assert isinstance(back, tuple) and len(back) == len(tree)
        for a, b in zip(tree, back):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_to_both_feeds_identical_values():
    x = np.arange(6, dtype=np.float32).reshape(2, 3).astype(BF16)
    jx, tx = to_both(x)
    assert_same(jx, tx)
    assert str(tx.dtype) == "torch.bfloat16" and tx.device.type == "cpu"
