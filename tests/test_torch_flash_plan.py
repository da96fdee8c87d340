"""K5's launch plan and the decode path's split-and-combine arithmetic.

``repro_torch.kernels.flash_attention.plan_launch`` picks the path of a call
(decode for short queries, the tensor-core kernel for bf16/fp16 prefill,
the float32 CUDA-core kernel otherwise), its tiles, its key splits and its
launch count; the CUDA kernels follow it on the card. Here the plan's
properties are checked, and :func:`split_reference` (the decode path's
arithmetic in plain PyTorch: per-split online ``(m, l, acc)`` with the
reference's -1e30 rule, then the combine) is held against the port's
``ref_flash_attention`` and the JAX package's ``ref_flash_attention`` on
numpy-seeded inputs.

Tolerance: rtol = atol = 2e-3 in float32 (the reference suite's K5
tolerance), for the other association order of the softmax sums; bf16 and
fp16 against the port's plain version at 2e-2 and 4e-3 (p rounded to v's
type for the P.V product, as the reference kernel does, plus one rounding
of the output; fp16 keeps three more bits than bf16).
"""

import importlib.util
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from test_torch_interop import assert_same, to_both

K5 = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _plan(BH, Sq, Skv, D, dtype=torch.bfloat16, causal=True, window=0,
          q_offset=0):
    return K5.plan_launch(BH, Sq, Skv, D, dtype, causal=causal, window=window,
                          q_offset=q_offset)


def _visible(Sq, Skv, causal, window, q_offset):
    return tref.attention_mask(Sq, Skv, causal=causal, window=window,
                               q_offset=q_offset, kv_len=None, device="cpu")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq", [1, 2, 15, 16, 17, 64, 2048])
def test_plan_path_follows_query_length_and_dtype(dtype, Sq):
    plan = _plan(4, Sq, 512, 64, dtype, q_offset=512 - Sq)
    if Sq <= K5.DECODE_MAX_SQ:
        assert plan.path == "decode"
    elif dtype == torch.float32:
        assert plan.path == "simt"
    else:
        assert plan.path == "tc"
    assert K5.DECODE_MAX_SQ == 16


SPLIT_CASES = [
    # (BH, Sq, Skv, D, causal, window, q_offset)
    (60, 1, 2048, 64, True, 0, 2047),     # SmolLM-360M decode step
    (1, 1, 2048, 64, True, 0, 2047),
    (2, 16, 1000, 128, False, 0, 0),
    (3, 4, 500, 32, True, 16, 200),       # window
    (2, 1, 300, 64, True, 0, 5000),       # q_offset past Skv
    (1, 5, 100, 64, True, 0, -3),         # rows that see no key
    (2, 3, 130, 32, False, 8, 400),       # window past Skv: no row sees a key
    (4, 7, 777, 64, True, 100, 770),      # ragged Skv and split
    (2, 16, 4100, 128, True, 1024, 4090),
    (1000, 1, 64, 64, True, 0, 63),       # heads alone fill the card
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_plan_splits_cover_each_needed_key_exactly_once(case, dtype):
    BH, Sq, Skv, D, causal, window, q_offset = case
    plan = _plan(BH, Sq, Skv, D, dtype, causal, window, q_offset)
    assert plan.path == "decode"
    assert plan.block_kv == K5.decode_tile(D, dtype)
    assert plan.split_len % plan.block_kv == 0
    assert plan.key_lo % plan.block_kv == 0
    ranges = plan.split_ranges(Skv)
    assert len(ranges) == plan.splits
    assert all(0 <= a < b <= Skv for a, b in ranges)          # none empty
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    covered = np.zeros(Skv, dtype=int)
    for a, b in ranges:
        covered[a:b] += 1
    assert covered.max() == 1                                  # at most once
    mask = _visible(Sq, Skv, causal, window, q_offset).numpy()
    need = mask.any(0) if mask.any(1).all() else np.ones(Skv, dtype=bool)
    assert (covered[need] == 1).all()                          # every needed key
    assert plan.blocks == BH * plan.splits


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_key_range_is_the_union_of_the_rows_visible_keys(case):
    _, Sq, Skv, _, causal, window, q_offset = case
    begin, end = K5.key_range(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset)
    mask = _visible(Sq, Skv, causal, window, q_offset).numpy()
    if not mask.any(1).all():
        assert (begin, end) == (0, Skv)
    else:
        keys = np.flatnonzero(mask.any(0))
        assert (begin, end) == (keys[0], keys[-1] + 1)
        assert len(keys) == end - begin                         # contiguous


def test_decode_grid_fills_the_card_at_the_smollm_decode_step():
    plan = _plan(60, 1, 2048, 64, torch.bfloat16, q_offset=2047)
    assert plan.blocks >= 2 * K5.SMS
    assert (plan.splits, plan.split_len, plan.blocks) == (8, 256, 480)


@pytest.mark.parametrize("BH,Skv", [(1, 2048), (8, 4096), (60, 2048),
                                    (64, 32768), (200, 1000)])
def test_decode_grid_keeps_two_blocks_an_sm_where_the_keys_allow(BH, Skv):
    plan = _plan(BH, 1, Skv, 64, torch.bfloat16, q_offset=Skv - 1)
    most = BH * -(-Skv // plan.block_kv)  # one tile a split
    assert plan.blocks >= min(2 * K5.SMS, most)


@pytest.mark.parametrize("case,want", [
    ((60, 1, 2048, 64, torch.bfloat16), 2),
    ((1000, 1, 64, 64, torch.bfloat16), 1),   # one split: o written directly
    ((60, 2048, 2048, 64, torch.bfloat16), 1),
    ((60, 2048, 2048, 64, torch.float16), 1),
    ((60, 2048, 2048, 64, torch.float32), 1),
    ((4, 16, 300, 128, torch.float32), 2),
])
def test_plan_launch_count(case, want):
    BH, Sq, Skv, D, dtype = case
    plan = _plan(BH, Sq, Skv, D, dtype, q_offset=Skv - Sq)
    assert plan.launches == want
    assert plan.launches == (2 if plan.splits > 1 else 1)


def test_plan_tiles_of_the_prefill_paths():
    tc = _plan(64, 4096, 4096, 128, torch.bfloat16, window=1024)
    assert (tc.path, tc.block_q, tc.block_kv, tc.splits) == ("tc", 128, 128, 1)
    assert tc.blocks == 64 * 32
    simt = _plan(60, 2048, 2048, 128, torch.float32)
    assert (simt.path, simt.block_q, simt.block_kv) == ("simt", 64, 32)


def test_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        _plan(2, 64, 64, 48)
    with pytest.raises(ValueError):
        _plan(2, 64, 64, 64, torch.float64)


# ---------------------------------------------------------------------------
# the split-and-combine arithmetic
# ---------------------------------------------------------------------------


def _qkv(rng, BH, Sq, Skv, D):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((BH, Sq, D), (BH, Skv, D), (BH, Skv, D)))


def split_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    key_lo: Optional[int] = None, split_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the decode path's arithmetic: per key chunk
    the float32 partial ``(m, l, acc)`` of an online softmax with the -1e30
    rule (``p`` rounded to v's type for the P.V product), then the combine
    ``sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30)``.

    The chunks are the plan's unless ``key_lo`` / ``split_len`` are given.
    A chunk that no row sees is skipped (its partial is ``(-1e30, 0, 0)``),
    unless some row sees no key at all: then every chunk is walked, and the
    combine averages v over all keys, as the reference does."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    plan = K5.plan_launch(BH, Sq, Skv, D, q.dtype, causal=causal,
                          window=window, q_offset=q_offset)
    key_lo = plan.key_lo if key_lo is None else key_lo
    split_len = plan.split_len if split_len is None else split_len
    if plan.path != "decode" and split_len == 0:
        split_len = Skv - key_lo
    begin, end = K5.key_range(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset)
    walk_all = not bool(
        tref.attention_mask(Sq, Skv, causal=causal, window=window,
                            q_offset=q_offset, kv_len=None, device=q.device)
        .any(-1).all())
    qf = q.float()
    scale = 1.0 / (D ** 0.5)
    ms, ls, accs = [], [], []
    for s0 in range(key_lo, Skv, split_len):
        s1 = min(Skv, s0 + split_len)
        if not walk_all and (s1 <= begin or s0 >= end):
            ms.append(torch.full((BH, Sq), tref.NEG_INF, device=q.device))
            ls.append(torch.zeros((BH, Sq), device=q.device))
            accs.append(torch.zeros((BH, Sq, D), device=q.device))
            continue
        s = torch.einsum("bqd,bkd->bqk", qf, k[:, s0:s1].float()) * scale
        mask = tref.attention_mask(Sq, s1, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=None,
                                   device=q.device)[:, s0:]
        s = torch.where(mask[None], s, torch.full_like(s, tref.NEG_INF))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                                 v[:, s0:s1].float()))
    m_all = torch.stack(ms)                   # (splits, BH, Sq)
    w = torch.exp(m_all - m_all.amax(0))
    den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    num = (w[..., None] * torch.stack(accs)).sum(0)
    return (num / den[..., None]).to(q.dtype)


ARITH_CASES = [
    # (BH, Sq, Skv, D, causal, window, q_offset, split_len)
    (2, 1, 300, 64, True, 0, 299, None),    # the plan's splits, ragged Skv
    (2, 1, 300, 64, True, 0, 299, 64),
    (1, 5, 100, 64, True, 0, -3, None),     # rows that see no key
    (1, 5, 100, 64, True, 0, -3, 32),
    (2, 3, 130, 32, False, 8, 400, 32),     # no row sees a key
    (3, 4, 500, 32, True, 16, 200, 64),     # window: most splits unseen
    (2, 6, 260, 32, True, 0, 40, 64),       # splits some rows cannot see
    (2, 16, 1000, 128, False, 0, 0, None),
    (2, 16, 70, 64, True, 0, 60, 32),       # Skv not a multiple of the split
    (1, 8, 2048, 64, True, 0, 5000, 128),   # q_offset past Skv
    (2, 2, 333, 32, False, 50, 200, 96),    # window without causal
]


@pytest.mark.parametrize("case", ARITH_CASES)
def test_split_arithmetic_matches_both_references(case):
    BH, Sq, Skv, D, causal, window, q_offset, split_len = case
    rng = np.random.default_rng(sum(abs(c) for c in case if c))
    q, k, v = _qkv(rng, BH, Sq, Skv, D)
    (jq, jk, jv), (tq, tk, tv) = to_both((q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = split_reference(tq, tk, tv, **kw, split_len=split_len,
                             key_lo=None if split_len is None else 0)
    want_t = tref.ref_flash_attention(tq, tk, tv, **kw)
    want_j = jref.ref_flash_attention(jq, jk, jv, **kw)
    torch.testing.assert_close(got, want_t, rtol=2e-3, atol=2e-3,
                               msg=lambda m: f"{case}: {m}")
    assert_same(want_j, got, rtol=2e-3, atol=2e-3, what=str(case))


def test_split_arithmetic_averages_v_for_rows_that_see_no_key():
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 1, 3, 200, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = split_reference(tq, tk, tv, causal=True, q_offset=-5,
                             split_len=64, key_lo=0)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        v[0].mean(0), (3, 32)), atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3)])
@pytest.mark.parametrize("case", ARITH_CASES[:6])
def test_split_arithmetic_in_half_types(case, dtype, tol):
    BH, Sq, Skv, D, causal, window, q_offset, split_len = case
    rng = np.random.default_rng(7 + Skv)
    tq, tk, tv = (torch.from_numpy(a).to(dtype)
                  for a in _qkv(rng, BH, Sq, Skv, D))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = split_reference(tq, tk, tv, **kw, split_len=split_len,
                             key_lo=None if split_len is None else 0)
    want = tref.ref_flash_attention(tq, tk, tv, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_cpu_calls_launch_nothing():
    before = K5.launches
    q = torch.ones(2, 1, 32)
    K5.attention(q, torch.ones(2, 70, 32), torch.ones(2, 70, 32),
                 q_offset=69)
    assert K5.launches == before


# ---------------------------------------------------------------------------
# chip_smoke.py's K5 limits: loose enough for rounding, tight enough for a
# kernel that skips a key tile
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked_attention(q, k, v, mask):
    """Attention in float64 over the keys ``mask`` leaves visible."""
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) / q.shape[-1] ** 0.5
    s = torch.where(mask[None], s, torch.full_like(s, tref.NEG_INF))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.double())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_chip_smoke_k5_limits_hold_rounding(dtype):
    """The decode path's arithmetic in another association order than the
    plain version passes both of chip_smoke.py's K5 checks."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11)
    tq, tk, tv = (torch.from_numpy(a).to(dtype)
                  for a in _qkv(rng, 2, 16, 1000, 64))
    kw = dict(causal=True, q_offset=984)
    got = split_reference(tq, tk, tv, **kw, split_len=64, key_lo=0)
    want = tref.ref_flash_attention(tq, tk, tv, **kw)
    rtol, atol = cs.FLASH_TOL[cs.dtype_name(dtype)]
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol,
                               atol=atol)
    cs.check_rows(torch, got, want, dtype, "split arithmetic")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_chip_smoke_k5_limits_catch_a_skipped_key_tile(dtype):
    """A tensor-core kernel whose last query block (128 rows of a causal
    (1024, 1024) call) skipped any one of its 128-key tiles fails the
    element-wise check and, by a wide margin, the per-row one."""
    cs = _chip_smoke()
    rng = np.random.default_rng(12)
    Sq = 1024
    tq, tk, tv = (torch.from_numpy(a).to(dtype)
                  for a in _qkv(rng, 1, Sq, Sq, 64))
    want = tref.ref_flash_attention(tq, tk, tv, causal=True)
    mask = _visible(Sq, Sq, True, 0, 0)
    rtol, atol = cs.FLASH_TOL[cs.dtype_name(dtype)]
    limit = cs.FLASH_ROW_TOL[cs.dtype_name(dtype)]
    for key0 in range(0, Sq, 128):
        skipped = mask.clone()
        skipped[-128:, key0:key0 + 128] = False
        got = _masked_attention(tq, tk, tv, skipped).to(dtype)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(got.double(), want.double(),
                                       rtol=rtol, atol=atol)
        assert cs.row_rel_err(torch, got, want) > 10 * limit
        with pytest.raises(AssertionError):
            cs.check_rows(torch, got, want, dtype, "skipped tile")
