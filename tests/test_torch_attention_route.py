"""The route of ``repro_torch.models.layers.flash_attention`` between K5 and
the blocked attention, on the CPU:

* the predicate (``k5_takes``) is a function of the device type, the dtype,
  the head size, the query rows and the grad state alone, and each
  exclusion holds: the CPU, float32, a head size K5 is not built for, a
  decode-sized query, a recorded graph;
* ``flash_attention`` hands it what it sees of its operands, and where it
  says K5, the call reaches ``K5.attention`` in K5's ``(B H, S, D)``
  layout with query head ``kh G + g`` reading KV head ``kh``, and the
  caller's scale: on the CPU ``K5.attention`` is ``ref_flash_attention``,
  which then equals the blocked path in float32 (1e-5 of the largest
  magnitude: both are float32, summed in different orders);
* under a (1, 4) mesh, with and without ``explicit_tp``, the route gets
  every head (the head-sharded projections assemble them first);
* ``ref_flash_attention(scale=)`` and the ``k5.call`` / ``attn.block``
  spans;
* the two benchmark readers ``attn_k5_share.prefill`` and
  ``attn_device_ms.prefill`` (``portbench/metrics``): None without their
  spans or kernels, the right figure with them.

The card tests are in ``test_torch_attention_card.py``.
"""

import importlib
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch import compat, perf_flags
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.models import layers as PL
from repro_torch.obs import tracing as ttracing
from repro_torch.sharding import make_topology, use_topology

K5 = importlib.import_module("repro_torch.kernels.flash_attention")
ROOT = Path(__file__).resolve().parents[1]

TAKEN = dict(device_type="cuda", dtype=torch.bfloat16, head_dim=128, sq=2048,
             records_grad=False)


@pytest.mark.parametrize("change, taken", [
    ({}, True),
    ({"dtype": torch.float16}, True),
    ({"head_dim": 64}, True),
    ({"sq": K5.DECODE_MAX_SQ + 1}, True),
    ({"device_type": "cpu"}, False),
    ({"device_type": "meta"}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": None}, False),            # operands of different dtypes
    ({"head_dim": 96}, False),
    ({"sq": K5.DECODE_MAX_SQ}, False),
    ({"sq": 1}, False),
    ({"records_grad": True}, False),
], ids=["granite", "fp16", "d64", "sq17", "cpu", "meta", "float32",
        "mixed_dtypes", "d96", "sq16", "sq1", "grad_recorded"])
def test_the_route_takes_k5_only_where_it_may(change, taken):
    assert PL.k5_takes(**{**TAKEN, **change}) is taken


def _qkv(B=2, Sq=40, Sk=40, H=8, Kh=2, D=16, dtype=torch.float32, seed=0,
         requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g).to(dtype)
    k = torch.randn(B, Sk, Kh, D, generator=g).to(dtype)
    v = torch.randn(B, Sk, Kh, D, generator=g).to(dtype)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def _seen(monkeypatch, take=False):
    """Record what ``flash_attention`` hands the predicate; answer ``take``."""
    seen = []

    def predicate(*args):
        seen.append(args)
        return take

    monkeypatch.setattr(PL, "k5_takes", predicate)
    return seen


@pytest.mark.parametrize("grad_enabled, requires_grad, records", [
    (True, True, True),
    (False, True, False),
    (True, False, False),
], ids=["recording", "no_grad", "frozen_inputs"])
def test_flash_attention_hands_the_predicate_what_it_sees(
        monkeypatch, grad_enabled, requires_grad, records):
    seen = _seen(monkeypatch)
    q, k, v = _qkv(D=16, Sq=40, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_enabled):
        PL.flash_attention(q, k, v, kv_block=16, q_block=16)
    assert seen == [("cpu", torch.float32, 16, 40, records)]


def test_operands_of_two_dtypes_reach_the_predicate_as_no_dtype(monkeypatch):
    seen = _seen(monkeypatch)
    q, k, v = _qkv()
    out = PL.flash_attention(q.bfloat16(), k, v, kv_block=16, q_block=16)
    assert seen == [("cpu", None, 16, 40, False)] and out.dtype == torch.bfloat16


@pytest.mark.parametrize("case", [
    dict(causal=True, window=0, q_offset=0, Sq=40, Sk=40),
    dict(causal=True, window=0, q_offset=0, Sq=37, Sk=37),       # ragged
    dict(causal=True, window=9, q_offset=24, Sq=24, Sk=48),
    dict(causal=False, window=0, q_offset=0, Sq=21, Sk=45),      # cross
    dict(causal=False, window=7, q_offset=3, Sq=32, Sk=32),
], ids=["causal", "ragged", "window_offset", "cross", "window_noncausal"])
@pytest.mark.parametrize("H, Kh", [(8, 2), (4, 4), (6, 1)], ids=["gqa4", "mha", "mqa"])
@pytest.mark.parametrize("scale", [None, 1.0 / 128], ids=["default", "granite"])
def test_the_k5_route_equals_the_blocked_path_in_float32(monkeypatch, case, H, Kh,
                                                         scale):
    case = dict(case)
    Sq, Sk = case.pop("Sq"), case.pop("Sk")
    q, k, v = _qkv(Sq=Sq, Sk=Sk, H=H, Kh=Kh, seed=Sq + H)
    q = q * 4  # scores of a few units: the softmax is far from uniform
    want = PL.flash_attention(q, k, v, q_block=16, kv_block=16, scale=scale, **case)
    calls = []
    real = K5.attention

    def counted(*a, **kw):
        calls.append((a[0].shape, a[1].shape, kw["scale"]))
        return real(*a, **kw)

    monkeypatch.setattr(K5, "attention", counted)
    _seen(monkeypatch, take=True)
    got = PL.flash_attention(q, k, v, q_block=16, kv_block=16, scale=scale, **case)
    B, _, _, D = q.shape
    assert calls == [((B * H, Sq, D), (B * H, Sk, D),
                      1.0 / math.sqrt(D) if scale is None else scale)]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_the_k5_route_maps_query_heads_to_their_kv_heads(monkeypatch):
    # every KV head's values are its index: query head h reads h // G
    B, S, H, Kh, D = 1, 24, 8, 2, 16
    q, k, _ = _qkv(B=B, Sq=S, Sk=S, H=H, Kh=Kh, D=D)
    v = torch.arange(Kh, dtype=torch.float32)[None, None, :, None].expand(B, S, Kh, D)
    _seen(monkeypatch, take=True)
    out = PL.flash_attention(q, k, v)
    want = (torch.arange(H) // (H // Kh)).float()[None, None, :, None].expand_as(out)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_with_a_recorded_graph_the_blocked_path_runs_unchanged(monkeypatch):
    calls = []
    monkeypatch.setattr(K5, "attention", lambda *a, **kw: calls.append(1))
    q, k, v = _qkv(requires_grad=True)
    got = PL.flash_attention(q, k, v, q_block=16, kv_block=16, scale=0.3)
    got.sum().backward()
    assert calls == [] and q.grad is not None
    with torch.no_grad():
        want = PL.flash_attention(q, k, v, q_block=16, kv_block=16, scale=0.3)
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("scale", [None, 1.0 / 128, 0.5])
def test_ref_flash_attention_scales_the_scores(scale):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(3, 20, 16, generator=g) for _ in range(3))
    got = ref_flash_attention(q, k, v, causal=True, scale=scale)
    s = q @ k.transpose(1, 2) * (1.0 / 4.0 if scale is None else scale)
    s = s.masked_fill(~torch.ones(20, 20, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(got, torch.softmax(s, -1) @ v, rtol=1e-5, atol=1e-6)


def test_k5_attention_passes_the_scale_on_the_cpu():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 30, 32, generator=g) for _ in range(3))
    got = K5.attention(q, k, v, causal=False, scale=0.01)
    torch.testing.assert_close(got, ref_flash_attention(q, k, v, causal=False,
                                                        scale=0.01))
    assert not torch.equal(got, K5.attention(q, k, v, causal=False))


def _count(name):
    return ttracing.span_totals().get(name, (0, 0))[0]


def _attention_params(H=4, Kh=2, hd=16, d=32):
    cfg = SimpleNamespace(d_model=d, resolved_head_dim=hd, num_heads=H,
                          num_kv_heads=Kh, qkv_bias=False, mrope=False,
                          rope_theta=0.0, attention_multiplier=None)
    return PL.Attention(torch.Generator().manual_seed(5), cfg, torch.float32,
                        "cpu"), cfg


@pytest.mark.parametrize("take", [False, True], ids=["blocked", "k5"])
def test_attention_block_counts_one_span_and_k5_calls(monkeypatch, take):
    p, cfg = _attention_params()
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(6))
    _seen(monkeypatch, take=take)
    blocks, calls = _count("attn.block"), _count("k5.call")
    with torch.no_grad():
        out = PL.attention_block(p, x, torch.arange(24), cfg)
    assert out.shape == x.shape
    assert _count("attn.block") - blocks == 1
    assert _count("k5.call") - calls == int(take)


@pytest.mark.parametrize("explicit_tp", [False, True], ids=["gspmd", "explicit_tp"])
@pytest.mark.parametrize("Kh", [4, 2], ids=["kv_sharded", "kv_replicated"])
def test_under_a_mesh_the_k5_route_gets_every_head(monkeypatch, explicit_tp, Kh):
    """Under a co-resident (1, 4) mesh K5 takes the global heads: with
    ``explicit_tp`` the head-sharded projections' out specs assemble them
    before ``flash_attention``, as the data-placing path has them."""
    H, S = 8, 24
    p, cfg = _attention_params(H=H, Kh=Kh)
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(7))
    positions = torch.arange(S)
    with torch.no_grad():
        want = PL.attention_block(p, x, positions, cfg)
    calls, sharded = [], []
    real, real_qkv = K5.attention, PL.explicit_tp_qkv

    def counted(*a, **kw):
        calls.append((a[0].shape, a[1].shape))
        return real(*a, **kw)

    def qkv(*a):
        sharded.append(1)
        return real_qkv(*a)

    monkeypatch.setattr(K5, "attention", counted)
    monkeypatch.setattr(PL, "explicit_tp_qkv", qkv)
    _seen(monkeypatch, take=True)
    monkeypatch.setattr(perf_flags, "FLAGS", perf_flags.FLAGS)
    perf_flags.set_flags(explicit_tp=explicit_tp)
    mesh = compat.Mesh((1, 4), ("data", "model"), device="cpu")
    with use_topology(make_topology(mesh)), torch.no_grad():
        got = PL.attention_block(p, x, positions, cfg)
    D = cfg.resolved_head_dim
    assert sharded == ([1] if explicit_tp else [])
    assert calls == [((2 * H, S, D), (2 * H, S, D))]
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import bench

    return bench.load_module("metrics", name).read


@pytest.mark.parametrize("totals, want", [
    ({"attn.block": (23, 9_000_000), "k5.call": (23, 100_000)}, 100.0),
    ({"attn.block": (20, 9_000_000), "k5.call": (5, 100_000)}, 25.0),
    # attention layers of which none ran on K5 read 0, not absent
    ({"attn.block": (20, 9_000_000)}, 0.0),
    # K5 calls without an attention layer (a kernel test, the decode path)
    ({"k5.call": (4, 100_000)}, None),
    ({}, None),
], ids=["all", "quarter", "none_on_k5", "no_layer", "nothing"])
def test_attn_k5_share_reads_the_span_counters(monkeypatch, totals, want):
    monkeypatch.setattr(ttracing, "span_totals", lambda: totals)
    got = reader("attn_k5_share.prefill")(None)
    assert got == (pytest.approx(want) if want is not None else None)


def test_attn_k5_share_is_absent_without_span_counters(monkeypatch):
    monkeypatch.delattr(ttracing, "span_totals")
    assert reader("attn_k5_share.prefill")(None) is None


TC = "void (anonymous namespace)::tc::k5_flash_kernel_tc<__nv_bfloat16, 128>(CUtensorMap)"


def _run(kernels, calls=4):
    return SimpleNamespace(traces=[{"calls": calls, "kernels": kernels}])


@pytest.mark.parametrize("kernels, calls, want", [
    # 4 calls, 40 ms of K5 in the window: 10 ms a call
    ({TC: [4, 0.040, "kernel"], "ampere_bf16_gemm": [40, 1.0, "kernel"]}, 4, 10.0),
    # the decode path's two kernels count too
    ({"k5_flash_kernel_decode<float, 64, 16>": [2, 0.002, "kernel"],
      "k5_flash_kernel_combine<float, 64>": [2, 0.001, "kernel"]}, 2, 1.5),
    # no K5 kernel: the parent's blocked attention, a Mamba2 cell
    ({"ampere_bf16_gemm": [40, 1.0, "kernel"],
      "Memcpy k5_flash_kernel": [1, 0.5, "gpu_memcpy"]}, 4, None),
    ({TC: [4, 0.040, "kernel"]}, 0, None),
], ids=["tc", "decode", "absent", "no_calls"])
def test_attn_device_ms_reads_the_k5_kernels(kernels, calls, want):
    got = reader("attn_device_ms.prefill")(_run(kernels, calls))
    assert got == (pytest.approx(want) if want is not None else None)


def test_attn_device_ms_is_absent_without_a_trace():
    assert reader("attn_device_ms.prefill")(SimpleNamespace(traces=[])) is None
