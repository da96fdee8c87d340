"""The K5 route of ``repro_torch.models.layers.flash_attention`` on the card
(``-m card``; each test skips itself without CUDA), at Granite-4.0-H-Small's
attention: 32 query heads over 8 KV heads of 128, scores times 1/128.

Each case runs the same bf16 operands three ways: the route (K5's
tensor-core path), the blocked path (the predicate patched to refuse), and
the float32 oracle (``ref_flash_attention`` over the KV heads copied to
their query heads). Tolerances, from what bf16 rounds:

* the output is rounded to bf16 once (2^-9 of each element at most) and K5
  rounds each probability to bf16 before the PV product (2^-9 of each term
  of ``sum_j p_j v_j``), so an element is off the oracle by at most 2^-8 of
  the largest |v|, and the relative L2 error stays near 2^-9 (the roundings
  are unbiased); the tests allow twice the bound, 2^-7 of the largest |v|,
  and 2^-7 relative L2;
* the blocked path rounds the scores to bf16 before the softmax (the bf16
  QK product), 2^-9 of |s| each; with |s| under 6 here that moves a
  probability by at most 2^-6 of itself, so the route and the blocked path
  differ by at most 2^-5 of the largest |v| element by element, and the
  two by 2^-7 relative L2 (each near 2^-9 of the oracle).

Each call on the route adds one to K5's ``launches`` (the tc path is one
launch); with a graph recorded the route is refused, K5 is not launched,
and the output is the blocked path's, bit for bit.
"""

import importlib

import pytest
import torch

from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.models import layers as PL
from repro_torch.obs import tracing as ttracing

K5 = importlib.import_module("repro_torch.kernels.flash_attention")

H, KH, D, SCALE = 32, 8, 128, 1.0 / 128
#: the queries' magnitude: scores of a few units at scale 1/128
Q_GAIN = 8.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 runs only there")


def _operands(B, Sq, Sk, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    return draw(B, Sq, H, D) * Q_GAIN, draw(B, Sk, KH, D), draw(B, Sk, KH, D)


def _oracle(q, k, v, **kw):
    """float32 attention over (B H, S, D), each KV head copied to its query
    heads (query head kh G + g reads KV head kh)."""
    B, Sq, _, _ = q.shape
    Sk = k.shape[1]

    def heads(t, S, n):
        t = t.float().transpose(1, 2)
        if n != H:
            t = t.repeat_interleave(H // n, dim=1)
        return t.reshape(B * H, S, D)

    o = ref_flash_attention(heads(q, Sq, H), heads(k, Sk, KH), heads(v, Sk, KH),
                            scale=SCALE, **kw)
    return o.reshape(B, H, Sq, D).transpose(1, 2)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


CASES = [
    dict(B=2, Sq=2048, Sk=2048, causal=True, window=0, q_offset=0),
    dict(B=1, Sq=4096, Sk=4096, causal=True, window=0, q_offset=0),
    dict(B=2, Sq=1000, Sk=1000, causal=True, window=0, q_offset=0),
    # the second chunk of a chunked prefill under a sliding window
    dict(B=1, Sq=1024, Sk=3072, causal=True, window=1024, q_offset=2048),
    # cross-attention: every key, fewer of them than queries, ragged
    dict(B=2, Sq=1500, Sk=777, causal=False, window=0, q_offset=0),
]
IDS = ["s2048", "s4096", "ragged_s1000", "window_q_offset", "cross"]


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_k5_route_matches_the_blocked_path_at_granites_attention(
        monkeypatch, case):
    _card()
    case = dict(case)
    B, Sq, Sk = case.pop("B"), case.pop("Sq"), case.pop("Sk")
    q, k, v = _operands(B, Sq, Sk, seed=Sq + Sk)
    before = K5.launches
    with torch.inference_mode():
        got = PL.flash_attention(q, k, v, scale=SCALE, **case)
    torch.cuda.synchronize()
    assert K5.launches - before == 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    monkeypatch.setattr(PL, "k5_takes", lambda *a: False)
    with torch.inference_mode():
        blocked = PL.flash_attention(q, k, v, scale=SCALE, **case)
    torch.cuda.synchronize()
    assert K5.launches - before == 1
    want = _oracle(q, k, v, **case)
    vmax = v.float().abs().max().item()
    assert _rel_l2(got, want) < 2 ** -7
    assert _max_err(got, want) < 2 ** -7 * vmax
    assert _rel_l2(blocked, want) < 2 ** -7
    assert _rel_l2(got, blocked) < 2 ** -7
    assert _max_err(got, blocked) < 2 ** -5 * vmax


@pytest.mark.card
def test_with_a_graph_recorded_the_blocked_path_runs_bit_for_bit(monkeypatch):
    _card()
    q, k, v = _operands(1, 2048, 2048, seed=11)
    before = K5.launches
    qg = q.detach().requires_grad_(True)
    got = PL.flash_attention(qg, k, v, scale=SCALE)
    got.float().sum().backward()
    torch.cuda.synchronize()
    assert K5.launches == before and qg.grad is not None
    monkeypatch.setattr(PL, "k5_takes", lambda *a: False)
    with torch.no_grad():
        blocked = PL.flash_attention(q, k, v, scale=SCALE)
    assert torch.equal(got.detach(), blocked)


@pytest.mark.card
def test_attention_block_on_the_card_is_one_k5_call():
    _card()
    from types import SimpleNamespace

    cfg = SimpleNamespace(d_model=512, resolved_head_dim=D, num_heads=H,
                          num_kv_heads=KH, qkv_bias=False, mrope=False,
                          rope_theta=0.0, attention_multiplier=SCALE)
    p = PL.Attention(torch.Generator().manual_seed(2), cfg, torch.bfloat16, "cuda")
    x = torch.randn(2, 512, cfg.d_model, device="cuda").bfloat16()

    def count(name):
        return ttracing.span_totals().get(name, (0, 0))[0]

    blocks, calls, launches = count("attn.block"), count("k5.call"), K5.launches
    with torch.inference_mode():
        out = PL.attention_block(p, x, torch.arange(512, device="cuda"), cfg)
    torch.cuda.synchronize()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert count("attn.block") - blocks == 1
    assert count("k5.call") - calls == 1
    assert K5.launches - launches == 1
