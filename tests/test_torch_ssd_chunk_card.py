"""K6, the chunked SSD's chunk output, on the card (``-m card``; each test
skips itself without CUDA), at the layer shapes of the two prefill cells:
Mamba2-130m's (8, 4096) with 24 heads and one row of Granite-4.0-H-Small's
(2, 16384) with 128 heads, P 64, N 128, chunks of 256 (and 64, 128).

Each case runs ``_ssd_chunked`` on the same bf16 operands twice: on the
route (K6) and on the eager path (the predicate patched to refuse), and
holds both to a float64 computation of the same formula from the same
bf16 scores (``ref.ref_ssd_chunk_out`` in float64 over the operands K6 was
handed). Bars:

* K6 and the eager path differ by float32 rounding alone: relative L2 at
  most 1e-5 (they differ near 1e-7: the eager GEMMs round each float32
  product sum, K6 sums in float64 and rounds once);
* K6's relative L2 error against float64 is at most twice the eager path's;
* one K6 launch a call, and the states returned are the eager path's bit
  for bit (K6 computes y alone);
* causality: changing x after position i leaves y up to i bit for bit.

A Mamba2-130m prefill under ``inference_mode`` runs every one of its 24
layers' chunk outputs on K6: 24 ``ssd.block`` and 24 ``k6.call`` spans.
"""

import math

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as K6
from repro_torch.models import mamba as PM
from repro_torch.obs import tracing as ttracing

P, N = 64, 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 runs only there")


def _operands(B, S, H, seed, state=False):
    """bf16 operands shaped as the mixer makes them: Bc and Cc the halves
    of one BC projection, the step sizes softplus'd around 1 and the decay
    rates of ``A_log``'s 1-16, as the configurations initialise them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(B, S, H, P, generator=g, device="cuda").bfloat16()
    bc = (torch.randn(B, S, 2 * N, generator=g, device="cuda") * 0.5).bfloat16()
    raw = torch.randn(B, S, H, generator=g, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(raw + math.log(math.e - 1))
    dA = dt * -torch.linspace(1.0, 16.0, H, device="cuda")
    state_in = None
    if state:
        state_in = (torch.rand(B, H, generator=g, device="cuda"),
                    torch.randn(B, H, P, N, generator=g, device="cuda"))
    return (xs, bc[..., :N], bc[..., N:], dA, dt), state_in


def _run(monkeypatch, operands, chunk, state_in):
    """(K6's y, the eager path's y, the operands K6 was handed, K6's
    launches), both calls under ``inference_mode``."""
    seen = []
    real = PM.ssd_chunk_out
    monkeypatch.setattr(PM, "ssd_chunk_out",
                        lambda *a: seen.append(a) or real(*a))
    before = K6.launches
    with torch.inference_mode():
        got = PM._ssd_chunked(*operands, chunk, state_in=state_in)
    torch.cuda.synchronize()
    launched = K6.launches - before
    monkeypatch.setattr(PM, "k6_takes", lambda *a: False)
    with torch.inference_mode():
        want = PM._ssd_chunked(*operands, chunk, state_in=state_in)
    torch.cuda.synchronize()
    assert K6.launches - before == launched
    return got, want, seen, launched


def _float64_errors(y6, ye, args):
    """Relative L2 errors of K6's and the eager path's y against the
    formula in float64, eight chunks of one row at a time."""
    B, nc, Q, H, _ = args[2].shape
    y6, ye = (y.reshape(B, nc, Q, H, P) for y in (y6, ye))
    num6 = nume = den = 0.0
    for b in range(B):
        for c0 in range(0, nc, 8):
            sl = (slice(b, b + 1), slice(c0, c0 + 8))
            want = ref.ref_ssd_chunk_out(*(t[sl].double() for t in args))
            num6 += (y6[sl].double() - want).pow(2).sum().item()
            nume += (ye[sl].double() - want).pow(2).sum().item()
            den += want.pow(2).sum().item()
    return math.sqrt(num6 / den), math.sqrt(nume / den)


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


CASES = [
    dict(B=8, S=4096, H=24, chunk=256, state=False),    # Mamba2-130m's layer
    dict(B=1, S=16384, H=128, chunk=256, state=False),  # a row of Granite's
    dict(B=2, S=2048, H=24, chunk=256, state=True),
    dict(B=2, S=2048, H=24, chunk=128, state=True),
    dict(B=2, S=1024, H=8, chunk=64, state=False),
]
IDS = ["mamba2_layer", "granite_row", "state_in", "q128_state_in", "q64"]


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k6_matches_the_eager_path_and_float64(monkeypatch, case):
    _card()
    operands, state_in = _operands(case["B"], case["S"], case["H"],
                                   seed=case["S"] + case["H"],
                                   state=case["state"])
    got, want, seen, launched = _run(monkeypatch, operands, case["chunk"],
                                     state_in)
    assert launched == 1 and len(seen) == 1
    y6, ye = got[0], want[0]
    assert y6.shape == ye.shape and y6.dtype == ye.dtype == torch.float32
    assert bool(torch.isfinite(y6).all())
    for a, b in zip((*got[1], *got[2]), (*want[1], *want[2])):
        assert torch.equal(a, b)
    assert _rel_l2(y6, ye) <= 1e-5
    err6, erre = _float64_errors(y6, ye, seen[0])
    assert err6 <= 2 * erre, (err6, erre)


@pytest.mark.card
def test_k6_is_causal_bit_for_bit():
    _card()
    (xs, Bc, Cc, dA, dt), _ = _operands(2, 1024, 24, seed=5)
    i = 300  # inside the second chunk of 256
    with torch.inference_mode():
        y1 = PM._ssd_chunked(xs, Bc, Cc, dA, dt, 256)[0]
        xs2 = xs.clone()
        xs2[:, i + 1:] = torch.randn_like(xs2[:, i + 1:].float()).bfloat16()
        y2 = PM._ssd_chunked(xs2, Bc, Cc, dA, dt, 256)[0]
    torch.cuda.synchronize()
    assert torch.equal(y1[:, :i + 1], y2[:, :i + 1])
    assert not torch.equal(y1[:, i + 1:], y2[:, i + 1:])


@pytest.mark.card
def test_a_mamba2_prefill_runs_every_layer_on_k6():
    _card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    from repro_torch.sharding.specs import Topology

    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cuda")
    step, _, _ = build_prefill_step(api, Topology(mesh=None),
                                    ShapeConfig("p", 1024, 2, "prefill"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), dtype=torch.int32,
                           device="cuda")

    def count(name):
        return ttracing.span_totals().get(name, (0, 0))[0]

    blocks, calls, launches = count("ssd.block"), count("k6.call"), K6.launches
    logits, _ = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    assert count("ssd.block") - blocks == cfg.num_layers == 24
    assert count("k6.call") - calls == 24
    assert K6.launches - launches == 24
