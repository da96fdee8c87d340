"""The route of ``repro_torch.models.mamba._ssd_chunked``'s chunk output
between K6 and the eager formula, on the CPU:

* the predicate (``k6_takes``) is a function of the device type, the dtype,
  the chunk length, the head size, the state size and the grad state alone,
  and each exclusion holds: the CPU, float32, mixed dtypes, a chunk that is
  not a multiple of 64 rows or is longer than 256, other widths, a recorded
  graph;
* ``_ssd_chunked`` hands it what it sees, and on the CPU it computes, bit for
  bit, what it computed before K6 existed (the seed's formula is copied
  below), launching nothing;
* the plain version ``ref.ref_ssd_chunk_out`` is the eager chunk output: in
  float64 to 1e-12 of the largest magnitude, and in bf16 to 1e-6 of it
  (float32 operations in the same order: equal in practice), with and
  without an incoming state; forced onto the route, ``_ssd_chunked`` hands
  K6's wrapper the chunk's scores, K3's segments, the dt-scaled inputs, C
  and the incoming states in the layouts K6 takes;
* the ``ssd.block`` and ``k6.call`` spans, the wrapper's checks of shape,
  dtype, device and layout, and K6's charge under a ``CostMode``.

The card tests are in ``test_torch_ssd_chunk_card.py``.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as K6
from repro_torch.models import mamba as PM
from repro_torch.models.layers import einsum, remat
from repro_torch.obs import tracing as ttracing
from repro_torch.roofline.analysis import kernel_cost
from repro_torch.roofline.op_cost import CostMode

P, N = K6.HEAD_DIM, K6.STATE

TAKEN = dict(device_type="cuda", dtype=torch.bfloat16, chunk=256, head_dim=P,
             state=N, records_grad=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("change, taken", [
    ({}, True),
    ({"dtype": torch.float16}, True),
    ({"chunk": 64}, True),
    ({"chunk": 128}, True),
    ({"chunk": 192}, True),
    ({"device_type": "cpu"}, False),
    ({"device_type": "meta"}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": None}, False),            # xs, Bc, Cc of different dtypes
    ({"chunk": 17}, False),
    ({"chunk": 320}, False),
    ({"chunk": 96}, False),
    ({"head_dim": 128}, False),
    ({"state": 64}, False),
    ({"records_grad": True}, False),
], ids=["bf16_q256", "fp16", "q64", "q128", "q192", "cpu", "meta", "float32",
        "mixed_dtypes", "q17", "q320", "q96", "p128", "n64", "grad_recorded"])
def test_the_route_takes_k6_only_where_it_may(change, taken):
    assert PM.k6_takes(**{**TAKEN, **change}) is taken


def _operands(B=1, S=256, H=2, dtype=torch.bfloat16, seed=0, state=False,
              requires_grad=False):
    """``_ssd_chunked``'s operands at K6's widths; Bc and Cc are the two
    halves of one BC projection, as the mixer hands them over."""
    g = torch.Generator().manual_seed(seed)
    f = torch.float64 if dtype == torch.float64 else torch.float32
    xs = torch.randn(B, S, H, P, generator=g).to(dtype)
    bc = (torch.randn(B, S, 2 * N, generator=g) * 0.3).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, dtype=f))
    dA = -dt * torch.linspace(0.02, 0.3, H, dtype=f)
    state_in = None
    if state:
        state_in = (torch.rand(B, H, generator=g, dtype=f),
                    torch.randn(B, H, P, N, generator=g, dtype=f))
    if requires_grad:
        xs.requires_grad_(True)
    return (xs, bc[..., :N], bc[..., N:], dA, dt), state_in


def _seed_ssd_chunked(xs, Bc, Cc, dA, dt, chunk, state_in=None):
    """``_ssd_chunked`` as it was before K6: the eager formula."""
    B, S, H, Pd = xs.shape
    N_ = Bc.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xb = (xs * dt[..., None]).to(xs.dtype)
    xbc_ = xb.reshape(B, nc, Q, H, Pd)
    Bcc = Bc.reshape(B, nc, Q, N_)
    Ccc = Cc.reshape(B, nc, Q, N_)
    dAc = dA.reshape(B, nc, Q, H)
    seg = PM._segment_scan(dAc)

    def intra(Ccc, Bcc, seg, xbc_):
        scores = einsum("bcin,bcjn->bcij", Ccc, Bcc)
        Lmat = torch.exp(
            torch.clamp(seg[:, :, :, None, :] - seg[:, :, None, :, :],
                        -60.0, 0.0)
        )
        ii = torch.arange(Q, device=xs.device)
        causal = (ii[:, None] >= ii[None, :]).to(scores.dtype)
        W = scores[..., None] * Lmat * causal[None, None, :, :, None]
        return einsum("bcijh,bcjhp->bcihp", W, xbc_)

    y_intra = remat(intra, Ccc, Bcc, seg, xbc_)
    decay_end = torch.exp(seg[:, :, -1:, :] - seg)
    S_c = einsum("bcjhp,bcjn->bchpn", xbc_ * decay_end[..., None], Bcc)
    A_c = torch.exp(seg[:, :, -1, :])
    A_inc, S_inc = PM._chunk_scan(A_c, S_c)
    A_exc = torch.cat([torch.ones_like(A_inc[:, :1]), A_inc[:, :-1]], dim=1)
    S_exc = torch.cat([torch.zeros_like(S_inc[:, :1]), S_inc[:, :-1]], dim=1)
    if state_in is not None:
        a_in, s_in = state_in
        S_exc = A_exc[..., None, None] * s_in[:, None] + S_exc
        A_exc = A_exc * a_in[:, None]
    y_inter = einsum("bcin,bchpn->bcihp", Ccc, S_exc) * torch.exp(seg)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    A_tot, S_tot = A_inc[:, -1], S_inc[:, -1]
    if state_in is not None:
        S_tot = A_inc[:, -1][..., None, None] * state_in[1] + S_tot
        A_tot = A_tot * state_in[0]
    return y, (A_tot, S_tot), (Ccc, seg, A_exc)


def _count(name):
    return ttracing.span_totals().get(name, (0, 0))[0]


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state_in"])
@pytest.mark.parametrize("dtype, chunk", [
    (torch.float32, 64), (torch.bfloat16, 256), (torch.bfloat16, 48),
    (torch.float64, 128)], ids=["f32_q64", "bf16_q256", "bf16_q48", "f64_q128"])
def test_ssd_chunked_on_the_cpu_is_the_seeds_formula(dtype, chunk, state):
    (xs, Bc, Cc, dA, dt), state_in = _operands(S=384 if chunk == 128 else 256,
                                               dtype=dtype, state=state)
    if chunk == 48:
        (xs, Bc, Cc, dA, dt) = (t[:, :240] for t in (xs, Bc, Cc, dA, dt))
    launches, calls = K6.launches, _count("k6.call")
    got = PM._ssd_chunked(xs, Bc, Cc, dA, dt, chunk, state_in=state_in)
    want = _seed_ssd_chunked(xs, Bc, Cc, dA, dt, chunk, state_in=state_in)
    flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert K6.launches == launches and _count("k6.call") == calls


def _forced(monkeypatch, plain=False):
    """Send every call down the K6 branch; record what reaches K6's entry
    (with ``plain``, the plain version itself, free of the wrapper's
    dtype and width checks)."""
    seen = []
    monkeypatch.setattr(PM, "k6_takes", lambda *a: True)
    real = ref.ref_ssd_chunk_out if plain else PM.ssd_chunk_out

    def entry(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(PM, "ssd_chunk_out", entry)
    return seen


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state_in"])
@pytest.mark.parametrize("dtype, rel", [(torch.float64, 1e-12),
                                        (torch.bfloat16, 1e-6)],
                         ids=["f64", "bf16"])
def test_the_plain_version_is_the_eager_chunk_output(monkeypatch, dtype, rel,
                                                     state):
    (xs, Bc, Cc, dA, dt), state_in = _operands(S=512, dtype=dtype, state=state,
                                               seed=1)
    want = PM._ssd_chunked(xs, Bc, Cc, dA, dt, 128, state_in=state_in)
    seen = _forced(monkeypatch, plain=True)
    got = PM._ssd_chunked(xs, Bc, Cc, dA, dt, 128, state_in=state_in)
    assert len(seen) == 1
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    tol = rel * want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=tol)
    for a, b in zip((*got[1], *got[2]), (*want[1], *want[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state_in"])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_the_route_hands_k6_its_layouts(monkeypatch, chunk, state):
    """Forced onto the route on the CPU, the call goes through K6's wrapper
    (which runs the plain version there) with the operands as K6 takes
    them, and the output is the eager path's bit for bit."""
    B, S, H = 2, 256, 3
    (xs, Bc, Cc, dA, dt), state_in = _operands(B=B, S=S, H=H, state=state,
                                               seed=chunk)
    want = PM._ssd_chunked(xs, Bc, Cc, dA, dt, chunk, state_in=state_in)
    seen = _forced(monkeypatch)
    calls = _count("k6.call")
    got = PM._ssd_chunked(xs, Bc, Cc, dA, dt, chunk, state_in=state_in)
    assert _count("k6.call") - calls == 1
    scores, seg, x, C, S_exc = seen[0]
    nc = S // chunk
    assert scores.shape == (B, nc, chunk, chunk) and scores.dtype == xs.dtype
    assert seg.shape == (B, nc, H, chunk) and seg.is_contiguous()
    assert x.shape == (B, nc, chunk, H, P) and x.is_contiguous()
    assert C.shape == (B, nc, chunk, N) and C.stride()[2:] == (2 * N, 1)
    assert C.data_ptr() == Cc.data_ptr()   # the BC projection's C half, as it is
    assert S_exc.shape == (B, nc, H, P, N) and S_exc.dtype == torch.float32
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("grad_enabled, requires_grad, records", [
    (True, True, True),
    (False, True, False),
    (True, False, False),
], ids=["recording", "no_grad", "frozen_inputs"])
def test_ssd_chunked_hands_the_predicate_what_it_sees(
        monkeypatch, grad_enabled, requires_grad, records):
    seen = []
    monkeypatch.setattr(PM, "k6_takes",
                        lambda *a: seen.append(a) or False)
    (xs, Bc, Cc, dA, dt), _ = _operands(S=128, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_enabled):
        PM._ssd_chunked(xs, Bc, Cc, dA, dt, 64)
    assert seen == [("cpu", torch.bfloat16, 64, P, N, records)]


def test_operands_of_two_dtypes_reach_the_predicate_as_no_dtype(monkeypatch):
    seen = []
    monkeypatch.setattr(PM, "k6_takes", lambda *a: seen.append(a) or False)
    (xs, Bc, Cc, dA, dt), _ = _operands(S=128)
    PM._ssd_chunked(xs, Bc.half(), Cc.half(), dA, dt, 256)
    assert seen == [("cpu", None, 128, P, N, False)]


@pytest.mark.parametrize("take", [False, True], ids=["eager", "k6"])
def test_each_call_is_one_ssd_block_and_k6_calls_only_on_the_route(
        monkeypatch, take):
    (xs, Bc, Cc, dA, dt), _ = _operands(S=128)
    if take:
        _forced(monkeypatch)
    blocks, calls = _count("ssd.block"), _count("k6.call")
    for _ in range(3):
        PM._ssd_chunked(xs, Bc, Cc, dA, dt, 64)
    assert _count("ssd.block") - blocks == 3
    assert _count("k6.call") - calls == (3 if take else 0)


def _chunk_operands(B=1, nc=2, Q=64, H=2, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(9)
    scores = torch.randn(B, nc, Q, Q, generator=g).to(dtype)
    seg = -torch.rand(B, nc, H, Q, generator=g).cumsum(-1)
    x = torch.randn(B, nc, Q, H, P, generator=g).to(dtype)
    bc = torch.randn(B, nc * Q, 2 * N, generator=g).to(dtype)
    C = bc[..., N:].reshape(B, nc, Q, N)
    S_exc = torch.randn(B, nc, H, P, N, generator=g)
    return [scores, seg, x, C, S_exc]


def _wide_rows(C, ld):
    """C's values in rows ``ld`` elements apart."""
    wide = torch.zeros(C.shape[:-1] + (ld,), dtype=C.dtype)
    wide[..., :C.shape[-1]] = C
    return wide[..., :C.shape[-1]]


BAD = {
    "scores_shape": lambda o: [o[0][..., :32]] + o[1:],
    "seg_heads": lambda o: [o[0], o[1][:, :, :1]] + o[2:],
    "x_rank": lambda o: [o[0], o[1], o[2][0]] + o[3:],
    "head_dim_32": lambda o: [o[0], o[1], o[2][..., :32], o[3],
                              o[4][:, :, :, :32]],
    "state_64": lambda o: [o[0], o[1], o[2], o[3][..., :64],
                           o[4][..., :64].contiguous()],
    "float32_model": lambda o: [o[0].float(), o[1], o[2].float(),
                                o[3].float(), o[4]],
    "mixed_types": lambda o: [o[0], o[1], o[2], o[3].half(), o[4]],
    "seg_float64": lambda o: [o[0], o[1].double()] + o[2:],
    "state_bf16": lambda o: o[:4] + [o[4].bfloat16()],
    "two_devices": lambda o: [o[0], o[1].to("meta")] + o[2:],
    "x_strided": lambda o: [o[0], o[1], o[2].transpose(3, 2).contiguous()
                            .transpose(3, 2)] + o[3:],
    "scores_strided": lambda o: [o[0].transpose(2, 3)] + o[1:],
    "C_columns_strided": lambda o: o[:3] + [o[3].transpose(2, 3).contiguous()
                                            .transpose(2, 3)] + o[4:],
    "C_rows_by_12": lambda o: o[:3] + [_wide_rows(o[3], N + 12)] + o[4:],
}


@pytest.mark.parametrize("bad", list(BAD), ids=list(BAD))
def test_the_wrapper_refuses_what_k6_does_not_take(bad):
    with pytest.raises(ValueError):
        K6.chunk_out(*BAD[bad](_chunk_operands()))


@pytest.mark.parametrize("Q", [48, 320])
def test_the_wrapper_refuses_chunks_k6_does_not_take(Q):
    ops_ = _chunk_operands(Q=Q, nc=1)
    with pytest.raises(ValueError):
        K6.chunk_out(*ops_)


def test_the_wrapper_takes_wider_rows_of_c_and_runs_the_plain_version():
    o = _chunk_operands()
    launches, calls = K6.launches, _count("k6.call")
    got = K6.chunk_out(*o[:3], _wide_rows(o[3], 2 * N + 8), o[4])
    assert torch.equal(got, ref.ref_ssd_chunk_out(*o))
    assert got.shape == o[2].shape and got.dtype == torch.float32
    assert K6.launches == launches and _count("k6.call") - calls == 1


def test_the_public_entry_has_no_gradient():
    o = _chunk_operands()
    o[4].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ops.ssd_chunk_out(*o)
    with torch.no_grad():
        assert ops.ssd_chunk_out(*o).shape == o[2].shape


def test_on_meta_tensors_the_plain_version_gives_the_shape():
    o = [t.to("meta") for t in _chunk_operands(B=2, nc=3, Q=128, H=4)]
    y = K6.chunk_out(*o)
    assert y.device.type == "meta" and y.shape == (2, 3, 128, 4, P)


def test_a_call_is_one_k6_charge_at_k6s_cost():
    o = _chunk_operands(B=2, nc=3, Q=128, H=4)
    with CostMode() as mode:
        K6.chunk_out(*o)
    assert [c.kind for c in mode.charges] == ["k6"]
    bc, Q, H = 6, 128, 4
    want = kernel_cost("k6", batch=2, chunks=3, chunk=Q, heads=H, head_dim=P,
                       state=N, dtype=torch.bfloat16)
    assert mode.cost.flops == want.flops == 2 * bc * H * P * (Q * (Q + 1) // 2 + Q * N)
    assert want.bytes == (2 * bc * (Q * Q + Q * H * P + Q * N)
                          + 4 * bc * H * (Q + P * N) + 4 * bc * Q * H * P)


def _constants() -> dict:
    src = (Path(K6.__file__).parent / "csrc" / "ssd_chunk.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("wrapper, source", [
    ("HEAD_DIM", "HEAD_DIM"), ("STATE", "STATE"), ("CHUNK_ROWS", "ROWS"),
    ("MAX_CHUNK", "MAX_CHUNK")])
def test_the_wrapper_mirrors_the_sources_widths(wrapper, source):
    assert getattr(K6, wrapper) == _constants()[source]
