"""Parity of the port's model layers with the JAX reference.

Pairs: ``repro_torch.models.{layers,mamba,moe}`` vs
``repro.models.{layers,mamba,moe}``: ``_ssd_chunked`` with and without
``state_in`` (its segment scan also against the reference's Pallas kernel
in interpret mode), the Mamba mixer and ``mamba_decode``, the blocked
``flash_attention`` with windows, offsets and ``attn_probs_bf16``,
``decode_attention``, ``_expert_ffn``, and a bf16 Whisper on float32 frames
(at 2e-2). Float32 otherwise, inputs from a numpy
seed, the reference's reduced weights carried into the port. Tolerances:
1e-4 of the largest magnitude (``_close``); flash attention 1e-4 relative
plus 1e-5 absolute; the segment scan 1e-5 relative plus 1e-6 absolute.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import perf_flags as rflags
from repro.kernels.prefix_scan import prefix_scan_pallas
from repro.models import layers as RL
from repro.models import mamba as RM

from repro_torch import perf_flags as pflags
from repro_torch.models import layers as PL
from repro_torch.models import mamba as PM

from torch_model_helpers import (  # noqa: F401  (fixtures)
    _close, _one_thread, _pair, _rand, _ssd_inputs, _t,
)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 64])   # four chunks; one
def test_ssd_chunked_matches_the_reference(with_state, chunk):
    rng = np.random.default_rng(3)
    xs, Bc, Cc, dA, dt = _ssd_inputs(rng)
    state = None
    if with_state:
        state = (np.exp(-np.abs(_rand(rng, 2, 4))).astype(np.float32),
                 _rand(rng, 2, 4, 8, 6))
    ref = jax.jit(RM._ssd_chunked, static_argnums=5)
    want = ref(*map(jnp.asarray, (xs, Bc, Cc, dA, dt)), chunk,
               state_in=None if state is None else tuple(map(jnp.asarray, state)))
    got = PM._ssd_chunked(*map(_t, (xs, Bc, Cc, dA, dt)), chunk,
                          state_in=None if state is None else tuple(map(_t, state)))
    _close(got[0], want[0], what="y")
    _close(got[1][0], want[1][0], what="A_tot")
    _close(got[1][1], want[1][1], what="S_tot")
    for g, w in zip(got[2], want[2]):
        _close(g, w, what="extras")


def test_segment_scan_matches_the_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(4)
    B, nc, Q, H = 2, 3, 16, 4
    dAc = -np.abs(_rand(rng, B, nc, Q, H, scale=0.3))
    flat = jnp.moveaxis(jnp.asarray(dAc), 2, 3).reshape(-1, Q)
    want = prefix_scan_pallas(flat, op="add", interpret=True)
    want = jnp.moveaxis(want.reshape(B, nc, H, Q), 3, 2)
    got = PM._segment_scan(_t(dAc))
    assert got.dtype == torch.float32 and got.is_contiguous() is False
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_segment_scan_hands_the_scan_contiguous_rows(monkeypatch):
    """``_ssd_chunked``'s segment scan moves the chunk axis last, a strided
    view; the rows that reach K3's wrapper are a contiguous copy."""
    import importlib

    k3 = importlib.import_module("repro_torch.kernels.prefix_scan")
    seen = []
    scan_rows = k3.scan_rows

    def recording(x, **kw):
        seen.append(x)
        return scan_rows(x, **kw)

    monkeypatch.setattr(k3, "scan_rows", recording)
    rng = np.random.default_rng(10)
    B, nc, Q, H = 2, 3, 16, 4
    dAc = _t(-np.abs(_rand(rng, B, nc, Q, H)))
    PM._segment_scan(dAc)
    (rows,) = seen
    assert rows.shape == (B * nc * H, Q) and rows.is_contiguous()
    assert torch.equal(rows, torch.movedim(dAc, 2, 3).reshape(-1, Q))


def test_ssd_chunked_raises_where_the_reference_asserts():
    rng = np.random.default_rng(5)
    xs, Bc, Cc, dA, dt = _ssd_inputs(rng, S=21)
    with pytest.raises(AssertionError):
        RM._ssd_chunked(*map(jnp.asarray, (xs, Bc, Cc, dA, dt)), 16)
    with pytest.raises(ValueError, match=r"\(21, 16\)"):
        PM._ssd_chunked(*map(_t, (xs, Bc, Cc, dA, dt)), 16)
    # a prompt no longer than a chunk is one chunk of its own length
    xs, Bc, Cc, dA, dt = _ssd_inputs(rng, S=13)
    want = jax.jit(RM._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (xs, Bc, Cc, dA, dt)), 16)
    _close(PM._ssd_chunked(*map(_t, (xs, Bc, Cc, dA, dt)), 16)[0], want[0])


def _mamba_pair():
    rc, pc, params, module = _pair("mamba2_130m")
    rp = jax.tree.map(lambda a: a[0], params["blocks"]["mamba"])
    return rc, pc, rp, module.blocks[0].mamba


def test_mamba_mixer_and_decode_match_the_reference():
    rc, pc, rp, pp = _mamba_pair()
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 32, rc.d_model)
    ry, rcache = jax.jit(lambda p, x: RM.mamba_mixer(p, x, rc))(rp, jnp.asarray(x))
    py, pcache = PM.mamba_mixer(pp, _t(x), pc)
    _close(py, ry, what="mixer y")
    for key in ("ssm", "conv_x", "conv_bc"):
        _close(pcache[key], rcache[key], what=key)
    state = {k: _rand(rng, *np.shape(v)) for k, v in rcache.items()}
    decode = jax.jit(lambda p, x, st: RM.mamba_decode(p, x, st, rc))
    for step in range(2):
        xt = _rand(rng, 2, 1, rc.d_model)
        r_out, r_state = decode(rp, jnp.asarray(xt), jax.tree.map(jnp.asarray, state))
        p_in = {k: _t(v) for k, v in state.items()}
        kept = {k: v.clone() for k, v in p_in.items()}
        p_out, p_state = PM.mamba_decode(pp, _t(xt), p_in, pc)
        assert all(torch.equal(kept[k], p_in[k]) for k in kept)
        _close(p_out, r_out, what=f"decode out {step}")
        for k in state:
            _close(p_state[k], r_state[k], what=f"decode {k} {step}")
        state = {k: np.asarray(v) for k, v in r_state.items()}


def test_mamba_decode_continues_the_prefill():
    """One decode step from the prefill's state equals the mixer over the
    sequence one token longer, in the port as in the reference."""
    rc, pc, rp, pp = _mamba_pair()
    rng = np.random.default_rng(7)
    x = _t(_rand(rng, 1, 9, rc.d_model))
    full, _ = PM.mamba_mixer(pp, x, pc)
    _, cache = PM.mamba_mixer(pp, x[:, :8], pc)
    step, _ = PM.mamba_decode(pp, x[:, 8:], cache, pc)
    _close(step[:, 0], full[:, 8].numpy(), rel=1e-4)


@pytest.mark.parametrize("case", [
    dict(causal=True, window=0, q_offset=0, q_block=8, kv_block=8),
    dict(causal=True, window=5, q_offset=0, q_block=8, kv_block=16),
    dict(causal=False, window=0, q_offset=0, q_block=16, kv_block=8),
    dict(causal=False, window=7, q_offset=3, q_block=16, kv_block=16),
    dict(causal=True, window=0, q_offset=12, q_block=1024, kv_block=1024),
    dict(causal=True, window=0, q_offset=-6, q_block=8, kv_block=8),
])
@pytest.mark.parametrize("probs_bf16", [False, True])
def test_flash_attention_matches_the_reference(case, probs_bf16):
    rng = np.random.default_rng(8)
    q, k, v = _rand(rng, 2, 21, 4, 8), _rand(rng, 2, 27, 2, 8), _rand(rng, 2, 27, 2, 8)
    saved = rflags.FLAGS, pflags.FLAGS
    try:
        rflags.set_flags(attn_probs_bf16=probs_bf16)
        pflags.set_flags(attn_probs_bf16=probs_bf16)
        want = jax.jit(functools.partial(RL.flash_attention, **case))(
            *map(jnp.asarray, (q, k, v)))
        got = PL.flash_attention(*map(_t, (q, k, v)), **case)
    finally:
        rflags.FLAGS, pflags.FLAGS = saved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window,cache_len", [(0, 0), (0, 9), (4, 9), (3, 15), (0, 40)])
def test_decode_attention_matches_the_reference(window, cache_len):
    rc, pc, params, module = _pair("qwen25_14b")   # GQA with qkv biases
    rp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    pp = copy.deepcopy(module.blocks[0].attn)
    for name in ("bq", "bk", "bv"):       # the init's biases are zero
        rp[name] = rp[name] + 0.1
        getattr(pp, name).data += 0.1
    rng = np.random.default_rng(9)
    hd = rc.resolved_head_dim
    x = _rand(rng, 2, 1, rc.d_model)
    kc, vc = _rand(rng, 2, 16, rc.num_kv_heads, hd), _rand(rng, 2, 16, rc.num_kv_heads, hd)
    ro, rk, rv = jax.jit(lambda *a: RL.decode_attention(*a, rc, window=window))(
        rp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.array(cache_len, jnp.int32))
    pk, pv = _t(kc), _t(vc)
    po, nk, nv = PL.decode_attention(pp, _t(x), pk, pv, cache_len, pc, window=window)
    _close(po, ro, what="out")
    _close(nk, rk, what="k cache")
    _close(nv, rv, what="v cache")
    assert np.array_equal(pk.numpy(), kc) and np.array_equal(pv.numpy(), vc)


def test_expert_ffn_matches_the_reference():
    from repro.models import moe as RMOE
    from repro_torch.models import moe as PMOE

    rc, pc, params, module = _pair("olmoe_1b_7b")
    rp = {k: params["blocks"]["moe"][k][0] for k in ("w_in", "w_gate", "w_out")}
    x = _rand(np.random.default_rng(13), rc.moe_num_experts, 5, rc.d_model)
    want = RMOE._expert_ffn(rp, jnp.asarray(x), rc.act)
    got = PMOE._expert_ffn(module.blocks[0].moe, _t(x), pc.act)
    _close(got, want, what="expert ffn")


def test_bf16_whisper_on_float32_frames_matches_the_reference():
    """A bf16 Whisper given float32 frames: the reference's ``jnp.einsum``
    promotes the bf16 queries against the float32 encoder states, and so
    does the port's blocked flash (it raised before). ``forward`` and
    ``prefill`` against the reference within 2e-2 of the largest logit, the
    bf16 attention tolerance of ``chip_smoke.py`` (``FLASH_TOL``)."""
    import dataclasses

    from repro.configs import get_config as rget
    from repro.models import build_model as rbuild
    from repro_torch.configs import get_config as pget
    from repro_torch.interop import model_params_from_numpy
    from repro_torch.models import build_model as pbuild
    from torch_model_helpers import _batch, _first

    rc = dataclasses.replace(rget("whisper_large_v3").reduced(), dtype="bfloat16")
    pc = dataclasses.replace(pget("whisper_large_v3").reduced(), dtype="bfloat16")
    params = jax.jit(rbuild(rc).init)(jax.random.key(0))
    module = model_params_from_numpy(jax.tree.map(np.asarray, params), pc, "cpu")
    rb, pb = _batch(rc, 2, 32)
    assert pb["frames"].dtype == torch.float32
    want = np.asarray(_first(rbuild(rc).forward(params, rb)), np.float32)
    _close(_first(pbuild(pc).forward(module, pb)), want, rel=2e-2, what="forward")
    want_last, _ = rbuild(rc).prefill(params, rb)
    got_last, _ = pbuild(pc).prefill(module, pb)
    _close(got_last, np.asarray(want_last, np.float32), rel=2e-2, what="prefill")
