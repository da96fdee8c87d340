"""Parity of the port's model families with the JAX reference, arch by
arch.

Pairs: ``repro_torch.models.{transformer,encdec,model}`` vs
``repro.models.{transformer,encdec,model}``, and
``repro_torch.interop.model_params_from_numpy``. Both run in float32 on the
reduced configurations, on the same inputs drawn from a numpy seed, with
the reference's weights (``init`` from ``jax.random.key(0)``) carried into
the port's module. Tolerance: logits, caches and losses to 1e-4 of the
largest magnitude (``_close``). The layer-level functions are in
``test_torch_model_layers.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as rget
from repro.models import build_model as rbuild
from repro.models import transformer as RT

from repro_torch.configs import get_config as pget
from repro_torch.core.trees import tree_map
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import build_model as pbuild
from repro_torch.models import input_specs
from repro_torch.models import transformer as PT

from torch_model_helpers import (  # noqa: F401  (fixtures)
    _batch, _close, _first, _one_thread, _pair, untied_router,
)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_the_reference(arch, untied_router):
    rc, pc, params, module = _pair(arch)
    rb, pb = _batch(rc, 2, 32)
    want = _first(rbuild(rc).forward(params, rb))
    got = _first(pbuild(pc).forward(module, pb))
    assert got.shape == (2, 32, pc.padded_vocab)
    _close(got, want, what=f"{arch} logits")


def _place_ref(full, cache):
    def place(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return jnp.pad(src.astype(dst.dtype),
                       [(0, d - s) for d, s in zip(dst.shape, src.shape)])
    return jax.tree.map(place, full, cache)


def _place_port(full, cache):
    def place(dst, src):
        if dst.shape == src.shape:
            return src.to(dst.dtype)
        pads = []
        for d, s in reversed(list(zip(dst.shape, src.shape))):
            pads += [0, d - s]
        return torch.nn.functional.pad(src.to(dst.dtype), pads)
    return tree_map(place, full, cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_match_the_reference(arch, untied_router):
    rc, pc, params, module = _pair(arch)
    rapi, papi = rbuild(rc), pbuild(pc)
    B, S = 2, 32
    rb, pb = _batch(rc, B, S, seed=1)
    r_last, r_cache = rapi.prefill(params, rb)
    p_last, p_cache = papi.prefill(module, pb)
    _close(p_last, r_last, what=f"{arch} prefill logits")
    jax.tree.map(lambda w, g: _close(g, w, what=f"{arch} prefill cache"),
                 r_cache, p_cache)
    r_cache = _place_ref(rapi.init_cache(B, S + 8), r_cache)
    p_cache = _place_port(papi.init_cache(B, S + 8, device="cpu"), p_cache)
    tok = np.asarray(jnp.argmax(r_last[:, -1:], -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(p_last[:, -1:], -1).numpy(), tok)
    kept = tree_map(torch.clone, p_cache)
    r_next, r_new = rapi.decode_step(params, jnp.asarray(tok), r_cache,
                                     jnp.array(S, jnp.int32))
    p_next, p_new = papi.decode_step(module, torch.from_numpy(tok), p_cache, S)
    assert p_next.dtype == torch.int32 and p_next.shape == (B, 1)
    assert np.array_equal(p_next.numpy(), np.asarray(r_next))
    jax.tree.map(lambda w, g: _close(g, w, what=f"{arch} decode cache"),
                 r_new, p_new)
    # the cache handed in is not written
    tree_map(lambda a, b: None if torch.equal(a, b) else 1 / 0, kept, p_cache)


def test_decode_matches_forward_logits():
    """Greedy decode continuation equals the full-forward argmax path (the
    reference's test of the same name, on the port)."""
    cfg = pget("smollm_360m").reduced()
    api = pbuild(cfg)
    module = api.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    B, S = 1, 16
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32))
    last_logits, cache = api.prefill(module, {"tokens": toks})
    t1 = int(torch.argmax(last_logits[0, -1]))
    cache = _place_port(api.init_cache(B, S + 4, device="cpu"), cache)
    t2, _ = api.decode_step(module, torch.tensor([[t1]], dtype=torch.int32), cache, S)
    logits, _ = PT.lm_forward(module, torch.cat([toks, torch.tensor([[t1]],
                                                                    dtype=torch.int32)], 1), cfg)
    assert int(t2[0, 0]) == int(torch.argmax(logits[0, -1]))


def test_gemma_local_global_pattern_differs():
    """Sliding-window flags must actually change the computation (the
    reference's test of the same name, on the port)."""
    cfg = pget("gemma3_27b").reduced()
    cfg_nw = dataclasses.replace(cfg, sliding_window=0, local_global_ratio=0)
    module = pbuild(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)).astype(np.int32))
    la, _ = PT.lm_forward(module, toks, cfg)
    lb, _ = PT.lm_forward(module, toks, cfg_nw)
    assert not torch.allclose(la, lb)
    assert PT._layer_flags(cfg).tolist() == np.asarray(RT._layer_flags(rget("gemma3_27b").reduced())).tolist()
    assert [PT._window_for(cfg, f) for f in (0, 1)] == [cfg.sliding_window, 0]


def test_converter_names_a_misshapen_missing_or_extra_leaf():
    rc, pc, params, _ = _pair("smollm_360m")
    pnp = jax.tree.map(np.asarray, params)

    def edited(fn):
        tree = jax.tree.map(lambda a: a, pnp)
        fn(tree)
        return tree

    bad = edited(lambda t: t["blocks"]["attn"].__setitem__(
        "wq", t["blocks"]["attn"]["wq"][..., :-1]))
    with pytest.raises(ValueError, match="blocks/attn/wq"):
        model_params_from_numpy(bad, pc, "cpu")
    with pytest.raises(ValueError, match="embed"):
        model_params_from_numpy(edited(lambda t: t.pop("embed")), pc, "cpu")
    with pytest.raises(ValueError, match="blocks/mlp/w_extra"):
        model_params_from_numpy(edited(lambda t: t["blocks"]["mlp"].__setitem__(
            "w_extra", t["blocks"]["mlp"]["w_in"])), pc, "cpu")
    with pytest.raises(ValueError, match="final_norm/scale"):
        model_params_from_numpy(edited(lambda t: t["final_norm"].__setitem__(
            "scale", t["final_norm"]["scale"].astype(np.float16))), pc, "cpu")
    # one layer too many is a leaf the module has no parameter for
    with pytest.raises(ValueError, match="blocks/norm1/scale"):
        model_params_from_numpy(edited(lambda t: t["blocks"]["norm1"].__setitem__(
            "scale", np.concatenate([t["blocks"]["norm1"]["scale"]] * 2))), pc, "cpu")
    # the hybrid family's periods split per period, sublayers by name
    _, jc, jparams, jmod = _pair("jamba_v01_52b")
    assert "periods.0.sub_1.moe.router" in jmod.state_dict()
    assert "periods.0.sub_0.attn.wq" in jmod.state_dict()


def test_input_specs_and_param_shapes_are_meta():
    cfg = pget("jamba_v01_52b")          # full width: nothing is allocated
    api = pbuild(cfg)
    shapes = api.param_shapes()
    assert sum(int(np.prod(s)) for s in shapes.values()) > 5e10
    from repro_torch.configs import SHAPES
    specs = input_specs(cfg, SHAPES["decode_32k"])
    leaves = [specs["token"], specs["cache_len"], *jax.tree.leaves(
        tree_map(lambda t: np.zeros(0), specs["cache"]))]
    assert specs["token"].device.type == "meta"
    assert specs["cache"]["k"].shape == (4, 128, 32768, 8, 128)
    assert specs["cache"]["mamba"]["ssm"].shape == (4, 7, 128, 128, 64, 16)
    assert len(leaves) == 7
    train = input_specs(pget("qwen2_vl_7b"), SHAPES["train_4k"])
    assert sorted(train) == ["labels", "positions3", "tokens", "vision_embeds"]
    assert all(t.device.type == "meta" for t in train.values())


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_large_v3"])
def test_loss_value_matches_the_reference(arch, untied_router):
    """``lm_loss`` (an MoE family, with its aux terms) and ``encdec_loss``,
    forward value only, with masked labels."""
    rc, pc, params, module = _pair(arch)
    rb, pb = _batch(rc, 2, 16, seed=11)
    labels = np.random.default_rng(12).integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    rb["labels"], pb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    want, wm = rbuild(rc).loss(params, rb)
    got, gm = pbuild(pc).loss(module, pb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key, value in wm.items():
        np.testing.assert_allclose(float(gm[key]), float(value), rtol=1e-5, atol=1e-7)
