"""Sequence-sharded decode attention and decoding under a mesh, against the
reference.

Pairs: ``repro_torch.models.layers.cached_attention(kv_mode="seq")`` (its
region ``seq_sharded_decode_attention_core``) vs the reference's local
``decode_attention`` (in this process) and its
``cached_attention(kv_mode="seq")`` under ``shard_map`` on forced host
devices (a subprocess), over ``(1, 4)`` and ``(2, 2)`` meshes, with and
without a window, and a ``cache_len`` at every shard boundary; and
``repro_torch.models.transformer.lm_prefill`` + ``lm_decode_step`` and
``repro_torch.serving.ServeEngine`` under a ``(1, 4)`` mesh vs the same
model with no mesh. Reduced configs, the reference's weights carried into
the port, float32; tolerance 1e-4 of the largest magnitude (``_close``).
The gloo form of the decode region is held bitwise in
``test_torch_mesh_collectives.py``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import layers as RL

from repro_torch import compat
from repro_torch.core.trees import tree_map
from repro_torch.models import build_model as pbuild
from repro_torch.models import layers as PL
from repro_torch.serving import Request, ServeEngine
from repro_torch.sharding import Topology, make_topology, use_topology

from torch_mesh_helpers import run_reference
from torch_model_helpers import (  # noqa: F401  (fixtures)
    _batch, _close, _one_thread, _pair, _rand, _t, untied_router,
)

S_MAX = 16
#: (mesh, window, cache_len): 4 positions a shard at (1, 4), 8 at (2, 2);
#: cache_len 4, 8 and 12 start a shard, 15 ends the cache
CASES = [(shape, window, clen)
         for shape in ((1, 4), (2, 2))
         for window in (0, 3)
         for clen in (0, 3, 4, 8, 12, 15)]


def _under(shape, fn):
    mesh = compat.Mesh(shape, ("data", "model"), device="cpu")
    with use_topology(make_topology(mesh)):
        return fn()


@pytest.fixture(scope="module")
def attn():
    """Reduced Qwen2.5-14B's first attention layer (GQA, one kv head, qkv
    biases made nonzero), a token and a random cache."""
    rc, pc, params, module = _pair("qwen25_14b")
    rp = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"]["attn"])
    pp = copy.deepcopy(module.blocks[0].attn)
    for name in ("bq", "bk", "bv"):       # the init's biases are zero
        rp[name] = rp[name] + np.float32(0.1)
        getattr(pp, name).data += 0.1
    rng = np.random.default_rng(9)
    hd = rc.resolved_head_dim
    x = _rand(rng, 2, 1, rc.d_model)
    kc = _rand(rng, 2, S_MAX, rc.num_kv_heads, hd)
    vc = _rand(rng, 2, S_MAX, rc.num_kv_heads, hd)
    return rc, pc, rp, pp, x, kc, vc


def _port_seq(attn, shape, window, clen):
    _, pc, _, pp, x, kc, vc = attn
    pk, pv = _t(kc), _t(vc)
    out = _under(shape, lambda: PL.cached_attention(
        pp, _t(x), pk, pv, clen, pc, window=window, kv_mode="seq"))
    # the cache handed in is not written
    assert np.array_equal(pk.numpy(), kc) and np.array_equal(pv.numpy(), vc)
    return out


@pytest.mark.parametrize("shape,window,clen", CASES)
def test_seq_decode_matches_the_reference_local_decode(attn, shape, window,
                                                       clen):
    rc, _, rp, _, x, kc, vc = attn
    want = jax.jit(lambda *a: RL.decode_attention(*a, rc, window=window))(
        rp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.array(clen, jnp.int32))
    got = _port_seq(attn, shape, window, clen)
    for g, w, what in zip(got, want, ("out", "k cache", "v cache")):
        _close(g, w, what=what)


_REF_SEQ = r"""
from repro.configs import get_config
from repro.models.layers import cached_attention

cfg = get_config("qwen25_14b").reduced()
compiled = {}
for shape, window, clen in IN["cases"]:
    with use_topology(make_topology(mesh(shape))):
        if (shape, window) not in compiled:    # cache_len is traced
            compiled[(shape, window)] = jax.jit(
                lambda p, x, kc, vc, clen, window=window: cached_attention(
                    p, x, kc, vc, clen, cfg, window=window, kv_mode="seq"))
        OUT[(shape, window, clen)] = compiled[(shape, window)](
            IN["p"], IN["x"], IN["kc"], IN["vc"], jnp.array(clen, jnp.int32))
"""


@pytest.fixture(scope="module")
def reference_seq(attn, tmp_path_factory):
    _, _, rp, _, x, kc, vc = attn
    return run_reference(_REF_SEQ, {"p": rp, "x": x, "kc": kc, "vc": vc,
                                    "cases": CASES},
                         tmp_path_factory.mktemp("ref_seq"))


@pytest.mark.parametrize("shape,window,clen", CASES)
def test_seq_decode_matches_the_reference_seq_decode(attn, reference_seq,
                                                     shape, window, clen):
    got = _port_seq(attn, shape, window, clen)
    for g, w, what in zip(got, reference_seq[(shape, window, clen)],
                          ("out", "k cache", "v cache")):
        _close(g, w, what=what)


def test_decode_kv_mode_follows_the_kv_heads():
    """'seq' when the kv heads do not divide the model axis (SmolLM-360M's
    5 on 4), 'heads' when they do, 'local' off-mesh."""
    from repro_torch.configs import get_config

    smollm, gemma = get_config("smollm-360m"), get_config("gemma3_27b").reduced()
    assert PL.decode_kv_mode(smollm) == "local"
    assert _under((1, 4), lambda: PL.decode_kv_mode(smollm)) == "seq"
    assert _under((2, 2), lambda: PL.decode_kv_mode(gemma)) == "heads"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_under_a_mesh_match_no_mesh(arch, untied_router):
    _, pc, _, module = _pair(arch)
    pc = dataclasses.replace(pc, capacity_factor=8.0)   # no EP drops
    api = pbuild(pc)
    B, S = 4, 32
    _, pb = _batch(pc, B, S, seed=11)

    def run():
        last, cache = api.prefill(module, pb)
        full = api.init_cache(B, S + 8, device="cpu")
        cache = tree_map(
            lambda d, s: torch.nn.functional.pad(
                s.to(d.dtype), [p for a, b in reversed(list(zip(d.shape, s.shape)))
                                for p in (0, a - b)]),
            full, cache)
        tok = torch.argmax(last[:, -1:], -1).to(torch.int32)
        nxt, new = api.decode_step(module, tok, cache, S)
        return last, nxt, new

    want = run()
    got = _under((1, 4), run)
    _close(got[0], want[0].numpy(), what=f"{arch} prefill")
    assert torch.equal(got[1], want[1])
    tree_map(lambda g, w: _close(g, w.numpy(), what=f"{arch} cache"),
             got[2], want[2])


def test_serve_engine_under_a_mesh_serves_the_unmeshed_tokens():
    """Reduced SmolLM-360M through ServeEngine(4, 64) under a co-resident
    (1, 4) mesh: its decode takes kv_mode 'seq' (16 cache positions a
    shard), and every request gets the unmeshed engine's tokens."""
    _, cfg, _, module = _pair("smollm_360m")
    api = pbuild(cfg)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 17, size=6)]

    def serve(topo):
        eng = ServeEngine(api, module, topo, batch_size=4, max_len=64,
                          device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.generated for r in reqs]

    want = serve(Topology(mesh=None))
    mesh = compat.Mesh((1, 4), ("data", "model"), device="cpu")
    assert serve(make_topology(mesh)) == want
