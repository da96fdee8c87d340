"""Granite-4.0-H-Small on the port: the dropless routed MoE against the
dense path, a reduced Granite stage against the benchmark's plain float32
reference (``portbench/reference/granite_hybrid.py``), prefill and then
decode through the cache, the configuration's parameter counts, and
Jamba's hybrid layout left as it was.

The card tests (``-m card``, skip without CUDA) run the routed path under
``torch.cuda.set_sync_debug_mode("error")`` and count the ``moe.*`` spans
and series after one prefill. This file imports no JAX.
"""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.families import granite_hybrid as family  # noqa: E402
from portbench.reference import granite_hybrid as ref  # noqa: E402

#: float32 on both sides: the routed path sums each token's k picks and
#: the dense one contracts over every expert, so the two
#: differ by float32 rounding alone (a few ulps of the largest output)
MOE_REL = 1e-5
#: float32 program against the float32 reference: their chunked SSDs,
#: attention blocks and expert sums associate differently; 1e-4 of the
#: largest value is float32 rounding through ten layers, and a missing or
#: wrong term (a multiplier, an eps, a dropped pick) moves them by 1e-2 or more
STAGE_REL = 1e-4

#: a Granite stage small enough for the CPU: one period of 10 layers,
#: attention at index 5, every mechanism of the full one kept
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
        "mamba_chunk_size": 16, "num_local_experts": 8, "num_experts_per_tok": 3,
        "intermediate_size": 32, "shared_intermediate_size": 64, "vocab_size": 500,
        "dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


def tiny_file():
    import json

    c = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json").read_text())
    return {**c, **TINY}


# ---------------------------------------------------------------------------
# the routed MoE
# ---------------------------------------------------------------------------


def _moe(bias=None, seed=0):
    cfg = get_config("granite-4.0-h-small").reduced()
    p = MOE.MoE(torch.Generator().manual_seed(seed), cfg, torch.float32, "cpu")
    if bias is not None:
        # the inputs' feature 0 is one (below): this row adds to the logits
        p.router.data[0] = bias
    return cfg, p


def _biases(E):
    one = torch.zeros(E)
    one[3] = 8.0                          # expert 3 in nearly every token's top-k
    none = torch.zeros(E)
    none[[0, 5, 6]] = -8.0                # experts 0, 5, 6 take no pick
    return {"balanced": None, "one_expert_most": one, "experts_without_picks": none}


@pytest.mark.parametrize("case", ["balanced", "one_expert_most", "experts_without_picks"])
def test_routed_moe_matches_the_dense_path(case, monkeypatch):
    cfg, p = _moe(_biases(8)[case])
    x = torch.randn(2, 48, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x[..., 0] = 1.0
    scans = []
    scan = MOE.prefix_scan

    def recorded(t, **kw):
        scans.append((t.clone(), kw))
        return scan(t, **kw)

    monkeypatch.setattr(MOE, "prefix_scan", recorded)
    got, gaux = MOE._routed_moe(p, x, cfg, "silu")
    want, waux = MOE._dense_moe(p, x, cfg, "silu")
    _close(got, want, MOE_REL, case)
    for k in waux:
        assert torch.allclose(gaux[k], waux[k], rtol=1e-6), k
    # one K3 call a block: the exclusive scan of the per-expert counts,
    # which hold every pick (none dropped)
    assert len(scans) == 1
    counts, kw = scans[0]
    assert kw == {"op": "add", "exclusive": True}
    assert counts.dtype == torch.int32 and counts.shape == (cfg.moe_num_experts,)
    assert int(counts.sum()) == x.shape[0] * x.shape[1] * cfg.moe_top_k
    if case == "one_expert_most":
        assert int(counts[3]) == x.shape[0] * x.shape[1]
    if case == "experts_without_picks":
        assert counts[[0, 5, 6]].tolist() == [0, 0, 0]


def test_routed_moe_is_chosen_by_the_configuration():
    cfg, p = _moe()
    x = torch.randn(1, 16, cfg.d_model)
    before = obs_tracing.span_totals().get("moe.block", (0, 0))[0]
    MOE.moe_block(p, x, cfg)
    assert obs_tracing.span_totals()["moe.block"][0] == before + 1
    # a property of the configuration's class, not a setting of an instance
    assert "moe_routed" not in {f.name for f in dataclasses.fields(cfg)}
    # OLMoE, DeepSeek-MoE and Jamba keep the dense path
    for arch in ("olmoe_1b_7b", "deepseek_moe_16b", "jamba_v01_52b"):
        other = get_config(arch).reduced()
        assert not getattr(other, "moe_routed", False)
        q = MOE.MoE(torch.Generator().manual_seed(0), other, torch.float32, "cpu")
        MOE.moe_block(q, torch.randn(1, 16, other.d_model), other)
        assert obs_tracing.span_totals()["moe.block"][0] == before + 1, arch


def test_moe_spans_nest_and_series_publish():
    cfg, p = _moe()
    x = torch.randn(2, 16, cfg.d_model)
    with obs_tracing.tracing() as tracer:
        MOE._routed_moe(p, x, cfg, "silu")
    spans = {s.name: s for s in tracer.spans()}
    block = spans["moe.block"]
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert spans[name].parent_id == block.span_id
    assert spans["k3.call"].parent_id == spans["moe.route"].span_id
    reg = obs_metrics.get_registry()
    picks = reg.counter("repro_moe_picks_total", "expert picks routed by the routed MoE")
    before = picks.value()
    MOE._routed_moe(p, x, cfg, "silu")
    assert picks.value() == before + 2 * 16 * cfg.moe_top_k
    text = obs_metrics.render_prometheus()
    assert "repro_moe_expert_picks_max" in text
    gauge = reg.metrics()["repro_moe_expert_picks_max"].collect()[()]
    assert 2 * 16 * cfg.moe_top_k / cfg.moe_num_experts <= gauge <= 2 * 16


# ---------------------------------------------------------------------------
# a reduced Granite stage against the plain reference
# ---------------------------------------------------------------------------


def _stage(seed=7):
    c = tiny_file()
    weights = ref.make_weights(c, seed, "cpu")
    api, model = family.load_program(c, weights)
    return c, api, model, weights


def test_stage_prefill_matches_the_reference():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.sharding.specs import Topology

    c, api, model, weights = _stage()
    B, S = 2, 64
    tokens = torch.randint(0, c["vocab_size"], (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    step, _, _ = build_prefill_step(api, Topology(mesh=None), ShapeConfig("t", S, B, "prefill"))
    last, caches = step(model, {"tokens": tokens})
    want_last, want = ref.prefill(weights, tokens, c, rows=1)
    _close(last.reshape(want_last.shape), want_last, STAGE_REL, "logits")
    m = caches["mamba"]
    assert caches["k"].shape == (1, B, S, 2, 16)
    assert m["ssm"].shape == (1, 9, B, 8, 16, 16)
    for name in ("ssm", "conv_x", "conv_bc"):
        _close(m[name].reshape(want[name].shape), want[name], STAGE_REL, name)
    _close(caches["k"], want["k"], STAGE_REL, "k")
    _close(caches["v"], want["v"], STAGE_REL, "v")


def test_stage_decodes_through_the_cache(monkeypatch):
    """Prefill 32 tokens, then 4 decode steps fed the next tokens of a fixed
    sequence; each step's logits against the reference's full forward over
    the sequence so far (its last position)."""
    c, api, model, weights = _stage(seed=11)
    B, S, steps = 2, 32, 4
    seq = torch.randint(0, c["vocab_size"], (B, S + steps), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(5))
    seen = []
    greedy = T._greedy

    def keep(logits):
        seen.append(logits[:, -1].clone())
        return greedy(logits)

    monkeypatch.setattr(T, "_greedy", keep)
    with torch.inference_mode():
        _, pre = api.prefill(model, {"tokens": seq[:, :S]})
        cache = api.init_cache(B, S + steps, device="cpu")
        cache["k"][:, :, :S] = pre["k"]
        cache["v"][:, :, :S] = pre["v"]
        cache["mamba"] = pre["mamba"]
        for j in range(steps):
            _, cache = api.decode_step(model, seq[:, S + j:S + j + 1], cache, S + j)
    assert len(seen) == steps
    for j in range(steps):
        want, _ = ref.prefill(weights, seq[:, :S + j + 1], c, rows=B)
        _close(seen[j], want, STAGE_REL, f"decode step {j}")


def test_stage_multipliers_each_matter():
    """Each of the configuration's settings moves the logits by ten times
    the stage's tolerance or more: the comparison above sees every one."""
    from repro_torch.models import layers as L

    c, api, model, weights = _stage()
    tokens = torch.randint(0, c["vocab_size"], (1, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(9))
    want, _ = ref.prefill(weights, tokens, c, rows=1)
    cfg = api.cfg
    for change in ({"embedding_multiplier": 1.0}, {"residual_multiplier": 1.0},
                   {"attention_multiplier": None}, {"logits_scaling": 1.0},
                   {"norm_eps": 1.0}, {"moe_top_k": 2}):
        other = dataclasses.replace(cfg, **change)
        with torch.inference_mode():
            got, _ = T.lm_prefill(model, tokens, other)
        err = float((got.reshape(want.shape) - want).abs().max())
        assert err > 10 * STAGE_REL * float(want.abs().max()), change
    assert L.attention_scale(cfg, 16) == 0.0078125
    assert L.attention_scale(get_config("olmoe_1b_7b"), 128) == 1 / math.sqrt(128)


# ---------------------------------------------------------------------------
# layouts and counts
# ---------------------------------------------------------------------------


def test_granite_layout_and_names():
    cfg = get_config("granite-4.0-h-small")
    layout = T.hybrid_layout(cfg)
    assert [k for k, _ in layout] == ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    assert all(moe for _, moe in layout)
    names = build_model(cfg).param_shapes()
    assert names["periods.3.sub_5.attn.wq"] == (4096, 32, 128)
    assert names["periods.0.sub_0.moe.w_in"] == (72, 4096, 768)
    assert names["periods.0.sub_9.moe.shared.w_in"] == (4096, 1536)
    assert not any(".mlp." in k for k in names)
    bad = dataclasses.replace(cfg, layer_types=cfg.layer_types[:39] + ("attention",))
    with pytest.raises(ValueError, match="layer_types"):
        T.hybrid_layout(bad)


def test_jamba_layout_and_names_unchanged():
    cfg = get_config("jamba_v01_52b")
    assert T.hybrid_layout(cfg) == tuple(
        ("attn" if i == 0 else "mamba", i % 2 == 1) for i in range(8))
    names = build_model(cfg.reduced()).param_shapes()
    kinds = {}
    for key in names:
        parts = key.split(".")
        if parts[0] == "periods":
            kinds.setdefault(parts[2], set()).add(parts[3])
    assert kinds == {"sub_0": {"norm1", "attn", "norm2", "mlp"},
                     "sub_1": {"norm1", "mamba", "norm2", "moe"},
                     "sub_2": {"norm1", "mamba", "norm2", "mlp"},
                     "sub_3": {"norm1", "mamba", "norm2", "moe"}}
    assert not hasattr(cfg, "layer_types")


def test_full_configuration_counts():
    from repro_torch.roofline.analysis import model_flops

    cfg = get_config("granite-4.0-h-small")
    assert type(cfg).__name__ == "GraniteHybridConfig"
    assert cfg.param_count() == 32_207_337_984          # 32.20e9 by the widths
    assert cfg.active_param_count() == 8_803_121_664    # 8.80e9: top-10 of 72
    shapes = build_model(cfg).param_shapes()            # on meta: nothing allocated
    assert sum(math.prod(s) for s in shapes.values()) == cfg.param_count()
    stage = dataclasses.replace(cfg, num_layers=10, layer_types=cfg.layer_types[:10])
    assert stage.param_count() == 8_360_118_912         # the benchmark's stage
    shape = SHAPES["prefill_32k"]
    tokens = shape.global_batch * shape.seq_len
    assert model_flops(cfg, shape, "prefill") == pytest.approx(2 * 8_803_121_664 * tokens)
    assert model_flops(cfg, SHAPES["train_4k"], "train") == pytest.approx(
        6 * 8_803_121_664 * 256 * 4096)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_routed_moe_makes_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync check is CUDA's")
    cfg = get_config("granite-4.0-h-small")
    p = MOE.MoE(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cuda")
    x = torch.randn(1, 2048, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        MOE._routed_moe(p, x, cfg, "silu")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = MOE._routed_moe(p, x, cfg, "silu")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, _ = MOE._dense_moe(p, x[:, :128], cfg, "silu")
    # bf16 on both sides, rounded at different points: 2% of the largest
    _close(out[:, :128], want, 2e-2, "routed vs dense on the card")


@pytest.mark.card
def test_moe_spans_and_series_after_one_prefill():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prefill runs there")
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.sharding.specs import Topology

    c = {**tiny_file(), "dtype": "bfloat16"}
    api, model = family.load_program(c, ref.make_weights(c, 3, "cuda"))
    step, _, _ = build_prefill_step(api, Topology(mesh=None), ShapeConfig("t", 64, 2, "prefill"))
    tokens = torch.randint(0, c["vocab_size"], (2, 64), dtype=torch.int32, device="cuda")
    reg = obs_metrics.get_registry()
    picks = reg.counter("repro_moe_picks_total", "expert picks routed by the routed MoE")
    before, count0 = obs_tracing.span_totals(), picks.value()
    step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    after = obs_tracing.span_totals()
    for name in ("moe.block", "moe.route", "moe.experts", "moe.combine"):
        assert after[name][0] - before.get(name, (0, 0))[0] == 10, name
    assert picks.value() - count0 == 10 * 2 * 64 * c["num_experts_per_tok"]
    top = reg.metrics()["repro_moe_expert_picks_max"].collect()[()]
    assert 2 * 64 * 3 / 8 <= top <= 2 * 64
