"""The Granite-4.0-H-Small cell's pieces on the CPU: its configuration file
against the published ``config.json``, the bridge that loads the
reference's weights into the program, the FLOP count against a hand count,
and the ``hybrid_prefill`` checks against planted faults at a tiny size."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench import bench, run
from portbench.bench import HERE
from portbench.families import granite_hybrid as family
from portbench.reference import granite_hybrid as ref

CELL = "granite-4.0-h-small-prefill-16k"
#: a Granite stage the CPU runs in a second: one period of 10 layers,
#: attention at index 5, every mechanism of the full one kept
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
        "mamba_chunk_size": 16, "num_local_experts": 8, "num_experts_per_tok": 2,
        "intermediate_size": 32, "shared_intermediate_size": 64, "vocab_size": 500,
        "dtype": "float32"}


def config():
    return json.loads((HERE / "configs" / "granite-4.0-h-small.json").read_text())


def tiny_cell():
    bench.use_port()
    cell = bench.load_cell(CELL)
    return dataclasses.replace(cell, config={**cell.config, **TINY},
                               mix={**cell.mix, "seq_len": 64, "batch": 2})


def test_file_holds_the_published_widths():
    c = config()
    published = {
        "hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 768, "shared_intermediate_size": 1536,
        "num_local_experts": 72, "num_experts_per_tok": 10, "vocab_size": 100352,
        "mamba_n_heads": 128, "mamba_d_head": 64, "mamba_d_state": 128,
        "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_chunk_size": 256,
        "mamba_expand": 2, "mamba_conv_bias": True, "mamba_proj_bias": False,
        "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
        "residual_multiplier": 0.22, "logits_scaling": 16, "rms_norm_eps": 1e-5,
        "position_embedding_type": "nope", "tie_word_embeddings": True,
        "model_type": "granitemoehybrid"}
    assert {k: c[k] for k in published} == published
    types = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    assert c["layer_types"] == types * 4             # the published 40, kept whole
    assert c["num_hidden_layers"] == 10 and c["reduced"] == ["num_hidden_layers"]
    assert ref.layer_types(c) == types               # layers 0-9: one period
    assert ref.period(c) == 10


def test_bridge_names_shapes_and_types_at_full_width():
    """The reference's table against the program's module on ``meta``: every
    name, shape and type equal, nothing allocated."""
    from repro_torch.models import build_model

    c = config()
    api = build_model(family.program_config(c))
    module = api.init(torch.Generator().manual_seed(0), device="meta")
    want = {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
    table = {name: (shape, getattr(torch, dt))
             for name, shape, dt, *_ in ref.param_table(c)}
    assert table == want
    assert sum(torch.Size(s).numel() for s, _ in table.values()) == 8_360_118_912
    assert api.cfg.param_count() == 8_360_118_912


def test_bridge_loads_the_weights_as_they_are():
    c = {**config(), **TINY}
    weights = ref.make_weights(c, 4000000123, "cpu")
    api, model = family.load_program(c, weights)
    sd = model.state_dict()
    assert set(sd) == set(weights)
    for name, w in weights.items():
        assert sd[name].data_ptr() == w.data_ptr() and sd[name].dtype == w.dtype, name
    again = ref.make_weights(c, 4000000123, "cpu")
    assert all(torch.equal(again[k], w) for k, w in weights.items())
    with pytest.raises(ValueError, match="differ"):
        family.load_program(c, {k: w for k, w in weights.items() if k != "embed"})
    with pytest.raises(ValueError, match="d_conv"):
        family.program_config({**c, "mamba_d_conv": 3})


def test_flop_count_against_a_hand_count():
    c = config()
    S = 16384
    f = ref.layer_flops(c, S)
    # one Mamba2 layer, one row of S tokens: in projections 2 * 4096 * (2 *
    # 8192 + 2 * 128 + 128), conv 2 * 4 * (8192 + 256), out 2 * 8192 * 4096
    # a token; 64 chunks of 256: C B^T and the weighted sum over 256 * 257 / 2
    # pairs, (2 * 128 + 2 * 128 * 64) each, the chunk state and the state's
    # outputs 2 * 2 * 256 * 128 * 64 * 128, the passing 2 * 128 * 64 * 128
    token = 2 * 4096 * 16768 + 2 * 4 * 8448 + 2 * 8192 * 4096
    chunk = 32896 * (256 + 16384) + 4 * 256 * 128 * 64 * 128 + 2 * 128 * 64 * 128
    assert f["mamba"] == S * token + 64 * chunk
    # the attention layer: q, k, v, o 2 * 4096 * (32 + 16) * 128 + 2 * 4096 * 4096
    # a token, and 4 * 32 * 128 a (query, key) pair over S (S + 1) / 2 pairs
    assert f["attention"] == S * (2 * 4096 * 48 * 128 + 2 * 4096 * 4096) \
        + 4 * 32 * 128 * S * (S + 1) // 2
    # one MoE block: 10 experts of 3 matrices 4096 x 768, the router 4096 x 72,
    # the shared MLP's 3 matrices 4096 x 1536, each a multiply-add a token
    assert f["routed"] == S * 10 * 2 * 3 * 4096 * 768
    assert f["moe"] == f["routed"] + S * (2 * 4096 * 72 + 2 * 3 * 4096 * 1536)
    total = ref.forward_flops(c, 2, S, 1)
    assert total == 2 * (9 * f["mamba"] + f["attention"] + 10 * f["moe"] + 2 * 4096 * 100352)
    assert total / (2 * S) == pytest.approx(4.39e9, rel=2e-3)          # a token
    assert ref.routed_expert_flops(c, 2, S) == pytest.approx(6.18e13, rel=1e-3)
    assert ref.routed_expert_flops(c, 2, S) / total == pytest.approx(0.43, abs=0.01)


def test_tiny_cell_is_correct_and_reads_its_metrics():
    line, checks = run.execute(tiny_cell(), 4000000123, 0.5, 0, device="cpu")
    assert line["correct"], {c.name: (c.value, c.limit) for c in checks}
    assert {c.name for c in checks} == {"logit_rel_err", "logit_max_gap", "ssm_rel_err",
                                        "conv_rel_err", "kv_rel_err"}
    assert set(line["metrics"]) == {"setup_s", "tokens_per_s"}
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault,caught", [
    ("half", {"logit_rel_err", "logit_max_gap", "ssm_rel_err", "conv_rel_err", "kv_rel_err"}),
    ("altered", {"logit_rel_err", "logit_max_gap"}),
    ("unchanged", {"ssm_rel_err", "conv_rel_err", "kv_rel_err"}),
])
def test_checks_catch_planted_faults(fault, caught):
    line, checks = run.execute(tiny_cell(), 4000000123, 0.5, 0, device="cpu", fault=fault)
    assert not line["correct"]
    assert {c.name for c in checks if not c.ok} == caught
    from repro_torch.models import transformer as T
    assert T.lm_prefill.__name__ == "lm_prefill"     # every fault taken out again


def test_metric_readers_on_known_state(monkeypatch):
    from repro_torch.obs import tracing

    host = bench.load_module("metrics", "moe_host_ms.prefill")
    share = bench.load_module("metrics", "moe_gemm_roofline_share")
    monkeypatch.setattr(tracing, "span_totals", lambda: {
        "step.prefill": (4, 8_000_000_000), "moe.block": (40, 200_000_000)})
    assert host.read(None) == pytest.approx(50.0)
    monkeypatch.setattr(tracing, "span_totals", lambda: {"step.prefill": (4, 1)})
    assert host.read(None) is None
    kernels = {f"cutlass_{share.KERNEL}_a": [20, 0.5, "kernel"],
               "elementwise": [900, 2.0, "kernel"]}
    m = bench.Measured(calls=5, window_s=6.0, facts={"moe_expert_flops_per_call": 6.18e13},
                       traces=[{"calls": 4, "busy_s": 3.0, "window_s": 3.0,
                                "kernels": kernels, "idle_gaps": {}}])
    # 62.49 ms of bound over 125 ms of grouped GEMM a call
    assert share.read(m) == pytest.approx(100 * 6.18e13 / 989e12 / 0.125)
    m.traces[0]["kernels"] = {"elementwise": [900, 2.0, "kernel"]}
    assert share.read(m) is None
