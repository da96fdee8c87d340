"""The program's Granite-4.0-H stack (``repro_torch.configs.granite_40_h_small``)
from a configuration's file (HF's ``config.json`` keys), with the benchmark's
weights loaded into it."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from portbench.reference.granite_hybrid import layer_types, period, widths

#: the program's conv width and number of B/C groups, fixed in its code
PROGRAM_CONV = 4
PROGRAM_GROUPS = 1


def program_config(c: Dict):
    """The port's configuration for the file ``c``; raises where the file
    asks for what the program does not compute."""
    from repro_torch.configs import get_config

    w = widths(c)
    if w["W"] != PROGRAM_CONV or w["G"] != PROGRAM_GROUPS:
        raise ValueError(f"the program's Mamba2 has d_conv {PROGRAM_CONV} and "
                         f"{PROGRAM_GROUPS} group; the file asks for {w['W']}, {w['G']}")
    if w["H"] * w["P"] != w["di"]:
        raise ValueError(f"mamba_n_heads x mamba_d_head {w['H']} x {w['P']} is not "
                         f"mamba_expand x hidden_size {w['di']}")
    if (c["position_embedding_type"] != "nope" or c["attention_bias"]
            or c["mamba_proj_bias"] or not c["mamba_conv_bias"]
            or c["hidden_act"] != "silu" or c["normalization_function"] != "rmsnorm"):
        raise ValueError("the program runs NoPE attention without biases, Mamba2 with "
                         "conv biases and no projection bias, SiLU and RMSNorm")
    if w["fs"] % w["ff"]:
        raise ValueError(f"the shared MLP ({w['fs']}) is a whole number of experts "
                         f"({w['ff']}) wide in the program")
    base = get_config("granite-4.0-h-small")
    return dataclasses.replace(
        base, name=c["name"], num_layers=w["L"], d_model=w["d"], num_heads=w["nh"],
        num_kv_heads=w["kh"], head_dim=w["hd"], d_ff=w["ff"], vocab_size=w["V"],
        moe_num_experts=w["E"], moe_top_k=w["k"], moe_num_shared=w["fs"] // w["ff"],
        attn_every=period(c), ssm_state=w["N"], ssm_head_dim=w["P"],
        ssm_expand=int(c["mamba_expand"]), ssm_chunk=w["Q"], rope_theta=0.0,
        tie_embeddings=bool(c["tie_word_embeddings"]), dtype=c["dtype"],
        layer_types=tuple(layer_types(c)),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        attention_multiplier=float(c["attention_multiplier"]),
        logits_scaling=float(c["logits_scaling"]), norm_eps=float(c["rms_norm_eps"]))


def load_program(c: Dict, weights: Dict[str, torch.Tensor]):
    """``(api, model)``: the program's model holding ``weights`` (the same
    tensors, no copy); every name, shape and type has to match."""
    from repro_torch.models import build_model

    api = build_model(program_config(c))
    model = api.init(torch.Generator().manual_seed(0), device="meta")
    want = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise ValueError(f"the program's parameters differ from the file's: {diff}")
    model.load_state_dict(weights, assign=True)
    return api, model
