"""The program's Mamba2 language model from a configuration's file, with
the benchmark's weights loaded into it."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.mamba2 import widths

#: the program's conv width and number of B/C groups, fixed in its code
PROGRAM_CONV = 4
PROGRAM_GROUPS = 1


def program_config(c: Dict):
    """The port's ``ModelConfig`` for the file ``c``; raises where the file
    asks for what the program does not compute."""
    from repro_torch.configs.base import ModelConfig

    if int(c["d_conv"]) != PROGRAM_CONV or int(c["ngroups"]) != PROGRAM_GROUPS:
        raise ValueError(f"the program's Mamba2 has d_conv {PROGRAM_CONV} and "
                         f"ngroups {PROGRAM_GROUPS}; the file asks for "
                         f"{c['d_conv']}, {c['ngroups']}")
    if c.get("residual_in_fp32") or int(c.get("d_intermediate", 0)):
        raise ValueError("the program's Mamba2 keeps its residual in the model's type "
                         "and has no MLP: the file asks for residual_in_fp32 "
                         f"{c.get('residual_in_fp32')}, d_intermediate {c.get('d_intermediate')}")
    mc = ModelConfig(
        name=c["name"], family="ssm", num_layers=int(c["n_layer"]),
        d_model=int(c["d_model"]), num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=int(c["vocab_size"]), ssm_state=int(c["d_state"]),
        ssm_head_dim=int(c["headdim"]), ssm_expand=int(c["expand"]),
        ssm_chunk=int(c["chunk_size"]), norm="rmsnorm",
        tie_embeddings=bool(c["tie_embeddings"]), dtype=c["dtype"])
    if mc.padded_vocab != widths(c)["Vp"]:
        raise ValueError(f"the program pads the vocabulary to {mc.padded_vocab}, "
                         f"the file to {widths(c)['Vp']}")
    return mc


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
