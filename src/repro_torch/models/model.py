"""Unified model API: build_model(cfg) -> ModelApi (port of
``repro.models.model``).

One object per architecture exposing init / loss / forward / prefill /
decode_step / init_cache, so the server and the tests speak one interface
regardless of family.

``init(gen, device=None)`` draws the weights from a ``torch.Generator`` and
returns the family's ``nn.Module`` on ``device``: the card unless the caller
names another (``"cpu"``, or ``"meta"`` for shapes alone); without a card
the default raises. Every other callable takes that module where the
reference takes its ``params`` pytree. ``input_specs`` returns tensors on
the ``meta`` device, the port's counterpart of ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.trees import checked_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.layers import torch_dtype


def model_device(device: "torch.device | str | None") -> torch.device:
    """The device a model entry point runs on: CUDA unless ``device`` names
    another; raises when CUDA is asked for and there is none."""
    return checked_device("cuda" if device is None else device,
                          "the model entry points (device='cuda')")


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., nn.Module]
    loss: Callable[[nn.Module, Dict[str, torch.Tensor]], Any]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Dict[str, Any]]

    def param_shapes(self) -> Dict[str, torch.Size]:
        """Every parameter's shape, from a module built on ``meta``."""
        module = self.init(torch.Generator().manual_seed(0), device="meta")
        return {k: v.shape for k, v in module.state_dict().items()}


def build_model(cfg: ModelConfig) -> ModelApi:
    def cache(batch: int, seq: int, device: "torch.device | str | None" = None):
        return T.init_decode_cache(cfg, batch, seq, device=model_device(device))

    if cfg.family == "audio":
        return ModelApi(
            cfg=cfg,
            init=lambda gen, device=None: ED.init_encdec(
                gen, cfg, model_device(device)),
            loss=lambda m, b: ED.encdec_loss(m, b, cfg),
            forward=lambda m, b: ED.encdec_forward(
                m, b["tokens"], b["frames"], cfg
            ),
            prefill=lambda m, b: ED.encdec_prefill(
                m, b["tokens"], b["frames"], cfg
            ),
            decode_step=lambda m, tok, cache, clen: ED.encdec_decode_step(
                m, tok, cache, clen, cfg
            ),
            init_cache=cache,
        )

    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: T.init_lm(gen, cfg, model_device(device)),
        loss=lambda m, b: T.lm_loss(m, b, cfg),
        forward=lambda m, b: T.lm_forward(
            m,
            b["tokens"],
            cfg,
            vision_embeds=b.get("vision_embeds"),
            positions3=b.get("positions3"),
        ),
        prefill=lambda m, b: T.lm_prefill(
            m,
            b["tokens"],
            cfg,
            vision_embeds=b.get("vision_embeds"),
            positions3=b.get("positions3"),
        ),
        decode_step=lambda m, tok, cache, clen: T.lm_decode_step(
            m, tok, cache, clen, cfg
        ),
        init_cache=cache,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of a given shape.

    train/prefill: token batches (+ stub frontend embeddings for audio/vlm).
    decode: one new token + the full decode cache + cache_len scalar.
    """
    B, S = shape.global_batch, shape.seq_len
    act_dt = torch_dtype(cfg.dtype)
    i32 = torch.int32
    d = cfg.d_model

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": _meta((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), i32)
        if cfg.family == "audio":
            batch["frames"] = _meta((B, cfg.encoder_frames, d), act_dt)
        if cfg.family == "vlm":
            batch["vision_embeds"] = _meta((B, cfg.vision_patches, d), act_dt)
            batch["positions3"] = _meta((B, S, 3), i32)
        return batch

    # decode: cache laid out for context length S
    cache = build_model(cfg).init_cache(B, S, device="meta")
    return {
        "token": _meta((B, 1), i32),
        "cache": cache,
        "cache_len": _meta((), i32),
    }


__all__ = ["ModelApi", "build_model", "input_specs", "model_device"]
