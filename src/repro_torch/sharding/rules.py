"""Parameter & input PartitionSpec rules per architecture family (port of
``repro.sharding.rules``).

Rules are name+shape based. The same rules produce:
  * param specs (TP layout over the 'model' axis),
  * ZeRO-1 optimizer-state specs (param spec + an extra 'data' sharding on
    the first divisible unsharded dim),
  * batch input specs,
  * decode-cache specs.

Non-divisible dims (whisper's 20 heads on a 16-way axis, ...) degrade to
replicated for that dim.

The reference keys its rules on pytree paths of *stacked* layers
(``blocks/attn/wq`` over an ``(L, d, h, hd)`` leaf, the leading layer axis
skipped). The port's parameters are per-layer ``state_dict`` names with the
layer index inserted (``blocks.3.attn.wq`` over ``(d, h, hd)``): the index
is dropped from the name and there is no stack axis, so each port spec is
the reference's spec of the same leaf without its leading ``None``. ZeRO-1
picks its dim among the per-layer dims (the reference's may pick the
stacked layer axis) and counts the per-layer size against its 65536 floor.

Specs are :class:`repro_torch.compat.P`. On one card they are metadata:
placement stays the identity, as ``sharding.shard`` is.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch import perf_flags
from repro_torch.compat import P
from repro_torch.sharding.specs import Topology


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _leaf_spec(path: str, shape: tuple, cfg, msize: int) -> P:
    """TP spec for one (unstacked: trailing dims) param leaf."""
    nd = len(shape)

    def pad(*tail):
        return P(*([None] * (nd - len(tail)) + list(tail)))

    d = cfg.d_model
    if "embed" in path or "lm_head" in path:
        # (V, d) table / (d, V) head: shard the vocab dim
        if shape[-1] == cfg.padded_vocab and _div(cfg.padded_vocab, msize):
            return pad(None, "model")
        if nd >= 2 and shape[-2] == cfg.padded_vocab and _div(cfg.padded_vocab, msize):
            return pad("model", None)
        return P(*([None] * nd))
    if "attn" in path or "cross" in path:
        if perf_flags.FLAGS.attn_seq_over_tp:
            return P(*([None] * nd))  # replicated projections (seq-sharded attn)
        if path.endswith("wq"):
            return pad(None, "model", None) if _div(cfg.num_heads, msize) else P(*([None] * nd))
        if path.endswith("wk") or path.endswith("wv"):
            return pad(None, "model", None) if _div(cfg.num_kv_heads, msize) else P(*([None] * nd))
        if path.endswith("wo"):
            return pad("model", None, None) if _div(cfg.num_heads, msize) else P(*([None] * nd))
        if path.endswith("bq"):
            return pad("model", None) if _div(cfg.num_heads, msize) else P(*([None] * nd))
        if path.endswith("bk") or path.endswith("bv"):
            return pad("model", None) if _div(cfg.num_kv_heads, msize) else P(*([None] * nd))
    if "moe" in path and ("w_in" in path or "w_gate" in path or "w_out" in path) and "shared" not in path:
        # expert-parallel: experts over 'model'
        return pad("model", None, None) if _div(cfg.moe_num_experts, msize) else P(*([None] * nd))
    if "router" in path:
        return P(*([None] * nd))
    if path.endswith("w_in") or path.endswith("w_gate"):
        return pad(None, "model") if _div(shape[-1], msize) else P(*([None] * nd))
    if path.endswith("w_out") and nd >= 2 and shape[-2] != cfg.ssm_d_inner:
        return pad("model", None) if _div(shape[-2], msize) else P(*([None] * nd))
    # --- mamba ---
    if "mamba" in path:
        if cfg.family == "ssm":
            return P(*([None] * nd))  # SP mode: weights replicated
        di, H = cfg.ssm_d_inner, cfg.ssm_num_heads
        if path.endswith("w_z") or path.endswith("w_x"):
            return pad(None, "model") if _div(di, msize) else P(*([None] * nd))
        if path.endswith("w_dt"):
            return pad(None, "model") if _div(H, msize) else P(*([None] * nd))
        if path.endswith("conv_w_x"):
            return pad(None, "model") if _div(di, msize) else P(*([None] * nd))
        if path.endswith("conv_b_x") or path.endswith("norm_scale"):
            return pad("model") if _div(di, msize) else P(*([None] * nd))
        if path.endswith("A_log") or path.endswith("D") or path.endswith("dt_bias"):
            return pad("model") if _div(H, msize) else P(*([None] * nd))
        if path.endswith("w_out"):
            return pad("model", None) if _div(di, msize) else P(*([None] * nd))
        return P(*([None] * nd))
    return P(*([None] * nd))


def _path_str(name: str) -> str:
    """A ``state_dict`` name as the reference's unstacked rule path:
    ``blocks.3.attn.wq`` -> ``blocks/attn/wq``."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _nest(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _nest(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_specs(param_shapes: Dict[str, Any], cfg, topo: Topology) -> Dict[str, P]:
    """``{name: P}`` over a module's parameter shapes
    (:meth:`repro_torch.models.ModelApi.param_shapes`)."""
    msize = topo.model_size
    return {
        name: _leaf_spec(_path_str(name), tuple(shape), cfg, msize)
        for name, shape in param_shapes.items()
    }


def zero1_specs(param_specs_tree: Dict[str, P], param_shapes: Dict[str, Any],
                topo: Topology) -> Dict[str, P]:
    """Optimizer-state specs: param spec + extra 'data' sharding (ZeRO-1).

    The first dim that is unsharded and divisible by the data-axis size gets
    the DP axes. Scalars and tiny leaves stay as-is.
    """
    dp = topo.batch_axes
    dp_size = topo.dp_size
    dp_entry = dp[0] if len(dp) == 1 else tuple(dp)

    def one(spec: P, shape) -> P:
        shape = tuple(shape)
        if len(shape) == 0 or int(np.prod(shape)) < 65536 or dp_size <= 1:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % dp_size == 0:
                entries[i] = dp_entry
                return P(*entries)
        return spec

    return {name: one(spec, param_shapes[name])
            for name, spec in param_specs_tree.items()}


def batch_specs(batch_shapes: Dict[str, Any], topo: Topology) -> Dict[str, Any]:
    """Batch dims over DP axes; everything else replicated. Leaves are
    tensors (``meta`` ones from ``input_specs`` too) or anything with a
    ``shape``."""
    dp = topo.batch_axes
    dp_entry = dp[0] if len(dp) == 1 else tuple(dp)
    dp_size = topo.dp_size

    def one(_path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if leaf.shape[0] % dp_size == 0 and leaf.shape[0] > 1:
            return P(*([dp_entry] + [None] * (nd - 1)))
        return P(*([None] * nd))

    return _nest(batch_shapes, one)


def cache_specs(cache_shapes: Any, cfg, topo: Topology) -> Any:
    """Decode-cache specs: batch over DP; KV heads over 'model' when they
    divide, else cache SEQUENCE over 'model' (the kv_seq decode mode)."""
    msize = topo.model_size
    dp = topo.batch_axes
    dp_entry = dp[0] if len(dp) == 1 else tuple(dp)
    dp_size = topo.dp_size
    kv_heads_ok = _div(cfg.num_kv_heads, msize)

    def one(path_s, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        # leading dim is the stacked layer/period dim for k/v/mamba caches
        entries: list = [None] * nd
        # find batch dim: first dim equal to a multiple of dp that's not the
        # layer dim — by construction caches are (L, B, S, Kh, D) or
        # mamba (L, [7,] B, ...)
        if path_s.startswith("k") or path_s.startswith("v") or path_s.startswith("x"):
            # (L, B, S, Kh, D)
            if shape[1] % dp_size == 0 and shape[1] > 1:
                entries[1] = dp_entry
            if kv_heads_ok:
                entries[3] = "model"
            elif shape[2] % msize == 0 and shape[2] > 1:
                entries[2] = "model"
        elif "mamba" in path_s:
            bdim = 1 if cfg.family == "ssm" else 2
            if nd > bdim and shape[bdim] % dp_size == 0 and shape[bdim] > 1:
                entries[bdim] = dp_entry
        return P(*entries)

    return _nest(cache_shapes, one)
