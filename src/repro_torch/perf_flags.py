"""Performance-iteration flags (port of ``repro.perf_flags``).

Every beyond-paper optimization is gated so the paper-faithful baseline and
each optimized variant run from the same code. Flags are read from the
environment once at import, or set programmatically via ``set_flags``.

The port reads ``REPRO_TORCH_OPT_*``, where the reference reads
``REPRO_OPT_*``: one setting never moves both packages (the rule the port
keeps for ``REPRO_TORCH_TUNING_TABLE`` too). The fields, their defaults and
``parse_opt_string`` are the reference's. Flags that name a mesh path
(``seq_shard_attn``, ``explicit_tp``, ``attn_seq_over_tp``,
``scan_algorithm``, ``scan_payload_bf16``, ``tp_reduce_bf16``'s psum) act
only under a mesh topology, which this port does not serve yet, and
``remat_policy`` has none while no gradient is taken.

Knobs:
  seq_shard_attn     (0/1)  shard flash-attention query blocks over the model
                            axis when heads don't divide it (fixes the
                            replicated-attention waste on whisper/smollm/
                            qwen2.5/qwen2-vl).
  remat_policy       (none | save_block_outputs)
                            layer-remat policy; save_block_outputs names the
                            post-collective block outputs so the backward
                            pass does NOT re-run forward TP collectives.
  scan_algorithm     (binomial_tree | sklansky | hillis_steele | ...)
                            algo_type for the SSM inter-chunk dist_exscan.
  scan_payload_bf16  (0/1)  carry the scan collective's (decay, state) pair
                            in bf16 on the wire.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class PerfFlags:
    seq_shard_attn: bool = False
    remat_policy: str = "none"
    scan_algorithm: str = "binomial_tree"
    scan_payload_bf16: bool = False
    attn_probs_bf16: bool = False   # exp(s-m) weights in bf16 for the PV matmul
    attn_kv_block: int = 1024       # flash KV block (bigger = fewer o-rescales)
                                    # (both: the blocked attention only, not K5)
    tp_reduce_bf16: bool = False    # force bf16 payloads on TP all-reduces by
                                    # emitting bf16 dots for psum'd projections
    explicit_tp: bool = False       # run attention/MLP projections in
                                    # shard_map with explicitly-owned psums
                                    # (payload dtype + placement controlled)
    ssm_chunk: int = 0              # override SSD chunk length (0 = config)
    attn_seq_over_tp: bool = False  # replicate attention projections and
                                    # shard flash q-blocks over the model axis
                                    # instead of TP heads (small-d models:
                                    # kills the dx all-reduces entirely)


def _from_env() -> PerfFlags:
    return PerfFlags(
        seq_shard_attn=os.environ.get("REPRO_TORCH_OPT_SEQ_SHARD_ATTN", "0") == "1",
        remat_policy=os.environ.get("REPRO_TORCH_OPT_REMAT_POLICY", "none"),
        scan_algorithm=os.environ.get(
            "REPRO_TORCH_OPT_SCAN_ALGORITHM", "binomial_tree"
        ),
        scan_payload_bf16=os.environ.get("REPRO_TORCH_OPT_SCAN_PAYLOAD_BF16", "0") == "1",
        attn_probs_bf16=os.environ.get("REPRO_TORCH_OPT_ATTN_PROBS_BF16", "0") == "1",
        attn_kv_block=int(os.environ.get("REPRO_TORCH_OPT_ATTN_KV_BLOCK", "1024")),
        tp_reduce_bf16=os.environ.get("REPRO_TORCH_OPT_TP_REDUCE_BF16", "0") == "1",
        explicit_tp=os.environ.get("REPRO_TORCH_OPT_EXPLICIT_TP", "0") == "1",
        ssm_chunk=int(os.environ.get("REPRO_TORCH_OPT_SSM_CHUNK", "0")),
        attn_seq_over_tp=os.environ.get("REPRO_TORCH_OPT_ATTN_SEQ_OVER_TP", "0") == "1",
    )


FLAGS = _from_env()


def set_flags(**kwargs) -> PerfFlags:
    global FLAGS
    FLAGS = dataclasses.replace(FLAGS, **kwargs)
    return FLAGS


def parse_opt_string(opt: Optional[str]) -> None:
    """'seq_shard_attn=1,remat_policy=save_block_outputs' -> set_flags."""
    if not opt:
        return
    kw = {}
    for pair in opt.split(","):
        k, v = pair.split("=")
        k = k.strip()
        v = v.strip()
        if k in ("seq_shard_attn", "scan_payload_bf16", "attn_probs_bf16", "tp_reduce_bf16", "explicit_tp", "attn_seq_over_tp"):
            kw[k] = v in ("1", "true", "True")
        elif k in ("attn_kv_block", "ssm_chunk"):
            kw[k] = int(v)
        else:
            kw[k] = v
    set_flags(**kw)
