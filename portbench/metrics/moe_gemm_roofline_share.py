"""moe_gemm_roofline_share (%): the routed experts' least time a call, their
FLOPs counted from the widths (``facts["moe_expert_flops_per_call"]``:
``B S k 6 d ff`` a layer, ``reference/granite_hybrid.py``) over the data
sheet's bf16 dense peak, over the device time a call of the expert GEMM
kernels in the traced window: the kernels ``torch._grouped_mm`` launches,
matched by the name substring ``KERNEL`` read from the card's trace."""

from portbench.reference import peaks
from portbench.trace import kernel_time

#: held by the names of the grouped GEMM kernels of ``torch._grouped_mm``
#: (bf16, sm_90) in the profiler's trace of an H100, and by no other kernel
#: of the prefill
KERNEL = "GroupProblemShape"


def read(run):
    flops = run.facts.get("moe_expert_flops_per_call")
    if not flops or not run.traces or not run.traces[0]["calls"]:
        return None
    launches, secs = kernel_time(run.traces[0], KERNEL)
    if launches == 0 or secs <= 0:
        return None
    bound = flops / peaks.BF16_FLOPS
    return 100.0 * bound / (secs / run.traces[0]["calls"])
