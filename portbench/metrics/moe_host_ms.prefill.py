"""moe_host_ms.prefill (ms): the host's time a prefill in the program's
``moe.block`` spans (the routed MoE's eager dispatch, every MoE layer of
the step): their total over the count of ``step.prefill`` spans, from the
program's span counters (``repro_torch.obs.tracing.span_totals``) read in
the run's process once the windows have closed. They hold set-up's warm-up
prefills and the measured window, never a profiled window. None where the
program keeps no such counters or has no routed MoE."""

import sys


def totals():
    tracing = sys.modules.get("repro_torch.obs.tracing")
    read_totals = getattr(tracing, "span_totals", None)
    return read_totals() if read_totals is not None else {}


def read(run):
    t = totals()
    steps = t.get("step.prefill", (0, 0))[0]
    blocks, ns = t.get("moe.block", (0, 0))
    if not steps or not blocks:
        return None
    return ns / steps * 1e-6
