"""mfu (%): the model's FLOPs a step (``reference/flops.py``: counted from
the configuration's widths, never from what the program dispatches) times
the measured window's steps, over its seconds (host clock) times the data
sheet's bf16 dense peak. Read in the traced run, whose measured window runs
without the profiler; reported only where the trace shows the card busy."""

from portbench.reference import peaks
from portbench.trace import device_s_per_call


def read(run):
    f = run.facts.get("flops_per_call")
    if not f or run.calls == 0 or device_s_per_call(run) is None:
        return None
    return 100.0 * f * run.calls / (run.window_s * peaks.BF16_FLOPS)
