"""k1_roofline_share (%): K1's least time a call, every input byte read once
and every result byte written once over the data sheet's HBM bandwidth
(``reference/flops.py``), over K1's device time a call from the profiler's
kernel records (``k1_`` kernels) of the traced window."""

from portbench.reference import flops
from portbench.trace import kernel_time


def read(run):
    if not run.traces or not run.traces[0]["calls"]:
        return None
    launches, secs = kernel_time(run.traces[0], "k1_")
    if launches == 0 or secs <= 0:
        return None
    f = run.facts
    bound = flops.scan_bound_s(f["ranks"], f["count"], f["itemsize"])
    return 100.0 * bound / (secs / run.traces[0]["calls"])
