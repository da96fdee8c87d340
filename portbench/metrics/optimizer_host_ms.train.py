"""optimizer_host_ms.train (ms): the host's time a step in the program's
``step.optimizer`` span (AdamW's eager dispatch): its total over its count,
from the program's span counters (``repro_torch.obs.tracing.span_totals``)
read in the run's process once the windows have closed. They hold set-up's
warm-up steps and the measured window, never a profiled window. None where
the program keeps no such counters."""

import sys


def totals():
    tracing = sys.modules.get("repro_torch.obs.tracing")
    read_totals = getattr(tracing, "span_totals", None)
    return read_totals() if read_totals is not None else {}


def read(run):
    steps, ns = totals().get("step.optimizer", (0, 0))
    return ns / steps * 1e-6 if steps else None
