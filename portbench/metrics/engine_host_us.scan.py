"""engine_host_us.scan (us): the offload engine's own host time a call: the
time in the program's ``engine.offload`` spans less the time in their
``engine.compile``, ``engine.drain`` and ``engine.wait`` children, over the
number of ``engine.offload`` spans. Read from the program's span counters
(``repro_torch.obs.tracing.span_totals``) in the run's process once the
windows have closed: they hold set-up and the measured window, never a
profiled window. None where the program keeps no such counters."""

import sys


def totals():
    tracing = sys.modules.get("repro_torch.obs.tracing")
    read_totals = getattr(tracing, "span_totals", None)
    return read_totals() if read_totals is not None else {}


def read(run):
    t = totals()
    calls, ns = t.get("engine.offload", (0, 0))
    if not calls:
        return None
    waits = sum(t.get(name, (0, 0))[1]
                for name in ("engine.compile", "engine.drain", "engine.wait"))
    return (ns - waits) / calls * 1e-3
