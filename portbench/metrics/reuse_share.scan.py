"""reuse_share.scan (%): the share of the offload engine's dispatches that
took the prepared path: the count of the program's ``engine.reuse`` spans
over the count of its ``engine.offload`` spans, from the program's span
counters (``repro_torch.obs.tracing.span_totals``) read in the run's process
once the windows have closed: they hold set-up and the measured window,
never a profiled window. 0 where the engine has a prepared path
(``repro_torch.offload.engine.PREPARED_MAX``) that no dispatch took; None
where the program has no prepared path, keeps no span counters, or never
dispatched."""

import sys


def totals():
    tracing = sys.modules.get("repro_torch.obs.tracing")
    read_totals = getattr(tracing, "span_totals", None)
    return read_totals() if read_totals is not None else {}


def read(run):
    engine = sys.modules.get("repro_torch.offload.engine")
    if not hasattr(engine, "PREPARED_MAX"):
        return None
    t = totals()
    calls = t.get("engine.offload", (0, 0))[0]
    if not calls:
        return None
    return 100.0 * t.get("engine.reuse", (0, 0))[0] / calls
