"""ssd_k6_share.prefill (%): the share of the chunked SSD's calls whose
chunk output ran on K6: the count of the program's ``k6.call`` spans over
the count of its ``ssd.block`` spans, from the program's span counters
(``repro_torch.obs.tracing.span_totals``) read in the run's process once
the windows have closed. They hold set-up's warm-up prefills and the
measured window, never a profiled window. None where the program keeps no
such counters or ran no ``ssd.block`` (a model without Mamba2 layers, or a
program without the span)."""

import sys


def totals():
    tracing = sys.modules.get("repro_torch.obs.tracing")
    read_totals = getattr(tracing, "span_totals", None)
    return read_totals() if read_totals is not None else {}


def read(run):
    t = totals()
    blocks = t.get("ssd.block", (0, 0))[0]
    if not blocks:
        return None
    return 100.0 * t.get("k6.call", (0, 0))[0] / blocks
