"""scan_p95_us (us): the 95th percentile of every call's latency in the
window, host clock from the call to its result being ready on the card
(one call scans every rank's message)."""

import statistics


def read(run):
    if len(run.latencies_s) < 20:
        return None
    return statistics.quantiles(run.latencies_s, n=20, method="inclusive")[18] * 1e6
