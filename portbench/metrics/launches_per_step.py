"""launches_per_step (launches): device kernels (not copies or memsets) the
profiler recorded in the traced window, a step."""


def read(run):
    if not run.traces or not run.traces[0]["calls"]:
        return None
    t = run.traces[0]
    n = sum(count for count, _secs, cat in t["kernels"].values() if cat == "kernel")
    return n / t["calls"] if n else None
