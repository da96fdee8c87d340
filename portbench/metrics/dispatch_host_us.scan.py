"""dispatch_host_us.scan (us): a call's time in which the card ran nothing:
the measured window's time a call (host clock, no profiler) less the card's
busy time a call (the union of its activity in the traced window, over that
window's calls); the mean over the cards. The host's dispatch, staging and
waits between back-to-back calls."""

from portbench.trace import device_s_per_call


def read(run):
    busy = device_s_per_call(run)
    if busy is None or run.calls == 0:
        return None
    return 1e6 * (run.window_s / run.calls - busy)
