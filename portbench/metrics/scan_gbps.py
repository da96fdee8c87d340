"""scan_gbps (GB/s): payload bytes of every MPI_Scan completed in the window
(ranks x message bytes a call), over the window's seconds."""


def read(run):
    if run.window_s <= 0 or "bytes" not in run.units:
        return None
    return run.units["bytes"] / run.window_s / 1e9
