"""ssd_device_ms.prefill (ms): the device time a call of K6's kernels in
the traced window, the kernels matched by the name substring ``KERNEL``
read from the card's trace (``portbench.trace.kernel_time``). None where
the trace holds no such kernel (a model without Mamba2 layers, or a program
whose chunk output does not run on K6)."""

from portbench.trace import kernel_time

#: held by the name of the kernel of ``csrc/ssd_chunk.cu`` and by no other
KERNEL = "k6_ssd_chunk"


def read(run):
    if not run.traces or not run.traces[0]["calls"]:
        return None
    launches, secs = kernel_time(run.traces[0], KERNEL)
    if launches == 0 or secs <= 0:
        return None
    return 1e3 * secs / run.traces[0]["calls"]
