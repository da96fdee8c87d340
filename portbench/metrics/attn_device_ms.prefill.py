"""attn_device_ms.prefill (ms): the device time a call of K5's kernels in
the traced window, the kernels matched by the name substring ``KERNEL``
read from the card's trace (``portbench.trace.kernel_time``). None where
the trace holds no such kernel (a model without attention, or a program
whose attention does not run on K5)."""

from portbench.trace import kernel_time

#: held by the name of every kernel of ``csrc/flash_attention.cu`` (the
#: tensor-core, simt, decode and combine kernels) and by no other kernel
KERNEL = "k5_flash_kernel"


def read(run):
    if not run.traces or not run.traces[0]["calls"]:
        return None
    launches, secs = kernel_time(run.traces[0], KERNEL)
    if launches == 0 or secs <= 0:
        return None
    return 1e3 * secs / run.traces[0]["calls"]
