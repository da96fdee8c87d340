"""setup_s (s): from the process's start to the first timed call: imports,
the kernels' build or load, the benchmark's weights and inputs, warm-up."""


def read(run):
    return run.setup_s
