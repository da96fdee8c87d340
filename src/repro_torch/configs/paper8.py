"""The paper's own experimental configuration (section IV): 8 NetFPGA nodes,
Intel i5-2400 hosts, directly-connected 1GbE testbed, OSU-microbenchmark-style
back-to-back MPI_Scan at small message sizes (port of
``repro.configs.paper8``; a copy, so the port imports nothing of the
reference). It names no model architecture and is not in ``ARCH_IDS``.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    n_ranks: int = 8
    msg_bytes: tuple = (4, 16, 64, 256, 1024)
    algorithms: tuple = (
        "sequential",            # Open MPI default (paper II-B1)
        "recursive_doubling",    # MPICH (paper II-B2)
        "binomial_tree",         # paper II-B3
    )
    iters: int = 10_000_000      # paper: 10M back-to-back calls
    link_gbps: float = 1.0       # 1GbE
    nic_clock_mhz: float = 125.0  # 8ns timer resolution


CONFIG = PaperSetup()
