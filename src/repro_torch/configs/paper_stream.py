"""The paper's own case study: STREAM over disaggregated memory.

Not an LM: a bridge workload description (kernel set, array sizes, master
counts from the paper, section 3), kept beside the model registry.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class StreamCaseStudy:
    array_elems: int = 10_000_000          # paper: 10M elements
    total_mib: float = 228.9               # paper: 228.9 MiB working set
    kernels: tuple = ("copy", "scale", "add", "triad")
    max_masters: int = 4                   # 4 A53 cores
    link_gbps: float = 10.0
    num_links: int = 2


CONFIG = StreamCaseStudy()
