"""K1/K2 (``csrc/rank_attention.cu``: the cached conditional row and the
unconditional row of every denoise step) against their roofline: the
summed bound of their calls (``flops.serve_request``) over their device
time, in %."""
from bench_port.harness.readers import roofline

LAYER = "attention kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "request_s"
SOURCE = "device_trace"
KERNELS = ("rank_attention",)


def read(record):
    return roofline(record, "rank_attention", KERNELS)
