"""K3/K9 (``csrc/bias_attention.cu``, ``bias_attention_bwd.cu``: the
bias-masked forward, its recompute and the backward, and the bias's tile
map built once a step) against their roofline: the summed bound of the
step's calls (``flops.train_step``) over their device time, in %."""
from bench_port.harness.readers import roofline

LAYER = "attention kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
KERNELS = ("bias_attention", "bias_tile_map", "tile_order")


def read(record):
    return roofline(record, "bias_attention", KERNELS)
