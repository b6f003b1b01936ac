"""K6/K7 (``csrc/inline_attention.cu``, ``inline_attention_bwd.cu``: the
metadata-masked forward, its recompute and the backward, with the tile
maps each launch builds) against their roofline: the summed bound of the
step's calls (``flops.train_step``) over their device time, in %."""
from bench_port.harness.readers import roofline

LAYER = "attention kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
KERNELS = ("inline_attention", "tile_summary", "meta_tile_map",
           "tile_order")


def read(record):
    return roofline(record, "inline_attention", KERNELS)
