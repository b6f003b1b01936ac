"""K6/K7 of the AFMoE trunk's layers (the windowed instances on the
sliding layers, the windowless on the full ones; the forward, its
recompute and the backward, with the tile maps each launch builds) against
their roofline: the summed bound of the step's calls at each layer's
visible pairs (``flops_afmoe.train_step``) over their device time, in %.
The kernel patterns are ``inline_attention_roofline``'s and the window's
map kernels besides."""
from bench_port.harness.readers import roofline

LAYER = "attention kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
KERNELS = ("inline_attention", "tile_summary", "meta_tile_map",
           "tile_order", "pos_range", "window_tile_map")


def read(record):
    return roofline(record, "inline_attention", KERNELS)
