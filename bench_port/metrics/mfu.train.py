"""The whole step's share of the card's dense bf16 peak: model FLOPs a
step (``flops.train_step``: three forwards over the real tokens, the
per-layer recompute not counted) over the wall time a step of the
untraced window."""
from bench_port.harness.readers import mfu

LAYER = "device"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(record):
    return mfu(record)
