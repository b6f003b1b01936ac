"""The routed experts of the AFMoE trunk's expert layers against their
roofline: the summed bound of their grouped products over a step (forward,
recompute, backward; ``flops_afmoe.train_step``) over the device time of
every kernel in the program's "MoE.experts" ranges (the permutation, the
weights' casts, the grouped products, the combine and their backward), in
%."""
from bench_port.harness.readers import device_s

LAYER = "expert layer"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"
RANGE = "MoE.experts"


def read(record):
    bound = record["unit"]["bounds_ms"].get("moe")
    ms = device_s(record, in_range=RANGE) * 1e3
    if not bound or ms <= 0:
        return None
    return 100.0 * bound / ms
