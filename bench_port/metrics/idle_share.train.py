"""The device's idle share in a training step: 1 - the union of the
device's busy intervals a unit in the traced slice over the wall time a
unit of the untraced window."""
from bench_port.harness.readers import idle_share

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(record):
    return idle_share(record)
