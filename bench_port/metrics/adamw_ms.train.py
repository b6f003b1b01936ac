"""Device ms a training step of the optimizer: every kernel that starts
inside the device span of the program's "AdamW.step" range (the clip and
the update, ``training/train_state.py``)."""
from bench_port.harness.readers import device_s

LAYER = "optimizer"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_tokens_per_s"
SOURCE = "program_span"
RANGE = "AdamW.step"


def read(record):
    sec = device_s(record, in_range=RANGE)
    return sec * 1e3 if sec > 0 else None
