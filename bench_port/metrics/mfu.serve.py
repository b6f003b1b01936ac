"""The whole request's share of the card's dense bf16 peak: model FLOPs a
request (``flops.serve_request``: the trunk's, the embedders' and the
head's linears and the attention over the visible pairs) over the wall
time a request of the untraced window."""
from bench_port.harness.readers import mfu

LAYER = "device"
UNIT = "%"
BETTER = "higher"
MOVES = "request_s"
SOURCE = "host_clock"


def read(record):
    return mfu(record)
