"""Device ms a serving request of every kernel in no other group: the
norms, RoPE, SiLU·up, adds, casts, concatenations and the sampler's
arithmetic. A kernel whose name matches none of the patterns below is
counted here."""
from bench_port.harness.readers import device_s

LAYER = "trunk elementwise"
UNIT = "ms"
BETTER = "lower"
MOVES = "request_s"
SOURCE = "device_trace"
OTHER_GROUPS = (
    # attention kernels and their tile maps
    "rank_attention", "bias_attention", "inline_attention", "tile_summary",
    "meta_tile_map", "tile_order", "fp32_attention", "fp32_bwd",
    # cuBLAS and cuDNN
    "gemm", "xmma", "cutlass", "cublas", "nvjet", "conv", "fprop", "dgrad",
    "wgrad", "cudnn", "winograd",
    # copies
    "Memcpy", "Memset")


def read(record):
    if not record["kernels"]:
        return None
    return device_s(record, (), OTHER_GROUPS) * 1e3
