"""The linears' achieved rate in a serving request: the products the
trunk's, the embedders' and the head's linears execute
(``flops.serve_request``) over the device time of the cuBLAS kernels, in
TFLOP/s. The VAE's convolutions are cuDNN's and are left out by name."""
from bench_port.harness.readers import device_s

LAYER = "trunk matmuls"
UNIT = "TFLOP/s"
BETTER = "higher"
MOVES = "request_s"
SOURCE = "device_trace"
KERNELS = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
NOT = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd")


def read(record):
    sec = device_s(record, KERNELS, NOT)
    if sec <= 0:
        return None
    return record["unit"]["matmul_flops"] / sec / 1e12
