"""The linears' rate in a training step: the model's own products through
the trunk's, the embedders' and the head's linears (``flops.train_step``:
three forwards over the real tokens; the recompute and the padding not
counted, so the work read is the same whatever the program recomputes)
over the device time of the cuBLAS kernels, in TFLOP/s. The VAE's
convolutions are cuDNN's and are left out by name."""
from bench_port.harness.readers import device_s

LAYER = "trunk matmuls"
UNIT = "TFLOP/s"
BETTER = "higher"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"
KERNELS = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
NOT = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd")


def read(record):
    sec = device_s(record, KERNELS, NOT)
    if sec <= 0:
        return None
    return record["unit"]["matmul_flops"] / sec / 1e12
