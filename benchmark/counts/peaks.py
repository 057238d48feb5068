"""The H100 SXM's peaks (NVIDIA data sheet, 700 W) that the rooflines and
``mfu`` divide by. The compute peak is 3xTF32: three TF32 tensor-core
products per float32-accurate product at 495 TFLOP/s dense, the fastest
float32-accurate rate of the chip and the rate of the port's K2 and K3."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_ACCURATE_FLOPS = TF32_FLOPS / 3


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time a call can take: its bytes at the memory rate
    against its operations at the float32-accurate peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_ACCURATE_FLOPS)
