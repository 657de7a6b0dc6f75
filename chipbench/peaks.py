"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline and utilization share."""

HBM_BYTES_PER_S = 3.35e12
# Float32 outside the tensor cores: the port pins TF32 off.
FP32_FLOPS_PER_S = 67e12
