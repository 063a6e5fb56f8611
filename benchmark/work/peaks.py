"""The card's peaks that roofline and mfu shares are taken against: NVIDIA's
H100 SXM data sheet at its 700 W limit. The configurations compute in
float32 with TF32 off, on the CUDA cores, so the float32 rate outside the
tensor cores is the peak of their operations."""

FLOAT32_FLOPS = 67e12  # operations a second, float32 off the tensor cores
HBM_BYTES = 3.35e12  # device memory, bytes a second


def least_s(flops, n_bytes):
    """The least time work of ``flops`` operations and ``n_bytes`` bytes
    takes: the larger of the two over their peaks."""
    return max(flops / FLOAT32_FLOPS, n_bytes / HBM_BYTES)
