"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W): NVIDIA's
data sheet, dense rates outside the tensor cores, and the HBM bandwidth."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def bound_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over the peak rate of `dtype`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype])
