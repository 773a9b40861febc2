"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full power limit of 700 W): HBM3 at 3.35 TB/s and float32
outside the tensor cores at 67 TFLOP/s. A card set below 700 W runs slower
than these; the run's nvidia-smi line states the limit beside every
number."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
POWER_LIMIT_W = 700


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the f32 operations
    at the f32 peak and the bytes at the HBM peak."""
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def share(ops: float, nbytes: float, seconds: float | None):
    """The bound as a percentage of a measured time; None without one."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds
