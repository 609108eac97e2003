"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12   # tensor cores, bf16 and fp16
F32_FLOPS = 67e12     # CUDA cores, float32 outside the tensor cores
HBM_BYTES = 3.35e12   # bytes a second of HBM3


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations at
    ``peak`` and the compulsory bytes at the memory's rate."""
    return max(flops / peak, nbytes / HBM_BYTES)
