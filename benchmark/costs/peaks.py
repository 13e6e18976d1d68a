"""The peaks every share of a roofline or of a peak divides by.

NVIDIA H100 SXM data sheet, dense, at the full 700 W: 495 TFLOP/s, the TF32
tensor-core rate, the highest rate at which the card multiplies float32
inputs at all, so that no float32-accurate implementation (SGEMM, 3xTF32)
can pass it; and 3.35 TB/s of HBM3.  A card set below 700 W reaches less;
every result names the card's power limit beside these shares.
"""

PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share(flops: float, nbytes: float, seconds: float) -> float | None:
    """The roofline share in per cent, or None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / seconds
