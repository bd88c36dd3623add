"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W), as
``chip_smoke.py``'s ``PEAK`` and ``bound()`` state them."""

from __future__ import annotations

PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, peak: str, nbytes: float) -> float:
    """The least time the card could take: the larger of ``ops`` at
    ``PEAK_OPS_PER_S[peak]`` and ``nbytes`` at the HBM rate."""
    return max(ops / PEAK_OPS_PER_S[peak], nbytes / HBM_BYTES_PER_S)
