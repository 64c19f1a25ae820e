"""NVIDIA H100 peak rates for roofline bounds (one card), from NVIDIA's
H100 data sheet, chosen by the card's name (``torch.cuda.get_device_name``).

    H100 SXM:  3.35 TB/s HBM3, 989 TFLOP/s dense bf16, 67 TFLOP/s f32,
               900 GB/s NVLink (both directions), 80 GB HBM3
    H100 PCIe: 2.0 TB/s HBM2e, 756 TFLOP/s dense bf16, 51 TFLOP/s f32

The module-level names are the SXM card's (the one the port is measured
on); :func:`peak_rates` picks the PCIe card's by name.  ``chip_smoke.py``'s
kernel bounds and the quality monitor's decode utilization both read
these, and so does the dry run's roofline (``launch/roofline.Roofline``),
so they rest on one set of numbers."""
from __future__ import annotations

from typing import NamedTuple, Optional

HBM_BW = 3.35e12              # B/s
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, no TF32
# H100 SXM, NVLink 4: 900 GB/s per GPU both directions together, so
# 450 GB/s each way; the dry run's collective term sends at this rate
# (within one NVLink domain; a hop over InfiniBand is slower)
NVLINK_BW = 450e9             # B/s per GPU, one direction
CARD_HBM_BYTES = 80e9         # H100 SXM: 80 GB HBM3

_PCIE = (2.0e12, 756e12, 51e12)


class PeakRates(NamedTuple):
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of one card."""
    hbm_bw: float
    flops_bf16: float
    flops_f32: float

    def flops(self, dtype_name: str) -> float:
        """Peak FLOP/s for operands of ``dtype_name`` (``"bfloat16"`` or
        ``"float32"``)."""
        return self.flops_bf16 if dtype_name == "bfloat16" \
            else self.flops_f32


def peak_rates(name: Optional[str] = None) -> PeakRates:
    """The peak rates of the card called ``name`` (an H100 SXM when the
    name is None or does not say PCIe)."""
    if name is not None and "PCIe" in name:
        return PeakRates(*_PCIE)
    return PeakRates(HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32)
