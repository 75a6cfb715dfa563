"""The dry run's roofline on H100 constants (counterpart of `repro.roofline`)."""
from repro_torch.roofline.analysis import (
    HW,
    CostMode,
    RooflineReport,
    analyze_traced,
    model_flops,
)

__all__ = [
    "HW",
    "CostMode",
    "RooflineReport",
    "analyze_traced",
    "model_flops",
]
