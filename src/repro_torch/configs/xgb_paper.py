"""The paper's own workload: out-of-core GBDT on the §4.1 synthetic dataset.

Counterpart of `repro.configs.xgb_paper`, field for field: the widths that
`chip_smoke.py` drives on the card (500 features, ``max_bin`` 256, depth 8,
learning rate 0.1, ``binary:logistic``, MVS at f = 0.1). ``REDUCED`` is the
reference's small variant.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    name: str = "xgb-paper"
    num_features: int = 500  # paper §4.1
    max_bin: int = 256
    n_bins: int = 255  # ELLPACK reserves 255 for missing
    max_depth: int = 8  # paper §4.3
    learning_rate: float = 0.1  # paper §4.3
    objective: str = "binary:logistic"
    sampling_f: float = 0.1  # paper Table 1 headline ratio
    rows_per_device: int = 32768  # sampled+compacted rows resident per device


CONFIG = GBDTConfig()
REDUCED = GBDTConfig(
    name="xgb-paper-reduced", num_features=16, max_bin=16, n_bins=16,
    max_depth=3, rows_per_device=256,
)
