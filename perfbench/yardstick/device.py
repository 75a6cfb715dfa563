"""The facts of the card a result was measured on."""
from __future__ import annotations

import subprocess


def power_limit_w(index: int) -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def require_cards(n: int) -> None:
    """Exit without a result unless CUDA has at least ``n`` cards."""
    import sys

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} cards; torch.cuda.device_count() is "
                 f"{torch.cuda.device_count()}")
