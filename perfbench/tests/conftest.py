"""The benchmark's own CPU tests: ``python -m pytest perfbench/tests`` from
the repository root. They put the port's ``src`` and the root on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(ROOT / "perfbench")):
    if p not in sys.path:
        sys.path.insert(0, p)
