"""What the benchmark loads: never JAX or the JAX package, compared by each
module's whole top-level name (the port's ``repro_torch`` begins with the
JAX package's ``repro``), and in the reference nothing of the port."""
import ast
from pathlib import Path

import pytest

from perfbench.yardstick.imports import forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]


def test_whole_top_level_names():
    assert forbidden_loaded(["repro_torch", "repro_torch.core.booster", "reprox"]) == []
    assert forbidden_loaded(["repro.core"]) == ["repro"]
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import perfbench.harness, perfbench.paths.in_core, perfbench.paths.sampled,"
            " perfbench.paths.sharded, perfbench.reference.judge, perfbench.control;"
            "import repro_torch.core.booster, repro_torch.distributed.gbdt_shard;"
            "from perfbench.yardstick.imports import forbidden_loaded;"
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH.parent, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_that_loads_the_jax_package_after_the_window_gives_no_result(monkeypatch):
    """The look comes after the judge: a module named as the JAX package,
    loaded while the reference judges, ends the run without a result."""
    import sys
    import types

    import rehearsal
    from perfbench.reference import judge

    inner = judge.judge

    def judging(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
        return inner(*args, **kwargs)

    monkeypatch.setattr(judge, "judge", judging)
    with pytest.raises(SystemExit, match="repro"):
        rehearsal.run_small("xgb-paper.in_core", 2**31 + 5)
