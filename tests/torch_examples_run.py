"""Runs the examples for `test_torch_examples.py` and
`test_torch_examples_ref.py`: each in a subprocess with the package on its
path and two threads, within a deadline; a run must exit 0."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def _env(jax: bool = False) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(script: str, *args: str, jax: bool = False) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env(jax), cwd=ROOT)


def _finish(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"{proc.args}: exit {proc.returncode}\n{err[-3000:]}"
    return out


def _run(script: str, *args: str) -> str:
    return _finish(_start(script, *args, "--device", "cpu"))
