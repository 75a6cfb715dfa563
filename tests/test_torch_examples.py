"""The port's examples, ``examples/torch_*.py``, on the CPU.

Each runs in a subprocess with ``--device cpu`` at its smallest size and
must exit 0; its in-script checks (the recovered elastic forest, the
budgeted store's equal forest) run with it, and its printed numbers are
checked. `test_torch_examples_ref.py` runs the two whose printed numbers
the reference's examples compute on the same data beside those.
"""
import re
import subprocess
import sys

import pytest
from torch_examples_run import ROOT, TIMEOUT_S, _env, _run

def test_quickstart():
    out = _run("torch_quickstart.py")
    assert re.search(r"^trees built:\s+30$", out, re.M), out
    assert float(re.search(r"final eval AUC: (\S+)", out).group(1)) > 0.9


def test_mvs_lm_training():
    out = _run("torch_mvs_lm_training.py", "--steps", "4")
    base = float(re.search(r"baseline\s+final loss: (\S+)", out).group(1))
    mvs = re.search(r"mvs f=0.5\s+final loss: (\S+) \(mean kept fraction (\S+)", out)
    assert base > 0 and float(mvs.group(1)) >= 0
    assert 0.0 < float(mvs.group(2)) <= 1.0


def test_deep_trees():
    out = _run("torch_deep_trees.py", "--quick")
    assert "without hist budget:" in out and "histograms alone need" in out
    spills = int(re.search(r"histogram tier traffic: (\d+) spills", out).group(1))
    assert spills > 0
    assert "auc_delta vs unlimited store = 0.000000" in out


def test_outofcore_train(tmp_path):
    out = _run("torch_outofcore_train.py", "--rows", "6000", "--trees", "8",
               "--workdir", str(tmp_path))
    assert "simulated crash after 4 trees" in out
    assert re.search(r"^trained 8 trees in \S+s \(mode: sampled, f=0.2\)$", out, re.M), out
    assert float(re.search(r"eval AUC:\s+(\S+)", out).group(1)) > 0.6


def test_elastic_train():
    out = _run("torch_elastic_train.py", "--quick")
    assert "recoveries: 1" in out
    assert "OK: recovered forest of 4 trees is bit-for-bit identical" in out


def test_distributed_gbdt():
    out = _run("torch_distributed_gbdt.py")
    assert "devices: ['cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu']" in out
    losses = [float(x) for x in re.findall(r"^iter \d+: logloss=(\S+)", out, re.M)]
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert re.search(r"^fit_sharded: 10 trees, train AUC 0\.9\d+$", out, re.M), out


@pytest.mark.parametrize("script", ["torch_quickstart.py", "torch_distributed_gbdt.py"])
def test_examples_refuse_without_cuda(script):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is usable")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                          capture_output=True, text=True, env=_env(), cwd=ROOT,
                          timeout=TIMEOUT_S)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
