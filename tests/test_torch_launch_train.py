"""The port's training command, ``python -m repro_torch.launch.train``, on
the CPU: the printed step and checkpoint lines, a resume that continues
from the saved step with the saved state, MVS sequence sampling, and the
refusal to run without CUDA unless ``--device cpu`` is given."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as train_cmd
from repro_torch.train import checkpoint as tck

ROOT = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(
    r"^step (\d+): loss=(\d+\.\d{4}) lr=(\S+) gnorm=(\d+\.\d{2}) \((\d+) tok/s\)$", re.M)


def _run(*args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    if check:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_train_prints_steps_and_checkpoint(tmp_path):
    out = _run("--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32")
    steps = STEP_LINE.findall(out.stdout)
    assert [int(s[0]) for s in steps] == [0, 2], out.stdout  # every 5th and the last
    assert all(float(s[1]) > 0 for s in steps)

    ckpt = tmp_path / "ckpt"
    out = _run("--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
               "--ckpt-dir", str(ckpt))
    assert f"checkpoint saved to {ckpt}" in out.stdout
    assert sorted(os.listdir(ckpt)) == ["ckpt.npz", "manifest.json"]
    saved = tck.restore_checkpoint(str(ckpt), _state_like(), device="cpu")[0]

    out = _run("--device", "cpu", "--steps", "5", "--batch", "4", "--seq", "32",
               "--ckpt-dir", str(ckpt), "--resume")
    assert "resumed from step 3" in out.stdout
    assert [int(s[0]) for s in STEP_LINE.findall(out.stdout)] == [4]
    assert f"checkpoint saved to {ckpt}" in out.stdout
    later, step = tck.restore_checkpoint(str(ckpt), _state_like(), device="cpu")
    assert step == 5 and int(later.opt.step) == 5
    assert not torch.equal(later.params["embed"], saved.params["embed"])


def _state_like():
    from repro_torch.configs.registry import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_state

    return init_state(get_config("smollm-135m", reduced=True), OptConfig(), None, "meta")


def test_resume_restores_the_saved_state(tmp_path):
    """In process: the checkpoint restores the state the run ended with, bit
    for bit, and a resumed run continues from its step."""
    ckpt = str(tmp_path)
    first = train_cmd.main(["--arch", "smollm-135m", "--device", "cpu", "--steps", "3",
                            "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt])
    restored, step = tck.restore_checkpoint(ckpt, first.state)
    assert step == 3
    for (ka, a), (kb, b) in zip(tck._flatten(first.state), tck._flatten(restored)):
        assert ka == kb and torch.equal(a, b), ka
    resumed = train_cmd.main(["--arch", "smollm-135m", "--device", "cpu", "--steps", "4",
                              "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt, "--resume"])
    assert resumed.start == 3 and len(resumed.metrics) == 1
    assert int(resumed.state.opt.step) == 4


def test_train_mvs_reports_kept_fraction():
    run = train_cmd.main(["--arch", "smollm-135m", "--device", "cpu", "--steps", "3",
                          "--batch", "8", "--seq", "16", "--mvs-f", "0.5", "--seed", "4"])
    kept = [m["kept"] for m in run.metrics]
    assert all(0.0 < k <= 1.0 for k in kept)
    assert all(k in ("loss", "nll", "kept", "grad_norm", "lr") for k in run.metrics[0])
    # the draws come from the seed: the same seed, the same run
    again = train_cmd.main(["--arch", "smollm-135m", "--device", "cpu", "--steps", "3",
                            "--batch", "8", "--seq", "16", "--mvs-f", "0.5", "--seed", "4"])
    assert [m["kept"] for m in again.metrics] == kept
    assert [m["loss"] for m in again.metrics] == [m["loss"] for m in run.metrics]
    out = _run("--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
               "--mvs-f", "0.5")
    assert len(STEP_LINE.findall(out.stdout)) == 2


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is usable")
    out = _run("--steps", "1", check=False)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train_cmd.main(["--arch", "smollm-135m", "--steps", "1"])
