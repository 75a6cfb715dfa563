"""Paper technique on LMs, on the PyTorch + CUDA port: MVS gradient-based
SEQUENCE sampling, the workflow of ``examples/mvs_lm_training.py``.

Trains smollm-135m (reduced) twice on the same stream:
  baseline   every sequence every step
  mvs f=0.5  cheap forward -> eq.-(9) sampling over sequences -> weighted bwd

Both runs start from the same seeded weights; the MVS draws of step i come
from a generator seeded with 100 + i.

    PYTHONPATH=src python examples/torch_mvs_lm_training.py [--steps 30] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.booster import resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (
    TrainConfig,
    init_state,
    make_mvs_train_step,
    make_train_step,
)


def batches(cfg, steps, device, batch=16, seq=64, seed=0):
    rng = np.random.default_rng(seed)
    # mixture stream: half the sequences are near-repeats (low loss -> low ĝ)
    for _ in range(steps):
        hard = rng.integers(0, cfg.vocab_size, (batch // 2, seq))
        easy = np.tile(rng.integers(0, cfg.vocab_size, (batch // 2, 8)), (1, seq // 8))
        yield {"tokens": torch.from_numpy(np.concatenate([hard, easy])).to(device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config("smollm-135m", reduced=True)
    oc = OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=args.steps)

    state = init_state(cfg, oc, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, oc)
    for b in batches(cfg, args.steps, dev):
        state, m = step(state, b)
    print(f"baseline   final loss: {float(m['loss']):.4f}")

    state2 = init_state(cfg, oc, torch.Generator(device=dev).manual_seed(0), dev)
    mstep = make_mvs_train_step(cfg, oc, TrainConfig(mvs_f=0.5))
    kept = []
    for i, b in enumerate(batches(cfg, args.steps, dev)):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        state2, m2 = mstep(state2, b, torch.rand(b["tokens"].shape[0], generator=gen, device=dev))
        kept.append(float(m2["kept"]))
    print(f"mvs f=0.5  final loss: {float(m2['loss']):.4f} "
          f"(mean kept fraction {np.mean(kept):.2f} -> ~{1/max(np.mean(kept),1e-9):.1f}x "
          f"fewer bwd tokens)")


if __name__ == "__main__":
    main()
