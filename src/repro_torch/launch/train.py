"""Training driver: ``--arch <id>`` selects any assigned architecture.

Counterpart of `repro.launch.train`. It trains the REDUCED config unless
``--full``, on ``--device`` ("cuda" unless asked otherwise; without a CUDA
device that raises), with random weights from a ``--seed``ed generator, on
the reference's synthetic batch stream. Features exercised: WSD/cosine
schedules (an arch's ``PREFERRED_SCHEDULE``), remat, MVS sequence sampling
(the paper's technique; each step's uniforms from a generator seeded by
``--seed`` and the step), periodic checkpoints in the reference's format,
resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def synth_batch(cfg, rng, batch, seq, device):
    """The reference's synthetic batch (the same numpy draws) as tensors on ``device``."""
    import torch

    if cfg.n_codebooks:
        codes = rng.integers(0, cfg.vocab_size, (batch, seq, cfg.n_codebooks))
        return {"codes": torch.from_numpy(codes).to(device)}
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(device)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(device)
    return out


@dataclasses.dataclass
class TrainRun:
    """What `main` trained: the config, the final state, the step it started
    from (the checkpoint's on ``--resume``), every step's metrics as floats
    and its host seconds (each ending when its metrics reach the host)."""

    cfg: object
    state: object
    start: int
    metrics: list
    step_s: list


def _step_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def main(argv=None) -> TrainRun:
    import torch

    from repro_torch.configs.registry import LM_ARCHS, get_config, get_module
    from repro_torch.core.booster import resolve_device
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (
        TrainConfig,
        init_state,
        make_mvs_train_step,
        make_train_step,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=LM_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="full (not reduced) config")
    ap.add_argument("--mvs-f", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda, or cpu (the same code on the host)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' generator and of the MVS draws")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    mod = get_module(args.arch)
    schedule = getattr(mod, "PREFERRED_SCHEDULE", "cosine")
    oc = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps, schedule=schedule)
    tc = TrainConfig(mvs_f=args.mvs_f)

    state = init_state(cfg, oc, torch.Generator(device=dev).manual_seed(args.seed), dev)
    start = 0
    if args.resume and args.ckpt_dir and os.path.exists(os.path.join(args.ckpt_dir, "ckpt.npz")):
        state, start = restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    mvs = args.mvs_f < 1.0
    step = make_mvs_train_step(cfg, oc, tc) if mvs else make_train_step(cfg, oc, tc)

    rng = np.random.default_rng(0)
    history, step_s = [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        ts = time.perf_counter()
        batch = synth_batch(cfg, rng, args.batch, args.seq, dev)
        if mvs:
            gen = torch.Generator(device=dev).manual_seed(_step_seed(args.seed, i))
            state, metrics = step(state, batch, torch.rand(args.batch, generator=gen, device=dev))
        else:
            state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        step_s.append(time.perf_counter() - ts)
        if i % 5 == 0 or i == args.steps - 1:
            toks = args.batch * args.seq
            dt = time.perf_counter() - t0
            m = history[-1]
            print(f"step {i}: loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                  f"({(i - start + 1) * toks / max(dt, 1e-9):.0f} tok/s)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state, i + 1, extra={"arch": args.arch})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state, args.steps, extra={"arch": args.arch})
        print(f"checkpoint saved to {args.ckpt_dir}")
    return TrainRun(cfg, state, start, history, step_s)


if __name__ == "__main__":
    main()
