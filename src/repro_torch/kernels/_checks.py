"""Argument checks shared by the kernel wrappers: a CUDA kernel reads raw
pointers, so every tensor is validated before its address is taken."""
from __future__ import annotations

import torch


def require(t: torch.Tensor, name: str, dtypes: tuple, shape: tuple, device) -> None:
    """Raise unless ``t`` lies on ``device``, has one of ``dtypes``, matches
    ``shape`` (None = any extent) and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_count_window(count_level, counts, device) -> None:
    """Raise unless ``count_level`` and ``counts`` are both None, or a window
    ``(offset >= 0, count >= 1)`` and an int32 ``(count,)`` buffer on
    ``device``."""
    if count_level is None and counts is None:
        return
    if count_level is None or counts is None:
        raise ValueError("count_level and counts are given together or not at all")
    offset, count = count_level
    if not (0 <= offset < 2**31 and 1 <= count < 2**31):
        raise ValueError(f"count_level {count_level} is not a window (offset >= 0, count >= 1)")
    require(counts, "counts", (torch.int32,), (count,), device)


def require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(
            f"{what} launches a CUDA kernel and takes CUDA tensors only; "
            f"got a tensor on {t.device} (use repro_torch.kernels.ops, which "
            "runs the plain version for CPU tensors)"
        )


def device_index(device: torch.device) -> int:
    """The index of the CUDA device ``device`` names: its own, or for a bare
    ``cuda`` the calling thread's current device's."""
    if device.type != "cuda":
        raise ValueError(f"a launch needs a CUDA device; got {device}")
    return device.index if device.index is not None else torch.cuda.current_device()


def launch_target(device: torch.device) -> tuple[int, int]:
    """The last two arguments of every C entry point: ``device``'s index,
    which the entry point makes current for its launch whatever device the
    calling thread has current, and the raw handle of that device's current
    stream (read without building a `torch.cuda.Stream` object, which costs
    a few microseconds a launch)."""
    index = device_index(device)
    return index, torch._C._cuda_getCurrentRawStream(index)
