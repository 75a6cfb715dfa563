"""Checkpoints of a training state, in the reference's format.

Counterpart of `repro.train.checkpoint`, file for file: ``ckpt.npz`` (written
as ``ckpt.tmp.npz``, then renamed over the old one: an atomic publish) holds
one array a leaf under its key with ``/`` turned into ``__``, bf16 leaves as
their ``uint16`` bit patterns; ``manifest.json`` records ``step``, ``keys``,
``bf16_keys`` and ``extra``. The keys are the reference's
``tree_flatten_with_path`` strings, in its order (dict keys sorted, a
NamedTuple field as ``.name``), so a checkpoint written by either package
restores bit for bit through the other's `restore_checkpoint`.

The reference's ``shardings`` argument (re-sharding onto the current mesh)
has no counterpart: the port has no mesh for these models yet, so a restore
places each leaf on one device.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flatten order and key strings."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    return [("/".join(prefix), tree)]


def _rebuild(like: Any, leaves: dict, prefix: tuple = ()) -> Any:
    """``like``'s structure (its key order kept) with the leaves by key."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves, prefix + (f".{f}",))
                            for f in like._fields))
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(path: str, state: Any, step: int, extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    items = _flatten(state)
    arrays = {}
    bf16 = []
    for key, leaf in items:
        if torch.as_tensor(leaf).dtype == torch.bfloat16:  # npz can't store bf16
            bf16.append(key)
        arrays[key.replace("/", "__")] = _to_numpy(leaf)
    tmp = os.path.join(path, "ckpt.tmp.npz")  # np.savez appends .npz otherwise
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, "ckpt.npz"))  # atomic publish
    manifest = {
        "step": step,
        "keys": [k for k, _ in items],
        "bf16_keys": bf16,
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def restore_checkpoint(path: str, state_like: Any,
                       device: str | torch.device | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``state_like`` (tensors, or meta tensors
    for the shapes only). Each leaf goes to ``device``, or where None to the
    device of its counterpart in ``state_like``. Returns (state, step)."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    bf16 = set(manifest["bf16_keys"])
    leaves = {}
    with np.load(os.path.join(path, "ckpt.npz")) as data:
        for key, like in _flatten(state_like):
            arr = data[key.replace("/", "__")]
            if arr.shape != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(like.shape)}")
            arr = np.array(arr, order="C")  # (ascontiguousarray widens a 0-d array)
            if key in bf16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves[key] = t.to(device if device is not None else like.device)
    return _rebuild(state_like, leaves), manifest["step"]
