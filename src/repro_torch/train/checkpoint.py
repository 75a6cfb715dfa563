"""Checkpoints of a training state, in the reference's format, sharded or not.

Counterpart of `repro.train.checkpoint`, file for file: ``ckpt.npz`` (written
as ``ckpt.tmp.npz``, then renamed over the old one: an atomic publish) holds
one array a leaf under its key with ``/`` turned into ``__``, bf16 leaves as
their ``uint16`` bit patterns; ``manifest.json`` records ``step``, ``keys``,
``bf16_keys`` and ``extra``. The keys are the reference's
``tree_flatten_with_path`` strings, in its order (dict keys sorted, a
NamedTuple field as ``.name``), so a checkpoint written by either package
restores bit for bit through the other's `restore_checkpoint`.

A sharded state (DTensor leaves, laid out over a mesh of ranks) is saved as
the reference saves one, in its single-host layout: every rank gathers each
leaf whole in the same order (a collective), rank 0 of the default process
group writes it into the zip as its own member and drops it, so the host
holds one leaf at a time, and the other ranks return after the publish,
behind a barrier. `restore_checkpoint` with ``shardings`` (a layout tree,
`repro_torch.sharding.state_shardings` on the current mesh) re-shards onto
that mesh, which may differ from the one that saved: each rank maps the
file and copies out only its slice of each leaf, so a job restarted on
fewer or more ranks reloads and continues.
"""
from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import contiguous_stride, local_slices


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


def _publish(path: str, tmp: str, items: list, step: int, bf16: list,
             extra: dict | None) -> None:
    os.replace(tmp, os.path.join(path, "ckpt.npz"))  # atomic publish
    manifest = {
        "step": step,
        "keys": [k for k, _ in items],
        "bf16_keys": bf16,
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def save_checkpoint(path: str, state: Any, step: int, extra: dict | None = None) -> None:
    """Write ``state`` at ``step``: plain tensors, or DTensors on every rank
    of a sharded run (see the module docstring)."""
    items = _flatten(state)
    if any(isinstance(leaf, DTensor) for _, leaf in items):
        return _save_sharded(path, items, step, extra)
    os.makedirs(path, exist_ok=True)
    arrays = {}
    bf16 = []
    for key, leaf in items:
        if torch.as_tensor(leaf).dtype == torch.bfloat16:  # npz can't store bf16
            bf16.append(key)
        arrays[key.replace("/", "__")] = _to_numpy(leaf)
    tmp = os.path.join(path, "ckpt.tmp.npz")  # np.savez appends .npz otherwise
    np.savez(tmp, **arrays)
    _publish(path, tmp, items, step, bf16, extra)


def _save_sharded(path: str, items: list, step: int, extra: dict | None) -> None:
    """`save_checkpoint` of a state with DTensor leaves: each leaf gathered
    whole on every rank in key order, rank 0 of the default group writing
    it as one member of np.savez's container (stored ``<key>.npy``) and
    dropping it; the others return after the publish, behind a barrier."""
    import torch.distributed as dist

    writer = dist.get_rank() == 0
    tmp = os.path.join(path, "ckpt.tmp.npz")
    bf16 = []
    if writer:
        os.makedirs(path, exist_ok=True)
        zf = zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True)
    try:
        for key, leaf in items:
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()  # a collective: every rank, in key order
            if not writer:
                continue
            if leaf.dtype == torch.bfloat16:
                bf16.append(key)
            arr = _to_numpy(leaf)
            del leaf
            with zf.open(key.replace("/", "__") + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, arr, allow_pickle=False)
            del arr
    finally:
        if writer:
            zf.close()
    if writer:
        _publish(path, tmp, items, step, bf16, extra)
    dist.barrier()


def _mapped_member(zf: zipfile.ZipFile, file: str, name: str) -> np.ndarray:
    """The array of the stored member ``name``, mapped from ``file`` (read
    only where it is sliced)."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{name} is compressed: a checkpoint's members are stored")
    with open(file, "rb") as fh:
        fh.seek(info.header_offset)
        n_name, n_extra = struct.unpack("<HH", fh.read(30)[26:30])  # the local header
        fh.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(fh)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = read_header(fh)
        offset = fh.tell()
    if fortran or dtype.hasobject:
        raise ValueError(f"{name}: a checkpoint holds C-ordered plain arrays")
    if int(np.prod(shape)) == 0:
        return np.empty(shape, dtype)
    return np.memmap(file, dtype=dtype, mode="r", offset=offset, shape=shape)


def restore_checkpoint(path: str, state_like: Any, shardings: Any | None = None,
                       device: str | torch.device | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``state_like`` (tensors, or meta tensors
    for the shapes only). Returns (state, step).

    With ``shardings`` None each leaf goes whole to ``device``, or where None
    to the device of its counterpart in ``state_like``. Otherwise
    ``shardings`` is a tree matching ``state_like`` whose leaves are
    `repro_torch.sharding.NamedSharding` layouts on the current mesh
    (`sharding.state_shardings` gives a `TrainState`'s): each leaf becomes a
    DTensor of its layout holding only this rank's slice, read from the file
    and placed on ``device`` (default: the mesh's device type, this rank's
    current card for ``"cuda"``). Every rank of the mesh calls it."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    bf16 = set(manifest["bf16_keys"])
    leaves = {}
    if shardings is None:
        with np.load(os.path.join(path, "ckpt.npz")) as data:
            for key, like in _flatten(state_like):
                arr = data[key.replace("/", "__")]
                _check_shape(key, arr, like)
                leaves[key] = _to_tensor(arr, key in bf16).to(
                    device if device is not None else like.device)
        return _rebuild(state_like, leaves), manifest["step"]
    file = os.path.join(path, "ckpt.npz")
    layouts = dict(_flatten(shardings))
    with zipfile.ZipFile(file) as zf:
        for key, like in _flatten(state_like):
            arr = _mapped_member(zf, file, key.replace("/", "__") + ".npy")
            _check_shape(key, arr, like)
            layout = layouts[key]
            pl = layout.placements
            local = _to_tensor(arr[local_slices(arr.shape, layout.mesh, pl)], key in bf16)
            del arr
            local = local.to(device if device is not None else layout.mesh.device_type)
            leaves[key] = DTensor.from_local(local, layout.mesh, pl, run_check=False,
                                             shape=torch.Size(like.shape),
                                             stride=contiguous_stride(like.shape))
    return _rebuild(state_like, leaves), manifest["step"]


def _check_shape(key: str, arr: np.ndarray, like) -> None:
    if arr.shape != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(like.shape)}")


def _to_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """A host tensor of its own holding ``arr`` (a bf16 leaf from its
    ``uint16`` bit patterns)."""
    arr = np.array(arr, order="C")  # (ascontiguousarray widens a 0-d array)
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
