"""Production meshes. FUNCTIONS only — importing this module touches no
process group and no device.

Counterpart of `repro.launch.mesh`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, which the caller sets up (``init_process_group``) before
asking for one; its dims are named as the reference's axes. Over NCCL each
rank must have a card of its own (checked when the mesh is made); nothing
falls back to another backend, device or world.
"""
from __future__ import annotations


def _world_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialised default process group of {n} ranks: "
            "call torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, the default process group has {world}"
        )
    if device_type == "cuda" and "nccl" in str(dist.get_backend()):
        _check_own_cards(_cards_of_ranks())
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def _cards_of_ranks() -> list[str]:
    """Every rank's card (its host and the uuid of its current CUDA
    device), exchanged through the default group's store (no NCCL call,
    which would fail or hang on ranks that share a card); a rank waits for
    the others' keys."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _get_default_store

    store = _get_default_store()
    card = torch.cuda.get_device_properties(torch.cuda.current_device()).uuid
    store.set(f"repro_torch/card{dist.get_rank()}", f"{socket.gethostname()}/{card}")
    return [store.get(f"repro_torch/card{r}").decode() for r in range(dist.get_world_size())]


def _check_own_cards(cards: list[str]) -> None:
    """Raises unless every NCCL rank has a card of its own: NCCL does not
    run two ranks on one device (gloo ranks may share one)."""
    first: dict[str, int] = {}
    for rank, card in enumerate(cards):
        if card in first:
            raise RuntimeError(
                f"NCCL ranks {first[card]} and {rank} are on one card ({card}): give each "
                "rank its own (torch.cuda.set_device(local_rank) before "
                "init_process_group), or use gloo to share a card"
            )
        first[card] = rank


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, axes, device_type)


def mesh_axes(multi_pod: bool = False):
    from repro_torch.sharding.rules import MeshAxes

    return MeshAxes(data=(("pod", "data") if multi_pod else ("data",)), model="model")


def make_host_mesh(n_data: int | None = None, n_model: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` mesh over every rank of the initialised world
    (tests/examples); ``device_type="cpu"`` for ranks on the host. On
    ``"cuda"`` rank r uses the card its process made current
    (``torch.cuda.set_device(local_rank)`` before ``init_process_group``);
    NCCL ranks that share a card raise."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default process group")
    n_data = n_data or (dist.get_world_size() // n_model)
    return _world_mesh((n_data, n_model), ("data", "model"), device_type)
