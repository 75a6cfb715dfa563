"""Three-term roofline of a dry-run cell, reckoned against one NVIDIA H100
SXM (no hardware needed).

  compute    = FLOPs / 989e12 FLOP/s (bf16 dense tensor-core peak)
  memory     = bytes / 3.35e12 B/s (HBM3)
  collective = collective bytes / link rate

all per device. Counterpart of `repro.roofline.analysis`, whose figures
come from XLA's cost analysis of the compiled per-device program; the
port's come from running the program: `CostMode` is a dispatch mode that
sits below DTensor, so it sees each rank's LOCAL ops, and books

  * FLOPs, by `torch.utils.flop_counter`'s formulas (matmuls, convolutions,
    attention kernels; elementwise work counts nothing, as there);
  * bytes accessed: every non-view aten op's tensor inputs read plus its
    outputs written, the eager program's memory traffic;
  * collectives: every `c10d` / `_c10d_functional` (and DTensor's
    all-to-all) op, by the reference's kind names, its payload taken from
    the op's result tensors (for all-gather the gathered size, the bytes
    actually moved), as `repro.roofline.analysis.collective_bytes_from_hlo`
    takes them;
  * the peak of live local bytes: every storage an op creates is live until
    its last reference dies (a weak reference's callback), the step's
    inputs included; this replaces XLA's ``memory_analysis``.

The link rate: NVLink 4 moves 450e9 B/s a direction per card within an
8-card node; across nodes a card has one 400 Gb/s NDR InfiniBand link,
50e9 B/s. A mesh of more than 8 cards puts its collectives on the network
rate: both production meshes have a ``model`` axis of 16, which spans two
nodes, so every collective of their cells crosses one.

MODEL_FLOPS (6·N·D train / 2·N·D inference, N = active params) over the
counted FLOPs measures how much of the program's compute is "useful" —
catching remat/redundancy waste and masked-attention overcompute. It is
None where no FLOPs were counted (the GBDT cell has no matmul).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclasses.dataclass(frozen=True)
class _HW:
    # NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s bf16 dense (1979 with sparsity)
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12  # HBM3, H100 SXM5 datasheet
    nvlink_bw: float = 450e9  # NVLink 4: 900 GB/s bidirectional a card, 450 a direction
    network_bw: float = 50e9  # one 400 Gb/s NDR InfiniBand link a card (DGX H100)
    node_cards: int = 8  # cards joined by NVLink in one node (DGX/HGX H100)

    def collective_bw(self, chips: int) -> float:
        """The link rate a collective of a ``chips``-card mesh runs at."""
        return self.nvlink_bw if chips <= self.node_cards else self.network_bw


HW = _HW()

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# op name (namespace.name) -> the reference's kind name
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.broadcast_": "broadcast",
    "c10d.scatter_": "scatter",
    "c10d.gather_": "gather",
    "c10d.reduce_": "reduce",
}
# ops that move no data of their own
_FREE = {
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "aten._local_scalar_dense",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Books one rank's local FLOPs, bytes accessed, collectives and peak
    live bytes (see the module docstring). Enter it around the work; call
    `track` for tensors made before it was entered, and `start` to zero the
    counters and the peak at the step's start (setup not counted)."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._refs: dict[int, weakref.ref] = {}

    # ----------------------------------------------------------- live bytes
    def _freed(self, key: int, n: int, _ref) -> None:
        if self._refs.get(key) is _ref:
            del self._refs[key]
            self.live -= n

    def track(self, *trees: Any) -> None:
        """Count the storages of every tensor in ``trees`` as live."""
        from torch.distributed.tensor import DTensor

        for t in tree_leaves(trees):
            if isinstance(t, DTensor):
                t = t.to_local()
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs and self._refs[key]() is not None:
                continue
            n = st.nbytes()
            ref = weakref.ref(st, lambda r, key=key, n=n: self._freed(key, n, r))
            self._refs[key] = ref
            self.live += n
            self.peak = max(self.peak, self.live)

    def start(self) -> None:
        """Zero the counters; the live bytes now are the step's arguments."""
        self.flops = 0
        self.bytes = 0
        self.collectives = {}
        self.argument_bytes = self.live
        self.peak = self.live

    # ------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run; its local ops come back here
        fake = next((t for t in tree_leaves((args, kwargs)) if isinstance(t, FakeTensor)), None)
        if fake is not None:  # DTensor's sharding propagation: no work, run as fake
            with fake.fake_mode:
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(map(_nbytes, outs))
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _FREE:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.track(outs)
        return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float | None  # MODEL_FLOPS / (flops_per_device * chips)
    memory_stats: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference steps."""
    c = 6.0 if kind == "train" else 2.0
    return c * float(n_active_params) * float(tokens)


def analyze_traced(
    cost: CostMode,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    n_active_params: int,
    tokens: int,
    kind: str,
    useful_flops: float | None = None,
) -> RooflineReport:
    """The roofline of one step from a `CostMode`'s tallies (this rank's;
    SPMD ranks are alike). ``useful_flops`` replaces 6·N·D / 2·N·D where the
    cell is no LM step."""
    flops_dev = float(cost.flops)
    bytes_dev = float(cost.bytes)
    coll = dict(cost.collectives)
    coll_dev = float(sum(coll.values()))

    compute_s = flops_dev / HW.peak_flops
    memory_s = bytes_dev / HW.hbm_bw
    collective_s = coll_dev / HW.collective_bw(chips)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(n_active_params, tokens, kind) if useful_flops is None else useful_flops
    total_flops = flops_dev * chips
    useful = mf / total_flops if total_flops else None
    mem_stats = {
        "argument_size_in_bytes": int(cost.argument_bytes),
        "temp_size_in_bytes": int(cost.peak - cost.argument_bytes),
        "peak_estimate_bytes": int(cost.peak),
    }
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev, collective_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, useful_ratio=useful,
        memory_stats=mem_stats,
    )
