"""Logical-axis sharding rules -> partition specs for params and activations.

Counterpart of `repro.sharding.rules`, rule for rule. Strategy (FSDP x TP,
pod-extended):
  * batch/rows  -> the data axes ("pod", "data")  [DP]
  * d_model     -> the data axes                  [FSDP / ZeRO-3 param shards]
  * heads / d_ff / experts / vocab -> "model"     [TP / EP]
  * head-count axes that don't divide the model axis fall back to sharding
    head_dim (all assigned archs have head_dim % 16 == 0), else replicate —
    `axis_if_divisible` encodes the fallback chain.

A spec (`P`) has one entry a tensor dim: None, an axis name, or a tuple of
names. The rules read only axis sizes, so they take any mesh whose axis
sizes they can read: a `torch.distributed.device_mesh.DeviceMesh` with
named dims, or anything with a ``shape`` mapping name -> size.
`placements` turns a spec into DTensor placements on a `DeviceMesh`.

An ambient mesh context (contextvar) lets model code call `constrain(x,
spec)` / `constrain_act(x, kind)` without threading a mesh through every
function: with no mesh set they return ``x`` itself, so single-device runs
execute the identical code path; under a mesh they redistribute a DTensor
to the spec's placements. Plain tensors met under a mesh (positions,
masks, the small tensors the model makes itself) are treated as
replicated (`implicit_replication`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: tuple[str, ...] = ("data",)  # ("pod", "data") for multi-pod
    model: str = "model"


_CTX: contextvars.ContextVar[tuple[Any, MeshAxes] | None] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None
)


@contextlib.contextmanager
def set_mesh_context(mesh, axes: MeshAxes):
    """Run the body with ``mesh`` ambient (a `DeviceMesh`), plain tensors
    met by DTensor ops taken as replicated (DTensor's implicit replication,
    restored to its state before on exit, so that the contexts nest)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    token = _CTX.set((mesh, axes))
    was = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = was
        _CTX.reset(token)


def current_mesh_axes() -> tuple[Any, MeshAxes] | None:
    return _CTX.get()


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a `DeviceMesh` (or the ``axis_sizes`` it
    carries where mesh dims fuse axes, as ``"pod+data"``) or of a mesh with
    a ``shape`` mapping."""
    if getattr(mesh, "axis_sizes", None):
        return dict(mesh.axis_sizes)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(s) for n, s in dict(mesh.shape).items()}


def _axis_size(mesh, names: tuple[str, ...] | str | None) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_sizes(mesh)
    size = 1
    for n in names:
        size *= sizes[n]
    return size


def axis_if_divisible(dim: int, names, mesh):
    """Return `names` if dim divides the axis product, else None."""
    if names is None or dim == 0:
        return None
    return names if dim % _axis_size(mesh, names) == 0 else None


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the `DeviceMesh` ``mesh``: mesh dim
    ``i`` shards the tensor dim whose entry names it, else replicates. A dim
    over several axes (``("pod", "data")``) is sharded in mesh-dim order,
    the first axis outermost, as JAX lays out such a dim, or over the one
    mesh dim that fuses them (``"pod+data"``). An axis of size 1
    replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    sizes = [mesh.size(i) for i in range(len(names))]
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        fused = "+".join(group)
        idx = [names.index(fused)] if fused in names else [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            if sizes[i] > 1:  # a split over one rank is a replica
                out[i] = Shard(dim)
    return tuple(out)


def _redistribute(x: Tensor, mesh, spec) -> Tensor:
    from torch.distributed.tensor import DTensor, Replicate

    want = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def fit_spec(shape, spec, mesh=None) -> P:
    """``spec`` for a tensor of ``shape``: padded with None, the axes that
    do not divide their dim dropped (on the ambient mesh by default)."""
    if mesh is None:
        mesh = _CTX.get()[0]
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(e if e and dim % _axis_size(mesh, e) == 0 else None
               for dim, e in zip(shape, entries)))


def spec_of(x) -> P:
    """The spec of a DTensor's layout (the inverse of `placements`)."""
    names = x.device_mesh.mesh_dim_names
    entries: list = [None] * x.ndim
    for name, pl in zip(names, x.placements):
        if pl.is_shard():
            d = pl.dim % x.ndim
            group = tuple(name.split("+"))
            prev = entries[d]
            if prev is None:
                entries[d] = group[0] if len(group) == 1 else group
            else:
                entries[d] = ((prev,) if isinstance(prev, str) else prev) + group
        elif not pl.is_replicate():
            raise ValueError(f"no spec for a {pl} placement")
    return P(*entries)


def on_shards(fn, args, in_specs, out_specs):
    """``fn(*args)`` with no mesh set. Under the ambient mesh: each tensor
    argument laid out as its spec in ``in_specs`` (None: passed as it is),
    ``fn`` run on the local shards, and each output wrapped as a DTensor of
    its spec in ``out_specs`` (one spec, or a tuple of them for a tuple of
    outputs). For the computations DTensor has no layout rule for, run per
    shard at a layout chosen at the call site; the specs must divide their
    dims (`fit_spec`)."""
    ctx = _CTX.get()
    if ctx is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial

    mesh, _ = ctx
    single = not isinstance(out_specs, tuple) or isinstance(out_specs, P)
    specs = (out_specs,) if single else out_specs
    out_pl = [placements(sp, mesh) for sp in specs]
    # an input whole over a mesh dim along which the outputs differ feeds
    # different local computations: its gradient is their sum (Partial)
    split = [any(pl[i].is_shard() for pl in out_pl) for i in range(mesh.ndim)]
    local = []
    for a, spec in zip(args, in_specs):
        if spec is None or not isinstance(a, Tensor):
            local.append(a)
            continue
        pl = placements(spec, mesh)
        grad_pl = [Partial() if p.is_replicate() and split[i] else p for i, p in enumerate(pl)]
        local.append(_redistribute(a, mesh, spec).to_local(grad_placements=grad_pl))
    outs = fn(*local)
    outs = (outs,) if single else outs
    wrapped = tuple(
        DTensor.from_local(o, mesh, pl, run_check=False) if isinstance(o, Tensor) else o
        for o, pl in zip(outs, out_pl))
    return wrapped[0] if single else wrapped


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) over a process group forward, identity backward:
    every rank of the group goes on with the same sum and back-propagates
    the same loss, so each rank's part of the sum takes the sum's gradient
    as it is (Megatron's reduction out of a model-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_across(t: Tensor, mesh, axis: str) -> Tensor:
    """Inside an `on_shards` function: ``t`` summed over the ranks of the
    mesh axis ``axis`` (the same on each), with the gradient of each rank's
    part that of the sum."""
    return _SumAcross.apply(t, mesh.get_group(axis))


def max_across(t: Tensor, mesh, axis: str) -> Tensor:
    """Inside an `on_shards` function: the elementwise max of ``t`` over
    the ranks of ``axis`` (no gradient)."""
    import torch.distributed as dist

    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return out


def assign(dst: Tensor, index, value: Tensor) -> None:
    """``dst[index] = value`` in place. On a DTensor ``dst`` the write runs
    on the local shard, ``value`` laid out as ``dst[index]`` first. ``index``
    holds ints, slices and at most one 1-D index tensor; a sharded dim takes
    an int (the rank holding it writes, the others skip) or the whole dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(dst, DTensor):
        dst[index] = value
        return
    index = list(index) if isinstance(index, tuple) else [index]
    mesh = dst.device_mesh
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    dropped = [d for d, ix in enumerate(index) if isinstance(ix, int)]
    out = []
    for pl in dst.placements:
        d = pl.dim % dst.ndim if pl.is_shard() else None
        if d is None or d in dropped:
            out.append(Replicate())
            continue
        if d < len(index) and not (isinstance(index[d], slice) and index[d] == slice(None)):
            raise ValueError(f"a write indexing dim {d}, which is sharded ({pl})")
        out.append(Shard(d - sum(1 for k in dropped if k < d)))
    val = value if isinstance(value, DTensor) else DTensor.from_local(
        value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    val = val.redistribute(mesh, out)
    for d in dropped:  # ints into the local shard; a row another rank holds: no write
        if not offset[d] <= index[d] < offset[d] + shape[d]:
            return
        index[d] -= offset[d]
    dst.to_local()[tuple(index)] = val.to_local().to(dst.dtype)


def constrain(x: Tensor, spec) -> Tensor:
    """``x`` laid out as ``spec`` under the ambient mesh; ``x`` itself without one."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, _ = ctx
    return _redistribute(x, mesh, spec)


def constrain_act(x: Tensor, kind: str) -> Tensor:
    """Constrain to a named activation layout under the ambient mesh (``x``
    itself without one) — usable from any model module without threading a
    mesh. Axes that don't divide the corresponding dim are dropped per-leaf."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, axes = ctx
    return _redistribute(x, mesh, fit_spec(x.shape, activation_spec(kind, axes), mesh))


# ---------------------------------------------------------------------------
# Parameter rules (pattern-matched on the leaf's path name)
# ---------------------------------------------------------------------------


def _leaf_spec(path: str, shape: tuple[int, ...], mesh, axes: MeshAxes) -> P:
    d = axes.data  # FSDP axes
    m = axes.model
    fsdp = lambda n: axis_if_divisible(n, d, mesh)  # noqa: E731
    tp = lambda n: axis_if_divisible(n, m, mesh)  # noqa: E731
    name = path.split("/")[-1]
    L = None  # layer-stacked leading axis is never sharded

    def heads_spec(n_heads_dim, head_dim_dim):
        """Shard heads if divisible, else head_dim, else neither."""
        if tp(n_heads_dim):
            return m, None
        if tp(head_dim_dim):
            return None, m
        return None, None

    if name in ("embed",):  # (V, d)
        return P(tp(shape[0]), fsdp(shape[1]))
    if name == "codebook_embed":  # (K, V, d)
        return P(None, tp(shape[1]), fsdp(shape[2]))
    if name == "lm_head":  # (d, V)
        return P(fsdp(shape[0]), tp(shape[1]))
    if name == "codebook_head":  # (K, d, V)
        return P(None, fsdp(shape[1]), tp(shape[2]))
    if name in ("wq", "wk", "wv"):  # (L, d, H, hd)
        hs, ds = heads_spec(shape[2], shape[3])
        return P(L, fsdp(shape[1]), hs, ds)
    if name == "wo":  # (L, H, hd, d)
        hs, ds = heads_spec(shape[1], shape[2])
        return P(L, hs, ds, fsdp(shape[3]))
    if name in ("w_gate", "w_up"):
        if len(shape) == 4:  # MoE (L, E, d, ff)
            return P(L, tp(shape[1]), fsdp(shape[2]), None)
        return P(L, fsdp(shape[1]), tp(shape[2]))  # dense (L, d, ff)
    if name == "w_down":
        if len(shape) == 4:  # MoE (L, E, ff, d)
            return P(L, tp(shape[1]), None, fsdp(shape[3]))
        return P(L, tp(shape[1]), fsdp(shape[2]))  # dense (L, ff, d)
    if name == "router":  # (L, d, E)
        return P(L, fsdp(shape[1]), tp(shape[2]))
    if name == "in_proj":  # (L, d, proj_dim)
        return P(L, fsdp(shape[1]), tp(shape[2]))
    if name == "out_proj":  # (L, d_inner, d)
        return P(L, tp(shape[1]), fsdp(shape[2]))
    if name == "patch_proj":  # (d_in, d)
        return P(fsdp(shape[0]), tp(shape[1]))
    # norms, conv weights, A_log, dt_bias, D, fusion scales: replicated
    return P(*([None] * len(shape)))


def _map_with_path(fn, tree: Any, path: str = ""):
    """``fn(path, leaf)`` over nested dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, f"{path}/{f}" if path else f)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params: Any, mesh, axes: MeshAxes) -> Any:
    """A spec tree matching ``params`` (meta tensors are enough)."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), mesh, axes),
                          params)


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (as torch gives them)."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(stride))


def local_slices(shape, mesh, pl) -> tuple[slice, ...]:
    """This rank's slice of a tensor of global ``shape`` laid out as the
    placements ``pl`` on ``mesh`` (uneven splits as DTensor makes them)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def from_whole(x: Tensor, mesh, pl) -> Tensor:
    """``x``, a whole tensor every rank holds alike, as a DTensor of the
    placements ``pl``: this rank copies out its own slice and sends nothing
    (as `jax.device_put` of a host array in a multi-process run). The
    slice is a copy, so ``x`` can be freed."""
    from torch.distributed.tensor import DTensor

    local = x[local_slices(x.shape, mesh, pl)].clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


CHECKSUM_CHUNK = 1 << 24  # elements of a leaf `_checksum` reads at a time


def _checksum(t: Tensor) -> Tensor:
    """A 0-d int64 of ``t``'s bit patterns, each weighted by its place in its
    chunk of CHECKSUM_CHUNK elements and summed (wrapping): equal for equal
    leaves, on any device. Read a chunk at a time, so no whole int64 copy of
    a leaf is made."""
    flat = t.detach().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    weight = torch.arange(1, min(CHECKSUM_CHUNK, bits.numel()) + 1, dtype=torch.int64,
                          device=t.device)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, bits.numel(), CHECKSUM_CHUNK):
        chunk = bits[i:i + CHECKSUM_CHUNK].to(torch.int64)
        total += (chunk * weight[:chunk.numel()]).sum()
    return total


def check_ranks_agree(tree: Any, mesh) -> None:
    """Raises ValueError unless every rank of ``mesh`` holds the same values
    in each tensor leaf of ``tree`` (meta leaves aside): one all-gather of a
    checksum a leaf (`_checksum`). `distribute_tree` copies each rank's
    slice of what that rank holds, so ranks that drew other weights or
    another batch would otherwise make one DTensor of unrelated shards."""
    from torch.distributed.tensor import DTensor, Shard

    if mesh.size() == 1:
        return
    named = []
    _map_with_path(lambda path, leaf: named.append((path, leaf))
                   if isinstance(leaf, Tensor) and not leaf.is_meta else None, tree)
    if not named:
        return
    sums = torch.stack([_checksum(t).to(mesh.device_type) for _, t in named])
    local = sums.reshape((1,) * mesh.ndim + (len(named),))
    whole = DTensor.from_local(local, mesh, [Shard(d) for d in range(mesh.ndim)],
                               run_check=False).full_tensor().reshape(-1, len(named))
    differ = (whole != whole[0]).any(dim=0).nonzero().flatten().tolist()
    if differ:
        paths = [named[i][0] or "<the tree itself>" for i in differ]
        raise ValueError(f"the ranks of the mesh hold different values in {len(paths)} "
                         f"leaves, first {paths[:5]}: every rank must lay out the same tree")


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out per
    its spec in ``specs`` (a tree of the same structure); other leaves as
    they are. Every rank must hold the same ``tree``: this is checked first
    (`check_ranks_agree`, one all-gather of a checksum a leaf), and then
    each rank copies out its own slice with no further collective
    (`from_whole`). The dicts of ``tree`` are updated in place, each whole
    leaf replaced by its DTensor as soon as that is made, so that beside its
    shards a rank holds the whole leaves not yet laid out and no more: a
    caller that wants the whole leaves afterwards keeps a copy of the tree.
    A meta leaf gives a meta local shard, nothing allocated."""

    def walk(t, s):
        if isinstance(t, dict):
            for k in t:
                t[k] = walk(t[k], s[k])
            return t
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, sv) for v, sv in zip(t, s)))
        if isinstance(t, tuple):
            return tuple(walk(v, sv) for v, sv in zip(t, s))
        if not isinstance(t, Tensor):
            return t
        return from_whole(t, mesh, placements(s, mesh))

    check_ranks_agree(tree, mesh)
    return walk(tree, specs)


def param_shardings(params: Any, mesh, axes: MeshAxes) -> Any:
    """``params`` distributed over ``mesh`` per the rules (`param_specs`)
    with `distribute_tree`: every rank must hold the same weights (checked,
    ValueError otherwise), and ``params``' own dicts are rewritten in place,
    their whole leaves replaced by DTensors, so the caller's tree is the
    result (``params = param_shardings(params, mesh, axes)``)."""
    return distribute_tree(params, param_specs(params, mesh, axes), mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of `jax.sharding.NamedSharding`,
    the leaf of a layout tree (`state_shardings`, `restore_checkpoint`)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def state_shardings(state: Any, mesh, axes: MeshAxes) -> Any:
    """The layout tree of a `TrainState` (meta tensors are enough): the
    params per `param_specs`, the AdamW moments ``m`` and ``v`` as their
    params, ``step`` replicated; each leaf a `NamedSharding` on ``mesh``.
    Counterpart of the reference's ``launch/dryrun.py::_state_shardings``;
    the layout `adamw_init` gives a fresh state of sharded params."""
    p = _map_with_path(lambda path, leaf: NamedSharding(mesh, _leaf_spec(
        path, tuple(leaf.shape), mesh, axes)), state.params)
    opt = state.opt._replace(step=NamedSharding(mesh, P()), m=p, v=p)
    return state._replace(params=p, opt=opt)


def serve_cache_specs(cache: Any, mesh, axes: MeshAxes, batch: int) -> Any:
    """Sharding specs for any serve cache tree (its Python-int leaves get ``P()``).

    Per leaf: shard the dim whose size equals `batch` over the data axes when
    it divides (paged caches shard n_pages = batch*pages_per_seq instead);
    then shard the longest remaining large dim (sequence) over `model` when it
    divides — context-parallel decode, the fallback for batch=1 long-context.
    """
    d, m = axes.data, axes.model
    dsize, msize = _axis_size(mesh, d), _axis_size(mesh, m)

    def leaf_spec(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            return P()
        spec: list = [None] * len(shape)
        bdim = next((i for i in (0, 1) if i < len(shape) and shape[i] == batch), None)
        if bdim is not None and batch % dsize == 0:
            spec[bdim] = d
        # model axis: prefer head_dim (last dim; 64/96/128 all divide 16) —
        # keeps the KV/state tensors themselves sharded, not just transients;
        # fall back to the longest big (sequence) dim.
        if len(shape) >= 3 and shape[-1] % msize == 0 and shape[-1] >= msize:
            spec[-1] = m
        else:
            cand = [
                (sz, i) for i, sz in enumerate(shape)
                if spec[i] is None and sz % msize == 0 and sz >= 512
            ]
            if cand:
                _, i = max(cand)
                spec[i] = m
        return P(*spec)

    return _map_with_path(leaf_spec, cache)


# ---------------------------------------------------------------------------
# Activation rules
# ---------------------------------------------------------------------------


def activation_spec(kind: str, axes: MeshAxes) -> P:
    """Named activation layouts used by the constraint call sites."""
    d = axes.data
    m = axes.model
    table = {
        "tokens": P(d, None),  # (B, S)
        # Megatron sequence parallelism: the residual stream between layers is
        # sharded over (batch x seq). Without this, remat storage for a
        # 34B/60L model is O(L*B*S*d) replicated across TP ranks.
        "act": P(d, m, None),  # (B, S, d)
        "act_batch_only": P(d, None, None),
        "logits": P(d, None, m),  # (B, S, V)
        "moe_buf": P(d, m, None, None),  # (G, E, C, d) dispatch buffers
        "moe_tokens": P(d, None, None),  # (G, N, d) grouped tokens
        "kv_cache": P(None, d, None, None, None),  # (L, B, len, KH, hd)
        "decode_act": P(d, None, None),  # (B, 1, d)
        "rows": P(d, None),  # GBDT (n, m)
    }
    return table[kind]
