"""The port's sharding rules (`repro_torch.sharding.rules`) against the
reference's, on the production mesh geometry.

The reference's rules read only axis sizes, so they are called here with a
stand-in mesh (``shape`` a name -> size mapping) on ``jax.eval_shape``
structs; the port's take the same stand-in, and meta tensors. Specs are
compared leaf for leaf after normalising single-name tuples (JAX's
``PartitionSpec`` stores ``("data",)`` as ``"data"``). Then the
divisibility checks and the four named cases of `tests/test_sharding.py`
restated on the port, `placements` to local shard shapes (pod-major over
``("pod", "data")``), and the no-mesh identity of `constrain` /
`constrain_act`.
"""
import types

import jax
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models.serve import init_cache as j_init_cache
from repro.models.transformer import init_params as j_init_params
from repro.sharding.rules import MeshAxes as JMeshAxes
from repro.sharding.rules import activation_spec as j_activation_spec
from repro.sharding.rules import param_specs as j_param_specs
from repro.sharding.rules import serve_cache_specs as j_serve_cache_specs
from repro_torch.configs.registry import LM_ARCHS, get_config
from repro_torch.models.serve import init_cache
from repro_torch.models.transformer import init_params
from repro_torch.sharding.rules import (
    MeshAxes,
    P,
    activation_spec,
    axis_if_divisible,
    constrain,
    constrain_act,
    param_specs,
    placements,
    serve_cache_specs,
)

MESHES = {
    "16x16": (types.SimpleNamespace(shape={"data": 16, "model": 16}),
              MeshAxes(), JMeshAxes()),
    "2x16x16": (types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16}),
                MeshAxes(data=("pod", "data")), JMeshAxes(data=("pod", "data"))),
}
CACHE_ARCHS = ["llama3.2-1b", "moonshot-v1-16b-a3b", "mamba2-130m", "hymba-1.5b"]
KINDS = ["tokens", "act", "act_batch_only", "logits", "moe_buf", "moe_tokens",
         "kv_cache", "decode_act", "rows"]


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


def _flat(tree, prefix=""):
    """path -> leaf over dicts, tuples and NamedTuples (by field name)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}{f}/"))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, P) and not type(tree).__name__ == (
            "PartitionSpec"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _j_params(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda k: j_init_params(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    mesh, axes, jaxes = MESHES[mesh_name]
    want = _flat(j_param_specs(_j_params(arch), mesh, jaxes))
    got = _flat(param_specs(init_params(get_config(arch), None, "meta"), mesh, axes))
    assert set(got) == set(want)
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), path


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_serve_cache_specs_match_reference(arch):
    mesh, axes, jaxes = MESHES["16x16"]
    B, L = 128, 4096
    paged = get_config(arch).family in ("dense", "moe")
    jcfg = j_get_config(arch)
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, B, L, paged=paged))
    want = _flat(j_serve_cache_specs(jcache, mesh, jaxes, B))
    cache = init_cache(get_config(arch), B, L, paged=paged, device=torch.device("meta"))
    got = _flat(serve_cache_specs(cache, mesh, axes, B))
    # the port's caches keep their token counts as Python ints (``length``,
    # ``max_length``): JAX has them as 0-d arrays (``P()``) or not at all
    for path, spec in want.items():
        assert _norm(got[path]) == _norm(spec), path
    assert all(got[p] == P() for p in set(got) - set(want))
    assert len(want) > 2


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_activation_spec_table_matches_reference(kind, mesh_name):
    _, axes, jaxes = MESHES[mesh_name]
    assert _norm(activation_spec(kind, axes)) == _norm(j_activation_spec(kind, jaxes))


def _check_divisible(specs, tree, mesh):
    sizes = dict(mesh.shape)
    leaves = _flat(tree)
    n_checked = 0
    for path, spec in _flat(specs).items():
        shape = tuple(getattr(leaves[path], "shape", ()))
        for dim, names in zip(shape, spec):
            if names is None:
                continue
            n = 1
            for name in (names if isinstance(names, tuple) else (names,)):
                n *= sizes[name]
            assert dim % n == 0, (path, spec, shape)
        n_checked += 1
    assert n_checked


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_divisible(arch, mesh_name):
    mesh, axes, _ = MESHES[mesh_name]
    params = init_params(get_config(arch), None, "meta")
    _check_divisible(param_specs(params, mesh, axes), params, mesh)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_divisible(arch):
    mesh, axes, _ = MESHES["16x16"]
    cfg = get_config(arch)
    cache = init_cache(cfg, 128, 4096, paged=cfg.family in ("dense", "moe"),
                       device=torch.device("meta"))
    _check_divisible(serve_cache_specs(cache, mesh, axes, 128), cache, mesh)


def _specs(arch):
    mesh, axes, _ = MESHES["16x16"]
    return param_specs(init_params(get_config(arch), None, "meta"), mesh, axes)


def test_attention_params_fall_back_to_head_dim():
    """llava: 56 heads don't divide 16 -> head_dim (128) carries the TP axis."""
    assert _specs("llava-next-34b")["blocks"]["wq"] == P(None, ("data",), None, "model")


def test_divisible_heads_sharded_directly():
    assert _specs("phi3-mini-3.8b")["blocks"]["wq"] == P(None, ("data",), "model", None)


def test_odd_vocab_not_model_sharded():
    specs = _specs("minicpm-2b")  # vocab 122753 is odd
    assert specs["embed"][0] is None  # V unsharded
    assert specs["embed"][1] in (("data",), "data")  # FSDP on d


def test_moe_experts_on_model_axis():
    assert _specs("olmoe-1b-7b")["blocks"]["w_gate"][1] == "model"  # (L, E, d, ff)


def test_axis_if_divisible():
    mesh = MESHES["2x16x16"][0]
    assert axis_if_divisible(64, ("pod", "data"), mesh) == ("pod", "data")
    assert axis_if_divisible(48, ("pod", "data"), mesh) is None
    assert axis_if_divisible(0, "model", mesh) is None
    assert axis_if_divisible(16, None, mesh) is None


def test_placements_give_local_shard_shapes():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    class Mesh:  # what `placements` reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

        @staticmethod
        def size(i):
            return (2, 16, 16)[i]

    pl = placements(P(None, ("pod", "data"), None, "model"), Mesh)
    assert pl == (Shard(1), Shard(1), Shard(3))
    assert placements(P("data", None), Mesh) == (Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), Mesh)
    # llava's wq (L, d, H, hd) on 2 x 16 x 16: d over pod x data, hd over model
    shape = (60, 7168, 56, 128)
    for coord, offset in [((0, 0, 0), (0, 0, 0, 0)), ((0, 1, 3), (0, 224, 0, 24)),
                          ((1, 0, 15), (0, 3584, 0, 120)), ((1, 15, 0), (0, 6944, 0, 0))]:
        local, off = _compute_local_shape_and_global_offset(shape, (2, 16, 16), list(coord),
                                                            pl)
        assert tuple(local) == (60, 224, 56, 8)
        assert tuple(off) == offset  # pod outermost, as JAX lays out ("pod", "data")


def test_constrain_is_identity_without_mesh():
    x = torch.randn(4, 8, 16)
    assert constrain(x, P("data", "model", None)) is x
    for kind in ("act", "logits", "act_batch_only"):
        assert constrain_act(x, kind) is x
