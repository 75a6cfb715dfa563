"""Sharding rules of the port's LM models (counterpart of `repro.sharding`)."""
from repro_torch.sharding.rules import (
    MeshAxes,
    NamedSharding,
    P,
    activation_spec,
    axis_if_divisible,
    constrain,
    constrain_act,
    current_mesh_axes,
    param_shardings,
    param_specs,
    placements,
    serve_cache_specs,
    set_mesh_context,
    state_shardings,
)

__all__ = [
    "MeshAxes",
    "NamedSharding",
    "P",
    "activation_spec",
    "axis_if_divisible",
    "constrain",
    "constrain_act",
    "current_mesh_axes",
    "param_shardings",
    "param_specs",
    "placements",
    "serve_cache_specs",
    "set_mesh_context",
    "state_shardings",
]
