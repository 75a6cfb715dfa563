"""Sharding rules of the port's LM models (counterpart of `repro.sharding`)."""
from repro_torch.sharding.rules import (
    MeshAxes,
    P,
    activation_spec,
    axis_if_divisible,
    constrain,
    constrain_act,
    current_mesh_axes,
    param_specs,
    placements,
    serve_cache_specs,
    set_mesh_context,
)

__all__ = [
    "MeshAxes",
    "P",
    "activation_spec",
    "axis_if_divisible",
    "constrain",
    "constrain_act",
    "current_mesh_axes",
    "param_specs",
    "placements",
    "serve_cache_specs",
    "set_mesh_context",
]
