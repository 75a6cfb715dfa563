"""The dry run's input shapes (`repro_torch.configs.shapes`) against the
reference's `repro.configs.shapes`.

`SHAPES` and `applicable` field for field; for every (arch, shape) cell at
full CONFIG, `input_specs` (meta tensors) against the reference's
``ShapeDtypeStruct`` stand-ins, shape and dtype, the decode cache leaf for
leaf against ``jax.eval_shape`` of its ``init_cache`` (the port keeps token
counts as Python ints where JAX has 0-d arrays). Nothing is allocated: every
tensor is on the meta device.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import applicable as j_applicable
from repro.configs.shapes import input_specs as j_input_specs
from repro_torch.configs import SHAPES, applicable, input_specs
from repro_torch.configs.registry import LM_ARCHS, get_config

CELLS = [(a, s) for a in LM_ARCHS for s in SHAPES if applicable(get_config(a), SHAPES[s])]

_DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _leaves(tree, prefix=""):
    """path -> leaf over dicts, tuples and NamedTuples (by field name)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}/"))
    return out


def test_shapes_match_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, spec in SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_applicable_matches_reference(arch):
    for name in SHAPES:
        assert applicable(get_config(arch), SHAPES[name]) == j_applicable(
            j_get_config(arch), J_SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    got = _leaves(input_specs(get_config(arch), shape))
    want = _leaves(j_input_specs(j_get_config(arch), shape))
    tensors = {p: t for p, t in got.items() if isinstance(t, torch.Tensor)}
    assert set(tensors) <= set(want)
    for path, leaf in want.items():
        if path in tensors:
            t = tensors[path]
            assert t.is_meta, path  # nothing allocated
            assert tuple(t.shape) == tuple(leaf.shape), path
            assert jnp.dtype(_DTYPES[t.dtype]) == jnp.dtype(leaf.dtype), path
        else:  # a token count: a Python int here, a 0-d int array there
            assert np.shape(leaf) == () and isinstance(got[path], int), path
    assert tensors
