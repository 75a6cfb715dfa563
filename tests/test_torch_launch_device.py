"""Where a kernel launch runs: the device index every wrapper hands its C
entry point, and the entry points' declarations against the argument lists
the wrappers bind (`kernels._build.SIGNATURES`).

Each ``extern "C"`` entry point in ``kernels/csrc`` takes, after its own
arguments, the index of its tensors' device and that device's stream, and
runs its body through ``guard::on_device`` (``csrc/device_guard.cuh``),
which makes the device current for the launch and restores the calling
thread's own. These hold on the CPU; launching on a second card and from a
fresh thread is `test_torch_cuda.py`'s (marked ``cuda``).
"""
import ctypes
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import device_index

C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long": ctypes.c_long}


def _entry_point(name: str) -> tuple[list[str], str]:
    """The parameters (type and name) and the body of ``csrc/<name>.cu``'s
    entry point."""
    fn_name, _ = _build.SIGNATURES[name]
    text = (_build.CSRC / f"{name}.cu").read_text()
    found = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)\s*\{(.*?)\n\}", text,
                      re.DOTALL)
    assert found, f"{name}.cu declares no {fn_name}"
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    return params, found.group(2)


def _c_type(param: str):
    """The ctypes type a C parameter binds as: any pointer is a void*."""
    decl = param.rsplit(" ", 1)[0]
    return ctypes.c_void_p if "*" in decl else C_TYPES[decl.replace("const ", "")]


@pytest.mark.parametrize("index", [0, 1, 3, 63])
def test_device_index_is_the_tensors_own(index):
    assert device_index(torch.device("cuda", index)) == index


def test_device_index_refuses_a_host_device():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        device_index(torch.device("cpu"))


@pytest.mark.parametrize("name", _build.SOURCES)
def test_entry_point_takes_its_device_and_stream_last(name):
    params, _ = _entry_point(name)
    assert params[-2:] == ["int device", "void* stream_ptr"], params
    assert _build.SIGNATURES[name][1][-2:] == _build.LAUNCH_TARGET


@pytest.mark.parametrize("name", _build.SOURCES)
def test_bound_argument_types_match_the_declaration(name):
    params, _ = _entry_point(name)
    assert [_c_type(p) for p in params] == _build.SIGNATURES[name][1], params


@pytest.mark.parametrize("name", _build.SOURCES)
def test_entry_point_runs_its_body_on_the_device(name):
    """The whole body runs through `guard::on_device(device, ...)`, the one
    place the device is made current and restored; no source asks the
    runtime which device is current for its per-device state."""
    _, body = _entry_point(name)
    assert "guard::on_device(device, [&]() -> int {" in body
    assert body.strip().startswith(("return guard::on_device", "if ("))
    sources = [(_build.CSRC / f"{name}.cu").read_text(),
               (_build.CSRC / "hist_common.cuh").read_text()]
    assert not any("cudaGetDevice" in text for text in sources)


def test_wrappers_raise_on_a_host_tensor():
    """No quiet fallback: a wrapper handed a CPU tensor raises rather than
    run the plain version."""
    from repro_torch.kernels import bitpack, ellpack_bin, forest, histogram, partition

    bins = torch.zeros((4, 2), dtype=torch.uint8)
    f = torch.zeros(4)
    i = torch.zeros(4, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    calls = [
        lambda: histogram.build_histogram_nodes(bins, f, f, i, one, 8),
        lambda: histogram.build_histogram(bins, f, f, i, 1, 8),
        lambda: partition.partition_rows(bins, i, one, one, one.bool(), one.bool()),
        lambda: forest.predict_forest(bins, one[None], one[None], one[None].bool(),
                                      one[None].bool(), f[:1][None], 1, f),
        lambda: ellpack_bin.bin_values(f.reshape(2, 2), f.reshape(2, 2), one.repeat(2)),
        lambda: bitpack.bitpack_decode(bins, 2, 8, None),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes CUDA tensors only"):
            call()
