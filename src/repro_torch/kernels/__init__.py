"""Hand-written CUDA kernels, their plain PyTorch versions, and the dispatch.

`kernels.ops` dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (`histogram`, `partition`, `forest`,
`ellpack_bin`, `bitpack`), a CPU tensor runs the plain version in `kernels.ref`.
Nothing here builds or imports a compiler at import time; `kernels._build`
compiles the sources in ``kernels/csrc`` on first use.

Each wrapper counts the launches of its kernel in this process;
`launch_counts` reads every count by kernel name, `reset_launch_counts`
sets them to 0.
"""

# kernel name -> (wrapper module, counter attribute)
_COUNTERS = {
    "build_histogram_nodes": ("histogram", "launches"),
    "build_histogram": ("histogram", "launches_window"),
    "partition_rows": ("partition", "launches"),
    "predict_forest": ("forest", "launches"),
    "bin_values": ("ellpack_bin", "launches"),
    "bitpack_decode": ("bitpack", "launches"),
}


def _module(name: str):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


def launch_counts() -> dict[str, int]:
    """This process's launch count of every CUDA kernel, by kernel name."""
    return {k: getattr(_module(mod), attr) for k, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(_module(mod), attr, 0)
