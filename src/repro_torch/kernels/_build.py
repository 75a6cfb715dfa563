"""Build the CUDA sources in ``kernels/csrc`` on first use and bind them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a shared
library with a plain C interface (``-gencode=arch=compute_90a,code=sm_90a``),
all processes started together, and loaded with `ctypes`. No source includes
PyTorch's headers, so a build takes seconds rather than the minutes a
`torch.utils.cpp_extension` build of the same code would. The wrappers pass
raw device pointers (``tensor.data_ptr()``), then the index of the tensors'
device and its current stream (`_checks.launch_target`): each entry point
makes that device current for its launch and restores the calling thread's
own (``csrc/device_guard.cuh``), so a launch runs on its tensors' card from
any thread, whatever device the thread has current.

Libraries go to ``build/torch_kernels/`` at the repository root, named by a
hash of their source, the local headers it includes (``#include "..."``)
and the flags, so an edited source or header rebuilds and an unchanged one
is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("histogram", "hist_window", "partition", "forest", "ellpack_bin", "bitpack")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
    "-ldl",  # device_guard.cuh looks up a libcuda symbol with dlsym
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# argtypes of each library's C entry point (see the extern "C" functions);
# each ends with the device index and the stream
LAUNCH_TARGET = [_I, _P]
SIGNATURES = {
    "histogram": ("hist_nodes_launch", [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                                        _I, _P, _I, *LAUNCH_TARGET]),
    "hist_window": ("hist_window_launch", [_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                                           _P, _P, _P, _I, _P, _I, *LAUNCH_TARGET]),
    "partition": ("partition_launch", [_P, _I, _L, _I, _P, _P, _P, _P, _P, _I, _P, _L, _I, _P,
                                       *LAUNCH_TARGET]),
    "forest": ("forest_launch", [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P, *LAUNCH_TARGET]),
    "ellpack_bin": ("ellpack_bin_launch", [_P, _I, _L, _I, _P, _I, _P, _P, *LAUNCH_TARGET]),
    "bitpack": ("bitpack_decode_launch", [_P, _L, _L, _L, _I, _I, _L, _P, *LAUNCH_TARGET]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source compiler output (ptxas register/shared-memory report) and the
# wall seconds of the last build, for `chip_smoke.py` to print
build_log: dict[str, str] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_bytes(path: Path, seen: set[Path]) -> bytes:
    """A source's bytes followed by those of every local header it includes,
    recursively, each once."""
    if path in seen:
        return b""
    seen.add(path)
    text = path.read_bytes()
    return text + b"".join(
        _source_bytes(path.parent / inc.decode(), seen) for inc in _LOCAL_INCLUDE.findall(text)
    )


def _lib_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}.{digest}.so"


def build_all() -> None:
    """Compile every source whose library is missing, one nvcc each, in
    parallel; raise with the compiler's output if any build fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes._CFuncPtr:
    """The C entry point of ``csrc/<name>.cu``, building all sources first
    if any library is missing."""
    with _lock:
        if name not in _libs:
            if not all(_lib_path(n).exists() for n in SOURCES):
                build_all()
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(str(_lib_path(n)))
                fn_name, argtypes = SIGNATURES[n]
                fn = getattr(_libs[n], fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        fn_name, _ = SIGNATURES[name]
        return getattr(_libs[name], fn_name)


def check(err: int, what: str, device) -> None:
    """Raise if a launch on ``device`` returned a CUDA error code."""
    if err != 0:
        import torch

        name = torch.cuda.get_device_name(device) if torch.cuda.is_available() else "no device"
        raise RuntimeError(f"{what}: CUDA error {err} on {device} ({name})")
