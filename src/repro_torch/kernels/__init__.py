"""Hand-written CUDA kernels, their plain PyTorch versions, and the dispatch.

`kernels.ops` dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (`histogram`, `partition`, `forest`,
`ellpack_bin`), a CPU tensor runs the plain version in `kernels.ref`.
Nothing here builds or imports a compiler at import time; `kernels._build`
compiles the sources in ``kernels/csrc`` on first use.
"""
