"""PyTorch + CUDA port of `repro`, the out-of-core GBDT reproduction.

Mirrors `src/repro/` module for module. Plain tensor code is PyTorch; every
Pallas kernel on the in-core and out-of-core streaming ``GradientBooster.fit
-> predict`` paths is a hand-written CUDA C++ kernel for Hopper
(`repro_torch.kernels`). Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel wrapper is replaced by its
plain PyTorch version.
"""
