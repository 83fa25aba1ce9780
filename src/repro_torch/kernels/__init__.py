"""Kernels of the port (DESIGN.md §4; the page movers §9, §12): CUDA
C++ sources in ``csrc/``, built at first use by ``_build``; Python
wrappers with launch counts; plain PyTorch versions in ``ref``; device
dispatch in ``ops``.
Importing this package builds nothing and needs no card."""
