"""PyTorch / CUDA port of the CLOVER reproduction, for one NVIDIA H100.

Same module layout as the JAX package ``repro`` (which stays the
reference): ``configs``, ``models``, ``core``, ``kernels``, ``serve``.
This package imports ``torch`` and ``numpy`` only.  Its entry points
(``models.transformer.init_lm_params`` / ``forward``,
``serve.engine.Engine`` / ``greedy_reference``) run on ``cuda`` unless
the caller passes ``device="cpu"`` (``repro_torch.device``).

Kernels (DESIGN.md §4): the Pallas TPU kernels on the serving path are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use (``kernels/_build.py``).

The JAX reference computes in full float32, so TF32 is switched off
once, here, for every float32 matmul and convolution the port runs.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
