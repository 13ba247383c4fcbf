"""Hand-written Hopper kernels, one package per reference Pallas kernel.

Each ``kernels/<name>/`` holds ``ref.py`` (the plain torch version: the CPU
path and the test oracle), ``ops.py`` (the wrapper: plain version for CPU
tensors, the kernel for CUDA tensors, never a fallback) and ``kernel.py``
(the GPU launch, with its CUDA C++ or Triton source beside it). Kernels are
built at first use, never at import, into ``build/torch_kernels/``.
"""
