"""FedRPCA in PyTorch for NVIDIA Hopper: the port of ``src/repro``.

The layout mirrors the JAX package module for module
(``repro_torch/core/rpca.py`` is the counterpart of ``repro/core/rpca.py``).
It imports torch, numpy and the standard library only — never JAX and
never the JAX package.  Its Pallas kernels are CUDA kernels written by hand
(``repro_torch/kernels``), built from source at first use.
"""
