"""repro_torch — the PyTorch/CUDA port of the Seneca reproduction.

The JAX package ``repro`` is the reference; this package is its second
implementation for an NVIDIA H100.  It imports ``torch`` and ``numpy``
and never ``jax`` or any module of ``repro``: every data-plane module it
needs is its own copy, at the same relative path (``repro_torch.data.
pipeline`` is the twin of ``repro.data.pipeline``).  The Pallas kernels
on the loader's device route are hand-written CUDA C++ under
``csrc/``, each beside a plain PyTorch version.  Start at
:mod:`repro_torch.api`.
"""
