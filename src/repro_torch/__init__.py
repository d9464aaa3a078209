"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA H100.

Mirrors ``repro``'s layout module for module; imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.  Ported so far: the PPC450
machine model the plan compiler uses (:mod:`.core`) and the stencil
engine's main path (:mod:`.kernels.stencil_engine`).
"""
