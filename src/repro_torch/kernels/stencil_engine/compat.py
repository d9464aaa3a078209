"""Legacy per-stencil entry points, thin wrappers over the engine.

The wrapper bodies are built by the factories in
:mod:`repro_torch.kernels._compat`: ``stencil3`` / ``stencil7`` /
``stencil27(a, w, block_*)`` run ``stencil_apply``, and their ``*_ref``
functions ``stencil_ref``.
"""

from __future__ import annotations

from .._compat import (stencil3, stencil3_ref, stencil7,  # noqa: F401
                       stencil7_ref, stencil27, stencil27_ref)
