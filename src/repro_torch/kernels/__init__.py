"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (the port of the reference package's Pallas TPU kernels)."""

from .stencil_engine import (BC, PATH_KINDS, StencilPlan,  # noqa: F401
                             StencilSpec, as_boundary, autotune_engine,
                             bytes_per_point, carry_over, compile_plan,
                             dirichlet, get_stencil, list_stencils,
                             pick_block_rows, register_stencil,
                             spec_from_mask, stencil3, stencil3_ref,
                             stencil7, stencil7_ref, stencil27,
                             stencil27_ref, stencil_apply, stencil_ref)
