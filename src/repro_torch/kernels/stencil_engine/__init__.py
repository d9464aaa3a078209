"""The stencil engine, ported to PyTorch with CUDA kernels for the H100.

The same spec registry (:mod:`.spec`) and cost-driven plan compiler
(:mod:`.plan`) as the reference package's engine, one entry point
(:func:`stencil_apply`), and three hand-written CUDA kernels
(:mod:`.kernel`): ``stencil_stream`` for volumetric specs (the plane-
streaming main path), ``stencil_replicate`` for volumetric specs with
``path="replicate"`` (sweeps fused in one launch) and ``stencil_rows`` for
k-only specs, each beside its plain PyTorch version.  :func:`stencil_ref`
is the oracle; :mod:`.compat` holds the legacy per-stencil entry points.

The port carries every boundary condition, constant and variable
coefficients and Jacobi sweeps at radius <= 2; the rest raises
``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from .autotune import (PATH_KINDS, autotune_engine,  # noqa: F401
                       bytes_per_point, pick_block_rows, replicate_tile)
from .kernel import (build_kernels, stencil_replicate,  # noqa: F401
                     stencil_replicate_plain, stencil_rows,
                     stencil_rows_plain, stencil_stream,
                     stencil_stream_plain)
from .compat import (stencil3, stencil3_ref, stencil7,  # noqa: F401
                     stencil7_ref, stencil27, stencil27_ref)
from .ops import stencil_apply  # noqa: F401
from .plan import (PASS_PRESETS, PLAN_KINDS, PlanOp,  # noqa: F401
                   StencilPlan, compile_plan, execute_plan,
                   mirror_symmetric, peak_live, run_passes, shift_slice)
from .ref import stencil_ref  # noqa: F401
from .spec import (BC, BC_KINDS, CLAMP, GUARD_KINDS, NEUMANN,  # noqa: F401
                   ORDERING_KINDS, PERIODIC, StencilSpec, as_boundary,
                   bc_labels, carry_over, dirichlet, get_stencil,
                   list_stencils, register_stencil, spec_from_mask)
