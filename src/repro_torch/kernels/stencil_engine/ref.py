"""PyTorch oracle for the engine's stencils (f64-capable reference path).

Executes the same compiled plan (:mod:`.plan`) as the reference package's
``stencil_ref``, with zero-fill shifts and the same accumulation dtype
rules, on the whole field: each sweep walks the plan and zeroes the
one-point clamp ring of the trailing ``ndim`` axes.  This slice carries
clamp boundaries and Jacobi sweeps; other boundary conditions and red-black
ordering raise (:func:`~.kernel.check_slice`).
"""

from __future__ import annotations

import torch

from .kernel import _interior_mask, acc_dtype_for, check_slice, run_sweeps
from .plan import StencilPlan, compile_plan
from .spec import get_stencil


def apply_plan_once(u: torch.Tensor, w: torch.Tensor,
                    cplan: StencilPlan) -> torch.Tensor:
    """One clamp application of the planned operator, in ``u.dtype``:
    masked execution on the unpadded field (the zero-fill shifts are the
    clamp ghosts)."""
    return run_sweeps(u, _interior_mask(u.shape, cplan.spec.ndim, u.device),
                      w, cplan, 1)


def stencil_ref(a: torch.Tensor, w, stencil="stencil27", sweeps: int = 1,
                plan: str = "auto", bc=None) -> torch.Tensor:
    """Reference for ``stencil_apply``: ``sweeps`` Jacobi applications of
    the named (or ad-hoc) spec under the same compiled ``plan``."""
    spec = get_stencil(stencil)
    if bc is not None:
        spec = spec.with_bc(bc)
    check_slice(spec)
    if a.dim() < spec.ndim:
        raise ValueError(f"{spec.name}: input rank {a.dim()} < {spec.ndim}")
    cplan = compile_plan(spec, plan)
    acc = acc_dtype_for(a.dtype)
    u = a.to(acc)
    wf = spec.canon_weights(torch.as_tensor(w)).to(device=a.device,
                                                   dtype=acc)
    u = run_sweeps(u, _interior_mask(u.shape, spec.ndim, a.device), wf,
                   cplan, sweeps)
    return u.to(a.dtype)
