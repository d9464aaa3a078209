"""PyTorch oracle for the engine's stencils (f64-capable reference path).

Executes the same compiled plan (:mod:`.plan`) as the reference package's
``stencil_ref``, with zero-fill shifts and the same accumulation dtype
rules, on the whole field.

Boundary conditions are realized ``np.pad``-style: each sweep pads the
field by ``radius`` per axis under the per-axis-side pad mode (``clamp`` ->
zeros, ``periodic`` -> ``wrap``, ``dirichlet`` -> the ghost value,
``neumann`` -> ``symmetric``, so ghost ``-1-g`` reads ``g``), axes in i, j,
k order (at ghost corners the later-padded axis wins), walks the plan on
the padded field, crops the centre, and zeroes the one-point ring of every
``clamp`` side.  Variable coefficients are zero-padded.  The all-clamp
default skips the pad: the zero-fill shifts are the clamp ghosts.

The kernels' plain versions (:mod:`.kernel`) run this same sweep,
:func:`apply_plan_once`; red-black ordering raises
(:func:`~.common.check_slice`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import acc_dtype_for, check_slice
from .plan import StencilPlan, compile_plan, execute_plan
from .spec import BC, StencilSpec, get_stencil


def ghost_index(g: torch.Tensor, n: int, kind: str) -> torch.Tensor:
    """Where the ghost coordinates ``g`` of an axis of extent ``n`` read
    under a wrapping (``periodic``) or mirroring (``neumann``) BC: ``np.pad``
    modes ``wrap`` and ``symmetric``, at any overshoot (the symmetric
    extension has period ``2 n``).  The same rule as
    ``csrc/stencil_common.cuh:bc_index``."""
    if kind == "periodic":
        return g % n
    m = g % (2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _pad_side(u: torch.Tensor, axis: int, lo_w: int, hi_w: int,
              bc: BC) -> torch.Tensor:
    """Pad ``axis`` by ``lo_w`` / ``hi_w`` ghosts under one side's BC."""
    if lo_w == 0 and hi_w == 0:
        return u
    n = u.shape[axis]
    parts = []
    for g0, width in ((-lo_w, lo_w), (n, hi_w)):
        if width == 0:
            parts.append(None)
        elif bc.kind in ("clamp", "dirichlet"):
            shape = list(u.shape)
            shape[axis] = width
            parts.append(torch.full(shape, bc.value, dtype=u.dtype,
                                    device=u.device))
        else:
            g = torch.arange(g0, g0 + width, device=u.device)
            parts.append(u.index_select(axis, ghost_index(g, n, bc.kind)))
    return torch.cat([p for p in (parts[0], u, parts[1]) if p is not None],
                     dim=axis)


def pad_bc(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One ``np.pad``-equivalent ghost extension of the trailing ``ndim``
    axes by ``radius`` per side, per-axis-side modes, axes in i, j, k order
    (a periodic pair pads both sides at once; other axes pad lo then hi --
    each one-sided pad reads only its own edge)."""
    for ax in range(3 - spec.ndim, 3):
        r = spec.radius[ax]
        if r == 0:
            continue
        axis = u.dim() - 3 + ax
        lo, hi = spec.bc[ax]
        if lo.kind == "periodic":           # validated paired
            u = _pad_side(u, axis, r, r, lo)
        else:
            u = _pad_side(u, axis, r, 0, lo)
            u = _pad_side(u, axis, 0, r, hi)
    return u


def clamp_ring_mask(shape, spec: StencilSpec,
                    device=None) -> Optional[torch.Tensor]:
    """Boolean mask, False on the one-point output ring of every clamp side
    of the trailing ``ndim`` axes (one point wide at every radius); ``None``
    when no side is clamp.  The one place the port builds the ring."""
    mask = None
    for ax in range(3 - spec.ndim, 3):
        axis = len(shape) - 3 + ax
        lo, hi = spec.bc[ax]
        n = shape[axis]
        idx = torch.arange(n, device=device).view(
            (n,) + (1,) * (len(shape) - 1 - axis))
        for side, keep in ((lo, idx > 0), (hi, idx < n - 1)):
            if side.kind == "clamp":
                mask = keep if mask is None else mask & keep
    return mask


def apply_plan_once(u: torch.Tensor, w: torch.Tensor,
                    cplan: StencilPlan) -> torch.Tensor:
    """One BC-padded application of the planned operator, in ``u.dtype``.

    ``w`` is the flat weight vector, or for a variable-coefficient spec the
    ``(n_weights, *domain)`` coefficient fields, zero-extended to the padded
    shape: coefficients are evaluated at the output point, and every
    ghost-position output is cropped."""
    spec = cplan.spec
    mask = clamp_ring_mask(u.shape, spec, u.device)
    if all(s.kind == "clamp" for ax in spec.bc for s in ax):
        v = execute_plan(cplan, u, w)
    else:
        wp = w
        if spec.coef == "var":
            pw = []
            for ax in reversed(range(3 - spec.ndim, 3)):
                pw += [spec.radius[ax]] * 2
            wp = torch.nn.functional.pad(w, pw)
        v = execute_plan(cplan, pad_bc(u, spec), wp)
        for ax in range(3 - spec.ndim, 3):
            axis = u.dim() - 3 + ax
            v = v.narrow(axis, spec.radius[ax], u.shape[axis])
    if mask is None:
        return v
    return torch.where(mask, v, 0.0)


def run_sweeps(u: torch.Tensor, w: torch.Tensor, plan: StencilPlan,
               sweeps: int) -> torch.Tensor:
    """``sweeps`` Jacobi applications of the plan (:func:`apply_plan_once`);
    ``u`` and ``w`` carry the accumulation dtype."""
    for _ in range(sweeps):
        u = apply_plan_once(u, w, plan)
    return u


def stencil_ref(a: torch.Tensor, w, stencil="stencil27", sweeps: int = 1,
                plan: str = "auto", bc=None) -> torch.Tensor:
    """Reference for ``stencil_apply``: ``sweeps`` Jacobi applications of
    the named (or ad-hoc) spec under the same compiled ``plan``, re-padded
    per sweep under the spec's (or the ``bc`` override's) boundary
    conditions."""
    spec = get_stencil(stencil)
    if bc is not None:
        spec = spec.with_bc(bc)
    check_slice(spec)
    if a.dim() < spec.ndim:
        raise ValueError(f"{spec.name}: input rank {a.dim()} < {spec.ndim}")
    cplan = compile_plan(spec, plan)
    acc = acc_dtype_for(a.dtype)
    dom = a.shape[-spec.ndim:] if spec.coef == "var" else None
    wf = spec.canon_weights(torch.as_tensor(w), dom).to(device=a.device,
                                                        dtype=acc)
    return run_sweeps(a.to(acc), wf, cplan, sweeps).to(a.dtype)
