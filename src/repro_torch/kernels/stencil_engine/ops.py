"""Public entry point: ``stencil_apply``, one configurable stencil executor.

``stencil_apply`` runs a registered (or ad-hoc) spec over batched,
multi-dtype inputs: the spec compiles to a plan (:mod:`.plan`), the block
chooser (:mod:`.autotune`) sizes the launch for the H100, and the kernels
(:mod:`.kernel`) run it -- ``stencil_stream`` for volumetric specs,
``stencil_rows`` for k-only ones.  On a CPU tensor the kernels' plain
PyTorch versions run instead; on a CUDA tensor the kernels launch or the
call raises.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .autotune import PATH_KINDS, autotune_engine, pick_block_rows
from .kernel import acc_dtype_for, check_slice, stencil_rows, stencil_stream
from .plan import compile_plan
from .spec import StencilSpec, get_stencil


def _validate_blocks(m: int, n: int, bi: Optional[int], bj: Optional[int],
                     sweeps: int, radius, apps: int = 1) -> None:
    """The reference's contract for pinned blocks (a pinned ``block_i``
    divides M and covers the fused-sweep halo; likewise a pinned
    ``block_j`` for N), kept message for message so a call the reference
    refuses is refused here too.  ``apps`` is the spec's applications per
    sweep; ``None`` is a block the chooser picks."""
    ri, rj, _ = radius
    if bi is not None:
        if m % bi != 0:
            raise ValueError(f"block size {bi} must divide M={m}")
        if ri * sweeps * apps > bi:
            raise ValueError(f"fused sweeps={sweeps} exceed the carried "
                             f"halo; need block_i >= sweeps*r_i*sweep_apps "
                             f"(block_i={bi}, r_i={ri}, sweep_apps={apps})")
    if bj is not None:
        if n % bj != 0:
            raise ValueError(f"block size {bj} must divide N={n}")
        if rj * sweeps * apps > bj:
            raise ValueError(f"fused sweeps={sweeps} exceed the carried "
                             f"halo; need block_j >= sweeps*r_j*sweep_apps "
                             f"(block_j={bj}, r_j={rj}, sweep_apps={apps})")


def stencil_apply(a: torch.Tensor, w,
                  stencil: Union[str, int, StencilSpec] = "stencil27",
                  block_i: Optional[int] = None,
                  block_j: Optional[int] = None, plan: str = "auto",
                  sweeps: int = 1, path: str = "auto", bc=None,
                  guard=None) -> torch.Tensor:
    """Apply a registered stencil: ``sweeps`` Jacobi applications.

    * volumetric specs: ``a`` is ``(..., M, N, P)`` -- leading dims batch;
    * k-only specs: ``a`` is ``(..., P)`` -- leading dims are rows;
    * ``w`` is the spec's weight array (``w_shape``; a tensor, a numpy
      array or a sequence), moved to ``a``'s device;
    * bf16/f32 inputs accumulate in f32, f64 stays f64; the result has
      ``a``'s dtype and device;
    * ``plan`` picks the plan the plain versions walk (``auto``,
      ``factored``, ``cse``, ``direct``);
    * ``path``: ``"auto"`` and ``"stream"`` run the streaming kernel;
    * ``block_i`` / ``block_j`` (the i-chunk a thread block streams, the
      j-tile height; ``block_i`` is the rows per block for k-only specs)
      default to the H100 block chooser; pinned values keep the
      reference's contract (:func:`_validate_blocks`);
    * ``bc`` overrides the spec's boundary conditions.

    Not ported yet, and refused with ``NotImplementedError`` on every
    device: periodic, dirichlet and neumann boundaries, variable
    coefficients, red-black ordering, ``path="replicate"`` and guarded
    execution (``guard`` other than ``None``/``"off"``).
    """
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if path not in PATH_KINDS:
        raise ValueError(f"unknown path {path!r}; expected one of "
                         f"{PATH_KINDS}")
    spec = get_stencil(stencil)
    level = spec.guard if guard is None else guard
    if level not in (None, "off"):
        raise NotImplementedError(
            f"guarded execution (guard={level!r}) is not ported yet "
            f"(ROADMAP A8)")
    if bc is not None:
        spec = spec.with_bc(bc)
    if path == "replicate":
        raise NotImplementedError(
            "path='replicate' (the stateless replicated-halo kernel) is not "
            "ported yet (ROADMAP A6); use path='stream' or 'auto'")
    check_slice(spec)
    cplan = compile_plan(spec, plan)
    a = torch.as_tensor(a)
    acc = acc_dtype_for(a.dtype)
    wf = spec.canon_weights(torch.as_tensor(w))
    if a.is_cuda and not wf.is_cuda:
        # From pageable memory the copy would wait for the card to finish
        # its queue; from pinned memory it is queued behind it instead.
        wf = wf.pin_memory().to(a.device, non_blocking=True)
    wf = wf.to(device=a.device, dtype=acc).contiguous()

    if spec.ndim == 1:
        if a.dim() < 2:
            raise ValueError(f"{spec.name}: need (..., rows, P), got "
                             f"{tuple(a.shape)}")
        rows = int(np.prod(a.shape[:-1]))
        a2 = a.reshape(rows, a.shape[-1]).contiguous()
        br = block_i or pick_block_rows(rows, a.shape[-1], a.element_size())
        return stencil_rows(a2, wf, cplan, br, sweeps).reshape(a.shape)

    if a.dim() < 3:
        raise ValueError(f"{spec.name}: need (..., M, N, P), got "
                         f"{tuple(a.shape)}")
    m, n, p = a.shape[-3:]
    batch = int(np.prod(a.shape[:-3])) if a.dim() > 3 else 1
    a4 = a.reshape(batch, m, n, p).contiguous()
    _validate_blocks(m, n, block_i, block_j, sweeps, spec.radius,
                     spec.sweep_apps)
    bi, bj = block_i, block_j
    if bi is None or bj is None:
        _, bi, bj = autotune_engine(m, n, p, a.element_size(),
                                    sweeps=sweeps, plan=cplan, batch=batch,
                                    block_i=bi, block_j=bj, path=path)
    return stencil_stream(a4, wf, cplan, bi, bj, sweeps).reshape(a.shape)
