"""Public entry point: ``stencil_apply``, one configurable stencil executor.

``stencil_apply`` runs a registered (or ad-hoc) spec over batched,
multi-dtype inputs: the spec compiles to a plan (:mod:`.plan`), the block
chooser (:mod:`.autotune`) sizes the launch for the H100, and the kernels
(:mod:`.kernel`) run it -- ``stencil_stream`` for volumetric specs (or
``stencil_replicate`` with ``path="replicate"``), ``stencil_rows`` for
k-only ones.  On a CPU tensor the kernels' plain PyTorch versions run
instead; on a CUDA tensor the kernels launch or the call raises.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .autotune import PATH_KINDS, autotune_engine, pick_block_rows
from .kernel import (acc_dtype_for, check_slice, stencil_replicate,
                     stencil_rows, stencil_stream)
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


def _on_device(a) -> torch.Tensor:
    """A tensor keeps its device; anything else goes to the card."""
    if isinstance(a, torch.Tensor):
        return a
    if not torch.cuda.is_available():
        raise RuntimeError(
            "stencil_apply: the input is not a torch.Tensor, so it would run "
            "on the CUDA device, and there is none; pass a CPU tensor "
            "(torch.as_tensor(a)) to run the kernels' plain versions on the "
            "CPU")
    return torch.as_tensor(a, device="cuda")


def stencil_apply(a, w, stencil: Union[str, int, StencilSpec] = "stencil27",
                  block_i: Optional[int] = None,
                  block_j: Optional[int] = None, plan: str = "auto",
                  sweeps: int = 1, path: str = "auto", bc=None,
                  guard=None) -> torch.Tensor:
    """Apply a registered stencil: ``sweeps`` Jacobi applications.

    * volumetric specs: ``a`` is ``(..., M, N, P)`` -- leading dims batch;
    * k-only specs: ``a`` is ``(..., P)`` -- leading dims are rows;
    * ``a`` as a ``torch.Tensor`` runs where it lies (a CPU tensor runs the
      kernels' plain versions); anything else (a numpy array, a sequence)
      goes to the CUDA device, and the call raises where there is none;
    * ``w`` is the spec's weight array (``w_shape``; a tensor, a numpy
      array or a sequence), moved to ``a``'s device; for a
      variable-coefficient spec (``spec.coef == "var"``) it carries a
      leading ``(n_weights,)`` axis with trailing dims broadcast over the
      domain (``out[x] = sum_t w_t(x) * u[x + off_t]``, coefficients at the
      output point, shared across the batch);
    * bf16/f32 inputs accumulate in f32, f64 stays f64; the result has
      ``a``'s dtype and device;
    * ``plan`` picks the plan the plain versions walk (``auto``,
      ``factored``, ``cse``, ``direct``);
    * ``path``: ``"auto"`` and ``"stream"`` run the streaming kernel, one
      launch per sweep; ``"replicate"`` the replicated-halo kernel, which
      fuses the sweeps into one launch (in groups where its tile cannot
      hold all their halo -- :func:`~.kernel.stencil_replicate`);
    * ``block_i`` / ``block_j`` default to the H100 block chooser: for the
      streaming kernel the i-chunk a thread block streams and the j-tile
      height, for the replicated-halo kernel its output tile's i and j
      extents, for k-only specs (``block_i``) the rows per block; pinned
      values keep the reference's contract (:func:`_validate_blocks`);
    * ``bc`` overrides the spec's per-axis-side boundary conditions (any
      :func:`~.spec.as_boundary` spelling).

    Not ported yet, and refused with ``NotImplementedError`` on every
    device: red-black ordering, radius > 2 volumetric specs and guarded
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
    check_slice(spec)
    cplan = compile_plan(spec, plan)
    a = _on_device(a)
    if a.dim() < 2 or (spec.ndim == 3 and a.dim() < 3):
        want = "(..., rows, P)" if spec.ndim == 1 else "(..., M, N, P)"
        raise ValueError(f"{spec.name}: need {want}, got {tuple(a.shape)}")
    acc = acc_dtype_for(a.dtype)
    var = spec.coef == "var"
    wf = spec.canon_weights(torch.as_tensor(w),
                            a.shape[-spec.ndim:] if var else None)
    if a.is_cuda and not wf.is_cuda and not var:
        # From pageable memory the copy would wait for the card to finish
        # its queue; from pinned memory it is queued behind it instead.
        wf = wf.pin_memory().to(a.device, non_blocking=True)
    wf = wf.to(device=a.device, dtype=acc).contiguous()

    if spec.ndim == 1:
        rows = int(np.prod(a.shape[:-1]))
        a2 = a.reshape(rows, a.shape[-1]).contiguous()
        br = block_i or pick_block_rows(rows, a.shape[-1], a.element_size())
        return stencil_rows(a2, wf, cplan, br, sweeps).reshape(a.shape)

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
    run = stencil_replicate if path == "replicate" else stencil_stream
    return run(a4, wf, cplan, bi, bj, sweeps).reshape(a.shape)
