"""The engine's kernels: CUDA wrappers and their plain PyTorch versions.

Two hand-written CUDA kernels (``csrc/``) carry ``stencil_apply`` on the
card; beside each sits its plain PyTorch version, which computes the same
function on whole tensors by walking the compiled plan (:mod:`.plan`):

``stencil_stream`` -- volumetric specs over ``(B, M, N, P)``
    Replaces the TPU kernel ``repro/kernels/stencil_engine/kernel.py:496``
    (``stencil3d_stream_kernel``).  Plain version:
    :func:`stencil_stream_plain`, the whole-domain clamp :func:`run_sweeps`
    over :func:`~.plan.execute_plan`.

``stencil_rows`` -- k-only specs over independent ``(rows, P)`` rows
    Replaces ``repro/kernels/stencil_engine/kernel.py:766``
    (``stencil1d_kernel``).  Plain version: :func:`stencil_rows_plain`.

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises -- there is no fallback.  Each
wrapper counts its launches in a plain int attribute (``.launches``), so a
run can show that it went through the kernels.  Both implement the slice of
the reference's semantics this port carries (:func:`check_slice`): clamp
boundaries on every side, constant coefficients, Jacobi sweeps.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from ... import cuda_build
from .autotune import rows_smem_bytes, stream_smem_bytes
from .common import SMEM_PER_BLOCK, STATIC_SMEM, STREAM_MAX_BLOCK_J
from .plan import StencilPlan, execute_plan
from .spec import StencilSpec

CSRC = Path(__file__).resolve().with_name("csrc")
STREAM_SOURCE = CSRC / "stencil_stream.cu"
ROWS_SOURCE = CSRC / "stencil_rows.cu"

MAX_TAPS = 125        # csrc/stencil_common.cuh:STENCIL_MAX_TAPS
MAX_RADIUS = 2        # csrc/stencil_common.cuh:STENCIL_MAX_R
GRID_YZ_LIMIT = 65535

_DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """bf16/f32 accumulate in f32; f64 stays f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def check_slice(spec: StencilSpec) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port does
    not carry yet, naming the ROADMAP item that will port it."""
    if any(s.kind != "clamp" for ax in spec.bc for s in ax):
        raise NotImplementedError(
            f"{spec.name}: periodic, dirichlet and neumann boundaries are "
            f"not ported yet (ROADMAP A5c); the port runs clamp boundaries")
    if spec.coef != "const":
        raise NotImplementedError(
            f"{spec.name}: variable coefficients are not ported yet "
            f"(ROADMAP A5d)")
    if spec.ordering != "jacobi":
        raise NotImplementedError(
            f"{spec.name}: red-black ordering is not ported yet "
            f"(ROADMAP A7)")
    if spec.ndim == 3 and max(spec.radius) > MAX_RADIUS:
        raise NotImplementedError(
            f"{spec.name}: radius {spec.radius} exceeds the streaming "
            f"kernel's window (radius <= {MAX_RADIUS} per axis; ROADMAP A5g)")
    if spec.taps > MAX_TAPS:
        raise NotImplementedError(
            f"{spec.name}: {spec.taps} taps exceed the kernels' tap table "
            f"({MAX_TAPS})")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _interior_mask(shape, ndim: int, device) -> torch.Tensor:
    """True off the one-point clamp ring of the trailing ``ndim`` axes --
    the ring is one point wide at every radius (out-of-domain reads are
    zeros).  The one place the port builds the ring."""
    mask = torch.ones((), dtype=torch.bool, device=device)
    for ax in range(-ndim, 0):
        n = shape[ax]
        idx = torch.arange(n, device=device).view(
            (n,) + (1,) * (-ax - 1))
        mask = mask & (idx > 0) & (idx < n - 1)
    return mask


def _volumetric_interior(shape, device) -> torch.Tensor:
    """Interior mask of a whole ``(..., M, N, P)`` domain: the clamp ring on
    all three axes."""
    return _interior_mask(shape, 3, device)


def run_sweeps(u: torch.Tensor, interior: torch.Tensor, w: torch.Tensor,
               plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """``sweeps`` clamp Jacobi applications of the plan: each walks the
    plan with zero-fill shifts (the clamp ghosts) and zeroes the clamp ring.
    ``u`` and ``w`` carry the accumulation dtype."""
    for _ in range(sweeps):
        u = torch.where(interior, execute_plan(plan, u, w), 0.0)
    return u


def stencil_stream_plain(a4: torch.Tensor, wf: torch.Tensor,
                         plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """Plain version of :func:`stencil_stream`: the whole domain at once,
    intermediates in the accumulation dtype, one cast at the end."""
    acc = acc_dtype_for(a4.dtype)
    u = run_sweeps(a4.to(acc), _volumetric_interior(a4.shape, a4.device),
                   wf.to(acc), plan, sweeps)
    return u.to(a4.dtype)


def stencil_rows_plain(a2: torch.Tensor, wf: torch.Tensor,
                       plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """Plain version of :func:`stencil_rows`: every row at once, the k
    clamp ring zeroed after each sweep."""
    acc = acc_dtype_for(a2.dtype)
    u = run_sweeps(a2.to(acc), _interior_mask(a2.shape, 1, a2.device),
                   wf.to(acc), plan, sweeps)
    return u.to(a2.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def build_kernels() -> Dict[str, str]:
    """Build both kernels (one ``nvcc`` each, started together) and return
    each source's ``-Xptxas -v`` report."""
    cuda_build.build([STREAM_SOURCE, ROWS_SOURCE])
    return {src.name: cuda_build.build_log(src)
            for src in (STREAM_SOURCE, ROWS_SOURCE)}


@functools.lru_cache(maxsize=None)
def _stream_lib() -> ctypes.CDLL:
    lib = cuda_build.load(str(STREAM_SOURCE))
    lib.stencil_stream_launch.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 12
                                          + [ctypes.c_void_p])
    lib.stencil_stream_launch.restype = ctypes.c_int
    lib.stencil_stream_error_string.argtypes = [ctypes.c_int]
    lib.stencil_stream_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _rows_lib() -> ctypes.CDLL:
    lib = cuda_build.load(str(ROWS_SOURCE))
    lib.stencil_rows_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.stencil_rows_launch.restype = ctypes.c_int
    lib.stencil_rows_error_string.argtypes = [ctypes.c_int]
    lib.stencil_rows_error_string.restype = ctypes.c_char_p
    return lib


def _window_radius(spec: StencilSpec):
    """The (ri, rj, rk) the kernels widen their windows by: a k-only spec
    streams no i or j halo."""
    if spec.ndim == 1:
        return 0, 0, spec.radius[2]
    return tuple(spec.radius)


@functools.lru_cache(maxsize=64)
def _tap_table(spec: StencilSpec, device: torch.device) -> torch.Tensor:
    """The spec's taps as the kernels read them (``csrc/stencil_common.cuh``):
    the start of each ``di`` run, then ``(dj, dk, w_index)`` per tap."""
    ri = _window_radius(spec)[0]
    group = [0]
    for g in range(2 * ri + 1):
        group.append(group[-1] + sum(1 for o in spec.offsets
                                     if o[0] == g - ri))
    rows = [v for (_, dj, dk), wi in zip(spec.offsets, spec.w_index)
            for v in (dj, dk, wi)]
    return torch.tensor(group + rows, dtype=torch.int32, device=device)


def _check_cuda_operands(name: str, a: torch.Tensor, wf: torch.Tensor,
                         spec: StencilSpec) -> None:
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {a.dtype}; the kernel "
                        f"takes float32, float64 and bfloat16")
    if not a.is_contiguous():
        raise ValueError(f"{name}: the field must be contiguous")
    acc = acc_dtype_for(a.dtype)
    if (wf.device != a.device or wf.dtype != acc or not wf.is_contiguous()
            or wf.shape != (spec.n_weights,)):
        raise ValueError(
            f"{name}: weights must be a contiguous ({spec.n_weights},) "
            f"{acc} tensor on {a.device}, got {tuple(wf.shape)} {wf.dtype} "
            f"on {wf.device}")


def _raise_on(code: int, lib_error, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{lib_error(code).decode()} (cudaError {code})")


def stencil_stream(a4: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
                   block_i: int, block_j: int, sweeps: int) -> torch.Tensor:
    """``sweeps`` clamp Jacobi sweeps of a volumetric plan over ``a4``
    ``(B, M, N, P)``, with the flat weights ``wf`` in the accumulation dtype.

    On a CUDA tensor: one ``csrc/stencil_stream.cu`` launch per sweep,
    thread blocks of ``(block_j x STREAM_TILE_K)`` tiles each streaming
    ``block_i`` planes; sweeps chain through accumulation-dtype buffers and
    the result is cast once, at the end.  On a CPU tensor: the plain
    version."""
    spec = plan.spec
    check_slice(spec)
    if spec.ndim != 3:
        raise ValueError(f"stencil_stream: {spec.name} is k-only; use "
                         f"stencil_rows")
    if a4.dim() != 4:
        raise ValueError(f"stencil_stream: need (B, M, N, P), got "
                         f"{tuple(a4.shape)}")
    if a4.device.type == "cpu":
        return stencil_stream_plain(a4, wf, plan, sweeps)
    if a4.device.type != "cuda":
        raise ValueError(f"stencil_stream: no kernel for device {a4.device}")
    _check_cuda_operands("stencil_stream", a4, wf, spec)
    b, m, n, p = a4.shape
    ri, rj, rk = _window_radius(spec)
    acc = acc_dtype_for(a4.dtype)
    if block_i < 1 or not 1 <= block_j <= STREAM_MAX_BLOCK_J:
        raise ValueError(f"stencil_stream: need block_i >= 1 and 1 <= "
                         f"block_j <= {STREAM_MAX_BLOCK_J}, got "
                         f"block_i={block_i}, block_j={block_j}")
    smem = stream_smem_bytes(block_j, (ri, rj, rk), acc.itemsize)
    if smem + STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(
            f"stencil_stream: block_j={block_j} needs {smem} bytes of "
            f"shared memory for its window, over the H100's "
            f"{SMEM_PER_BLOCK - STATIC_SMEM} bytes per block")
    if n * p >= 2 ** 31:
        raise ValueError(f"stencil_stream: a plane of {n} x {p} points "
                         f"exceeds the kernel's 32-bit plane offsets")
    n_chunks = -(-m // block_i)
    if -(-n // block_j) > GRID_YZ_LIMIT or b * n_chunks > GRID_YZ_LIMIT:
        raise ValueError(
            f"stencil_stream: grid ({-(-n // block_j)}, {b * n_chunks}) "
            f"exceeds {GRID_YZ_LIMIT}; raise block_j / block_i")
    lib = _stream_lib()
    taps = _tap_table(spec, a4.device)
    out = torch.empty_like(a4)
    bufs = [torch.empty(a4.shape, dtype=acc, device=a4.device)
            for _ in range(min(sweeps - 1, 2))]
    with torch.cuda.device(a4.device):
        stream = torch.cuda.current_stream().cuda_stream
        src = a4
        for q in range(sweeps):
            dst = out if q == sweeps - 1 else bufs[q % 2]
            code = lib.stencil_stream_launch(
                src.data_ptr(), dst.data_ptr(), wf.data_ptr(),
                taps.data_ptr(), spec.taps, ri, rj, rk,
                _DTYPE_CODES[src.dtype], _DTYPE_CODES[dst.dtype],
                b, m, n, p, block_i, block_j, stream)
            _raise_on(code, lib.stencil_stream_error_string, "stencil_stream")
            stencil_stream.launches += 1
            src = dst
    return out


stencil_stream.launches = 0


def stencil_rows(a2: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
                 block_rows: int, sweeps: int) -> torch.Tensor:
    """``sweeps`` fused clamp Jacobi sweeps of a k-only plan over the
    independent rows of ``a2`` ``(rows, P)``.

    On a CUDA tensor: one ``csrc/stencil_rows.cu`` launch, ``block_rows``
    rows per thread block resident in shared memory for every sweep.  On a
    CPU tensor: the plain version."""
    spec = plan.spec
    check_slice(spec)
    if spec.ndim != 1:
        raise ValueError(f"stencil_rows: {spec.name} is volumetric; use "
                         f"stencil_stream")
    rows, p = a2.shape
    if rows % block_rows != 0:
        raise ValueError(f"block_rows {block_rows} must divide rows={rows}")
    if a2.device.type == "cpu":
        return stencil_rows_plain(a2, wf, plan, sweeps)
    if a2.device.type != "cuda":
        raise ValueError(f"stencil_rows: no kernel for device {a2.device}")
    _check_cuda_operands("stencil_rows", a2, wf, spec)
    acc = acc_dtype_for(a2.dtype)
    smem = rows_smem_bytes(block_rows, p, acc.itemsize)
    limit = SMEM_PER_BLOCK - STATIC_SMEM
    if smem > limit:
        raise ValueError(
            f"stencil_rows: {block_rows} row(s) of P={p} need {smem} bytes "
            f"of shared memory (two {acc} copies), over the H100's {limit} "
            f"bytes per block; P <= {limit // (2 * acc.itemsize)} fits one "
            f"row per block")
    lib = _rows_lib()
    taps = _tap_table(spec, a2.device)
    out = torch.empty_like(a2)
    with torch.cuda.device(a2.device):
        code = lib.stencil_rows_launch(
            a2.data_ptr(), out.data_ptr(), wf.data_ptr(), taps.data_ptr(),
            spec.taps, _DTYPE_CODES[a2.dtype], rows, p, block_rows, sweeps,
            torch.cuda.current_stream().cuda_stream)
        _raise_on(code, lib.stencil_rows_error_string, "stencil_rows")
        stencil_rows.launches += 1
    return out


stencil_rows.launches = 0
