"""The engine's kernels: CUDA wrappers and their plain PyTorch versions.

Three hand-written CUDA kernels (``csrc/``) carry ``stencil_apply`` on the
card; beside each sits its plain PyTorch version, which computes the same
function on whole tensors by walking the compiled plan (:mod:`.plan`) on
the boundary-padded field (:func:`~.ref.apply_plan_once`, the oracle's
sweep -- one helper for all three):

``stencil_stream`` -- volumetric specs over ``(B, M, N, P)``
    Replaces the TPU kernel ``repro/kernels/stencil_engine/kernel.py:496``
    (``stencil3d_stream_kernel``).  One launch per sweep.  Plain version:
    :func:`stencil_stream_plain`.

``stencil_replicate`` -- volumetric specs, ``path="replicate"``
    Replaces ``repro/kernels/stencil_engine/kernel.py:435``
    (``stencil3d_kernel``).  Fuses the sweeps into one launch, each block
    recomputing its tile's halo.  Plain version:
    :func:`stencil_replicate_plain`.

``stencil_rows`` -- k-only specs over independent ``(rows, P)`` rows
    Replaces ``repro/kernels/stencil_engine/kernel.py:766``
    (``stencil1d_kernel``).  Plain version: :func:`stencil_rows_plain`.

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises -- there is no fallback.  Each
wrapper counts its launches in a plain int attribute (``.launches``), so a
run can show that it went through the kernels.  All three carry every
boundary condition (per axis side), constant and variable coefficients
(``wf`` is then the ``(n_weights, *domain)`` coefficient fields, shared
across the batch) and Jacobi sweeps (:func:`check_slice`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict

import torch

from ... import cuda_build
from .autotune import replicate_tile, rows_smem_bytes, stream_smem_bytes
from .common import (SMEM_PER_BLOCK, STATIC_SMEM,  # noqa: F401
                     STREAM_MAX_BLOCK_J, acc_dtype_for, check_slice)
from .plan import StencilPlan
from .ref import run_sweeps
from .spec import BC_KINDS, StencilSpec

CSRC = Path(__file__).resolve().with_name("csrc")
STREAM_SOURCE = CSRC / "stencil_stream.cu"
ROWS_SOURCE = CSRC / "stencil_rows.cu"
REPLICATE_SOURCE = CSRC / "stencil_replicate.cu"
SOURCES = (STREAM_SOURCE, ROWS_SOURCE, REPLICATE_SOURCE)

GRID_YZ_LIMIT = 65535

_DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _plain(a: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
           sweeps: int) -> torch.Tensor:
    """``sweeps`` sweeps on the whole field, intermediates in the
    accumulation dtype, one cast at the end."""
    acc = acc_dtype_for(a.dtype)
    return run_sweeps(a.to(acc), wf.to(acc), plan, sweeps).to(a.dtype)


def stencil_stream_plain(a4: torch.Tensor, wf: torch.Tensor,
                         plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """Plain version of :func:`stencil_stream`."""
    return _plain(a4, wf, plan, sweeps)


def stencil_replicate_plain(a4: torch.Tensor, wf: torch.Tensor,
                            plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """Plain version of :func:`stencil_replicate`: the same function as
    :func:`stencil_stream_plain` -- the two kernels differ only in how
    they move data."""
    return _plain(a4, wf, plan, sweeps)


def stencil_rows_plain(a2: torch.Tensor, wf: torch.Tensor,
                       plan: StencilPlan, sweeps: int) -> torch.Tensor:
    """Plain version of :func:`stencil_rows`: every row at once, the k
    boundary conditions re-padded each sweep."""
    return _plain(a2, wf, plan, sweeps)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def build_kernels() -> Dict[str, str]:
    """Build every kernel (one ``nvcc`` each, started together) and return
    each source's ``-Xptxas -v`` report."""
    cuda_build.build(SOURCES)
    return {src.name: cuda_build.build_log(src) for src in SOURCES}


@functools.lru_cache(maxsize=None)
def _stream_lib() -> ctypes.CDLL:
    lib = cuda_build.load(str(STREAM_SOURCE))
    lib.stencil_stream_launch.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 14
                                          + [ctypes.c_double, ctypes.c_void_p])
    lib.stencil_stream_launch.restype = ctypes.c_int
    lib.stencil_stream_error_string.argtypes = [ctypes.c_int]
    lib.stencil_stream_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _rows_lib() -> ctypes.CDLL:
    lib = cuda_build.load(str(ROWS_SOURCE))
    lib.stencil_rows_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_double, ctypes.c_void_p])
    lib.stencil_rows_launch.restype = ctypes.c_int
    lib.stencil_rows_error_string.argtypes = [ctypes.c_int]
    lib.stencil_rows_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _replicate_lib() -> ctypes.CDLL:
    lib = cuda_build.load(str(REPLICATE_SOURCE))
    lib.stencil_replicate_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17
        + [ctypes.c_double, ctypes.c_void_p])
    lib.stencil_replicate_launch.restype = ctypes.c_int
    lib.stencil_replicate_error_string.argtypes = [ctypes.c_int]
    lib.stencil_replicate_error_string.restype = ctypes.c_char_p
    return lib


def _bc_word(spec: StencilSpec) -> int:
    """The spec's boundary conditions as the kernels read them
    (``csrc/stencil_common.cuh:bc_kind``): 2 bits per side."""
    word = 0
    for ax, sides in enumerate(spec.bc):
        for side, b in enumerate(sides):
            word |= BC_KINDS.index(b.kind) << (4 * ax + 2 * side)
    return word


def ghost_value(spec: StencilSpec) -> float:
    """The spec's dirichlet ghost value (one per spec, validated), 0.0
    where no side is dirichlet."""
    return next((b.value for ax in spec.bc for b in ax
                 if b.kind == "dirichlet"), 0.0)


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
    want = (spec.n_weights,)
    if spec.coef == "var":
        want += tuple(a.shape[-spec.ndim:])
    if (wf.device != a.device or wf.dtype != acc or not wf.is_contiguous()
            or tuple(wf.shape) != want):
        raise ValueError(
            f"{name}: weights must be a contiguous {want} {acc} tensor on "
            f"{a.device}, got {tuple(wf.shape)} {wf.dtype} on {wf.device}")


def _raise_on(code: int, lib_error, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{lib_error(code).decode()} (cudaError {code})")


def _chain(a4: torch.Tensor, launches: int, launch) -> torch.Tensor:
    """Run ``launches`` launches of ``launch(src, dst)`` in order: the first
    reads ``a4``, each writes what the next reads through two
    accumulation-dtype buffers, and the last writes the result in ``a4``'s
    dtype -- one cast, at the end."""
    acc = acc_dtype_for(a4.dtype)
    out = torch.empty_like(a4)
    bufs = [torch.empty(a4.shape, dtype=acc, device=a4.device)
            for _ in range(min(launches - 1, 2))]
    with torch.cuda.device(a4.device):
        src = a4
        for q in range(launches):
            dst = out if q == launches - 1 else bufs[q % 2]
            launch(src, dst, torch.cuda.current_stream().cuda_stream)
            src = dst
    return out


def _check_volumetric(name: str, a4: torch.Tensor, spec: StencilSpec):
    check_slice(spec)
    if spec.ndim != 3:
        raise ValueError(f"{name}: {spec.name} is k-only; use stencil_rows")
    if a4.dim() != 4:
        raise ValueError(f"{name}: need (B, M, N, P), got "
                         f"{tuple(a4.shape)}")
    if a4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {a4.device}")


def stencil_stream(a4: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
                   block_i: int, block_j: int, sweeps: int) -> torch.Tensor:
    """``sweeps`` Jacobi sweeps of a volumetric plan over ``a4``
    ``(B, M, N, P)``, with the weights ``wf`` in the accumulation dtype
    (flat, or the ``(n_weights, M, N, P)`` coefficient fields).

    On a CUDA tensor: one ``csrc/stencil_stream.cu`` launch per sweep,
    thread blocks of ``(block_j x STREAM_TILE_K)`` tiles each streaming
    ``block_i`` planes; sweeps chain through accumulation-dtype buffers and
    the result is cast once, at the end.  On a CPU tensor: the plain
    version."""
    spec = plan.spec
    _check_volumetric("stencil_stream", a4, spec)
    if a4.device.type == "cpu":
        return stencil_stream_plain(a4, wf, plan, sweeps)
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
    var, bcw, dval = int(spec.coef == "var"), _bc_word(spec), ghost_value(spec)

    def launch(src, dst, stream):
        code = lib.stencil_stream_launch(
            src.data_ptr(), dst.data_ptr(), wf.data_ptr(), taps.data_ptr(),
            spec.taps, var, ri, rj, rk, _DTYPE_CODES[src.dtype],
            _DTYPE_CODES[dst.dtype], b, m, n, p, block_i, block_j, bcw, dval,
            stream)
        _raise_on(code, lib.stencil_stream_error_string, "stencil_stream")
        stencil_stream.launches += 1

    return _chain(a4, sweeps, launch)


stencil_stream.launches = 0


def stencil_replicate(a4: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
                      block_i: int, block_j: int,
                      sweeps: int) -> torch.Tensor:
    """``sweeps`` Jacobi sweeps of a volumetric plan over ``a4``
    ``(B, M, N, P)``, fused in one launch, with the weights ``wf`` as for
    :func:`stencil_stream`.

    On a CUDA tensor: ``csrc/stencil_replicate.cu``, thread blocks of
    ``(block_i, block_j, tk)`` output tiles, each loading its tile widened
    by ``r * sweeps`` per side into shared memory and running every sweep
    there.  :func:`~.autotune.replicate_tile` picks ``tk`` and the sweeps a
    launch fuses: where the tile cannot hold the halo of all ``sweeps`` in
    the 227 KB a block may use, the sweeps run in groups of fused sweeps,
    one launch per group, chained through accumulation-dtype buffers.  On
    a CPU tensor: the plain version."""
    spec = plan.spec
    _check_volumetric("stencil_replicate", a4, spec)
    if a4.device.type == "cpu":
        return stencil_replicate_plain(a4, wf, plan, sweeps)
    _check_cuda_operands("stencil_replicate", a4, wf, spec)
    b, m, n, p = a4.shape
    ri, rj, rk = spec.radius
    n_var = spec.n_weights if spec.coef == "var" else 0
    ti, tj, tk, group = replicate_tile(
        m, n, p, a4.element_size(), sweeps, tuple(spec.radius), n_var,
        block_i, block_j)
    n_ti = -(-m // ti)
    if -(-n // tj) > GRID_YZ_LIMIT or b * n_ti > GRID_YZ_LIMIT:
        raise ValueError(
            f"stencil_replicate: grid ({-(-n // tj)}, {b * n_ti}) exceeds "
            f"{GRID_YZ_LIMIT}; raise block_j / block_i")
    lib = _replicate_lib()
    taps = _tap_table(spec, a4.device)
    bcw, dval = _bc_word(spec), ghost_value(spec)
    counts = [group] * (sweeps // group) + (
        [sweeps % group] if sweeps % group else [])
    todo = iter(counts)

    def launch(src, dst, stream):
        code = lib.stencil_replicate_launch(
            src.data_ptr(), dst.data_ptr(), wf.data_ptr(), taps.data_ptr(),
            spec.taps, spec.n_weights, int(n_var > 0), ri, rj, rk,
            _DTYPE_CODES[src.dtype], _DTYPE_CODES[dst.dtype], b, m, n, p, ti,
            tj, tk, next(todo), bcw, dval, stream)
        _raise_on(code, lib.stencil_replicate_error_string,
                  "stencil_replicate")
        stencil_replicate.launches += 1

    return _chain(a4, len(counts), launch)


stencil_replicate.launches = 0


def stencil_rows(a2: torch.Tensor, wf: torch.Tensor, plan: StencilPlan,
                 block_rows: int, sweeps: int) -> torch.Tensor:
    """``sweeps`` fused Jacobi sweeps of a k-only plan over the independent
    rows of ``a2`` ``(rows, P)``, with the weights ``wf`` in the
    accumulation dtype (flat, or the ``(n_weights, P)`` coefficient rows
    every row shares).

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
            spec.taps, int(spec.coef == "var"), spec.radius[2],
            _DTYPE_CODES[a2.dtype], rows, p, block_rows, sweeps,
            _bc_word(spec), ghost_value(spec),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(code, lib.stencil_rows_error_string, "stencil_rows")
        stencil_rows.launches += 1
    return out


stencil_rows.launches = 0
