"""Shared stencil-engine constants: the H100's budgets and block divisors.

The block choosers and the kernels' launch checks agree on one source of
truth for what a thread block may hold and how wide the card is (NVIDIA H100
SXM data sheet and Hopper tuning guide):

* :data:`SMEM_PER_BLOCK` -- 227 KB (232,448 bytes) of shared memory a block
  can use; above 48 KB only as dynamic shared memory after
  ``cudaFuncSetAttribute`` (the kernels' C entries do that);
* :data:`NUM_SMS` -- 132 streaming multiprocessors to fill;
* :data:`HBM_BYTES_PER_S` -- 3.35 TB/s of device-memory bandwidth, the
  rate every kernel's byte bound is taken against.
"""

from __future__ import annotations

from typing import List

import torch

SMEM_PER_BLOCK = 232_448
# Statically allocated shared memory of any kernel (tap weights and
# offsets), an upper bound: a block's dynamic window gets the rest.
STATIC_SMEM = 4096
NUM_SMS = 132
HBM_BYTES_PER_S = 3.35e12

# Resident blocks per SM the choosers aim for, so that each SM has warps to
# switch between while one waits on device memory.
BLOCKS_PER_SM = 8

# Thread-block shape of the streaming kernel (``csrc/stencil_stream.cu``
# compiles the same values in): a tile is ``STREAM_TILE_K`` points along the
# contiguous k axis -- one warp, coalesced -- by ``block_j`` rows along j,
# covered by ``STREAM_THREAD_ROWS`` rows of threads, each computing 1, 2, 4
# or 8 rows (``STREAM_MAX_BLOCK_J`` rows at most).
STREAM_TILE_K = 32
STREAM_THREAD_ROWS = 8
STREAM_MAX_BLOCK_J = 64

# Threads per block of the row kernel (``csrc/stencil_rows.cu``).
ROWS_THREADS = 256

MAX_TAPS = 125        # csrc/stencil_common.cuh:STENCIL_MAX_TAPS
MAX_RADIUS = 2        # csrc/stencil_common.cuh:STENCIL_MAX_R


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """bf16/f32 accumulate in f32; f64 stays f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def check_slice(spec) -> None:
    """Raise ``NotImplementedError`` for what the port does not carry yet,
    naming the ROADMAP item that will port it."""
    if spec.ordering != "jacobi":
        raise NotImplementedError(
            f"{spec.name}: red-black ordering is not ported yet "
            f"(ROADMAP A7)")
    if spec.ndim == 3 and max(spec.radius) > MAX_RADIUS:
        raise NotImplementedError(
            f"{spec.name}: radius {spec.radius} exceeds the volumetric "
            f"kernels' windows (radius <= {MAX_RADIUS} per axis; ROADMAP "
            f"A5g)")
    if spec.taps > MAX_TAPS:
        raise NotImplementedError(
            f"{spec.name}: {spec.taps} taps exceed the kernels' tap table "
            f"({MAX_TAPS})")


def divisors(x: int) -> List[int]:
    """All divisors of ``x`` in ascending order (block-size candidates)."""
    small, large = [], []
    d = 1
    while d * d <= x:
        if x % d == 0:
            small.append(d)
            if d != x // d:
                large.append(x // d)
        d += 1
    return small + large[::-1]
