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

SMEM_PER_BLOCK = 232_448
# Statically allocated shared memory of either kernel (tap weights and
# offsets), an upper bound: a block's dynamic window gets the rest.
STATIC_SMEM = 2048
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
