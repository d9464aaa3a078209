"""Block selection for the H100 kernels.

The streaming kernel (``csrc/stencil_stream.cu``) gives each thread block
one ``(block_j x STREAM_TILE_K)`` tile of the ``(j, k)`` plane and one chunk
of ``block_i`` planes along i, which the block walks after an ``r_i``-plane
lead-in, keeping a rotating window of ``2 r_i + 1`` halo-widened planes in
shared memory.  Each of its ``STREAM_THREAD_ROWS`` rows of threads computes
``rows_per_thread(block_j)`` rows of the tile.  The chooser asks, in order:

* **enough blocks to fill the card** -- at least ``BLOCKS_PER_SM *
  NUM_SMS`` blocks;
* **the measured j-tile height** (:func:`preferred_block_j`) -- more rows
  per thread share each tap's (weight, offset) load, until the window and
  the registers leave too few blocks resident: on an H100 SXM the tallest
  tile (64) was fastest in f32 for stencil7, stencil27, star13 and box125,
  and 32 in f64 for stencil7, star13 and stencil27, with box125 (125 taps
  per plane load) back at 64 (``scripts/stream_block_sweep.py``,
  ``PERF.md``); heights further from it rank lower;
* **halo re-reads** -- a block reads its tile's halo ring and its chunk's
  lead-in and tail planes on top of the points it owns, so long chunks
  cost less (most of it hits the 50 MB L2).

No TPU constant is carried over: the reference's ``autotune.py`` ranks
blocks on a TPU roofline against a VMEM budget, which does not describe
this card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

from .common import (BLOCKS_PER_SM, NUM_SMS, ROWS_THREADS, SMEM_PER_BLOCK,
                     STATIC_SMEM, STREAM_THREAD_ROWS, STREAM_TILE_K,
                     divisors)

PATH_KINDS = ("auto", "stream", "replicate")

# j-tile heights the chooser tries: 1, 2, 4 and 8 rows per thread.
BLOCK_J_CANDIDATES = (8, 16, 32, 64)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def acc_itemsize_for(itemsize: int) -> int:
    """bf16/f32 accumulate in f32 (4 bytes); f64 stays f64."""
    return 8 if itemsize == 8 else 4


def bytes_per_point(path: str, itemsize: int, sweeps: int = 1) -> float:
    """Device-memory bytes per output point per sweep of one
    ``stencil_apply`` call, each input plane read once and each output plane
    written once per launch.

    The streaming path runs ``s`` sweeps as ``s`` launches through an
    accumulation-dtype ping-pong buffer: sweep 1 reads the input and writes
    the buffer, later sweeps read and write the buffer, and the last writes
    the output -- ``(2 * itemsize + 2 * (s - 1) * acc_itemsize) / s`` per
    point-sweep, against ``2 * itemsize / s`` for sweeps fused in one
    launch (a later port slice).
    """
    if path != "stream":
        raise NotImplementedError(
            f"path {path!r} is not ported yet (ROADMAP A6 replicate, A7 "
            f"wavefront); the port streams")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    acc = acc_itemsize_for(itemsize)
    return (2 * itemsize + 2 * (sweeps - 1) * acc) / sweeps


def rows_per_thread(block_j: int) -> int:
    """Rows of the j tile each thread computes: ``block_j`` over the thread
    rows, rounded up to 1, 2, 4 or 8 (the kernel's compiled variants)."""
    need = _cdiv(block_j, STREAM_THREAD_ROWS)
    return next(r for r in (1, 2, 4, 8) if r >= need)


def stream_smem_bytes(block_j: int, radius: Tuple[int, int, int],
                      acc_itemsize: int) -> int:
    """Dynamic shared memory of one streaming block: the rotating window of
    ``2 r_i + 1`` halo-widened planes (every row the threads compute)."""
    ri, rj, rk = radius
    rows = rows_per_thread(block_j) * STREAM_THREAD_ROWS
    return ((2 * ri + 1) * (rows + 2 * rj) * (STREAM_TILE_K + 2 * rk)
            * acc_itemsize)


def _stream_blocks(m: int, n: int, p: int, batch: int, bi: int,
                   bj: int) -> int:
    return _cdiv(p, STREAM_TILE_K) * _cdiv(n, bj) * batch * _cdiv(m, bi)


def preferred_block_j(acc_itemsize: int, taps: int) -> int:
    """The j-tile height measured fastest at 512^3 on an H100 SXM: 64 in
    f32 accumulation, 32 in f64 for specs of up to 27 taps, 64 for more
    (measured at 125; the crossing between 27 and 125 taps is not)."""
    return 64 if acc_itemsize == 4 or taps > 27 else 32


def _stream_read_factor(bi: int, bj: int,
                        radius: Tuple[int, int, int]) -> float:
    """Input points a block reads per output point it owns."""
    ri, rj, rk = radius
    return ((bi + 2 * ri) / bi * (bj + 2 * rj) / bj
            * (STREAM_TILE_K + 2 * rk) / STREAM_TILE_K)


def autotune_engine(m: int, n: int, p: int, itemsize: int,
                    sweeps: int = 1, plan=None, batch: int = 1,
                    block_i: Optional[int] = None,
                    block_j: Optional[int] = None,
                    path: str = "auto") -> Tuple[str, int, int]:
    """The streaming kernel's ``(path, block_i, block_j)`` for a ``(batch,
    m, n, p)`` field.

    ``block_i`` (the i-chunk a block streams) runs over the divisors of
    ``m`` no shorter than the ``r_i``-plane lead-in; ``block_j`` (the j-tile
    height) over :data:`BLOCK_J_CANDIDATES`, a ragged last tile masked by
    the kernel.  The port runs one launch per sweep, so the choice does not
    depend on ``sweeps`` (the reference's fused kernel needs ``block_i >=
    r_i * sweeps * sweep_apps``; pinned blocks are still held to that by
    ``ops._validate_blocks``).  A pinned ``block_i`` or ``block_j`` is kept
    and the other is tuned.
    """
    if path not in PATH_KINDS:
        raise ValueError(f"unknown path {path!r}; expected one of "
                         f"{PATH_KINDS}")
    if path == "replicate":
        raise NotImplementedError(
            "path='replicate' (the stateless replicated-halo kernel) is not "
            "ported yet (ROADMAP A6); use path='stream' or 'auto'")
    rad = tuple(plan.spec.radius) if plan is not None else (1, 1, 1)
    taps = plan.spec.taps if plan is not None else 27
    return ("stream",) + _choose_stream_blocks(m, n, p, itemsize, rad, taps,
                                               batch, block_i, block_j)


@functools.lru_cache(maxsize=256)
def _choose_stream_blocks(m: int, n: int, p: int, itemsize: int,
                          rad: Tuple[int, int, int], taps: int, batch: int,
                          block_i: Optional[int],
                          block_j: Optional[int]) -> Tuple[int, int]:
    """:func:`autotune_engine`'s search, memoized per shape (it runs on
    every ``stencil_apply`` call)."""
    acc = acc_itemsize_for(itemsize)
    cands_i = ([block_i] if block_i is not None
               else [d for d in divisors(m) if d >= max(1, rad[0])] or [m])
    fits = [bj for bj in BLOCK_J_CANDIDATES
            if stream_smem_bytes(bj, rad, acc) + STATIC_SMEM
            <= SMEM_PER_BLOCK]
    cands_j = [block_j] if block_j is not None else fits or [8]
    want = BLOCKS_PER_SM * NUM_SMS
    pref = preferred_block_j(acc, taps)

    def key(bb):
        bi, bj = bb
        blocks = _stream_blocks(m, n, p, batch, bi, bj)
        return (0 if blocks >= want else 1,
                -blocks if blocks < want else 0,
                abs(math.log2(bj / pref)), -bj,
                _stream_read_factor(bi, bj, rad), -bi)

    return min(((bi, bj) for bi in cands_i for bj in cands_j), key=key)


def rows_smem_bytes(block_rows: int, p: int, acc_itemsize: int) -> int:
    """Dynamic shared memory of one row block: its rows twice (the sweep
    ping-pong), accumulation dtype."""
    return 2 * block_rows * p * acc_itemsize


def pick_block_rows(rows: int, p: int, itemsize: int) -> int:
    """Rows per block of the k-only row kernel.

    A block holds its rows twice in shared memory (the ping-pong of fused
    sweeps, accumulation dtype).  Candidates divide ``rows`` and keep
    ``BLOCKS_PER_SM`` blocks' windows inside one block's budget; the largest
    that still leaves ``BLOCKS_PER_SM * NUM_SMS`` blocks wins, else the
    smallest (most blocks).  Returns 1 when not even one row fits -- the
    kernel's wrapper then raises with the limit.
    """
    per_row = rows_smem_bytes(1, p, acc_itemsize_for(itemsize))
    cap = max(per_row, SMEM_PER_BLOCK // BLOCKS_PER_SM)
    fit = [c for c in divisors(rows)
           if c * per_row <= cap and c <= ROWS_THREADS] or [1]
    full = [c for c in fit if rows // c >= BLOCKS_PER_SM * NUM_SMS]
    return max(full) if full else min(fit)
