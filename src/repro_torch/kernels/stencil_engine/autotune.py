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

The replicated-halo kernel (``csrc/stencil_replicate.cu``,
``path="replicate"``) runs a fixed, untuned output tile
(:func:`replicate_tile`): it fuses as many sweeps per launch as the tile's
``r * sweeps``-widened copies fit in the block's shared memory.  Choosing
its tile, or B3 itself, on measured times is ROADMAP A7's routing work.

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


def bytes_per_point(path: str, itemsize: int, sweeps: int = 1,
                    coef: str = "const", n_weights: int = 0,
                    group: Optional[int] = None) -> float:
    """Device-memory bytes per output point per sweep of one
    ``stencil_apply`` call, each input point read once and each output
    point written once per launch.

    The streaming path runs ``s`` sweeps as ``s`` launches through an
    accumulation-dtype ping-pong buffer: sweep 1 reads the input and writes
    the buffer, later sweeps read and write the buffer, and the last writes
    the output -- ``(2 * itemsize + 2 * (s - 1) * acc_itemsize) / s`` per
    point-sweep.  The replicated path fuses ``group`` sweeps (default: all
    ``s``) per launch, so it makes ``ceil(s / group)`` such launches
    (``2 * itemsize / s`` when all are fused; the halo re-reads, which hit
    mostly in L2, are not counted).  ``coef="var"`` adds each launch's read
    of the ``n_weights`` coefficient fields in the accumulation dtype.
    """
    if path not in ("stream", "replicate"):
        raise NotImplementedError(
            f"path {path!r} is not ported yet (ROADMAP A7 wavefront); the "
            f"port streams or replicates")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    acc = acc_itemsize_for(itemsize)
    launches = sweeps if path == "stream" else _cdiv(sweeps, group or sweeps)
    coefs = n_weights * acc if coef == "var" else 0
    return (2 * itemsize + 2 * (launches - 1) * acc
            + launches * coefs) / sweeps


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
    """The ``(path, block_i, block_j)`` a ``(batch, m, n, p)`` field runs
    at.

    ``block_i`` (the i-chunk a block streams) runs over the divisors of
    ``m`` no shorter than the ``r_i``-plane lead-in; ``block_j`` (the j-tile
    height) over :data:`BLOCK_J_CANDIDATES`, a ragged last tile masked by
    the kernel.  The port runs one launch per sweep, so the choice does not
    depend on ``sweeps`` (the reference's fused kernel needs ``block_i >=
    r_i * sweeps * sweep_apps``; pinned blocks are still held to that by
    ``ops._validate_blocks``).  A pinned ``block_i`` or ``block_j`` is kept
    and the other is tuned.

    ``path="auto"`` streams, as the reference does wherever the streaming
    window fits (at radius <= 2 it always does here).  ``path="replicate"``
    returns the replicated-halo kernel's output tile's i and j extents
    (:func:`replicate_tile`, which also picks its k extent and the sweeps
    per launch).
    """
    if path not in PATH_KINDS:
        raise ValueError(f"unknown path {path!r}; expected one of "
                         f"{PATH_KINDS}")
    rad = tuple(plan.spec.radius) if plan is not None else (1, 1, 1)
    taps = plan.spec.taps if plan is not None else 27
    if path == "replicate":
        var = plan is not None and plan.spec.coef == "var"
        ti, tj, _, _ = replicate_tile(
            m, n, p, itemsize, sweeps, rad,
            plan.spec.n_weights if var else 0, block_i, block_j)
        return "replicate", ti, tj
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


# B3's output tile, not tuned: 4 x 8 points in (i, j), four rows for each
# of the block's 8 warps (``csrc/stencil_replicate.cu:REP_THREAD_ROWS``,
# ``REP_RPT``), and in k the width that gives the first of ``g`` fused
# sweeps rows of two warps, ``64 - 2 r_k (g - 1)``, no less than one warp.
REPLICATE_TILE_IJ = (4, 8)
REPLICATE_ROW_K = 64


def replicate_smem_bytes(tile: Tuple[int, int, int],
                         radius: Tuple[int, int, int], sweeps: int,
                         acc_itemsize: int, n_var: int = 0) -> int:
    """Dynamic shared memory of one replicated-halo block: its output tile
    widened by ``r * sweeps`` per side, twice (the sweeps' ping-pong; once
    for one sweep), plus one coefficient tile per weight for variable
    coefficients, all in the accumulation dtype."""
    vol = math.prod(t + 2 * r * sweeps for t, r in zip(tile, radius))
    return ((2 if sweeps > 1 else 1) + n_var) * vol * acc_itemsize


@functools.lru_cache(maxsize=256)
def replicate_tile(m: int, n: int, p: int, itemsize: int, sweeps: int,
                   radius: Tuple[int, int, int], n_var: int = 0,
                   block_i: Optional[int] = None,
                   block_j: Optional[int] = None
                   ) -> Tuple[int, int, int, int]:
    """The replicated-halo kernel's ``(ti, tj, tk, group)``: its output tile
    (:data:`REPLICATE_TILE_IJ`, :data:`REPLICATE_ROW_K`, each cut to the
    domain; a pinned ``block_i`` / ``block_j`` fixes ``ti`` / ``tj``) and
    the sweeps one launch fuses -- ``sweeps`` where the tile's widened
    copies fit the block's shared memory, else the most that fit (the
    wrapper then runs the sweeps in groups, one launch each).  Where not
    even one sweep fits (variable coefficients with many weights), the
    tile's longest unpinned extent is halved until it does.  Raises
    ``ValueError`` when no tile holds one sweep.
    """
    acc = acc_itemsize_for(itemsize)
    limit = SMEM_PER_BLOCK - STATIC_SMEM
    ti = block_i or min(REPLICATE_TILE_IJ[0], m)
    tj = block_j or min(REPLICATE_TILE_IJ[1], n)
    for group in range(sweeps, 0, -1):
        tk = min(max(REPLICATE_ROW_K - 2 * radius[2] * (group - 1), 32), p)
        if replicate_smem_bytes((ti, tj, tk), radius, group, acc,
                                n_var) <= limit:
            return ti, tj, tk, group
    tile = [ti, tj, tk]
    free = [ax for ax, pinned in enumerate((block_i, block_j, None))
            if pinned is None]
    while replicate_smem_bytes(tile, radius, 1, acc, n_var) > limit:
        ax = max(free, key=lambda x: tile[x])
        if tile[ax] == 1:
            raise ValueError(
                f"stencil_replicate: no tile of radius {radius} fits "
                f"{limit} bytes of shared memory for one sweep ({n_var} "
                f"coefficient tiles; block_i={block_i}, block_j={block_j})")
        tile[ax] = _cdiv(tile[ax], 2)
    return tuple(tile) + (1,)


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
