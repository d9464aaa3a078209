// stencil_replicate: s fused Jacobi sweeps of a volumetric stencil over a
// (B, M, N, P) field in ONE launch, each thread block recomputing the halo
// of its own output tile.
//
// Replaces the TPU kernel src/repro/kernels/stencil_engine/kernel.py:435
// (stencil3d_kernel, wired in ops.py:call_3d, path="replicate"), with its
// ghost handling (kernel.py:prepare_strip, fill_ghosts).
//
//   u_{q+1}[x] = ring(x) ? 0 : sum_t w_t(x) * u_q[x + off_t],  q = 0..s-1
//
// with every boundary condition (stencil_common.cuh:bc_index, ghost_code),
// the clamp sides' one-point ring, and constant or variable coefficients --
// the same function as s launches of stencil_stream.
//
// Bound on an H100 SXM: device memory for few sweeps, arithmetic for many.
// The call must read each point once and write it once (2 * itemsize bytes
// per point, plus n_weights * acc_itemsize for variable coefficients),
// against 2 * taps * s flops per point -- more with the halo's redundant
// work, which grows with s.  What holds this kernel above the bound is
// shared-memory loads (one per tap and point, two with variable
// coefficients, plus a tap load per REP_RPT points) and that redundant
// halo work.
//
// Design: a thread block owns one (ti, tj, tk) output tile, a warp across
// k and REP_THREAD_ROWS warps over its (i, j) rows, each thread computing
// REP_RPT rows at once so that one tap load serves REP_RPT points.  It
// loads the tile widened by h = r * s per side (h_a = r_a * s on each axis)
// into shared memory in the accumulation dtype, runs the s sweeps there,
// ping-ponging two buffers, and writes only the centre: one read and one
// write of device memory for all s sweeps.  Sweep q computes the region q*r
// in from the tile's edges (the part still exact after q sweeps; the last
// sweep computes the centre alone, straight to device memory).  Boundary
// conditions, as the reference's per-sweep pad:
//   - a periodic axis is loaded wrapped and never refilled: the tile is a
//     window on the periodic extension, computed like the interior;
//   - positions outside the domain on a clamp, dirichlet or neumann side
//     (ghosts) are not computed; after every sweep but the last, those
//     within r of the domain are refilled from the tile's current values
//     (neumann: the mirrored point; clamp and dirichlet: the constant;
//     corners: the last constant axis wins, as the pad's i, j, k order);
//   - the clamp ring is zeroed after every sweep.
// Variable coefficients get a coefficient tile with the same halo, loaded
// once.  The wrapper (kernel.py:stencil_replicate) runs a fixed tile
// (autotune.py:replicate_tile) and fuses as many sweeps per launch as its
// widened copies fit in the 227 KB a block may hold: the sweeps run in
// groups, one launch each, where it cannot hold the halo of all s.
#include <stdint.h>

#include "stencil_common.cuh"

#define REP_WARP 32
#define REP_THREAD_ROWS 8  // warps per block, over the tile's (i, j) rows
#define REP_RPT 4          // points per thread sharing each tap's load

// A variable-coefficient tap: its offset in the tile, and the offset of
// its weight's coefficient tile.
struct __align__(8) TapV {
  int off;
  int woff;
};

// BCS: whether any side is not clamp.  Without, every ghost is a zero and
// the rule folds away at compile time (VAR implies BCS: one variant).
template <typename TI, typename TO, typename A, bool VAR, bool BCS>
__global__ void __launch_bounds__(REP_WARP* REP_THREAD_ROWS)
    stencil_replicate_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                             const A* __restrict__ w,
                             const int* __restrict__ taps, int ntaps,
                             int nw, int ri, int rj, int rk, int M, int N,
                             int P, int ti, int tj, int tk, int n_ti,
                             int sweeps, int bcw, A dval) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ TapT<A> tap_s[VAR ? 1 : STENCIL_MAX_TAPS];
  __shared__ TapV tap_v[VAR ? STENCIL_MAX_TAPS : 1];

  const int hi = ri * sweeps, hj = rj * sweeps, hk = rk * sweeps;
  const int Ei = ti + 2 * hi, Ej = tj + 2 * hj, Ek = tk + 2 * hk;
  const int vol = Ei * Ej * Ek;
  A* cur = reinterpret_cast<A*>(smem_raw);
  A* nxt = cur + (sweeps > 1 ? vol : 0);
  A* ctile = nxt + vol;  // VAR: nw coefficient tiles

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * REP_WARP + tx;
  const int nthr = REP_WARP * REP_THREAD_ROWS;
  const int b = blockIdx.z / n_ti;
  const int ti0 = (blockIdx.z % n_ti) * ti;
  const int tj0 = blockIdx.y * tj, tk0 = blockIdx.x * tk;
  // global coordinates of the tile's local origin
  const int oi = ti0 - hi, oj = tj0 - hj, ok = tk0 - hk;
  const size_t plane = (size_t)N * P;
  const size_t field = (size_t)M * plane;
  const TI* src = in + b * field;
  TO* dst = out + b * field;

  if (!BCS) bcw = 0, dval = A(0);  // all clamp
  const int ilo = bc_kind(bcw, 0, 0), ihi = bc_kind(bcw, 0, 1);
  const int jlo = bc_kind(bcw, 1, 0), jhi = bc_kind(bcw, 1, 1);
  const int klo = bc_kind(bcw, 2, 0), khi = bc_kind(bcw, 2, 1);
  const bool per_i = ilo == BC_PERIODIC, per_j = jlo == BC_PERIODIC,
             per_k = klo == BC_PERIODIC;

  // taps: the tap table's di runs, then (dj, dk, wi) per tap
  const int ns = 2 * ri + 1;
  const int* tab = taps + ns + 1;
  for (int t = tid; t < ntaps; t += nthr) {
    int g = 0;
    while (t >= taps[g + 1]) ++g;
    const int off = ((g - ri) * Ej + tab[3 * t]) * Ek + tab[3 * t + 1];
    if (VAR) {
      tap_v[t] = TapV{off, tab[3 * t + 2] * vol};
    } else {
      TapT<A> tp;
      tp.w = w[tab[3 * t + 2]];
      tp.off = off;
      tap_s[t] = tp;
    }
  }

  // load the widened tile: every position read where the ghost rule puts it
  for (int row = ty; row < Ei * Ej; row += REP_THREAD_ROWS) {
    const int li = row / Ej, lj = row - li * Ej;
    const int ci = bc_index(oi + li, M, ilo, ihi);
    const int cj = bc_index(oj + lj, N, jlo, jhi);
    for (int lk = tx; lk < Ek; lk += REP_WARP) {
      const int ck = bc_index(ok + lk, P, klo, khi);
      const int code = ghost_code(ci, cj, ck);
      const int e = row * Ek + lk;
      const size_t g = code < 0 ? 0 : ci * plane + (size_t)cj * P + ck;
      cur[e] = code < 0 ? ghost_value(code, dval) : load_acc<A>(src + g);
      if (VAR) {
        for (int q = 0; q < nw; ++q)
          ctile[q * vol + e] = code < 0 ? A(0) : w[q * field + g];
      }
    }
  }
  __syncthreads();

  // does the widened tile reach past a non-periodic domain edge?
  const bool ghosts =
      (!per_i && (oi < 0 || oi + Ei > M)) ||
      (!per_j && (oj < 0 || oj + Ej > N)) ||
      (!per_k && (ok < 0 || ok + Ek > P));

  for (int q = 1; q <= sweeps; ++q) {
    const bool last = q == sweeps;
    const int i_lo = last ? hi : q * ri, i_hi = last ? hi + ti : Ei - q * ri;
    const int j_lo = last ? hj : q * rj, j_hi = last ? hj + tj : Ej - q * rj;
    const int k_lo = last ? hk : q * rk, k_hi = last ? hk + tk : Ek - q * rk;
    const int nj = j_hi - j_lo;
    const int rows = (i_hi - i_lo) * nj;

    // each thread computes REP_RPT rows of the region at once, so one tap
    // load serves REP_RPT points; ghosts (and rows past the region) are
    // computed from in-tile values but not stored
    for (int row0 = ty; row0 < rows;
         row0 += REP_THREAD_ROWS * REP_RPT) {
      int base[REP_RPT], gis[REP_RPT], gjs[REP_RPT];
      bool skip[REP_RPT], ring[REP_RPT];
#pragma unroll
      for (int r = 0; r < REP_RPT; ++r) {
        const int row = row0 + r * REP_THREAD_ROWS;
        const int rc = row < rows ? row : row0;
        const int li = i_lo + rc / nj, lj = j_lo + rc % nj;
        const int gi = oi + li, gj = oj + lj;
        skip[r] = row >= rows ||
                  ((!per_i || last) && (gi < 0 || gi >= M)) ||
                  ((!per_j || last) && (gj < 0 || gj >= N));
        ring[r] = on_clamp_ring(gi, M, ilo, ihi) ||
                  on_clamp_ring(gj, N, jlo, jhi);
        base[r] = (li * Ej + lj) * Ek;
        gis[r] = gi;
        gjs[r] = gj;
      }
      for (int lk = k_lo + tx; lk < k_hi; lk += REP_WARP) {
        const int gk = ok + lk;
        if ((!per_k || last) && (gk < 0 || gk >= P)) continue;
        A acc[REP_RPT];
#pragma unroll
        for (int r = 0; r < REP_RPT; ++r) acc[r] = A(0);
        if (VAR) {
#pragma unroll 4
          for (int t = 0; t < ntaps; ++t) {
            const TapV tp = tap_v[t];
#pragma unroll
            for (int r = 0; r < REP_RPT; ++r) {
              const int e = base[r] + lk;
              acc[r] = fma_acc(ctile[tp.woff + e], cur[e + tp.off], acc[r]);
            }
          }
        } else {
#pragma unroll 4
          for (int t = 0; t < ntaps; ++t) {
            const TapT<A> tp = tap_s[t];
#pragma unroll
            for (int r = 0; r < REP_RPT; ++r)
              acc[r] = fma_acc(tp.w, cur[base[r] + lk + tp.off], acc[r]);
          }
        }
        const bool kring = on_clamp_ring(gk, P, klo, khi);
#pragma unroll
        for (int r = 0; r < REP_RPT; ++r) {
          if (skip[r]) continue;
          const A val = (ring[r] || kring) ? A(0) : acc[r];
          if (last)
            store_val(dst + gis[r] * plane + (size_t)gjs[r] * P + gk, val);
          else
            nxt[base[r] + lk] = val;
        }
      }
    }
    if (last) break;
    __syncthreads();

    if (ghosts) {
      // refill the ghosts the next sweep reads (within r of the domain on
      // each axis they lie outside), from in-domain points of this sweep
      for (int row = ty; row < rows; row += REP_THREAD_ROWS) {
        const int li = i_lo + row / nj, lj = j_lo + row % nj;
        const int gi = oi + li, gj = oj + lj;
        const bool out_i = !per_i && (gi < 0 || gi >= M);
        const bool out_j = !per_j && (gj < 0 || gj >= N);
        if ((out_i && (gi < -ri || gi >= M + ri)) ||
            (out_j && (gj < -rj || gj >= N + rj)))
          continue;
        // per axis: a constant's code, or the local coordinate to copy
        // from (the mirror on a neumann side, the point itself otherwise)
        int ci = 0, si = li, cj = 0, sj = lj;
        if (out_i) {
          ci = bc_index(gi, M, ilo, ihi);
          if (ci >= 0) si = ci - oi, ci = 0;
        }
        if (out_j) {
          cj = bc_index(gj, N, jlo, jhi);
          if (cj >= 0) sj = cj - oj, cj = 0;
        }
        for (int lk = k_lo + tx; lk < k_hi; lk += REP_WARP) {
          const int gk = ok + lk;
          const bool out_k = !per_k && (gk < 0 || gk >= P);
          if (!(out_i || out_j || out_k)) continue;
          if (out_k && (gk < -rk || gk >= P + rk)) continue;
          int ck = 0, sk = lk;
          if (out_k) {
            ck = bc_index(gk, P, klo, khi);
            if (ck >= 0) sk = ck - ok, ck = 0;
          }
          const int code = ghost_code(ci, cj, ck);
          nxt[(li * Ej + lj) * Ek + lk] =
              code < 0 ? ghost_value(code, dval)
                       : nxt[(si * Ej + sj) * Ek + sk];
        }
      }
      __syncthreads();
    }
    A* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename TI, typename TO, typename A, bool VAR, bool BCS>
static cudaError_t launch_mode(const void* in, void* out, const void* w,
                              const int* taps, int ntaps, int nw, int ri,
                              int rj, int rk, int B, int M, int N, int P,
                              int ti, int tj, int tk, int sweeps, int bcw,
                              double dval, cudaStream_t stream) {
  const int n_ti = (M + ti - 1) / ti;
  const dim3 grid((P + tk - 1) / tk, (N + tj - 1) / tj, B * n_ti);
  const dim3 block(REP_WARP, REP_THREAD_ROWS);
  const size_t vol = (size_t)(ti + 2 * ri * sweeps) *
                     (tj + 2 * rj * sweeps) * (tk + 2 * rk * sweeps);
  const size_t smem =
      ((sweeps > 1 ? 2 : 1) + (VAR ? nw : 0)) * vol * sizeof(A);
  void (*kern)(const TI*, TO*, const A*, const int*, int, int, int, int, int,
               int, int, int, int, int, int, int, int, int, A) =
      stencil_replicate_kernel<TI, TO, A, VAR, BCS>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, block, smem, stream>>>(
      static_cast<const TI*>(in), static_cast<TO*>(out),
      static_cast<const A*>(w), taps, ntaps, nw, ri, rj, rk, M, N, P, ti, tj,
      tk, n_ti, sweeps, bcw, static_cast<A>(dval));
  return cudaGetLastError();
}

template <typename TI, typename TO, typename A>
static cudaError_t launch(const void* in, void* out, const void* w,
                          const int* taps, int ntaps, int nw, int var,
                          int ri, int rj, int rk, int B, int M, int N, int P,
                          int ti, int tj, int tk, int sweeps, int bcw,
                          double dval, cudaStream_t s) {
  if (var)
    return launch_mode<TI, TO, A, true, true>(in, out, w, taps, ntaps, nw, ri,
                                              rj, rk, B, M, N, P, ti, tj, tk,
                                              sweeps, bcw, dval, s);
  if (bcw != 0)
    return launch_mode<TI, TO, A, false, true>(in, out, w, taps, ntaps, nw,
                                               ri, rj, rk, B, M, N, P, ti, tj,
                                               tk, sweeps, bcw, dval, s);
  return launch_mode<TI, TO, A, false, false>(in, out, w, taps, ntaps, nw,
                                              ri, rj, rk, B, M, N, P, ti, tj,
                                              tk, sweeps, bcw, dval, s);
}

// w: the flat weights, or (var != 0) the (nw, M, N, P) coefficient fields,
// in the accumulation dtype.  (ti, tj, tk): the output tile; sweeps: the
// sweeps this launch fuses.  bcw: the packed boundary conditions; dval: the
// dirichlet ghost value.
extern "C" int stencil_replicate_launch(const void* in, void* out,
                                        const void* w, const void* taps,
                                        int ntaps, int nw, int var, int ri,
                                        int rj, int rk, int in_code,
                                        int out_code, int B, int M, int N,
                                        int P, int ti, int tj, int tk,
                                        int sweeps, int bcw, double dval,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(taps);
  if (in_code == DT_F32 && out_code == DT_F32)
    return launch<float, float, float>(in, out, w, t, ntaps, nw, var, ri, rj,
                                       rk, B, M, N, P, ti, tj, tk, sweeps,
                                       bcw, dval, s);
  if (in_code == DT_F64 && out_code == DT_F64)
    return launch<double, double, double>(in, out, w, t, ntaps, nw, var, ri,
                                          rj, rk, B, M, N, P, ti, tj, tk,
                                          sweeps, bcw, dval, s);
  if (in_code == DT_BF16 && out_code == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        in, out, w, t, ntaps, nw, var, ri, rj, rk, B, M, N, P, ti, tj, tk,
        sweeps, bcw, dval, s);
  if (in_code == DT_BF16 && out_code == DT_F32)
    return launch<__nv_bfloat16, float, float>(in, out, w, t, ntaps, nw, var,
                                               ri, rj, rk, B, M, N, P, ti, tj,
                                               tk, sweeps, bcw, dval, s);
  if (in_code == DT_F32 && out_code == DT_BF16)
    return launch<float, __nv_bfloat16, float>(in, out, w, t, ntaps, nw, var,
                                               ri, rj, rk, B, M, N, P, ti, tj,
                                               tk, sweeps, bcw, dval, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stencil_replicate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
