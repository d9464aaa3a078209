// stencil_stream: one Jacobi sweep of a volumetric stencil over a
// (B, M, N, P) field, streamed along i.
//
// Replaces the TPU kernel src/repro/kernels/stencil_engine/kernel.py:496
// (stencil3d_stream_kernel, wired in ops.py:_call_3d_stream).
//
//   out[x] = ring(x) ? 0 : sum_t w_t(x) * u[x + off_t]
//
// with u outside the domain given by the boundary conditions
// (stencil_common.cuh:bc_index, ghost_code -- the reference's per-sweep
// np.pad, ref.py:pad_bc), ring(x) the one-point ring of the clamp sides
// (ref.py:clamp_ring_mask), and w_t(x) the tap's weight: a constant, or
// for variable coefficients the coefficient field w[wi_t] at the output
// point x, read straight from device memory (the batch shares it).  s
// sweeps are s launches through an accumulation-dtype ping-pong buffer
// (kernel.py:stencil_stream); fusing them into one launch is later work.
//
// Bound on an H100 SXM: device-memory bytes.  One sweep must read each
// input point once and write each output point once, 2 * itemsize bytes
// per point at 3.35 TB/s (0.32 ms for f32 at 512^3, 0.64 ms for f64), plus
// n_weights * acc_itemsize for variable coefficients (1.60 ms for
// stencil27 f32), against 2 * taps flops per point (54 for stencil27:
// 0.11 ms at the 67 TFLOP/s f32 rate).  What holds this kernel above that
// bound is shared-memory instructions: one load per tap and point.
//
// Design: the TPU kernel's idea, kept -- stream along i and keep the active
// planes on chip, so each input plane comes from device memory about once.
// Each thread block owns a (block_j x TILE_K) tile of the (j, k) plane,
// with k (contiguous in memory) across the 32 lanes of a warp, and a chunk
// of block_i planes along i.  It keeps a rotating window of 2*ri + 1 planes
// of the tile, widened by rj / rk per side, in shared memory in the
// accumulation dtype.  After an ri-plane lead-in it stores one new plane
// per output plane; the plane after it is already on its way into
// registers while the current one computes, so device-memory latency hides
// behind the arithmetic.  A boundary condition is only a rule for where
// each load outside the domain reads: a wrapped or mirrored index, or a
// constant -- so a periodic i axis is the wrapped lead-in of the first
// chunk and the wrapped tail of the last.  Each thread computes RPT rows
// of the tile (THREAD_ROWS apart), so one packed (weight, offset) load per
// tap serves RPT points.  The taps come from a tap table (offsets, weight
// index) and the flat weights, not from the plan: on integer-valued data
// any summation order is exact, so the result still matches the plan walk
// bit for bit there.  Halo reads of neighbouring tiles and chunks mostly
// hit the 50 MB L2.
#include <stdint.h>

#include "stencil_common.cuh"

#define TILE_K 32       // common.py:STREAM_TILE_K
#define THREAD_ROWS 8   // common.py:STREAM_THREAD_ROWS

// BCS: whether any side is not clamp.  Without, every ghost is a zero and
// the rule folds away at compile time (VAR implies BCS: one variant).
template <typename TI, typename TO, typename A, int RPT, bool VAR, bool BCS>
__global__ void __launch_bounds__(TILE_K* THREAD_ROWS)
    stencil_stream_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                          const A* __restrict__ w,
                          const int* __restrict__ taps, int ntaps, int ri,
                          int rj, int rk, int M, int N, int P, int bi,
                          int bj, int n_chunks, int bcw, A dval) {
  // values of one widened plane each thread stages (radius <= STENCIL_MAX_R)
  constexpr int NV = ((RPT * THREAD_ROWS + 2 * STENCIL_MAX_R) *
                          (TILE_K + 2 * STENCIL_MAX_R) +
                      TILE_K * THREAD_ROWS - 1) /
                     (TILE_K * THREAD_ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* win = reinterpret_cast<A*>(smem_raw);
  __shared__ TapT<A> tap_s[STENCIL_MAX_TAPS];
  __shared__ int wix[VAR ? STENCIL_MAX_TAPS : 1];
  __shared__ int grp[2 * STENCIL_MAX_R + 2];

  const int ns = 2 * ri + 1;
  const int wk = TILE_K + 2 * rk;
  const int wj = RPT * THREAD_ROWS + 2 * rj;  // rows past bj: computed, not stored
  const int ps = wj * wk;
  const int tid = threadIdx.y * TILE_K + threadIdx.x;
  const int nthr = TILE_K * THREAD_ROWS;

  const int k0 = blockIdx.x * TILE_K;
  const int j0 = blockIdx.y * bj;
  const int chunk = blockIdx.z % n_chunks;
  const int b = blockIdx.z / n_chunks;
  const int i0 = chunk * bi;
  const int i1 = min(i0 + bi, M);
  const size_t plane = (size_t)N * P;
  const TI* src = in + (size_t)b * M * plane;
  TO* dst = out + (size_t)b * M * plane;

  const int* tab = taps + ns + 1;
  for (int t = tid; t < ntaps; t += nthr) {
    TapT<A> tp;
    tp.w = VAR ? A(0) : w[tab[3 * t + 2]];
    tp.off = tab[3 * t] * wk + tab[3 * t + 1];
    tap_s[t] = tp;
    if (VAR) wix[t] = tab[3 * t + 2];
  }
  for (int g = tid; g <= ns; g += nthr) grp[g] = taps[g];

  if (!BCS) bcw = 0, dval = A(0);  // all clamp
  const int ilo = bc_kind(bcw, 0, 0), ihi = bc_kind(bcw, 0, 1);
  const int jlo = bc_kind(bcw, 1, 0), jhi = bc_kind(bcw, 1, 1);
  const int klo = bc_kind(bcw, 2, 0), khi = bc_kind(bcw, 2, 1);

  // this thread's elements of a widened plane: where each reads in the
  // plane under the j and k boundary conditions, or a ghost constant's
  // code (< 0).  The clamp-only variant keeps the plain bounds tests: the
  // general rule, folded, still costs it instructions.
  int goff[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = tid + v * nthr;
    const int jj = e / wk;
    const int gj = j0 - rj + jj;
    const int gk = k0 - rk + (e - jj * wk);
    if constexpr (BCS) {
      const int cj = bc_index(gj, N, jlo, jhi);
      const int ck = bc_index(gk, P, klo, khi);
      const int code = ghost_code(0, cj, ck);
      goff[v] = e >= ps ? GHOST_ZERO : code < 0 ? code : cj * P + ck;
    } else {
      goff[v] = (e < ps && gj >= 0 && gj < N && gk >= 0 && gk < P)
                    ? gj * P + gk : GHOST_ZERO;
    }
  }
  A stage[NV];
  auto fetch = [&](int gi) {
    if constexpr (BCS) {
      const int ci = bc_index(gi, M, ilo, ihi);  // periodic i: wrapped
      const TI* p = src + (size_t)(ci < 0 ? 0 : ci) * plane;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int o = goff[v];  // a j/k constant wins over an i one
        stage[v] = o < 0 ? ghost_value(o, dval)
                   : ci < 0 ? ghost_value(ci, dval) : load_acc<A>(p + o);
      }
    } else {
      const bool iok = gi >= 0 && gi < M;
      const TI* p = src + (size_t)(iok ? gi : 0) * plane;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        stage[v] = (iok && goff[v] >= 0) ? load_acc<A>(p + goff[v]) : A(0);
    }
  };
  auto put = [&](int gi) {
    A* slot = win + ((gi + ns) % ns) * ps;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = tid + v * nthr;
      if (e < ps) slot[e] = stage[v];
    }
  };

  for (int gi = i0 - ri; gi < i0 + ri; ++gi) {  // lead-in
    fetch(gi);
    put(gi);
  }
  fetch(i0 + ri);

  const int k = k0 + threadIdx.x;
  const int base = (threadIdx.y + rj) * wk + threadIdx.x + rk;
  const int rstride = THREAD_ROWS * wk;
  // variable coefficients: each row's point in a coefficient field,
  // clamped into the domain for rows the tile does not store
  int coff[VAR ? RPT : 1];
  if (VAR) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      coff[r] = min(j0 + (int)threadIdx.y + r * THREAD_ROWS, N - 1) * P +
                min(k, P - 1);
  }
  const size_t wstride = (size_t)M * plane;
  for (int i = i0; i < i1; ++i) {
    put(i + ri);  // replaces plane i - ri - 1, done with at the last barrier
    __syncthreads();
    if (i + 1 < i1) fetch(i + 1 + ri);  // in flight while plane i computes
    A acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = A(0);
    for (int g = 0; g < ns; ++g) {
      const A* pl = win + ((i + g - ri + ns) % ns) * ps + base;
      const int t1 = grp[g + 1];
#pragma unroll 4
      for (int t = grp[g]; t < t1; ++t) {
        const TapT<A> tp = tap_s[t];
        const A* q = pl + tp.off;
        if (VAR) {
          const A* c = w + wix[t] * wstride + (size_t)i * plane;
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            acc[r] = fma_acc(__ldg(c + coff[r]), q[r * rstride], acc[r]);
        } else {
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            acc[r] = fma_acc(tp.w, q[r * rstride], acc[r]);
        }
      }
    }
    const bool iring = BCS ? on_clamp_ring(i, M, ilo, ihi)
                           : i == 0 || i == M - 1;
    const bool kring = BCS ? on_clamp_ring(k, P, klo, khi)
                           : k == 0 || k == P - 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jr = threadIdx.y + r * THREAD_ROWS;
      const int j = j0 + jr;
      if (jr < bj && j < N && k < P) {
        bool ring;  // one flat || chain: nesting the j tests in it
                    // costs the clamp variant a predicate op per row
        if constexpr (BCS)
          ring = iring || kring || on_clamp_ring(j, N, jlo, jhi);
        else
          ring = iring || kring || j == 0 || j == N - 1;
        store_val(dst + ((size_t)i * N + j) * P + k, ring ? A(0) : acc[r]);
      }
    }
    __syncthreads();
  }
}

template <typename TI, typename TO, typename A, int RPT, bool VAR, bool BCS>
static cudaError_t launch_rpt(const void* in, void* out, const void* w,
                              const int* taps, int ntaps, int ri, int rj,
                              int rk, int B, int M, int N, int P, int bi,
                              int bj, int bcw, double dval,
                              cudaStream_t stream) {
  const int n_chunks = (M + bi - 1) / bi;
  const dim3 grid((P + TILE_K - 1) / TILE_K, (N + bj - 1) / bj, B * n_chunks);
  const dim3 block(TILE_K, THREAD_ROWS);
  const size_t smem = (size_t)(2 * ri + 1) * (RPT * THREAD_ROWS + 2 * rj) *
                      (TILE_K + 2 * rk) * sizeof(A);
  void (*kern)(const TI*, TO*, const A*, const int*, int, int, int, int, int,
               int, int, int, int, int, int, A) =
      stencil_stream_kernel<TI, TO, A, RPT, VAR, BCS>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, block, smem, stream>>>(
      static_cast<const TI*>(in), static_cast<TO*>(out),
      static_cast<const A*>(w), taps, ntaps, ri, rj, rk, M, N, P, bi, bj,
      n_chunks, bcw, static_cast<A>(dval));
  return cudaGetLastError();
}

template <typename TI, typename TO, typename A, bool VAR, bool BCS>
static cudaError_t launch_mode(const void* in, void* out, const void* w,
                               const int* taps, int ntaps, int ri, int rj,
                               int rk, int B, int M, int N, int P, int bi,
                               int bj, int bcw, double dval, cudaStream_t s) {
  if (bj <= THREAD_ROWS)
    return launch_rpt<TI, TO, A, 1, VAR, BCS>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, bcw, dval, s);
  if (bj <= 2 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 2, VAR, BCS>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, bcw, dval, s);
  if (bj <= 4 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 4, VAR, BCS>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, bcw, dval, s);
  if (bj <= 8 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 8, VAR, BCS>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, bcw, dval, s);
  return cudaErrorInvalidValue;
}

template <typename TI, typename TO, typename A>
static cudaError_t launch(const void* in, void* out, const void* w,
                          const int* taps, int ntaps, int var, int ri,
                          int rj, int rk, int B, int M, int N, int P, int bi,
                          int bj, int bcw, double dval, cudaStream_t s) {
  if (var)
    return launch_mode<TI, TO, A, true, true>(in, out, w, taps, ntaps, ri, rj,
                                              rk, B, M, N, P, bi, bj, bcw,
                                              dval, s);
  if (bcw != 0)
    return launch_mode<TI, TO, A, false, true>(in, out, w, taps, ntaps, ri,
                                               rj, rk, B, M, N, P, bi, bj,
                                               bcw, dval, s);
  return launch_mode<TI, TO, A, false, false>(in, out, w, taps, ntaps, ri, rj,
                                              rk, B, M, N, P, bi, bj, bcw,
                                              dval, s);
}

// w: the flat weights, or (var != 0) the (n_weights, M, N, P) coefficient
// fields, in the accumulation dtype.  bcw: the packed boundary conditions;
// dval: the dirichlet ghost value.
extern "C" int stencil_stream_launch(const void* in, void* out,
                                     const void* w, const void* taps,
                                     int ntaps, int var, int ri, int rj,
                                     int rk, int in_code, int out_code,
                                     int B, int M, int N, int P, int bi,
                                     int bj, int bcw, double dval,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(taps);
  if (in_code == DT_F32 && out_code == DT_F32)
    return launch<float, float, float>(in, out, w, t, ntaps, var, ri, rj, rk,
                                       B, M, N, P, bi, bj, bcw, dval, s);
  if (in_code == DT_F64 && out_code == DT_F64)
    return launch<double, double, double>(in, out, w, t, ntaps, var, ri, rj,
                                          rk, B, M, N, P, bi, bj, bcw, dval,
                                          s);
  if (in_code == DT_BF16 && out_code == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        in, out, w, t, ntaps, var, ri, rj, rk, B, M, N, P, bi, bj, bcw, dval,
        s);
  if (in_code == DT_BF16 && out_code == DT_F32)
    return launch<__nv_bfloat16, float, float>(in, out, w, t, ntaps, var, ri,
                                               rj, rk, B, M, N, P, bi, bj,
                                               bcw, dval, s);
  if (in_code == DT_F32 && out_code == DT_BF16)
    return launch<float, __nv_bfloat16, float>(in, out, w, t, ntaps, var, ri,
                                               rj, rk, B, M, N, P, bi, bj,
                                               bcw, dval, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stencil_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
