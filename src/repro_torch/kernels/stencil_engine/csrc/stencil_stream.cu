// stencil_stream: one Jacobi sweep of a volumetric stencil over a
// (B, M, N, P) field, streamed along i.
//
// Replaces the TPU kernel src/repro/kernels/stencil_engine/kernel.py:496
// (stencil3d_stream_kernel, wired in ops.py:_call_3d_stream).
//
//   out[x] = ring(x) ? 0 : sum_t w[wi_t] * u[x + off_t]
//
// with u = 0 outside the domain and ring(x) the one-point clamp ring of all
// three axes (reference: kernel.py:_volumetric_interior, ref.py:_interior_mask).
// s sweeps are s launches through an accumulation-dtype ping-pong buffer
// (kernel.py:stencil_stream); fusing them into one launch is later work.
//
// Bound on an H100 SXM: device-memory bytes.  One sweep must read each
// input point once and write each output point once, 2 * itemsize bytes
// per point at 3.35 TB/s (0.32 ms for f32 at 512^3, 0.64 ms for f64),
// against 2 * taps flops per point (54 for stencil27: 0.11 ms at the
// 67 TFLOP/s f32 rate).  What holds this kernel above that bound is
// shared-memory instructions: one load per tap and point.
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
// behind the arithmetic.  Each thread computes RPT rows of the tile
// (THREAD_ROWS apart), so one packed (weight, offset) load per tap serves
// RPT points.  The taps come from a tap table (offsets, weight index) and
// the flat weights, not from the plan: on integer-valued data any
// summation order is exact, so the result still matches the plan walk bit
// for bit there.  Halo reads of neighbouring tiles and chunks mostly hit
// the 50 MB L2.
#include <stdint.h>

#include "stencil_common.cuh"

#define TILE_K 32       // common.py:STREAM_TILE_K
#define THREAD_ROWS 8   // common.py:STREAM_THREAD_ROWS

template <typename A> struct TapT;
template <> struct __align__(8) TapT<float> { float w; int off; };
template <> struct __align__(16) TapT<double> { double w; int off; int pad; };

template <typename TI, typename TO, typename A, int RPT>
__global__ void __launch_bounds__(TILE_K* THREAD_ROWS)
    stencil_stream_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                          const A* __restrict__ w,
                          const int* __restrict__ taps, int ntaps, int ri,
                          int rj, int rk, int M, int N, int P, int bi,
                          int bj, int n_chunks) {
  // values of one widened plane each thread stages (radius <= STENCIL_MAX_R)
  constexpr int NV = ((RPT * THREAD_ROWS + 2 * STENCIL_MAX_R) *
                          (TILE_K + 2 * STENCIL_MAX_R) +
                      TILE_K * THREAD_ROWS - 1) /
                     (TILE_K * THREAD_ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* win = reinterpret_cast<A*>(smem_raw);
  __shared__ TapT<A> tap_s[STENCIL_MAX_TAPS];
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
    tp.w = w[tab[3 * t + 2]];
    tp.off = tab[3 * t] * wk + tab[3 * t + 1];
    tap_s[t] = tp;
  }
  for (int g = tid; g <= ns; g += nthr) grp[g] = taps[g];

  // this thread's elements of a widened plane: offset in the plane, or -1
  // where the element lies outside the domain in j or k (a zero ghost)
  int goff[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = tid + v * nthr;
    const int jj = e / wk;
    const int gj = j0 - rj + jj;
    const int gk = k0 - rk + (e - jj * wk);
    goff[v] = (e < ps && gj >= 0 && gj < N && gk >= 0 && gk < P)
                  ? gj * P + gk : -1;
  }
  A stage[NV];
  auto fetch = [&](int gi) {
    const bool iok = gi >= 0 && gi < M;
    const TI* p = src + (size_t)(iok ? gi : 0) * plane;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      stage[v] = (iok && goff[v] >= 0) ? load_acc<A>(p + goff[v]) : A(0);
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
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          acc[r] = fma_acc(tp.w, q[r * rstride], acc[r]);
      }
    }
    const bool iring = i == 0 || i == M - 1;
    const bool kring = k == 0 || k == P - 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int jr = threadIdx.y + r * THREAD_ROWS;
      const int j = j0 + jr;
      if (jr < bj && j < N && k < P) {
        const bool ring = iring || kring || j == 0 || j == N - 1;
        store_val(dst + ((size_t)i * N + j) * P + k, ring ? A(0) : acc[r]);
      }
    }
    __syncthreads();
  }
}

template <typename TI, typename TO, typename A, int RPT>
static cudaError_t launch_rpt(const void* in, void* out, const void* w,
                              const int* taps, int ntaps, int ri, int rj,
                              int rk, int B, int M, int N, int P, int bi,
                              int bj, cudaStream_t stream) {
  const int n_chunks = (M + bi - 1) / bi;
  const dim3 grid((P + TILE_K - 1) / TILE_K, (N + bj - 1) / bj, B * n_chunks);
  const dim3 block(TILE_K, THREAD_ROWS);
  const size_t smem = (size_t)(2 * ri + 1) * (RPT * THREAD_ROWS + 2 * rj) *
                      (TILE_K + 2 * rk) * sizeof(A);
  void (*kern)(const TI*, TO*, const A*, const int*, int, int, int, int, int,
               int, int, int, int, int) =
      stencil_stream_kernel<TI, TO, A, RPT>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, block, smem, stream>>>(
      static_cast<const TI*>(in), static_cast<TO*>(out),
      static_cast<const A*>(w), taps, ntaps, ri, rj, rk, M, N, P, bi, bj,
      n_chunks);
  return cudaGetLastError();
}

template <typename TI, typename TO, typename A>
static cudaError_t launch(const void* in, void* out, const void* w,
                          const int* taps, int ntaps, int ri, int rj, int rk,
                          int B, int M, int N, int P, int bi, int bj,
                          cudaStream_t stream) {
  if (bj <= THREAD_ROWS)
    return launch_rpt<TI, TO, A, 1>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, stream);
  if (bj <= 2 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 2>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, stream);
  if (bj <= 4 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 4>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, stream);
  if (bj <= 8 * THREAD_ROWS)
    return launch_rpt<TI, TO, A, 8>(in, out, w, taps, ntaps, ri, rj, rk, B, M, N, P, bi, bj, stream);
  return cudaErrorInvalidValue;
}

extern "C" int stencil_stream_launch(const void* in, void* out,
                                     const void* w, const void* taps,
                                     int ntaps, int ri, int rj, int rk,
                                     int in_code, int out_code, int B, int M,
                                     int N, int P, int bi, int bj,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(taps);
  if (in_code == DT_F32 && out_code == DT_F32)
    return launch<float, float, float>(in, out, w, t, ntaps, ri, rj, rk, B,
                                       M, N, P, bi, bj, s);
  if (in_code == DT_F64 && out_code == DT_F64)
    return launch<double, double, double>(in, out, w, t, ntaps, ri, rj, rk,
                                          B, M, N, P, bi, bj, s);
  if (in_code == DT_BF16 && out_code == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        in, out, w, t, ntaps, ri, rj, rk, B, M, N, P, bi, bj, s);
  if (in_code == DT_BF16 && out_code == DT_F32)
    return launch<__nv_bfloat16, float, float>(in, out, w, t, ntaps, ri, rj,
                                               rk, B, M, N, P, bi, bj, s);
  if (in_code == DT_F32 && out_code == DT_BF16)
    return launch<float, __nv_bfloat16, float>(in, out, w, t, ntaps, ri, rj,
                                               rk, B, M, N, P, bi, bj, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stencil_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
