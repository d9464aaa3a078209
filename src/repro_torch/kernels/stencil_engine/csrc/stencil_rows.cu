// stencil_rows: s fused Jacobi sweeps of a k-only stencil over independent
// rows of a (rows, P) field.
//
// Replaces the TPU kernel src/repro/kernels/stencil_engine/kernel.py:766
// (stencil1d_kernel, wired in ops.py:_call_1d).
//
//   u_{q+1}[r, k] = ring(k) ? 0 : sum_t w_t(k) * u_q[r, k + dk_t]
//
// with u outside [0, P) given by the k boundary conditions
// (stencil_common.cuh:bc_index: wrapped, mirrored or a constant), ring(k)
// the one-point ring of a clamp side, zeroed after every sweep, and w_t(k)
// the tap's weight: a constant, or for variable coefficients the
// (n_weights, P) coefficient row w[wi_t, k] that every row shares
// (reference: kernel.py:stencil1d_kernel, ref.py:apply_plan_once).
//
// Bound on an H100 SXM: device-memory bytes.  Rows are independent, so all
// s sweeps run on chip and the call must only read each point once and
// write it once: 2 * itemsize bytes per point at 3.35 TB/s, against
// 2 * taps * s flops per point (6 s for stencil3).
//
// Design: each thread block owns block_rows whole rows, resident in shared
// memory twice (the ping-pong of the fused sweeps, accumulation dtype).  It
// reads its rows once, coalesced, runs every sweep between the two copies
// with one barrier per sweep -- row by row, the 256 threads across k -- and
// writes the rows once.  Under clamp sides a tap outside the row is
// skipped (a zero ghost); under other k boundary conditions a point whose
// taps all lie in the row reads them unchecked, and nearer the ends each
// ghost is read where the boundary condition puts it, inside the resident
// row, so no sweep leaves shared memory.
// Variable coefficients (n_weights * P values shared by all rows) are read
// from device memory through the L1 cache.  A row longer than the
// shared-memory budget is refused by the wrapper (kernel.py), with the
// limit in the message.
#include <stdint.h>

#include "stencil_common.cuh"

#define ROWS_THREADS 256  // common.py:ROWS_THREADS

// BCS: whether a k side is not clamp.  Without, every ghost is a zero and
// each tap is one bounds check: on an H100 the interior/edge split below
// took 15% longer on clamp rows (PERF.md).  VAR implies BCS: one variant.
template <typename TI, typename TO, typename A, bool VAR, bool BCS>
__global__ void __launch_bounds__(ROWS_THREADS)
    stencil_rows_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                        const A* __restrict__ w,
                        const int* __restrict__ taps, int ntaps, int rows,
                        int P, int block_rows, int sweeps, int rk, int klo,
                        int khi, A dval) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ A wt[STENCIL_MAX_TAPS];
  __shared__ int dk[STENCIL_MAX_TAPS];
  __shared__ int wix[VAR ? STENCIL_MAX_TAPS : 1];

  const int r0 = blockIdx.x * block_rows;
  const int n = min(block_rows, rows - r0) * P;
  A* cur = reinterpret_cast<A*>(smem_raw);
  A* nxt = cur + (size_t)block_rows * P;
  const TI* src = in + (size_t)r0 * P;
  TO* dst = out + (size_t)r0 * P;

  const int* tab = taps + 2;  // a k-only table has the group header [0, n]
  for (int t = threadIdx.x; t < ntaps; t += ROWS_THREADS) {
    wt[t] = VAR ? A(0) : w[tab[3 * t + 2]];
    dk[t] = tab[3 * t + 1];
    if (VAR) wix[t] = tab[3 * t + 2];
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += ROWS_THREADS)
    cur[e] = load_acc<A>(src + e);
  __syncthreads();

  if (!BCS) klo = khi = BC_CLAMP, dval = A(0);
  const int nr = n / P;
  for (int s = 0; s < sweeps; ++s) {
    for (int row = 0; row < nr; ++row) {
      const A* u = cur + (size_t)row * P;
      A* v = nxt + (size_t)row * P;
      for (int k = threadIdx.x; k < P; k += ROWS_THREADS) {
        A acc = A(0);
        if (!BCS) {
          for (int t = 0; t < ntaps; ++t) {
            const int kk = k + dk[t];
            if (kk >= 0 && kk < P) acc = fma_acc(wt[t], u[kk], acc);
          }
        } else if (k >= rk && k < P - rk) {  // every tap inside the row
          for (int t = 0; t < ntaps; ++t) {
            const A wv = VAR ? __ldg(w + (size_t)wix[t] * P + k) : wt[t];
            acc = fma_acc(wv, u[k + dk[t]], acc);
          }
        } else {
          for (int t = 0; t < ntaps; ++t) {
            const int kk = bc_index(k + dk[t], P, klo, khi);
            const A x = kk >= 0 ? u[kk] : ghost_value(kk, dval);
            const A wv = VAR ? __ldg(w + (size_t)wix[t] * P + k) : wt[t];
            acc = fma_acc(wv, x, acc);
          }
        }
        v[k] = on_clamp_ring(k, P, klo, khi) ? A(0) : acc;
      }
    }
    __syncthreads();
    A* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += ROWS_THREADS) store_val(dst + e, cur[e]);
}

template <typename TI, typename TO, typename A, bool VAR, bool BCS>
static cudaError_t launch_mode(const void* in, void* out, const void* w,
                              const int* taps, int ntaps, int rows, int P,
                              int block_rows, int sweeps, int rk, int bcw,
                              double dval, cudaStream_t stream) {
  const dim3 grid((rows + block_rows - 1) / block_rows);
  const size_t smem = 2 * (size_t)block_rows * P * sizeof(A);
  void (*kern)(const TI*, TO*, const A*, const int*, int, int, int, int,
               int, int, int, int, A) = stencil_rows_kernel<TI, TO, A, VAR, BCS>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, ROWS_THREADS, smem, stream>>>(
      static_cast<const TI*>(in), static_cast<TO*>(out),
      static_cast<const A*>(w), taps, ntaps, rows, P, block_rows, sweeps, rk,
      bc_kind(bcw, 2, 0), bc_kind(bcw, 2, 1), static_cast<A>(dval));
  return cudaGetLastError();
}

template <typename TI, typename TO, typename A>
static cudaError_t launch(const void* in, void* out, const void* w,
                          const int* taps, int ntaps, int rows, int P,
                          int block_rows, int sweeps, int var, int rk,
                          int bcw, double dval, cudaStream_t stream) {
  if (var)
    return launch_mode<TI, TO, A, true, true>(in, out, w, taps, ntaps, rows,
                                              P, block_rows, sweeps, rk, bcw,
                                              dval, stream);
  if (bc_kind(bcw, 2, 0) != BC_CLAMP || bc_kind(bcw, 2, 1) != BC_CLAMP)
    return launch_mode<TI, TO, A, false, true>(in, out, w, taps, ntaps, rows,
                                               P, block_rows, sweeps, rk, bcw,
                                               dval, stream);
  return launch_mode<TI, TO, A, false, false>(in, out, w, taps, ntaps, rows,
                                              P, block_rows, sweeps, rk, bcw,
                                              dval, stream);
}

// w: the flat weights, or (var != 0) the (n_weights, P) coefficient rows,
// in the accumulation dtype.  rk: the largest |dk| of a tap.  bcw: the
// packed boundary conditions (only the k sides are read); dval: the
// dirichlet ghost value.
extern "C" int stencil_rows_launch(const void* in, void* out, const void* w,
                                   const void* taps, int ntaps, int var,
                                   int rk, int dtype, int rows, int P,
                                   int block_rows, int sweeps, int bcw,
                                   double dval, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(taps);
  if (dtype == DT_F32)
    return launch<float, float, float>(in, out, w, t, ntaps, rows, P,
                                       block_rows, sweeps, var, rk, bcw, dval,
                                       s);
  if (dtype == DT_F64)
    return launch<double, double, double>(in, out, w, t, ntaps, rows, P,
                                          block_rows, sweeps, var, rk, bcw,
                                          dval, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        in, out, w, t, ntaps, rows, P, block_rows, sweeps, var, rk, bcw, dval,
        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stencil_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
