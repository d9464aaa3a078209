// stencil_rows: s fused Jacobi sweeps of a k-only stencil over independent
// rows of a (rows, P) field.
//
// Replaces the TPU kernel src/repro/kernels/stencil_engine/kernel.py:766
// (stencil1d_kernel, wired in ops.py:_call_1d).
//
//   u_{q+1}[r, k] = (k == 0 || k == P-1) ? 0 : sum_t w[wi_t] * u_q[r, k + dk_t]
//
// with u = 0 outside [0, P): the clamp ring of the k axis, zeroed after
// every sweep (reference: kernel.py:stencil1d_kernel).
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
// writes the rows once.  A row longer than the shared-memory budget is
// refused by the wrapper (kernel.py), with the limit in the message.
#include <stdint.h>

#include "stencil_common.cuh"

#define ROWS_THREADS 256  // common.py:ROWS_THREADS

template <typename TI, typename TO, typename A>
__global__ void __launch_bounds__(ROWS_THREADS)
    stencil_rows_kernel(const TI* __restrict__ in, TO* __restrict__ out,
                        const A* __restrict__ w,
                        const int* __restrict__ taps, int ntaps, int rows,
                        int P, int block_rows, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ A wt[STENCIL_MAX_TAPS];
  __shared__ int dk[STENCIL_MAX_TAPS];

  const int r0 = blockIdx.x * block_rows;
  const int n = min(block_rows, rows - r0) * P;
  A* cur = reinterpret_cast<A*>(smem_raw);
  A* nxt = cur + (size_t)block_rows * P;
  const TI* src = in + (size_t)r0 * P;
  TO* dst = out + (size_t)r0 * P;

  const int* tab = taps + 2;  // a k-only table has the group header [0, n]
  for (int t = threadIdx.x; t < ntaps; t += ROWS_THREADS) {
    wt[t] = w[tab[3 * t + 2]];
    dk[t] = tab[3 * t + 1];
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += ROWS_THREADS)
    cur[e] = load_acc<A>(src + e);
  __syncthreads();

  const int nr = n / P;
  for (int s = 0; s < sweeps; ++s) {
    for (int row = 0; row < nr; ++row) {
      const A* u = cur + (size_t)row * P;
      A* v = nxt + (size_t)row * P;
      for (int k = threadIdx.x; k < P; k += ROWS_THREADS) {
        A acc = A(0);
        for (int t = 0; t < ntaps; ++t) {
          const int kk = k + dk[t];
          if (kk >= 0 && kk < P) acc = fma_acc(wt[t], u[kk], acc);
        }
        v[k] = (k == 0 || k == P - 1) ? A(0) : acc;
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

template <typename TI, typename TO, typename A>
static cudaError_t launch(const void* in, void* out, const void* w,
                          const int* taps, int ntaps, int rows, int P,
                          int block_rows, int sweeps, cudaStream_t stream) {
  const dim3 grid((rows + block_rows - 1) / block_rows);
  const size_t smem = 2 * (size_t)block_rows * P * sizeof(A);
  void (*kern)(const TI*, TO*, const A*, const int*, int, int, int, int,
               int) = stencil_rows_kernel<TI, TO, A>;
  cudaError_t err = allow_dynamic_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, ROWS_THREADS, smem, stream>>>(
      static_cast<const TI*>(in), static_cast<TO*>(out),
      static_cast<const A*>(w), taps, ntaps, rows, P, block_rows, sweeps);
  return cudaGetLastError();
}

extern "C" int stencil_rows_launch(const void* in, void* out, const void* w,
                                   const void* taps, int ntaps, int dtype,
                                   int rows, int P, int block_rows,
                                   int sweeps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(taps);
  if (dtype == DT_F32)
    return launch<float, float, float>(in, out, w, t, ntaps, rows, P,
                                       block_rows, sweeps, s);
  if (dtype == DT_F64)
    return launch<double, double, double>(in, out, w, t, ntaps, rows, P,
                                          block_rows, sweeps, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        in, out, w, t, ntaps, rows, P, block_rows, sweeps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* stencil_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
