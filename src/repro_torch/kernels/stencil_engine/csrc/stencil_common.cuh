// Helpers shared by the stencil kernels: dtype codes, conversions into and
// out of the accumulation dtype, and the tap-table layout.
//
// Tap table (int32, built by kernel.py:_tap_table, device resident):
//   [ group[0] .. group[2*ri+1] | dj_0 dk_0 wi_0 | dj_1 dk_1 wi_1 | ... ]
// The taps are in the spec's lexicographic (di, dj, dk) order, so the taps
// with di = g - ri are the contiguous run [group[g], group[g+1]).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define STENCIL_MAX_TAPS 125
#define STENCIL_MAX_R 2

// dtype codes (kernel.py:_DTYPE_CODES)
#define DT_F32 0
#define DT_F64 1
#define DT_BF16 2

__device__ __forceinline__ float to_acc_f(float x) { return x; }
__device__ __forceinline__ double to_acc_f(double x) { return x; }
__device__ __forceinline__ float to_acc_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename A, typename T>
__device__ __forceinline__ A load_acc(const T* p) {
  return static_cast<A>(to_acc_f(*p));
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

// Opt a kernel into `bytes` of dynamic shared memory.  Without the opt-in a
// block may hold 48 KB in all, its static shared memory included, so the
// launchers set it for every size.
template <typename K>
static cudaError_t allow_dynamic_smem(K* kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
