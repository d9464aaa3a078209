// Helpers shared by the stencil kernels: dtype codes, conversions into and
// out of the accumulation dtype, the tap-table layout, and the boundary
// conditions' ghost rule.
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

// Boundary conditions, packed by kernel.py:_bc_word into one int: 2 bits
// per side, side s (0 lo, 1 hi) of axis a (0 i, 1 j, 2 k) at bit 4a + 2s,
// kinds in spec.py:BC_KINDS order.
#define BC_CLAMP 0
#define BC_PERIODIC 1
#define BC_DIRICHLET 2
#define BC_NEUMANN 3

// A ghost read that is a constant rather than a load.
#define GHOST_ZERO (-1)   // clamp: 0
#define GHOST_VALUE (-2)  // dirichlet: the spec's one ghost value

__host__ __device__ __forceinline__ int bc_kind(int word, int axis,
                                                int side) {
  return (word >> (4 * axis + 2 * side)) & 3;
}

// The ghost rule, one axis at a time: where a read at coordinate g of an
// axis of extent n lands.  In the domain it is g; outside, a periodic side
// wraps (np.pad "wrap"), a neumann side mirrors edge-inclusively (np.pad
// "symmetric": ghost -1-q reads q; the extension has period 2n, so any
// overshoot folds back), and a clamp or dirichlet side gives a constant.
// The same rule as ref.py:ghost_index.
__device__ __forceinline__ int bc_index(int g, int n, int lo, int hi) {
  if (g >= 0 && g < n) return g;
  const int kind = g < 0 ? lo : hi;
  if (kind == BC_CLAMP) return GHOST_ZERO;
  if (kind == BC_DIRICHLET) return GHOST_VALUE;
  if (kind == BC_PERIODIC) {
    const int m = g % n;
    return m < 0 ? m + n : m;
  }
  const int p = 2 * n;
  int m = g % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// Corners: the reference pads i, then j, then k (ref.py:pad_bc), so a point
// that lies outside on several axes takes the constant of the LAST axis
// that gives one, and is otherwise read at the per-axis indices.  Returns
// that constant's code, or 0 for a load.
__device__ __forceinline__ int ghost_code(int ci, int cj, int ck) {
  if (ck < 0) return ck;
  if (cj < 0) return cj;
  return ci < 0 ? ci : 0;
}

template <typename A>
__device__ __forceinline__ A ghost_value(int code, A dval) {
  return code == GHOST_VALUE ? dval : A(0);
}

// The one-point output ring of a clamp side, zeroed after every sweep.
__device__ __forceinline__ bool on_clamp_ring(int g, int n, int lo, int hi) {
  return (g == 0 && lo == BC_CLAMP) || (g == n - 1 && hi == BC_CLAMP);
}

// A tap as a kernel's inner loop reads it: its weight and its offset in
// the kernel's shared-memory window, in one load.
template <typename A> struct TapT;
template <> struct __align__(8) TapT<float> { float w; int off; };
template <> struct __align__(16) TapT<double> { double w; int off; int pad; };

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
