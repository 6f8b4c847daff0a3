// The pieces the descheduler's orderings share (deschedule.cu, metricsagg.cu,
// bandrank.cu): the float64 key map of np.lexsort's order and a block-level
// exclusive scan.  Each kernel runs its own radix passes in one launch.
//
// Float keys follow np.lexsort and lax.sort: -0.0 and 0.0 compare equal (the
// tie falls through to the next key) and every NaN sorts last, equal to the
// other NaNs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace koord_radix {

typedef unsigned long long u64;

// The float64 as an unsigned key whose unsigned order is the float's.
__device__ __forceinline__ u64 f64_key(double x) {
  if (x != x) return 0xFFF8000000000000ULL;  // every NaN: the canonical one, last
  if (x == 0.0) x = 0.0;                     // -0.0 == 0.0
  u64 b = (u64)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ULL);
}

__device__ __forceinline__ double f64_of_key(u64 k) {
  return __longlong_as_double((long long)((k >> 63) ? (k ^ 0x8000000000000000ULL) : ~k));
}

// Exclusive scan of one value a thread over the block (blockDim.x a multiple
// of 32, at most 1024; every thread calls it).  `smem` holds 32 values;
// `total` receives the block's sum.  Unsigned, so int64 sums wrap as int64
// arithmetic does.
template <typename T>
__device__ T block_excl_scan(T v, T* smem, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nw ? smem[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    smem[lane] = s;
  }
  __syncthreads();
  T before = warp ? smem[warp - 1] : (T)0;
  *total = smem[nw - 1];
  __syncthreads();
  return before + x - v;
}

__host__ inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

}  // namespace koord_radix
