// The node-resident strip's arithmetic, shared by the kernels that walk a
// strip of pods down a node column: the SCORE kernel (score.cu) and the
// LoadAware strip (breakdown.cu).  A thread owns a node column, keeps the
// node's terms in registers and evaluates each pair's quotients from a
// float estimate with one exact correction (quot100), its weighted sums
// in 32 bits (div32 with rcp32).  in_fast bounds the rows the estimate
// takes; pin keeps a node term in its register; Width selects a template
// width or the configuration's.
#pragma once

#include "pair.cuh"

constexpr long long kFastCap = 1LL << 55;  // the float estimate's capacities and rows

// floor(100 n / c) for 0 <= n <= c < 2**56, from df, a float within
// 3 * 2**-24 * c of n, rc = fl(100 / fl(c)) and n100 = 100 n (exact: it is
// below 2**63).  The exact product df * rc is within 3e-5 of t = 100 n / c,
// which lies in [0, 100].  The fused multiply-add rounds df * rc + 2**23
// toward zero to an integer (the float's unit at 2**23): qe = floor(df *
// rc), or -1 when df * rc is just below 0 (the sum rounds to 2**23 - 0.5).
// When the product's fraction (one rounding off) is in [1e-4, 1 - 1e-4],
// no integer lies between it and t, and qe is the quotient; else qe is one
// off at most either way, and one exact 64-bit correction each way makes
// it the quotient.
__device__ __forceinline__ int quot100(float df, float rc, long long n100, long long c) {
  const float y = __fmaf_rz(df, rc, 8388608.0f);
  const float qf = __fsub_rn(y, 8388608.0f);
  const float fr = __fmaf_rn(df, rc, -qf);
  const int qe = __float_as_int(y) - 0x4B000000;
  if (qf >= 0.0f && fabsf(__fsub_rn(fr, 0.5f)) <= 0.4999f) return qe;
  const long long r = n100 - (long long)qe * c;
  return qe + (r >= c ? 1 : 0) - (r < 0 ? 1 : 0);
}

__host__ __device__ __forceinline__ unsigned rcp32(long long d) {
  return d >= 1 && d < (1LL << 32) ? (unsigned)(0xFFFFFFFFu / (unsigned long long)d) : 0u;
}

__host__ __device__ __forceinline__ bool in_fast(long long x) {
  return (unsigned long long)x < (unsigned long long)kFastCap;
}

// A value computed once a thread stays in its register: the compiler may
// not recompute it from what it was computed from inside the pod loop.
__device__ __forceinline__ void pin(long long& x) { asm volatile("" : "+l"(x)); }
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)); }

// A width: the template's when it is > 0, else the configuration's (the
// generic instantiation, arrays sized KOORD_MAXR).
template <int T>
struct Width {
  static constexpr int cap = T > 0 ? T : KOORD_MAXR;
  __device__ static int of(int rt) { return T > 0 ? T : rt; }
};

// n / d for 0 <= n < 2**31 and 1 <= d < 2**32, m = rcp32(d) (score.cu
// div_w's 32-bit path)
__device__ __forceinline__ unsigned div32(unsigned n, unsigned d, unsigned m) {
  unsigned q = __umulhi(n, m);
  return n - q * d >= d ? q + 1 : q;
}
