// The node-resident strip's arithmetic, shared by the kernels that walk a
// strip of pods down a node column: the SCORE kernel (score.cu) and the
// LoadAware and NodeFit strips (breakdown.cu).  A thread owns a node column, keeps the
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

// ------------------------------------------------------------ NodeFit
//
// The NodeFit half of a strip, shared by the SCORE kernel (score.cu) and
// the NodeFit strip (breakdown.cu nf_strip_kernel): the staging of a pod's
// scoring row and its bypass mask, the table of every included-resource
// mask's weight sum with its rcp32 and RequestedToCapacityRatio's shape at
// every utilisation, the weighted mean from the table (nf_mean), and the
// out-of-line general path of a pair outside the float estimate's
// range (nf_exact, out of line as nf_general).  A stage S has rs, rs100,
// rsf, wsum, wrcp and shape members.

// Stage pod row `row` (its Rs scoring requests) as strip pod i: each
// request beside 100 times it and its float; returns whether every one is
// in [0, 2**55) and sets the Rs bits of `excl`: a bypassed resource the
// pod does not request.
template <int RS, class S>
__device__ __forceinline__ bool stage_nf_row(S& s, int i, const long long* row, const Cfg& c,
                                             int nRs, unsigned& excl) {
  bool small = true;
#pragma unroll
  for (int r = 0; r < Width<RS>::cap; ++r)
    if (r < nRs) {
      const long long v = row[r];
      s.rs[i][r] = v;
      s.rs100[i][r] = (long long)((unsigned long long)v * 100ULL);
      s.rsf[i][r] = __ll2float_rn(v);
      small = small && in_fast(v);
      excl |= (unsigned)(c.bypass[r] && v == 0) << r;
    }
  return small;
}

// The block's tables: the NodeFit weight sum of every included-resource
// mask (RTC: twice it) with its rcp32, and under RTC the shape at every
// utilisation in 0..100; the block's threads share the work.
template <int STRAT, class S>
__device__ __forceinline__ void stage_nf_tables(S& s, const Cfg& c, int nRs) {
  for (int m = threadIdx.x; m < (1 << nRs); m += blockDim.x) {
    long long w = 0;
    for (int r = 0; r < nRs; ++r)
      if ((m >> r) & 1) w += c.nf_w[r];
    if (STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO) w *= 2;
    s.wsum[m] = w;
    s.wrcp[m] = rcp32(w);
  }
  if (STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO)
    for (int u = threadIdx.x; u <= 100; u += blockDim.x)
      s.shape[u] = (int)broken_linear<false>(c, u);
}

// Every NodeFit weight in [0, 2**22) and their sum below 2**22: a weighted
// sum of quotients in [0, 100] is then below 2**29 and no weight sum wraps
// (the float estimate's precondition)
__device__ __forceinline__ bool small_nf_weights(const Cfg& c, int nRs) {
  bool ok = true;
  long long sum = 0;
  for (int r = 0; r < nRs; ++r) {
    ok = ok && c.nf_w[r] >= 0 && c.nf_w[r] < (1 << 22);
    if (ok) sum += c.nf_w[r];
  }
  return ok && sum < (1 << 22);
}

// the NodeFit score of a fast pair from its weighted sum over the
// resources in `mask` (below 2**29, small_nf_weights), 0 when the mask's
// weight sum is
template <int STRAT, class S>
__device__ __forceinline__ unsigned nf_mean(const S& s, unsigned acc, unsigned mask) {
  const unsigned ws = (unsigned)s.wsum[mask];
  return ws == 0 ? 0u
                 : div32(STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO ? 2 * acc + ws / 2 : acc, ws,
                         s.wrcp[mask]);
}

// A pair outside the float estimate's range: pair.cuh's nf_least, nf_most
// or nf_rtc over the resources of `mask` (a non-zero capacity and not a
// bypassed zero request), every quotient floored and every sum and product
// wrapping as the plain version's int64 tensors do, over node j's rows
// read again and strip pod i's staged row (rare: a node or pod with a row
// out of range, or weights out of range).  The configuration and the node
// table are the kernel's __grid_constant__ parameters, referenced in place.
// A kernel calls it out of line (nf_general), so that its fast path's
// registers do not carry it; score.cu's general_pair inlines it into its
// own out-of-line call beside la_exact.
template <int STRAT, class S>
__device__ __forceinline__ long long nf_exact(const Cfg& c, const NodeIn& n, const S& s,
                                              int nRs, int i, int j, unsigned mask) {
  long long acc = 0, wsum = 0;
  for (int r = 0; r < nRs; ++r) {
    if (!((mask >> r) & 1)) continue;
    const size_t o = (size_t)j * nRs + r;
    const long long cap = n.alloc_score[o];
    const long long req = wrap_add(s.rs[i][r], n.nreq_score[o]);
    long long sc;
    if (STRAT == KOORD_MOST_ALLOCATED) {
      sc = floor_div(wrap_mul(req > cap ? cap : req, 100), cap);
    } else if (STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO) {
      const long long util =
          req > cap ? 100 : wrap_sub(100, floor_div(wrap_mul(wrap_sub(cap, req), 100), cap));
      sc = (unsigned long long)util <= 100 ? s.shape[util] : broken_linear<false>(c, util);
      if (sc <= 0) continue;
    } else {
      sc = req > cap ? 0 : floor_div(wrap_mul(wrap_sub(cap, req), 100), cap);
    }
    acc = wrap_add(acc, wrap_mul(sc, c.nf_w[r]));
    wsum = wrap_add(wsum, c.nf_w[r]);
  }
  if (wsum == 0) return 0;
  if (STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO)
    return floor_div(wrap_add(wrap_mul(2, acc), wsum), wrap_mul(2, wsum));
  return floor_div(acc, wsum);
}

template <int STRAT, class S>
__device__ __noinline__ long long nf_general(const Cfg& c, const NodeIn& n, const S& s, int nRs,
                                             int i, int j, unsigned mask) {
  return nf_exact<STRAT>(c, n, s, nRs, i, j, mask);
}

// ---------------------------------------------------------- LoadAware
//
// A LoadAware pair outside the float estimate's range: pair.cuh's la_score
// with its quotients floored as the plain version floors, and its sums and
// products wrapping as int64 wraps there, over node j's rows read again
// and strip pod i's staged est (S has est, la_w and flags, bit 1 the prod
// score).  The node table is the kernel's __grid_constant__ parameter,
// referenced in place; out of line as la_general (nf_exact's note).
template <class S>
__device__ __forceinline__ long long la_exact(const NodeIn& n, const S& s, int nR, int i, int j) {
  const bool prod = s.flags[i] & 1;
  long long acc = 0, wsum = 0;
  for (int r = 0; r < nR; ++r) {
    const size_t o = (size_t)j * nR + r;
    const long long cap = n.la_alloc[o];
    const long long used = wrap_add(s.est[i][r], prod ? n.base_prod[o] : n.base_nonprod[o]);
    const long long sc =
        (cap == 0 || used > cap) ? 0 : floor_div(wrap_mul(wrap_sub(cap, used), 100), cap);
    acc = wrap_add(acc, wrap_mul(sc, s.la_w[r]));
    wsum = wrap_add(wsum, s.la_w[r]);
  }
  return floor_div(acc, wsum);
}

template <class S>
__device__ __noinline__ long long la_general(const NodeIn& n, const S& s, int nR, int i, int j) {
  return la_exact(n, s, nR, i, j);
}
