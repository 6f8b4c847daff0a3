// The per-plugin scores of SCORE's breakdown and the LoadAware library
// entry point, each [P, N] over the pods and node columns.
//
// Replaces three jax.jit programs of the JAX package:
//   la_score  core/loadaware.py:77 loadaware_score (registered at
//             service/engine.py:1173): the raw LoadAware score, [P, N]
//             int64, no plugin weight folded in;
//   nf_score  core/nodefit.py:84 nodefit_score (registered at
//             service/engine.py:1169, the strategy static): the raw NodeFit
//             score under LeastAllocated, MostAllocated or
//             RequestedToCapacityRatio (the strategy id and the shape ride
//             in Cfg), [P, N] int64;
//   loadaware_score_and_filter  core/loadaware.py:133: the raw LoadAware
//             score and the LoadAware filter in one pass, [P, N] int64 and
//             [P, N] bool.
//
// What bounds them on an H100: bytes.  Each writes 8 bytes a pair (9 for
// the fused one, 151 MB at 1,024 x 16,384, 0.045 ms at the memory's rate)
// against a few dozen integer operations a pair; the node rows they read
// are 1/P of the output.
//
// la_score and loadaware_score_and_filter are one LoadAware-only strip
// kernel, la_strip_kernel<R, FILTER> (FILTER adds the filter).  Its
// arithmetic is pair.cuh's la_score and la_fit, term for term, with the
// plain version's floor division where a dividend may be negative: the
// same int64 results for every input.  One thread a pair calling the pair
// functions read the node's rows again for every pod, ran R 64-bit `/`
// subroutines and a 64-bit division by the weight sum, and redid both
// threshold tests of the filter, which depend on the node alone.  The
// design (score.cu's, without NodeFit):
//   - a thread owns one node column and walks a strip of 32 pods; a block
//     covers 128 consecutive columns and stages the strip's pod rows (est,
//     100 times it and its float; the prod-score, prod-class and DaemonSet
//     flags and whether every est is in [0, 2**55)) and the LoadAware
//     weights with their sum and its 32-bit reciprocal in shared memory
//     once;
//   - everything that depends on the node alone is evaluated once a
//     thread, into registers: the capacities with 100 / cap as a float, 100
//     times each free base capacity and its float and, under FILTER, both
//     threshold tests (pair.cuh's la_reject, unchanged: a pair only
//     selects between them by its DaemonSet and prod-class flags);
//   - a pair does only its pod-dependent work: each quotient 100 (cap -
//     used) / cap from a float estimate with one exact correction
//     (strip.cuh's quot100), the weighted sum in 32 bits and its division
//     by the weight sum with div32, and under FILTER one select.  A pair
//     outside the estimate's proven range (a capacity of 0 or of 2**55 or
//     more, a negative or huge est or base, a negative weight or a weight
//     sum outside [1, 2**22)) takes strip.cuh's la_general, out of line:
//     the pair function's arithmetic, floored;
//   - R is a template parameter for the width every serving configuration
//     reaches (2), so the loops unroll and the rows stay in registers; a
//     generic instantiation (up to KOORD_MAXR) takes every other width;
//   - both outputs are written once, coalesced (consecutive threads on
//     consecutive columns of one pod row), as streaming stores;
//   - it reads no NodeFit entry of the pointer tables (they are null).
//
// nf_score is the NodeFit-only strip kernel nf_strip_kernel<RS, STRAT>, the
// same design over the scoring axis (score.cu's NodeFit half, without
// LoadAware and without the fit); its arithmetic is pair.cuh's nf_least,
// nf_most and nf_rtc, term for term, with the plain version's floor
// division and int64 wrapping: the same int64 results for every input.
// One thread a pair calling nf_score read the node's rows again for every
// pod and ran Rs 64-bit `/` subroutines with runtime widths and a 64-bit
// division by the weight sum.  Here:
//   - a block stages the strip's scoring rows (req_score, 100 times it and
//     its float, whether each is in [0, 2**55), the mask of bypassed
//     resources the pod does not request), the weight sum of every
//     included-resource mask with its 32-bit reciprocal and, under RTC,
//     the shape at every utilisation in 0..100 in shared memory once
//     (strip.cuh stage_nf_row, stage_nf_tables);
//   - a thread pins its node's capacities, 100 (cap - requested) (100
//     times the requested score under MostAllocated) with its float and
//     fl(100 / fl(cap)) in registers once;
//   - a pair costs Rs calls of quot100, a 32-bit weighted sum, one 32-bit
//     division by its weight sum (on a node with every capacity non-zero
//     the pod's own, staged beside its row; else the mask's, nf_mean) and
//     one streaming store;
//     a pair outside the estimate's proven range (a capacity of 2**55 or
//     more, a negative or huge request, a weight outside [0, 2**22) or a
//     weight sum of 2**22 or more) takes strip.cuh's nf_general, out of
//     line;
//   - RS is a template parameter for the scoring width every serving
//     configuration reaches (2, with and without batch scalars), the
//     strategy one for each of the three; a generic instantiation (up to
//     KOORD_MAXR) takes every other width.
#include <cuda_runtime.h>

#include "pair.cuh"
#include "strip.cuh"

namespace {

constexpr int kCols = 128;  // node columns a block, a thread each (at most)
constexpr int kStrip = 32;  // pods a block walks
// blocks of kCols an SM: at most 64 registers a thread (32 warps an SM)
constexpr int kMinBlocks = 8;

// The strip's pod rows and the block's weights, staged once a block.
template <int R>
struct LaStage {
  long long est[kStrip][Width<R>::cap];
  long long est100[kStrip][Width<R>::cap];
  float estf[kStrip][Width<R>::cap];
  unsigned char flags[kStrip];  // 1 prod score, 2 prod class, 4 DaemonSet,
                                // 16 every est in [0, 2**55)
  long long la_w[KOORD_MAXR];   // the LoadAware weights
  unsigned wsum, wrcp;          // their sum and its rcp32, when small_w
  bool small_w;                 // every weight in [0, 2**22), their sum in [1, 2**22)
};

template <int R, bool FILTER>
__global__ void __launch_bounds__(kCols, R > 0 ? kMinBlocks : 1)
    la_strip_kernel(PodIn p, __grid_constant__ const NodeIn n, const long long* la_w, int Rrt,
                    int P, int N, long long* out, uint8_t* feasible) {
  __shared__ LaStage<R> s;
  const int nR = Width<R>::of(Rrt);
  const int q0 = blockIdx.y * kStrip;
  const int cnt = min(kStrip, P - q0);
  // stage the strip's pods and the weights
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int q = q0 + i;
    bool small = true;
#pragma unroll
    for (int r = 0; r < Width<R>::cap; ++r)
      if (r < nR) {
        const long long v = p.est[(size_t)q * nR + r];
        s.est[i][r] = v;
        s.est100[i][r] = (long long)((unsigned long long)v * 100ULL);
        s.estf[i][r] = __ll2float_rn(v);
        small = small && in_fast(v);
      }
    s.flags[i] = (p.prod_score[q] ? 1 : 0) | (FILTER && p.prod_class[q] ? 2 : 0) |
                 (FILTER && p.daemonset[q] ? 4 : 0) | (small ? 16 : 0);
  }
  if (threadIdx.x == 0) {
    bool small_w = true;
    long long sum = 0;  // below 2**25 when every weight is in [0, 2**22)
    for (int r = 0; r < nR; ++r) {
      s.la_w[r] = la_w[r];
      small_w = small_w && s.la_w[r] >= 0 && s.la_w[r] < (1 << 22);
      if (small_w) sum += s.la_w[r];
    }
    s.small_w = small_w && sum >= 1 && sum < (1 << 22);
    s.wsum = (unsigned)sum;
    s.wrcp = rcp32(sum);
  }
  __syncthreads();

  const int j = blockIdx.x * kCols + threadIdx.x;
  if (j >= N) return;

  // The node's rows, once a thread, pinned in registers.  A node takes the
  // float estimate (`fast`) when every capacity is in [1, 2**55) and every
  // base in [0, 2**55), and the block's weights are small; a pair then
  // takes it when its pod's est are in [0, 2**55) too: no sum and no
  // 100-fold product wraps, used > cap exactly when 100 (cap - used) < 0,
  // every free capacity it divides is in [0, cap], and the weighted sum is
  // below 2**31.  Every other pair takes la_general.  a: 100 (cap - base),
  // f: its float.
  long long cap[Width<R>::cap], anp[Width<R>::cap], ap[Width<R>::cap];
  float fnp[Width<R>::cap], fp[Width<R>::cap], rcf[Width<R>::cap];
  bool fast = s.small_w;
#pragma unroll
  for (int r = 0; r < Width<R>::cap; ++r)
    if (r < nR) {
      const size_t o = (size_t)j * nR + r;
      cap[r] = n.la_alloc[o];
      const long long bnp = n.base_nonprod[o], bp = n.base_prod[o];
      anp[r] = (long long)((unsigned long long)(cap[r] - bnp) * 100ULL);
      ap[r] = (long long)((unsigned long long)(cap[r] - bp) * 100ULL);
      fnp[r] = __ll2float_rn(cap[r] - bnp);
      fp[r] = __ll2float_rn(cap[r] - bp);
      rcf[r] = __fdiv_rn(100.0f, __ll2float_rn(cap[r]));
      fast = fast && cap[r] >= 1 && in_fast(cap[r]) && in_fast(bnp) && in_fast(bp);
      pin(anp[r]);
      pin(ap[r]);
      pin(fnp[r]);
      pin(fp[r]);
      pin(rcf[r]);
    }
  const bool sv = n.score_valid[j];
  bool fit_np = true, fit_p = true;
  if (FILTER) {
    fit_np = !(n.filter_active[j] && la_reject(n.filter_usage, n.la_alloc, n.thresholds, nR, j));
    fit_p = n.has_prod_thr[j] ? !(n.prod_active[j] &&
                                  la_reject(n.prod_usage, n.la_alloc, n.prod_thresholds, nR, j))
                              : fit_np;
  }
  const unsigned wsum = s.wsum, wrcp = s.wrcp;

  for (int i = 0; i < cnt; ++i) {
    const unsigned f = s.flags[i];
    long long la = 0;
    if (sv) {
      if (fast && (f & 16)) {
        // every term in [0, 2**55): used > cap exactly when 100 (cap - used) < 0
        const bool prod = f & 1;
        unsigned acc = 0;
#pragma unroll
        for (int r = 0; r < Width<R>::cap; ++r)
          if (r < nR) {
            const long long n100 = (prod ? ap[r] : anp[r]) - s.est100[i][r];
            if (n100 >= 0)
              acc += (unsigned)quot100((prod ? fp[r] : fnp[r]) - s.estf[i][r], rcf[r], n100,
                                       cap[r]) *
                     (unsigned)s.la_w[r];
          }
        la = div32(acc, wsum, wrcp);
      } else {
        la = la_general(n, s, nR, i, j);
      }
    }
    // written once and read by no one here: streaming stores
    const size_t o = (size_t)(q0 + i) * N + j;
    __stcs(&out[o], la);
    if (FILTER) __stcs(&feasible[o], (uint8_t)((f & 4) || ((f & 2) ? fit_p : fit_np)));
  }
}

// The strip's launch: the instantiation for the configuration's R (cfg[0],
// the Cfg block's first entry; the NodeFit half is zeros and unread), R = 2
// or the generic one; nothing to do when P or N is 0.
template <bool FILTER>
int launch_la(const void* const* pods, const void* const* nodes, const long long* cfg,
              const void* la_w, int P, int N, void* out, void* feasible, int device,
              void* stream) {
  const int R = (int)cfg[0];
  if (P < 0 || N < 0 || R < 0 || R > KOORD_MAXR || (P + kStrip - 1) / kStrip > 65535)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kCols - 1) / kCols, (P + kStrip - 1) / kStrip);
  const PodIn p = koord_pods(pods);
  const NodeIn n = koord_nodes(nodes);
  const long long* w = (const long long*)la_w;
  long long* o = (long long*)out;
  uint8_t* f = (uint8_t*)feasible;
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 2)
    la_strip_kernel<2, FILTER><<<grid, kCols, 0, st>>>(p, n, w, R, P, N, o, f);
  else
    la_strip_kernel<0, FILTER><<<grid, kCols, 0, st>>>(p, n, w, R, P, N, o, f);
  return (int)cudaGetLastError();
}

// The NodeFit strip's pod rows and the block's tables, staged once a
// block (strip.cuh stage_nf_row, stage_nf_tables).
template <int RS>
struct NfStage {
  long long rs[kStrip][Width<RS>::cap];
  long long rs100[kStrip][Width<RS>::cap];
  float rsf[kStrip][Width<RS>::cap];
  // Rs bits: a bypassed resource the pod does not request; bit 8: every
  // req_score in [0, 2**55)
  unsigned short flags[kStrip];
  uint2 pw[kStrip];                     // the weight sum of every resource the pod does not
                                        // bypass and its rcp32 (not under RTC)
  long long wsum[1 << Width<RS>::cap];  // weight sum of an included-resource mask (RTC: 2x)
  unsigned wrcp[1 << Width<RS>::cap];   // its rcp32
  int shape[101];                       // RTC: the shape at utilisation 0..100
  bool small_w;                         // strip.cuh small_nf_weights
};

template <int RS, int STRAT>
__global__ void __launch_bounds__(kCols, RS > 0 ? kMinBlocks : 1)
    nf_strip_kernel(__grid_constant__ const Cfg c, PodIn p, __grid_constant__ const NodeIn n,
                    int P, int N, long long* out) {
  __shared__ NfStage<RS> s;
  const int nRs = Width<RS>::of(c.Rs);
  const int q0 = blockIdx.y * kStrip;
  const int cnt = min(kStrip, P - q0);
  const unsigned full = (1u << nRs) - 1;
  // stage the strip's pods and the tables
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    unsigned excl = 0;
    const bool small =
        stage_nf_row<RS>(s, i, p.req_score + (size_t)(q0 + i) * nRs, c, nRs, excl);
    s.flags[i] = (unsigned short)(excl | (small ? 0x100u : 0u));
    if (STRAT != KOORD_REQUESTED_TO_CAPACITY_RATIO) {
      long long w = 0;
      for (int r = 0; r < nRs; ++r)
        if (!((excl >> r) & 1)) w += c.nf_w[r];
      s.pw[i] = make_uint2((unsigned)w, rcp32(w));
    }
  }
  stage_nf_tables<STRAT>(s, c, nRs);
  if (threadIdx.x == 0) s.small_w = small_nf_weights(c, nRs);
  __syncthreads();

  const int j = blockIdx.x * kCols + threadIdx.x;
  if (j >= N) return;

  // The node's rows, once a thread, pinned in registers.  A node takes the
  // float estimate (`fast`) when every capacity is 0 or in [1, 2**55) and
  // every requested score in [0, 2**55), and the block's weights are
  // small; a pair then takes it when its pod's requests are in [0, 2**55)
  // too: no sum and no 100-fold product wraps, a free capacity is negative
  // exactly when its 100-fold is, every free or requested capacity it
  // divides is in [0, cap], and the weighted sum is below 2**29.  Every
  // other pair takes nf_general.  a: 100 (cap - requested) for the free
  // quotients (100 times the requested score for MostAllocated's), f: its
  // float.
  long long acap[Width<RS>::cap], aa[Width<RS>::cap], ac100[Width<RS>::cap];
  float af[Width<RS>::cap], arcf[Width<RS>::cap];
  unsigned inc = 0;  // Rs bits: a resource with a non-zero capacity
  bool fast = s.small_w;
#pragma unroll
  for (int r = 0; r < Width<RS>::cap; ++r)
    if (r < nRs) {
      const size_t o = (size_t)j * nRs + r;
      acap[r] = n.alloc_score[o];
      const long long nreq = n.nreq_score[o];
      inc |= (unsigned)(acap[r] != 0) << r;
      const long long d = STRAT == KOORD_MOST_ALLOCATED ? nreq : acap[r] - nreq;
      aa[r] = (long long)((unsigned long long)d * 100ULL);
      ac100[r] = (long long)((unsigned long long)acap[r] * 100ULL);
      af[r] = __ll2float_rn(d);
      arcf[r] = __fdiv_rn(100.0f, __ll2float_rn(acap[r]));
      fast = fast && in_fast(acap[r]) && in_fast(nreq);
      pin(aa[r]);
      pin(ac100[r]);
      pin(af[r]);
      pin(arcf[r]);
    }

  // every capacity non-zero (the rule): a pod's included resources, and
  // so its weight sum, are its own (pw), not the node's
  const bool all_inc = inc == full;

  for (int i = 0; i < cnt; ++i) {
    const unsigned f = s.flags[i];
    const unsigned mask = inc & ~f & full;
    long long nf;
    if (fast && (f >> 8)) {
      unsigned acc = 0, used_mask = mask;
#pragma unroll
      for (int r = 0; r < Width<RS>::cap; ++r)
        if (r < nRs && ((mask >> r) & 1)) {
          const unsigned w = (unsigned)c.nf_w[r];
          if (STRAT == KOORD_MOST_ALLOCATED) {
            const long long n100 = aa[r] + s.rs100[i][r];  // 100 req
            const int q = n100 > ac100[r]
                              ? 100
                              : quot100(af[r] + s.rsf[i][r], arcf[r], n100, acap[r]);
            acc += (unsigned)q * w;
          } else {
            const long long n100 = aa[r] - s.rs100[i][r];  // 100 (cap - req)
            const int q = n100 >= 0 ? quot100(af[r] - s.rsf[i][r], arcf[r], n100, acap[r]) : 0;
            if (STRAT == KOORD_REQUESTED_TO_CAPACITY_RATIO) {
              const int sc = s.shape[n100 >= 0 ? 100 - q : 100];
              if (sc > 0)
                acc += (unsigned)sc * w;
              else
                used_mask &= ~(1u << r);
            } else {
              acc += (unsigned)q * w;
            }
          }
        }
      if (STRAT != KOORD_REQUESTED_TO_CAPACITY_RATIO && all_inc) {
        const uint2 pw = s.pw[i];
        nf = pw.x == 0 ? 0 : div32(acc, pw.x, pw.y);
      } else {
        nf = nf_mean<STRAT>(s, acc, used_mask);
      }
    } else {
      nf = nf_general<STRAT>(c, n, s, nRs, i, j, mask);
    }
    // written once and read by no one here: a streaming store
    __stcs(&out[(size_t)(q0 + i) * N + j], nf);
  }
}

template <int RS>
void launch_nf_widths(const Cfg& c, const PodIn& p, const NodeIn& n, int P, int N, long long* o,
                      cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (P + kStrip - 1) / kStrip);
  if (c.strategy == KOORD_MOST_ALLOCATED)
    nf_strip_kernel<RS, KOORD_MOST_ALLOCATED><<<grid, kCols, 0, st>>>(c, p, n, P, N, o);
  else if (c.strategy == KOORD_REQUESTED_TO_CAPACITY_RATIO)
    nf_strip_kernel<RS, KOORD_REQUESTED_TO_CAPACITY_RATIO>
        <<<grid, kCols, 0, st>>>(c, p, n, P, N, o);
  else
    nf_strip_kernel<RS, KOORD_LEAST_ALLOCATED><<<grid, kCols, 0, st>>>(c, p, n, P, N, o);
}

// The NodeFit strip's launch: the instantiation for the configuration's
// scoring width (cfg[2]: 2, the serving configurations' with and without
// batch scalars, or the generic one) and strategy; nothing to do when P
// or N is 0.
int launch_nf(const void* const* pods, const void* const* nodes, const long long* cfg, int P,
              int N, void* out, int device, void* stream) {
  const int Rs = (int)cfg[2];
  if (P < 0 || N < 0 || Rs < 0 || Rs > KOORD_MAXR || (P + kStrip - 1) / kStrip > 65535)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Cfg c = koord_cfg(cfg, nullptr);
  const PodIn p = koord_pods(pods);
  const NodeIn n = koord_nodes(nodes);
  long long* o = (long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Rs == 2)
    launch_nf_widths<2>(c, p, n, P, N, o, st);
  else
    launch_nf_widths<0>(c, p, n, P, N, o, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The pod and node pointer tables are laid out as koord_pods/koord_nodes
// read them; the entries a kernel does not read may be null.
extern "C" int koord_la_score(const void* const* pods, const void* const* nodes,
                              const long long* cfg, const void* la_w, int P, int N, void* out,
                              int device, void* stream) {
  return launch_la<false>(pods, nodes, cfg, la_w, P, N, out, nullptr, device, stream);
}

extern "C" int koord_nf_score(const void* const* pods, const void* const* nodes,
                              const long long* cfg, int P, int N, void* out, int device,
                              void* stream) {
  return launch_nf(pods, nodes, cfg, P, N, out, device, stream);
}

extern "C" int koord_la_score_filter(const void* const* pods, const void* const* nodes,
                                     const long long* cfg, const void* la_w, int P, int N,
                                     void* out, void* feasible, int device, void* stream) {
  return launch_la<true>(pods, nodes, cfg, la_w, P, N, out, feasible, device, stream);
}
