// SCORE: every pending pod against every node, the [P, N] int64 totals and
// the [P, N] feasibility mask in one pass.
//
// Replaces: the JAX package's `score` kernel, service/engine.py:134
// score_fn -> core/cycle.py:195 score_batch (LoadAware least-requested +
// NodeFit under the configured strategy — LeastAllocated, MostAllocated or
// RequestedToCapacityRatio, pair.cuh nf_score —, weighted; LoadAware
// thresholds && NodeFit fit && the live-column mask), under the default
// profile's plugin weights, plus
// the batch's pre-weighted extra scores (deviceshare, amplified CPU; [P, N]
// int64, null when absent) as the JAX score_fn adds them.  Also the JAX
// package's `shard_score_map` (koordinator_tpu/service/sharding.py:480,
// one mesh device's block of the node axis): the same kernel over a
// column block [col0, col0 + Nb) of N (`koord_shard_score`).
//
// The arithmetic is pair.cuh's pair_total, la_fit and nf_fit, term for
// term: the same int64 results for every input, so every output is the
// one the plain version computes.  Where and how each term is evaluated
// differs.
//
// What bounds it on an H100: instructions.  The bytes it must write (9 a
// pair, 151 MB at 1,024 x 16,384) take 0.046 ms at the memory's rate, a
// kernel that only writes them ~0.065; a pair's arithmetic costs more.
// One thread a pair calling the pair function cost ~900 lane instructions
// (each 64-bit `/` a subroutine of tens of instructions, the widths
// runtime values, the node's rows and both LoadAware reject tests redone
// for every pod); this design's loop is ~240 a pair.  The design:
//   - a thread owns one node column and walks a strip of pods; a block
//     covers `cols` consecutive columns and stages the strip's pod rows
//     (est, req, req_score, each with 100 times it and its float; the four
//     flags; each pod's NodeFit masks) in shared memory once;
//   - everything that depends on the node alone is evaluated once a
//     thread, into registers: both LoadAware reject tests (a pair only
//     selects between them by its DaemonSet and prod-class flags),
//     NodeFit's pod-count gate with the live-column mask and its free
//     capacity, the capacities with 100 / cap as a float, 100 times each
//     free (or requested) base capacity and its float;
//   - a pair does only its pod-dependent work: each quotient 100 n / cap
//     (n the free or requested capacity, in [0, cap]) from a float
//     estimate, proven exact unless its fraction lies within 1e-4 of an
//     integer, when one exact 64-bit correction settles it (quot100: a few
//     float operations where a 64-bit division by the reciprocal took
//     eleven multiplies), the weighted sums in 32 bits, whose division by a
//     weight sum takes a 32-bit reciprocal (NodeFit's from a per-block
//     table of every included-resource mask's sum; RTC: also the shape at
//     every utilisation in 0..100), and the fit compares.  A pair outside the
//     estimate's proven range (a capacity of 2**55 or more, a negative
//     request or base, a weight outside [0, 2**22)) takes general_pair,
//     out of line: the pair function's own arithmetic (strip.cuh's
//     la_exact and nf_exact), every quotient floored and every sum
//     wrapping as the plain version's;
//   - R, Rf and Rs are template parameters for the widths the serving
//     configurations reach (2, 3, 2 without batch scalars; 2, 5, 2 with
//     them), so the loops unroll and the rows stay in registers; a generic
//     instantiation (up to KOORD_MAXR each) takes every other width;
//     koord_score chooses by the configuration's widths and strategy;
//   - both outputs are written once, coalesced (consecutive threads on
//     consecutive columns of one pod row) as streaming stores, and extra
//     scores read the same way;
//   - 128 columns a block, 32 pods a strip, 64 registers a thread (the
//     study's sweep, PERF.md §6);
//   - a launch covers the column block [col0, col0 + Nb): the grid's x
//     extent is ceil(Nb / 128), a tile starts at col0 + 128 blockIdx.x,
//     and a thread past col0 + Nb stops, so a tile that crosses the
//     block's end (col0 need not be a multiple of 128) writes nothing
//     outside it; the whole SCORE is the block [0, N).
#include <cuda_runtime.h>

#include "pair.cuh"
#include "strip.cuh"

namespace {

constexpr int kCols = 128;      // node columns a block, a thread each (at most)
constexpr int kStrip = 32;      // pods a block walks
constexpr int kMaxStrip = 64;   // the staging's capacity (the study's largest strip)
constexpr int kMaxMasks = 1 << KOORD_MAXR;
// blocks of kCols an SM: at most 64 registers a thread (32 warps an SM;
// 80 registers at 6 blocks and 98 at 5 were no faster on the H100)
constexpr int kMinBlocks = 8;

// The strip's pod rows and the block's tables, staged once a block: each
// request beside 100 times it and its float.
template <int R, int RF, int RS>
struct Stage {
  long long est[kMaxStrip][Width<R>::cap];
  long long est100[kMaxStrip][Width<R>::cap];
  float estf[kMaxStrip][Width<R>::cap];
  long long req[kMaxStrip][Width<RF>::cap];
  long long rs[kMaxStrip][Width<RS>::cap];
  long long rs100[kMaxStrip][Width<RS>::cap];
  float rsf[kMaxStrip][Width<RS>::cap];
  unsigned char flags[kMaxStrip];  // 1 prod score, 2 prod class, 4 DaemonSet, 8 any request,
                                   // 16 every est and req_score in [0, 2**55)
  unsigned char need[kMaxStrip];   // Rf bits: the fit checks the resource (always || req > 0)
  unsigned char excl[kMaxStrip];   // Rs bits: a bypassed resource the pod does not request
  long long wsum[kMaxMasks];       // NodeFit weight sum of an included-resource mask (RTC: 2x)
  unsigned wrcp[kMaxMasks];        // its rcp32
  int shape[101];                  // RTC: the shape at utilisation 0..100
  long long la_w[KOORD_MAXR];      // the LoadAware weights
  bool small_w;                    // every weight in [0, 2**22), each plugin's sum < 2**22
};

// A pair outside the float estimate's range: strip.cuh's la_exact and
// nf_exact (the pair function's arithmetic, floored and wrapping), in one
// out-of-line call so that the fast path's registers carry neither.
template <int R, int RS, int STRAT, class S>
__device__ __noinline__ void general_pair(const Cfg& c, const NodeIn& n, const S& s, int i, int j,
                                          unsigned mask, bool sv, long long* out) {
  out[0] = sv ? la_exact(n, s, Width<R>::of(c.R), i, j) : 0;
  out[1] = nf_exact<STRAT>(c, n, s, Width<RS>::of(c.Rs), i, j, mask);
}

// Columns [col0, col0 + Nb) of N: the node rows, valid, the extra scores
// and both outputs are indexed by the global column (the outputs at q * N +
// j); a tile that crosses the block's end writes nothing past it.
template <int R, int RF, int RS, int STRAT>
__global__ void __launch_bounds__(kCols, R > 0 ? kMinBlocks : 1)
    score_kernel(__grid_constant__ const Cfg c, PodIn p, __grid_constant__ const NodeIn n,
                 const uint8_t* valid, const long long* xsc, int P, int N, int col0, int Nb,
                 int strip, long long* totals, uint8_t* feasible) {
  __shared__ Stage<R, RF, RS> s;
  const int nR = Width<R>::of(c.R), nRf = Width<RF>::of(c.Rf), nRs = Width<RS>::of(c.Rs);
  const int q0 = blockIdx.y * strip;
  const int cnt = min(strip, P - q0);
  // stage the strip's pods and the tables
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
    unsigned need = 0, excl = 0;
#pragma unroll
    for (int r = 0; r < Width<RF>::cap; ++r)
      if (r < nRf) {
        const long long v = p.req[(size_t)q * nRf + r];
        s.req[i][r] = v;
        need |= (unsigned)(c.always[r] || v > 0) << r;
      }
    small = stage_nf_row<RS>(s, i, p.req_score + (size_t)q * nRs, c, nRs, excl) && small;
    s.flags[i] = (p.prod_score[q] ? 1 : 0) | (p.prod_class[q] ? 2 : 0) |
                 (p.daemonset[q] ? 4 : 0) | (p.has_any[q] ? 8 : 0) | (small ? 16 : 0);
    s.need[i] = (unsigned char)need;
    s.excl[i] = (unsigned char)excl;
  }
  stage_nf_tables<STRAT>(s, c, nRs);
  if (threadIdx.x == 0) {
    bool small_w = true;
    long long la_sum = 0;  // below 2**25 when every weight is in [0, 2**22)
    for (int r = 0; r < nR; ++r) {
      s.la_w[r] = c.la_w[r];
      small_w = small_w && s.la_w[r] >= 0 && s.la_w[r] < (1 << 22);
      if (small_w) la_sum += s.la_w[r];
    }
    s.small_w = small_w && la_sum >= 1 && la_sum < (1 << 22) && small_nf_weights(c, nRs);
  }
  __syncthreads();

  const int j = col0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= col0 + Nb || cnt <= 0) return;

  // The node's rows, once a thread, pinned in registers.  A node takes
  // the float estimate (`fast`) when every LoadAware capacity is in
  // [1, 2**55), every NodeFit capacity 0 or there, and every base and
  // requested score in [0, 2**55), and the block's weights are small; a
  // pair then takes it when its pod's rows are in [0, 2**55) too: no sum
  // and no 100-fold product wraps, a free capacity is negative exactly when
  // its 100-fold is, every free or requested capacity n it divides is in
  // [0, cap], and every weighted sum is below 2**31.  Every other pair
  // takes general_pair.  a: 100 (cap - base) for the free quotients (100
  // times the requested score for MostAllocated's), f: their floats.
  long long cap[Width<R>::cap], anp[Width<R>::cap], ap[Width<R>::cap];
  float fnp[Width<R>::cap], fp[Width<R>::cap], rcf[Width<R>::cap];
  bool fast = s.small_w;
  unsigned la_wsum = 0;
#pragma unroll
  for (int r = 0; r < Width<R>::cap; ++r)
    if (r < nR) {
      const size_t o = (size_t)j * nR + r;
      cap[r] = n.la_alloc[o];
      const long long bnp = n.base_nonprod[o], bp = n.base_prod[o];
      la_wsum += (unsigned)s.la_w[r];
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
  const unsigned la_wrcp = rcp32(la_wsum);
  const bool sv = n.score_valid[j];
  const bool fit_np = !(n.filter_active[j] &&
                        la_reject(n.filter_usage, n.la_alloc, n.thresholds, nR, j));
  const bool fit_p = n.has_prod_thr[j]
                         ? !(n.prod_active[j] &&
                             la_reject(n.prod_usage, n.la_alloc, n.prod_thresholds, nR, j))
                         : fit_np;
  const bool open = valid[j] && n.num_pods[j] + 1 <= n.allowed[j];
  long long free_[Width<RF>::cap];
#pragma unroll
  for (int r = 0; r < Width<RF>::cap; ++r)
    if (r < nRf) {
      const size_t o = (size_t)j * nRf + r;
      free_[r] = n.nf_alloc[o] - n.requested[o];
    }
  long long acap[Width<RS>::cap], aa[Width<RS>::cap], ac100[Width<RS>::cap];
  float af[Width<RS>::cap], arcf[Width<RS>::cap];
  unsigned inc = 0;  // Rs bits: a resource with a non-zero capacity
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

  for (int i = 0; i < cnt; ++i) {
    const unsigned f = s.flags[i];
    const bool prod = f & 1;
    const unsigned mask = inc & ~(unsigned)s.excl[i];
    long long la = 0, nf = 0;
    if (fast && (f & 16)) {
      // every term in [0, 2**55): used > cap exactly when 100 (cap - used) < 0
      if (sv) {
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
        la = div32(acc, la_wsum, la_wrcp);
      }
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
      nf = nf_mean<STRAT>(s, acc, used_mask);
    } else {
      long long both[2];
      general_pair<R, RS, STRAT>(c, n, s, i, j, mask, sv, both);
      la = both[0];
      nf = both[1];
    }
    // the filters: the live column and pod count, LoadAware, NodeFit
    bool ok = open && ((f & 4) || ((f & 2) ? fit_p : fit_np));
    if (ok && (f & 8)) {
      const unsigned need = s.need[i];
#pragma unroll
      for (int r = 0; r < Width<RF>::cap; ++r)
        if (r < nRf && ((need >> r) & 1) && s.req[i][r] > free_[r]) ok = false;
    }
    // written once and read by no one here: streaming stores
    const size_t o = (size_t)(q0 + i) * N + j;
    __stcs(&totals[o], la + nf + (xsc ? __ldcs(&xsc[o]) : 0));
    __stcs(&feasible[o], (uint8_t)ok);
  }
}

template <int R, int RF, int RS>
cudaError_t launch_widths(const Cfg& c, const PodIn& p, const NodeIn& n, const uint8_t* valid,
                          const long long* xsc, int P, int N, int col0, int Nb, int strip,
                          int cols, long long* totals, uint8_t* feasible, cudaStream_t st) {
  dim3 grid((Nb + cols - 1) / cols, (P + strip - 1) / strip);
  if (c.strategy == KOORD_MOST_ALLOCATED)
    score_kernel<R, RF, RS, KOORD_MOST_ALLOCATED><<<grid, cols, 0, st>>>(
        c, p, n, valid, xsc, P, N, col0, Nb, strip, totals, feasible);
  else if (c.strategy == KOORD_REQUESTED_TO_CAPACITY_RATIO)
    score_kernel<R, RF, RS, KOORD_REQUESTED_TO_CAPACITY_RATIO><<<grid, cols, 0, st>>>(
        c, p, n, valid, xsc, P, N, col0, Nb, strip, totals, feasible);
  else
    score_kernel<R, RF, RS, KOORD_LEAST_ALLOCATED><<<grid, cols, 0, st>>>(
        c, p, n, valid, xsc, P, N, col0, Nb, strip, totals, feasible);
  return cudaGetLastError();
}

// The instantiation for the configuration's widths: the serving
// configurations' own, else the generic one; over columns [col0, col0 +
// Nb) of N (nothing to do when P or Nb is 0).
int launch_score(const void* const* pods, const void* const* nodes, const long long* cfg,
                 const void* la_w, const void* valid, const void* xsc, int P, int N, int col0,
                 int Nb, int strip, int cols, void* totals, void* feasible, int device,
                 void* stream) {
  if (strip < 1 || strip > kMaxStrip || cols < 32 || cols > kCols || cols % 32 || P < 0 ||
      col0 < 0 || Nb < 0 || col0 > N - Nb || (P + strip - 1) / strip > 65535)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || Nb == 0) return (int)cudaSuccess;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Cfg c = koord_cfg(cfg, la_w);
  const PodIn p = koord_pods(pods);
  const NodeIn n = koord_nodes(nodes);
  const uint8_t* v = (const uint8_t*)valid;
  const long long* x = (const long long*)xsc;
  long long* t = (long long*)totals;
  uint8_t* f = (uint8_t*)feasible;
  cudaStream_t st = (cudaStream_t)stream;
  if (c.R == 2 && c.Rf == 3 && c.Rs == 2)
    e = launch_widths<2, 3, 2>(c, p, n, v, x, P, N, col0, Nb, strip, cols, t, f, st);
  else if (c.R == 2 && c.Rf == 5 && c.Rs == 2)
    e = launch_widths<2, 5, 2>(c, p, n, v, x, P, N, col0, Nb, strip, cols, t, f, st);
  else
    e = launch_widths<0, 0, 0>(c, p, n, v, x, P, N, col0, Nb, strip, cols, t, f, st);
  return (int)e;
}

}  // namespace

#ifdef KOORD_SCORE_STUDY
namespace {

// The store floor: every pair's two outputs written once, coalesced (a
// thread a node column, 32 pods a block row), and nothing read.
__global__ void score_floor_kernel(int P, int N, long long* totals, uint8_t* feasible) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int q1 = min(P, (int)(blockIdx.y + 1) * 32);
  for (int q = blockIdx.y * 32; q < q1; ++q) {
    const size_t o = (size_t)q * N + j;
    totals[o] = j;
    feasible[o] = (uint8_t)(q & 1);
  }
}

}  // namespace

extern "C" int koord_score_floor(int P, int N, void* totals, void* feasible, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + 127) / 128, (P + 31) / 32);
  score_floor_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(P, N, (long long*)totals,
                                                              (uint8_t*)feasible);
  return (int)cudaGetLastError();
}

// The score kernel under another strip height and block width, for the
// study's sweep (the path's launch takes kStrip and kCols).
extern "C" int koord_score_tuned(const void* const* pods, const void* const* nodes,
                                 const long long* cfg, const void* la_w, const void* valid,
                                 const void* xsc, int P, int N, int strip, int cols,
                                 void* totals, void* feasible, int device, void* stream) {
  return launch_score(pods, nodes, cfg, la_w, valid, xsc, P, N, 0, N, strip, cols, totals,
                      feasible, device, stream);
}
#endif

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_score(const void* const* pods, const void* const* nodes,
                           const long long* cfg, const void* la_w, const void* valid,
                           const void* xsc, int P, int N, void* totals, void* feasible,
                           int device, void* stream) {
  return launch_score(pods, nodes, cfg, la_w, valid, xsc, P, N, 0, N, kStrip, kCols, totals,
                      feasible, device, stream);
}

// SCORE over one node shard of the mesh (the JAX package's
// `shard_score_map`, koordinator_tpu/service/sharding.py:456-520, `_smap_fn`;
// the body `build`/`blk` at :480-505: each mesh device evaluates
// score_batch over its block of the node axis, adds the block's extra
// scores and ANDs the block's live-column mask): the same kernel over the
// column block [col0, col0 + Nb) of N.  pods, nodes, cfg, la_w, valid: the
// pair tables of `koord_score` over N node columns; xsc: [P, N] int64 extra
// scores or null; totals [P, N] int64, feasible [P, N] bool, written at
// the block's columns only.  Every block on one card writes straight into
// one [P, N] buffer; a block on a card of its own reads its copies of the
// node rows (col0 = 0, N = Nb).
extern "C" int koord_shard_score(const void* const* pods, const void* const* nodes,
                                 const long long* cfg, const void* la_w, const void* valid,
                                 const void* xsc, int P, int N, int col0, int Nb, void* totals,
                                 void* feasible, int device, void* stream) {
  return launch_score(pods, nodes, cfg, la_w, valid, xsc, P, N, col0, Nb, kStrip, kCols, totals,
                      feasible, device, stream);
}
