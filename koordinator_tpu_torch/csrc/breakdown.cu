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
//     sum outside [1, 2**22)) takes la_general, out of line: the pair
//     function's arithmetic with `/`, floored;
//   - R is a template parameter for the width every serving configuration
//     reaches (2), so the loops unroll and the rows stay in registers; a
//     generic instantiation (up to KOORD_MAXR) takes every other width;
//   - both outputs are written once, coalesced (consecutive threads on
//     consecutive columns of one pod row), as streaming stores;
//   - it reads no NodeFit entry of the pointer tables (they are null).
// nf_score stays one thread a pair over pair.cuh's nf_score.
#include <cuda_runtime.h>

#include "pair.cuh"
#include "strip.cuh"

namespace {

constexpr int kCols = 128;  // node columns a block, a thread each (at most)
constexpr int kStrip = 32;  // pods a block walks
// blocks of kCols an SM: at most 64 registers a thread (32 warps an SM)
constexpr int kMinBlocks = 8;

// floor(a / b), as the plain version's torch.div(rounding_mode="floor")
// divides (b != 0)
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

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

// A pair outside the float estimate's range: pair.cuh's la_score with its
// `/` floored as the plain version floors, and its sums and products
// wrapping as int64 wraps there, over node j's rows read again (rare: a
// node or pod with a row out of range, or weights out of range).  Out of
// line, so the fast path's registers do not carry it; the node table is
// the kernel's __grid_constant__ parameter, referenced in place.
template <class S>
__device__ __noinline__ long long la_general(const NodeIn& n, const S& s, int nR, int i, int j) {
  const bool prod = s.flags[i] & 1;
  unsigned long long acc = 0, wsum = 0;
  for (int r = 0; r < nR; ++r) {
    const size_t o = (size_t)j * nR + r;
    const long long cap = n.la_alloc[o];
    const unsigned long long b = prod ? n.base_prod[o] : n.base_nonprod[o];
    const unsigned long long used = (unsigned long long)s.est[i][r] + b;
    const long long free100 = (long long)(((unsigned long long)cap - used) * 100ULL);
    const long long sc = (cap == 0 || (long long)used > cap) ? 0 : floor_div(free100, cap);
    acc += (unsigned long long)sc * (unsigned long long)s.la_w[r];
    wsum += (unsigned long long)s.la_w[r];
  }
  return floor_div((long long)acc, (long long)wsum);
}

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

__global__ void nf_score_kernel(Cfg c, PodIn p, NodeIn n, int P, int N, long long* out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int q = blockIdx.y;
  if (j >= N || q >= P) return;
  out[(size_t)q * N + j] = nf_score(c, p, n, q, j);
}

const int kThreads = 256;

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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kThreads - 1) / kThreads, P);
  nf_score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, nullptr), koord_pods(pods), koord_nodes(nodes), P, N, (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int koord_la_score_filter(const void* const* pods, const void* const* nodes,
                                     const long long* cfg, const void* la_w, int P, int N,
                                     void* out, void* feasible, int device, void* stream) {
  return launch_la<true>(pods, nodes, cfg, la_w, P, N, out, feasible, device, stream);
}
