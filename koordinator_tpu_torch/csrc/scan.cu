// SCHEDULE's scan route: the greedy sequential assignment, one pod at a
// time in queue order, each scored against the state the earlier pods left.
//
// Replaces: the JAX package's `schedule` kernel on its scan route,
// service/engine.py:155 schedule_fn -> core/resolved.py:286-312 ->
// core/cycle.py:248 schedule_batch (the lax.scan step with score_batch,
// _quota_admit and _quota_consume at :163-193, the reservation restore
// against the live remainders at :318-330, nominate_on_node and the
// consumption, _assign_updates at :229, and commit_gangs after the scan).
// The engine takes this route under the MostAllocated and
// RequestedToCapacityRatio strategies, which break the resolved engine's
// monotonicity (a placement can make its node MORE attractive).
//
// Design: ONE persistent cooperative launch runs the whole loop, with no
// host sync per pod.  The grid's G blocks (at most one wave, co-resident by
// cudaLaunchCooperativeKernel) split the node columns into G contiguous
// ranges.  Each step q:
//   1. every block evaluates the pair function (pair.cuh, the strategy's
//      NodeFit score) on its columns against the live state, adds the
//      frozen reservation and extra scores, ANDs in the live column, the
//      real-pod row, the extra mask and the gang prefilter, and reduces the
//      int64 composite key  total * TB + (TB-1 - rot)  to its block maximum
//      (the key is unique per column, so the maximum is the reference's
//      argmax under either tie-break: "index" passes salts of 0);
//   2. one grid-wide barrier;
//   3. every block reduces the G block maxima to the winner and decodes its
//      column; the block that owns that column alone decides the quota
//      admission (_quota_admit against the live aggregates), and on admit
//      writes the host and score, applies the assume-path updates to the
//      column's node row, consumes the request up `ancestor_depth` quota
//      levels and nominates and consumes a matched reservation on the node.
// Invariants that make one barrier per pod enough: a node's row and the
// reservations bound to it are read and written only by the block owning
// its column; the quota aggregates are written by one block per step and
// read by the next step's owner after the next barrier; the block maxima
// are double-buffered by step parity.  Cross-block data is read with
// ld.global.cg (L2), never from a stale L1 line.  A pod that fits nowhere,
// or that the quota rejects, changes no state.  After a last barrier
// block 0 applies commit_gangs; the hosts it returns are the post-rollback
// hosts, which the JAX scan also reports as its pre-commit view.
//
// The kernel works on private copies of the node, quota and reservation
// state (the wrapper makes them) and never writes its inputs.
//
// What bounds it on an H100: latency.  The work is P x N pair evaluations
// (a few hundred integer operations each), but the P steps are sequential:
// each pays a block reduction, a grid barrier and a G-way reduction, so
// the time is about P times the barrier latency, not the operations.
#include <cuda_runtime.h>

#include <climits>

#include "pair.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr long long kNone = LLONG_MIN;  // no feasible column

// scratch (int64 words): block maxima [2, kMaxBlocks], then the barrier's
// arrival count and generation as two words
constexpr int kScratchWords = 2 * kMaxBlocks + 2;

// A sense-free grid barrier over co-resident blocks: thread 0 of each block
// arrives on a counter; the last arrival resets it and bumps the
// generation the others spin on.  The fences order each block's writes
// before its arrival and its later reads after the release.
__device__ void grid_sync(unsigned long long* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned long long* gen = bar + 1;
    const unsigned long long g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1ULL) + 1 == nblocks) {
      atomicExch(bar, 0ULL);
      __threadfence();
      atomicAdd(bar + 1, 1ULL);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

// the block's maximum of v, broadcast to every thread
__device__ long long block_max(long long v, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : kNone;
    v = warp_max(v);
    if (lane == 0) s_warp[32] = v;
  }
  __syncthreads();
  v = s_warp[32];
  __syncthreads();
  return v;
}

__device__ __forceinline__ long long eff_req(const ConIn& k, int q, int r) {
  return k.q_present[(size_t)q * k.Rq + r] ? k.q_req[(size_t)q * k.Rq + r] : 0;
}

// _quota_admit (core/cycle.py:163) against the live aggregates, read from L2
__device__ bool scan_admit(const ConIn& k, int q) {
  int grp = k.q_row[q];
  for (int a = 0; a <= k.cpd; ++a) {
    if (a > 0) {
      grp = k.q_parent[grp];
      if (grp == 0) continue;
    }
    for (int r = 0; r < k.Rq; ++r) {
      if (!k.q_present[(size_t)q * k.Rq + r]) continue;
      const long long req = k.q_req[(size_t)q * k.Rq + r];
      const size_t o = (size_t)grp * k.Rq + r;
      if (!(__ldcg(&k.q_used[o]) + req <= k.q_limit[o])) return false;
      if (a == 0 && k.q_np[q] && !(__ldcg(&k.q_npu[o]) + req <= k.q_min[o])) return false;
    }
  }
  return true;
}

// the masked composite key of pod q on column j (kNone when infeasible)
template <bool CON>
__device__ __forceinline__ long long scan_key(const Cfg& c, const PodIn& p, const NodeIn& n,
                                              const ConIn& k, const XIn& x, int P, int q, int j,
                                              int salt, int N, long long TB) {
  if (!x_feas(x, q, j, P) || !la_fit(c, p, n, q, j)) return kNone;
  long long total = pair_total(c, p, n, q, j) + x_score(x, q, j, P);
  if constexpr (CON) {
    if (k.has_rsv) {
      if (!nf_fit_rsv(c, p, n, k, q, j)) return kNone;
      total += k.rscores[(size_t)k.xs[q] * N + j] * k.w_rsv;
    } else if (!nf_fit(c, p, n, q, j)) {
      return kNone;
    }
  } else if (!nf_fit(c, p, n, q, j)) {
    return kNone;
  }
  const long long rot = (j + salt) % N;
  return total * TB + (TB - 1 - rot);
}

// the owner's assume path for pod q placed on node j (one thread)
template <bool CON>
__device__ void scan_commit(const Cfg& c, const PodIn& p, const NodeIn& n, const ConIn& k, int q,
                            int j) {
  for (int r = 0; r < c.R; ++r) {
    const long long e = p.est[(size_t)q * c.R + r];
    n.base_nonprod[(size_t)j * c.R + r] += e;
    if (p.prod_class[q]) n.base_prod[(size_t)j * c.R + r] += e;
  }
  for (int r = 0; r < c.Rf; ++r) n.requested[(size_t)j * c.Rf + r] += p.req[(size_t)q * c.Rf + r];
  for (int r = 0; r < c.Rs; ++r)
    n.nreq_score[(size_t)j * c.Rs + r] += p.req_score[(size_t)q * c.Rs + r];
  n.num_pods[j] += 1;
  if constexpr (CON) {
    if (k.has_quota) {
      // _quota_consume: the request up the group chain (root excluded)
      int grp = k.q_row[q];
      for (int d = 0; d < k.ad; ++d, grp = k.q_parent[grp]) {
        if (grp == 0) continue;
        for (int r = 0; r < k.Rq; ++r) {
          const long long e = eff_req(k, q, r);
          const size_t o = (size_t)grp * k.Rq + r;
          __stcg(&k.q_used[o], __ldcg(&k.q_used[o]) + e);
          if (k.q_np[q]) __stcg(&k.q_npu[o], __ldcg(&k.q_npu[o]) + e);
        }
      }
    }
    if (k.has_rsv) {
      // nominate_on_node: among the pod's matched reservations on node j,
      // the smallest positive order rank, else the first largest rscore;
      // consume min(request, remainder), floored at 0
      const int* mi = k.midx + (size_t)q * k.Mm;
      const long long* rs = k.rscore + (size_t)k.xs[q] * k.Rv;
      int nom = -1, best_v = -1;
      long long min_rank = (long long)k.Rv + 1, best = -1;
      for (int m = 0; m < k.Mm && mi[m] >= 0; ++m) {
        const int v = mi[m];
        if (k.r_node[v] != j) continue;
        const long long rk = k.r_rank[v];
        if (rk > 0 && rk < min_rank) {
          min_rank = rk;
          nom = v;
        }
        if (rs[v] > best) {
          best = rs[v];
          best_v = v;
        }
      }
      if (nom < 0) nom = best_v;
      if (nom >= 0)
        for (int r = 0; r < c.Rf; ++r) {
          long long* a = &k.r_allocated[(size_t)nom * c.Rf + r];
          const long long remain = k.r_alloc[(size_t)nom * c.Rf + r] - *a;
          *a += max(min(p.req[(size_t)q * c.Rf + r], remain), 0LL);
        }
    }
  }
}

template <bool CON>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                const uint8_t* pod_ok, const int* salt, int P, int N, long long TB, int chunk,
                long long* scratch, int* hosts, long long* scores) {
  __shared__ long long s_warp[33];
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int lo = b * chunk, hi = min(N, lo + chunk);
  long long* bmax = scratch;
  unsigned long long* bar = (unsigned long long*)(scratch + 2 * kMaxBlocks);
  for (int q = 0; q < P; ++q) {
    bool ok = pod_ok[q];
    if constexpr (CON) ok = ok && gang_pass(k, q);
    long long best = kNone;
    if (ok)
      for (int j = lo + t; j < hi; j += blockDim.x)
        if (valid[j]) best = max(best, scan_key<CON>(c, p, n, k, x, P, q, j, salt[q], N, TB));
    best = block_max(best, s_warp);
    long long* buf = bmax + (q & 1) * kMaxBlocks;
    if (t == 0) __stcg(&buf[b], best);
    grid_sync(bar, G);
    long long win = kNone;
    for (int i = t; i < G; i += blockDim.x) win = max(win, __ldcg(&buf[i]));
    win = block_max(win, s_warp);
    if (win != kNone && t == 0) {
      const long long low = key_floor_mod(win, TB);
      const int j = (int)((TB - 1 - low - salt[q] + N) % N);
      // only the block owning the winning column decides and commits
      bool take = j >= lo && j < hi;
      if constexpr (CON) take = take && (!k.has_quota || scan_admit(k, q));
      if (take) {
        hosts[q] = j;
        scores[q] = (win - low) / TB;
        scan_commit<CON>(c, p, n, k, q, j);
      }
    }
    __syncthreads();  // the commit lands before this block scores the next pod
  }
  if constexpr (CON) {
    grid_sync(bar, G);
    if (b != 0) return;
    // commit_gangs: a gang group whose gangs did not all reach minMember
    // (placed + bound children, or once satisfied) loses every placement,
    // unless the gang is non-strict
    long long* placed = k.scratch;
    long long* unsat = k.scratch + k.G;
    for (int g = t; g < 2 * k.G; g += blockDim.x) placed[g] = 0;
    __syncthreads();
    for (int q = t; q < P; q += blockDim.x)
      if (__ldcg(&hosts[q]) >= 0) atomicAdd((unsigned long long*)&placed[k.gang_row[q]], 1ULL);
    __syncthreads();
    for (int g = t; g < k.G; g += blockDim.x)
      if (!(placed[g] + k.g_bound[g] >= k.g_min[g] || k.g_once[g]))
        atomicAdd((unsigned long long*)&unsat[k.g_group[g]], 1ULL);
    __syncthreads();
    for (int q = t; q < P; q += blockDim.x) {
      const int g = k.gang_row[q];
      if (g != 0 && unsat[k.g_group[g]] != 0 && !k.g_nonstrict[g]) {
        hosts[q] = -1;
        scores[q] = 0;
      }
    }
  }
}

ConIn no_con() {
  ConIn k = {};
  return k;
}

int launch_scan(bool con, const void* const* pods, const void* const* nodes, const long long* cfg,
                const void* la_w, ConIn k, const void* xfeas, const void* xsc, const void* valid,
                const void* pod_ok, const void* salt, int P, int N, long long TB, void* scratch,
                void* hosts, void* scores, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  void* kernel = con ? (void*)scan_kernel<true> : (void*)scan_kernel<false>;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  int G = (N + kThreads - 1) / kThreads;
  G = max(1, min(G, min(kMaxBlocks, sms * per_sm)));
  int chunk = (N + G - 1) / G;
  G = (N + chunk - 1) / chunk;
  Cfg c = koord_cfg(cfg, la_w);
  PodIn p = koord_pods(pods);
  NodeIn n = koord_nodes(nodes);
  XIn x{(const uint8_t*)xfeas, (const long long*)xsc};
  const uint8_t* v = (const uint8_t*)valid;
  const uint8_t* ok = (const uint8_t*)pod_ok;
  const int* s = (const int*)salt;
  long long* sc = (long long*)scratch;
  int* h = (int*)hosts;
  long long* o = (long long*)scores;
  void* args[] = {&c, &p, &n, &k, &x, &v, &ok, &s, &P, &N, &TB, &chunk, &sc, &h, &o};
  e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" long long koord_scan_scratch_words() { return kScratchWords; }

// hosts [P] int32 and scores [P] int64 in queue order, set to -1 and 0 by
// the caller; the scratch zeroed by the caller
extern "C" int koord_scan(const void* const* pods, const void* const* nodes, const long long* cfg,
                          const void* la_w, const void* valid, const void* pod_ok,
                          const void* salt, const void* xfeas, const void* xsc, int P, int N,
                          long long TB, void* scratch, void* hosts, void* scores, int device,
                          void* stream) {
  return launch_scan(false, pods, nodes, cfg, la_w, no_con(), xfeas, xsc, valid, pod_ok, salt, P,
                     N, TB, scratch, hosts, scores, device, stream);
}

extern "C" int koord_scan_con(const void* const* pods, const void* const* nodes,
                              const long long* cfg, const void* la_w, const void* valid,
                              const void* pod_ok, const void* salt, const void* xfeas,
                              const void* xsc, int P, int N, long long TB,
                              const void* const* con, const long long* con_ints, void* scratch,
                              void* hosts, void* scores, int device, void* stream) {
  return launch_scan(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), xfeas, xsc, valid,
                     pod_ok, salt, P, N, TB, scratch, hosts, scores, device, stream);
}
