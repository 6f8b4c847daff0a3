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
// Design: two launches.  The first is the key build of csrc/schedule.cu on
// the int64 key lane (build_keys<CON, long long>): the composite key
// score * TB + (TB-1 - rot) of every (pod, node) pair against the
// batch-start state, M [N_pad, P], and its BS-row block maxima Mb [NB, P].
// The second is the step kernel below, ONE block of 1,024 threads that
// walks the pods in queue order.  It rests on one invariant: a pod's key on
// node j depends on the pod, on the batch's frozen inputs (extra mask and
// scores, reservation scores, gang prefilter) and on node j's live row (its
// assume-path fields and the allocations of the reservations bound to it)
// alone.  A commit writes one node's row and that node's reservations; a
// quota rejection, or a pod that fits nowhere, changes nothing.  So a key
// built at the batch start stays exact on every row no pod has landed on,
// and after each commit only the committed row is rescored, for the pods
// still to come.  Step q:
//   1. the sweep: pod q's maximum over its NB block maxima, the winner's
//      column decoded from the key's low bits (the key is unique per
//      column, so the maximum is the reference's argmax under either
//      tie-break: "index" passes salts of 0);
//   2. under constraints, _quota_admit against the live aggregates (in
//      shared memory where they fit), one quota dimension a lane of a warp,
//      while the commit's threads load row j's fields and every thread what
//      the rescoring reads for its pod (its old key, its block maximum, its
//      extras): one memory round trip for all of them;
//   3. on admit, the commit: the host and score; the assume-path update of
//      row j, a thread a field, which also stages the row (with its
//      LoadAware filter fields) and its capacities' reciprocals in shared
//      memory; the request up `ancestor_depth` quota levels; a matched
//      reservation on j nominated and consumed;
//   4. row j rescored for the pods q' > q with the key build's arithmetic
//      (key_of's pair_key / pair_key_con on the staged row, pair.cuh's exact
//      reciprocal division), except where the key is already infeasible
//      (a placement frees nothing: requests and pod counts only grow, a
//      reservation's remainder only shrinks, the rest is frozen), and their
//      block maximum Mb[j / BS, q'] kept: raised to a key above it,
//      re-reduced over the block only when row j held the maximum and its
//      key fell.
// The sweep reads the block maxima pod-major (MbT, the wrapper's transpose,
// kept beside Mb): one pod's row is contiguous, loaded a step ahead.
// After the last pod, commit_gangs.  The block's threads share the step's
// state through shared memory and __syncthreads alone: no grid barrier, no
// hop between SMs.  The launch updates M and Mb in place (the wrapper hands
// it the key build's fresh output) and commits into private copies of the
// node, quota and reservation state (the wrapper makes them).
//
// What bounds it on an H100: the P steps are sequential, and a step is a
// sweep of NB values, a few dependent global round trips and one row's
// rescoring for up to P - 1 pods, one pair a thread on this one SM; at
// 1,024 x 16,384 the rescoring's 64-bit arithmetic is the larger half of a
// step (PERF.md §6).  Spreading the rescoring over a few blocks, each
// owning a pod range and applying the earlier blocks' steps to its own
// pods, was measured slower: a block applies a step at about the pace the
// owner takes one, so the pipeline never gets ahead (PERF.md §6).
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr long long kNeg = KeyLane<long long>::neg;  // no feasible column
// the quota aggregates (used and npu) move to shared memory up to this
// many int64 words, 32 KB
constexpr int kQuotaSmemWords = 4096;
// the staged row: la_alloc, base_nonprod, base_prod [R], nf_alloc,
// requested [Rf], alloc_score, nreq_score [Rs], num_pods, allowed, then the
// LoadAware filter's filter_usage, thresholds, prod_usage, prod_thresholds
// [R]; and four flags: score_valid, filter_active, prod_active,
// has_prod_thr
constexpr int kRowWords = 11 * KOORD_MAXR + 2;
// the commit's other workers: the quota chain (a lane a dimension of this
// warp) and the reservation nomination (this thread)
constexpr int kQuotaWarp = 4;
constexpr int kRsvThread = 160;

#ifdef KOORD_SCAN_STUDY
// The study build (csrc/scanstudy.cu) adds the phase split: SM cycles of
// thread 0 summed over the pods, in the phases: the sweep, the decision
// (decode and admission), the commit, the rescoring with its block maxima.
// koord_scan_split reads it.
constexpr int kSplitPhases = 4;
__device__ long long g_scan_split[kSplitPhases];

// pair.cuh's divisions against floor_div on the caller's operands (d >=
// 1): out[i] = (div_cap, floor_div, div_small) of n[i] / d[i]
__global__ void div_check(const long long* n, const long long* d, long long* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long a = n[i], b = d[i];
  out[3 * i] = div_cap<true>(a, b, koord_rcp(b));
  out[3 * i + 1] = floor_div(a, b);
  out[3 * i + 2] = div_small<true>(a, b);
}
#endif

__device__ __forceinline__ long long warp_max(long long v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// the block's maximum of v, broadcast to every thread
__device__ long long block_max(long long v, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < (int)(blockDim.x >> 5) ? s_warp[lane] : kNeg);
    if (lane == 0) s_warp[32] = v;
  }
  __syncthreads();
  return s_warp[32];
}

// The step's admission: _quota_admit (core/cycle.py:163) of pod q against
// the live aggregates, one quota dimension a lane of the calling warp
__device__ __forceinline__ bool step_admit(const ConIn& k, const long long* used,
                                           const long long* npu, int q, int lane) {
  bool ok = true;
  if (lane < k.Rq && k.q_present[(size_t)q * k.Rq + lane]) {
    const long long req = k.q_req[(size_t)q * k.Rq + lane];
    int grp = k.q_row[q];
    for (int a = 0; a <= k.cpd; ++a) {
      if (a > 0) {
        grp = k.q_parent[grp];
        if (grp == 0) continue;
      }
      const size_t o = (size_t)grp * k.Rq + lane;
      if (!(used[o] + req <= k.q_limit[o])) ok = false;
      if (a == 0 && k.q_np[q] && !(npu[o] + req <= k.q_min[o])) ok = false;
    }
  }
  return __all_sync(0xffffffffu, ok);
}

template <bool CON>
__global__ void __launch_bounds__(kThreads)
    scan_steps(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
               const uint8_t* pod_ok, const int* salt, int P, int N, int BS, long long TB,
               long long* M, long long* Mb, long long* MbT, int* hosts, long long* scores) {
  extern __shared__ __align__(16) long long s_quota[];
  __shared__ long long s_warp[33];
  __shared__ long long s_row[kRowWords];
  __shared__ unsigned long long s_rcp[2 * KOORD_MAXR];
  __shared__ uint8_t s_flag[4];
  __shared__ int s_ok;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int R = c.R, Rf = c.Rf, Rs = c.Rs;
  const int NB = (N + BS - 1) / BS;
  const bool pow2 = (TB & (TB - 1)) == 0;
  // the quota aggregates: the private copies, or their copy in shared memory
  long long* used = k.q_used;
  long long* npu = k.q_npu;
  if constexpr (CON) {
    if (k.has_quota && 2 * k.Q * k.Rq <= kQuotaSmemWords) {
      const int w = k.Q * k.Rq;
      for (int i = t; i < w; i += T) {
        s_quota[i] = k.q_used[i];
        s_quota[w + i] = k.q_npu[i];
      }
      used = s_quota;
      npu = s_quota + w;
    }
  }
  for (int q = t; q < P; q += T) {
    hosts[q] = -1;
    scores[q] = 0;
  }
  // node j's row as the rescoring reads it: row 0 of the staged arrays
  NodeIn ns = n;
  ns.la_alloc = s_row;
  ns.base_nonprod = s_row + R;
  ns.base_prod = s_row + 2 * R;
  ns.nf_alloc = s_row + 3 * R;
  ns.requested = s_row + 3 * R + Rf;
  ns.alloc_score = s_row + 3 * R + 2 * Rf;
  ns.nreq_score = s_row + 3 * R + 2 * Rf + Rs;
  const int W = 3 * R + 2 * Rf + 2 * Rs + 2;  // the words before the filter's
  ns.num_pods = s_row + W - 2;
  ns.allowed = s_row + W - 1;
  ns.filter_usage = s_row + W;
  ns.thresholds = s_row + W + R;
  ns.prod_usage = s_row + W + 2 * R;
  ns.prod_thresholds = s_row + W + 3 * R;
  ns.score_valid = s_flag;
  ns.filter_active = s_flag + 1;
  ns.prod_active = s_flag + 2;
  ns.has_prod_thr = s_flag + 3;
  ns.la_rcp = s_rcp;
  ns.as_rcp = s_rcp + KOORD_MAXR;
  const int F = W + 4 * R + 4;  // the staged fields: the words, then the flags
  // the next pod's block maxima, loaded a step ahead (NB <= T: one a thread)
  const bool ahead = NB <= T;
  long long next = kNeg;
  if (ahead && t < NB && P > 0) next = MbT[t];
  __syncthreads();

#ifdef KOORD_SCAN_STUDY
  long long split[kSplitPhases] = {};
  long long tick = clock64();
#define KOORD_SPLIT(i)               \
  if (t == 0) {                      \
    const long long now = clock64(); \
    split[i] += now - tick;          \
    tick = now;                      \
  }
#else
#define KOORD_SPLIT(i)
#endif
  for (int q = 0; q < P; ++q) {
    // 1. the sweep of pod q's block maxima (MbT's row q, loaded a step
    // ahead), then the load of pod q+1's
    long long v = kNeg;
    if (ahead) {
      v = next;
    } else {
      for (int b = t; b < NB; b += T) v = max(v, MbT[(size_t)q * NB + b]);
    }
    if (ahead && t < NB && q + 1 < P) next = MbT[(size_t)(q + 1) * NB + t];
    if (!pod_pass<CON>(pod_ok, k, q)) continue;
    const long long win = block_max(v, s_warp);
    KOORD_SPLIT(0);
    if (win == kNeg) continue;
    // 2. the decision: every thread decodes the column (TB is a power of
    // two, tie_base: the floor modulo is a mask); the commit's threads load
    // row j's fields while, under quota, warp 2 decides the admission
    const long long low = pow2 ? win & (TB - 1) : key_floor_mod(win, TB);
    long long jj = TB - 1 - low - salt[q];  // the rotation undone
    if (jj < 0) jj += N;
    if (jj < 0 || jj >= N) jj = ((jj % N) + N) % N;
    const int j = (int)jj, b = j / BS;
    long long val = 0;
    if (t < F) {
      const int f = t;
      if (f < R) {
        val = n.la_alloc[(size_t)j * R + f];
      } else if (f < 2 * R) {
        val = n.base_nonprod[(size_t)j * R + f - R];
      } else if (f < 3 * R) {
        val = n.base_prod[(size_t)j * R + f - 2 * R];
      } else if (f < 3 * R + Rf) {
        val = n.nf_alloc[(size_t)j * Rf + f - 3 * R];
      } else if (f < 3 * R + 2 * Rf) {
        val = n.requested[(size_t)j * Rf + f - 3 * R - Rf];
      } else if (f < 3 * R + 2 * Rf + Rs) {
        val = n.alloc_score[(size_t)j * Rs + f - 3 * R - 2 * Rf];
      } else if (f < W - 2) {
        val = n.nreq_score[(size_t)j * Rs + f - 3 * R - 2 * Rf - Rs];
      } else if (f == W - 2) {
        val = n.num_pods[j];
      } else if (f == W - 1) {
        val = n.allowed[j];
      } else if (f < W + R) {
        val = n.filter_usage[(size_t)j * R + f - W];
      } else if (f < W + 2 * R) {
        val = n.thresholds[(size_t)j * R + f - W - R];
      } else if (f < W + 3 * R) {
        val = n.prod_usage[(size_t)j * R + f - W - 2 * R];
      } else if (f < W + 4 * R) {
        val = n.prod_thresholds[(size_t)j * R + f - W - 3 * R];
      } else if (f == F - 4) {
        val = n.score_valid[j];
      } else if (f == F - 3) {
        val = n.filter_active[j];
      } else if (f == F - 2) {
        val = n.prod_active[j];
      } else {
        val = n.has_prod_thr[j];
      }
    }
    // what the rescoring reads of row j for this thread's pod, loaded now
    // (P <= T: a pod a thread) so that the loads overlap the commit's
    const bool vj = valid[j];
    const int mq = t;
    const bool mine = P <= T && mq > q && mq < P && pod_pass<CON>(pod_ok, k, mq);
    long long m_old = 0, m_top = 0, m_xadd = 0;
    bool m_xf = true;
    if (mine) {
      m_old = M[(size_t)j * P + mq];
      m_top = Mb[(size_t)b * P + mq];
      m_xf = x_feas(x, mq, j, P);
      m_xadd = x_score(x, mq, j, P);
    }
    if constexpr (CON) {
      if (k.has_quota) {
        if (warp == kQuotaWarp) {
          const bool ok = step_admit(k, used, npu, q, lane);
          if (lane == 0) s_ok = ok;
        }
        __syncthreads();
        if (!s_ok) continue;
      }
    }
    KOORD_SPLIT(1);
    // 3. the commit: a thread a field of row j, each staged after its
    // update, the capacities' reciprocals beside them; the request up the
    // quota chain; a matched reservation on j nominated and consumed
    if (t == 0) {
      hosts[q] = j;
      scores[q] = pow2 ? (win - low) >> (__ffsll(TB) - 1) : (win - low) / TB;
    }
    if (t < F) {
      const int f = t;
      if (f < R) {
        s_rcp[f] = koord_rcp(val);
      } else if (f < 2 * R) {
        val += p.est[(size_t)q * R + f - R];
        n.base_nonprod[(size_t)j * R + f - R] = val;
      } else if (f < 3 * R) {
        if (p.prod_class[q]) {
          val += p.est[(size_t)q * R + f - 2 * R];
          n.base_prod[(size_t)j * R + f - 2 * R] = val;
        }
      } else if (f < 3 * R + Rf) {
      } else if (f < 3 * R + 2 * Rf) {
        const int r = f - 3 * R - Rf;
        val += p.req[(size_t)q * Rf + r];
        n.requested[(size_t)j * Rf + r] = val;
      } else if (f < 3 * R + 2 * Rf + Rs) {
        s_rcp[KOORD_MAXR + f - 3 * R - 2 * Rf] = koord_rcp(val);
      } else if (f < W - 2) {
        const int r = f - 3 * R - 2 * Rf - Rs;
        val += p.req_score[(size_t)q * Rs + r];
        n.nreq_score[(size_t)j * Rs + r] = val;
      } else if (f == W - 2) {
        n.num_pods[j] = ++val;
      }
      if (f < F - 4) {
        s_row[f] = val;
      } else {
        s_flag[f - (F - 4)] = (uint8_t)val;
      }
    }
    if constexpr (CON) {
      if (k.has_quota && warp == kQuotaWarp && lane < k.Rq) {
        // _quota_consume: the request up the group chain (root excluded)
        const long long e =
            k.q_present[(size_t)q * k.Rq + lane] ? k.q_req[(size_t)q * k.Rq + lane] : 0;
        int grp = k.q_row[q];
        for (int d = 0; d < k.ad; ++d, grp = k.q_parent[grp]) {
          if (grp == 0) continue;
          const size_t o = (size_t)grp * k.Rq + lane;
          used[o] += e;
          if (k.q_np[q]) npu[o] += e;
        }
      }
      if (k.has_rsv && t == kRsvThread) {
        // nominate_on_node: among the pod's matched reservations on node j,
        // the smallest positive order rank, else the first largest rscore;
        // consume min(request, remainder), floored at 0
        const int* mi = k.midx + (size_t)q * k.Mm;
        const long long* rs = k.rscore + (size_t)k.xs[q] * k.Rv;
        int nom = -1, best_v = -1;
        long long min_rank = (long long)k.Rv + 1, best = -1;
        for (int m = 0; m < k.Mm && mi[m] >= 0; ++m) {
          const int v2 = mi[m];
          if (k.r_node[v2] != j) continue;
          const long long rk = k.r_rank[v2];
          if (rk > 0 && rk < min_rank) {
            min_rank = rk;
            nom = v2;
          }
          if (rs[v2] > best) {
            best = rs[v2];
            best_v = v2;
          }
        }
        if (nom < 0) nom = best_v;
        if (nom >= 0)
          for (int r = 0; r < Rf; ++r) {
            long long* a = &k.r_allocated[(size_t)nom * Rf + r];
            const long long remain = k.r_alloc[(size_t)nom * Rf + r] - *a;
            *a += max(min(p.req[(size_t)q * Rf + r], remain), 0LL);
          }
      }
    }
    __syncthreads();
    KOORD_SPLIT(2);
    // 4. row j rescored for the pods still to come (key_of's arithmetic on
    // the staged row, its extras loaded above); their block maxima kept in
    // both layouts
    auto rescore = [&](int qq, long long old, long long top, bool xf, long long xadd) {
      // a key that was infeasible stays so: a placement frees no resources
      if (old == kNeg) return;
      const bool pre = vj && xf && la_fit(c, p, ns, qq, 0);
      long long key;
      if constexpr (CON)
        key = pair_key_con<long long, false, true>(c, p, ns, k, qq, j, pre, salt[qq], N, TB,
                                                   xadd, 0);
      else
        key = pair_key<long long, true>(c, p, ns, qq, j, pre, salt[qq], N, TB, xadd, 0);
      if (key == old) return;
      M[(size_t)j * P + qq] = key;
      long long m = top;
      if (key >= top) {
        m = key;
      } else if (old == top) {
        m = key;
        for (int i = 0; i < BS; ++i) m = max(m, M[(size_t)(b * BS + i) * P + qq]);
      }
      if (m != top) {
        Mb[(size_t)b * P + qq] = m;
        MbT[(size_t)qq * NB + b] = m;
      }
    };
    if (P <= T) {
      if (mine) rescore(mq, m_old, m_top, m_xf, m_xadd);
    } else {
      for (int qq = t; qq < P; qq += T)
        if (qq > q && pod_pass<CON>(pod_ok, k, qq))
          rescore(qq, M[(size_t)j * P + qq], Mb[(size_t)b * P + qq], x_feas(x, qq, j, P),
                  x_score(x, qq, j, P));
    }
    __syncthreads();
    // the next pod's maximum of block b may have moved after its load
    if (ahead && t == b && q + 1 < P) next = MbT[(size_t)(q + 1) * NB + b];
    KOORD_SPLIT(3);
  }
#undef KOORD_SPLIT
#ifdef KOORD_SCAN_STUDY
  if (t == 0)
    for (int i = 0; i < kSplitPhases; ++i) g_scan_split[i] = split[i];
#endif
  if constexpr (CON) {
    // commit_gangs: a gang group whose gangs did not all reach minMember
    // (placed + bound children, or once satisfied) loses every placement,
    // unless the gang is non-strict
    long long* placed = k.scratch;
    long long* unsat = k.scratch + k.G;
    for (int g = t; g < 2 * k.G; g += T) placed[g] = 0;
    __syncthreads();
    for (int q = t; q < P; q += T)
      if (hosts[q] >= 0) atomicAdd((unsigned long long*)&placed[k.gang_row[q]], 1ULL);
    __syncthreads();
    for (int g = t; g < k.G; g += T)
      if (!(placed[g] + k.g_bound[g] >= k.g_min[g] || k.g_once[g]))
        atomicAdd((unsigned long long*)&unsat[k.g_group[g]], 1ULL);
    __syncthreads();
    for (int q = t; q < P; q += T) {
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

int launch_steps(bool con, const void* const* pods, const void* const* nodes,
                 const long long* cfg, const void* la_w, ConIn k, const void* xfeas,
                 const void* xsc, const void* valid, const void* pod_ok, const void* salt, int P,
                 int N, int BS, long long TB, void* M, void* Mb, void* MbT, void* hosts,
                 void* scores, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Cfg c = koord_cfg(cfg, la_w);
  const size_t smem = con && k.has_quota && 2 * k.Q * k.Rq <= kQuotaSmemWords
                          ? (size_t)2 * k.Q * k.Rq * sizeof(long long)
                          : 0;
  XIn x{(const uint8_t*)xfeas, (const long long*)xsc};
  auto kernel = con ? scan_steps<true> : scan_steps<false>;
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      c, koord_pods(pods), koord_nodes(nodes), k, x, (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, (long long*)M, (long long*)Mb,
      (long long*)MbT, (int*)hosts, (long long*)scores);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef KOORD_SCAN_STUDY
// The phase split of the last step launch on this device ([4] int64 SM
// cycles, scan_steps) into `out`, then zeroed for the next.
extern "C" int koord_scan_split(void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbolAsync(out, g_scan_split, sizeof(g_scan_split), 0,
                                cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  void* addr = nullptr;
  e = cudaGetSymbolAddress(&addr, g_scan_split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemsetAsync(addr, 0, sizeof(g_scan_split), (cudaStream_t)stream);
}

// div_check over `count` operand pairs (int64 n, d; out [count, 3] int64)
extern "C" int koord_div_check(const void* n, const void* d, void* out, int count, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  div_check<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)n, (const long long*)d, (long long*)out, count);
  return (int)cudaGetLastError();
}
#endif

// The step kernel after the key build (koord_sched_keys64[_con] with a null
// la_feas_T): the same pair inputs, P, N, BS, TB, [the constraint table and
// block,] M [N_pad, P], Mb [NB, P] and its transpose MbT [P, NB] int64
// (updated in place), hosts [P] int32 and scores [P] int64 in queue order
// (written).
extern "C" int koord_scan_steps(const void* const* pods, const void* const* nodes,
                                const long long* cfg, const void* la_w, const void* valid,
                                const void* pod_ok, const void* salt, const void* xfeas,
                                const void* xsc, int P, int N, int BS, long long TB, void* M,
                                void* Mb, void* MbT, void* hosts, void* scores, int device,
                                void* stream) {
  return launch_steps(false, pods, nodes, cfg, la_w, no_con(), xfeas, xsc, valid, pod_ok, salt, P,
                      N, BS, TB, M, Mb, MbT, hosts, scores, device, stream);
}

extern "C" int koord_scan_steps_con(const void* const* pods, const void* const* nodes,
                                    const long long* cfg, const void* la_w, const void* valid,
                                    const void* pod_ok, const void* salt, const void* xfeas,
                                    const void* xsc, int P, int N, int BS, long long TB,
                                    const void* const* con, const long long* con_ints, void* M,
                                    void* Mb, void* MbT, void* hosts, void* scores, int device,
                                    void* stream) {
  return launch_steps(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), xfeas, xsc, valid,
                      pod_ok, salt, P, N, BS, TB, M, Mb, MbT, hosts, scores, device, stream);
}
