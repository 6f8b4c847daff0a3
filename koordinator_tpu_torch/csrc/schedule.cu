// SCHEDULE: the conflict-resolved cycle (cold key build and round loop) and
// the warm carry's delta refresh, for plain pods and under gang, quota and
// reservation constraints.
//
// Replaces: the JAX package's `schedule` kernel, service/engine.py:155
// schedule_fn -> core/resolved.py:204 schedule_batch_resolved, engine
// matrix_packed (run_matrix_packed:757 with pack_keys:698, commit_core:494,
// quota_certainty:434, touched_scores:585, refresh_blocks:782, round_body:788
// and commit_gangs after the rounds, :900-913), and the warm `sched_refresh`
// (engine.py:208) and `sched_rounds` (engine.py:238).
//
// The batch's placement-and-devices inputs (node selectors, taints,
// anti-affinity, device and cpuset feasibility as a mask; the deviceshare
// and amplified-CPU scores as a frozen addend, core/resolved.py
// ExtraInputs) enter every key the same way in all three: the mask joins
// the pair's feasibility and the score its total (key_of), so a rescored
// or refreshed key still equals a cold-built one.  Absent extras are null
// pointers and change nothing.
//
// Every kernel is a template over CON.  CON = false is the plain-pod
// instantiation; CON = true adds the constraint branches, so the plain
// path's code stays as it was and the constrained one compiles on its own.
//
// The cold key build and the round loop are templates over the key lane
// too (KeyLane in pair.cuh): int32 keys for the matrix_packed engine, and
// int64 keys for the JAX package's `matrix` engine (run_matrix,
// core/resolved.py:839), which the resolved engine takes when the packed
// key's bound does not fit int32 (fits_i32, :331-335).  The int64 lane holds
// the same composite key, score * TB + (TB-1 - rot), with the sentinel
// NEG = -(1 << 40); a max over it picks what run_matrix's composite-key
// argmax over the [P, N] masked totals picks (the score, then the rotated
// index, lowest index first under the "index" tie-break, whose salts are
// 0), so the rounds, commits and round count are run_matrix's.  The keys
// are decoded with floor division: an extra score may make a total
// negative.  The warm kernels stay int32 only.
//
// 1. build_keys: the cold init, under any NodeFit strategy (the scan's
//    route builds its int64 keys with it too, csrc/scan.cu).  One thread per
//    (pod, BS-row node block) evaluates the shared pair function (pair.cuh)
//    down its block and writes the packed keys M [N_pad, P] (score * TB +
//    rotated tie bits, the sentinel in pad rows), the block maxima Mb
//    [N_pad/BS, P] and, for the round loop, the LoadAware filter la_feas_T
//    [N, P].  Under CON the gang prefilter joins the pod mask and the pair
//    function adds the reservation restore and score (pair_key_con).  Bound
//    on an H100: bytes (5 bytes written per pair, ~84 MB at 16,384 x 1,024);
//    it runs at ~20x that, held by the pair function's 64-bit arithmetic.
//    Its divisions by each node's capacity and by the weight sums were a
//    subroutine each (the card has no 64-bit divide), about half the row
//    loop's instructions: a block stages its BS node rows in shared memory
//    beside their capacities' exact reciprocals, and the pair function
//    divides by multiplication (pair.cuh, RCP), the weight sums in 32 bits;
//    each thread writes coalesced rows and computes its block maximum in
//    registers.
//
// 2. rounds: the whole round loop in ONE cooperative launch, as the TPU runs
//    it inside one lax.while_loop (resolved.py:835): no host sync per round.
//    Each round: per-pod max over Mb and decode of the pick from the key's
//    low bits; first-picker scatter-min into node_first; prefix cut by a
//    block min and a block scan capped at K commits; the <= K node-row
//    updates of commit_core; rescoring of the K touched rows with the same
//    pair function; re-reduction of their blocks; exit when every pod is
//    committed.  Under CON, before the cut: quota_certainty — the admission
//    verdict under the committed quota aggregates (lower bound); the
//    candidates' totals; the `safe` check (every group keeps headroom for
//    one more maximal request after every candidate consumed, so the bounds
//    agree); only when not safe, the exclusive prefix of earlier
//    candidates' consumption at each pod's own admission groups, from
//    per-group entry lists built once per launch (one warp per group, a
//    shuffle scan per dimension), and the verdict under it (upper bound).
//    The cut takes the certain admits and rejects; each committed slot adds
//    its request up its group chain and nominates a matched reservation on
//    its node (smallest positive rank, else the first largest
//    scoreReservation) and consumes from it; the rescoring sees the
//    restored remainders.  After the loop, commit_gangs over [P] and [G]
//    in block 0: `precommit` keeps the hosts before it.
//    What bounds it on an H100: the rounds are sequential (173 at 1,024 x
//    16,384), so latency; a round's work is small (Mb's 4 MB swept, 16 x
//    1,024 pairs rescored, 1 MB re-reduced).  In one block of 1,024
//    threads, as it ran before, a round took 84.5 us on one SM while 131
//    idled, and the split measured then (PERF.md) put a third in the three
//    wide phases and the rest in the serial middle.  The design: one block
//    an SM at most (cuda.rounds_grid derives G from P, the block count NB
//    and K, so a one-pod probe takes a few), each block owning a range of
//    pods; the wide phases run on every block over its own pods' columns
//    (so M and Mb need no cross-block traffic), the serial middle on block
//    0, which publishes the round's touched rows as records after their
//    update, one per distinct row (padding slots share one record of row
//    N-1, so K no longer costs rescoring); one arrival count and one
//    release word a round instead of grid-wide barriers; cross-block state
//    read through L2 (ld.global.cg), because a plain load may hit a stale
//    line of the reading SM's L1; the records staged in shared memory for
//    the rescoring; the serial middle's contended minima reduced in each
//    warp first and its cut found from one scan.  What is left a round
//    (PERF.md): the serial middle, two hops between SMs, one pair
//    evaluation's int64 divisions and the sweep, each a few microseconds.
//    rounds_kernel below gives the phases and the protocol.
//
// 3. refresh_kernel: the warm carry's delta refresh, one launch a call.
//    The host plans the dirty node rows (a power-of-two index padded by
//    repeating a real row) into their distinct node blocks, each with a
//    mask of its dirty rows (refreshplan.cuh), and the plan rides in the
//    launch's parameters (a plan past 7,168 words, at 57,344 node columns
//    or more, in a device copy).  A block of the launch takes one plan
//    entry and 128 pods: it issues the loads of the block's clean rows of
//    M, evaluates the real LoadAware filter into la_feas_T[j] and the
//    packed key into M[j] of each dirty row j through the same pair
//    function while they are in flight (under CON with the batch-start
//    reservation allocations: quota never enters the carry), so a
//    refreshed key equals a cold-built one bit for bit, and writes the
//    block maximum from registers.  In place.  Each dirty row is evaluated
//    once and each block maximum written once, however many padding
//    duplicates or dirty rows a block holds.  Bound on an H100: bytes (at
//    D = 128 and 1,024 pods ~1.2 MB); at that size the launch's own
//    latency dominates.
//
// The warm rounds (`sched_rounds`) are the rounds kernel launched on copies
// of the carry's M and Mb (core/resolved.py schedule_rounds_warm).
//
// commit_cap (K) and block_size (BS) do not change results.  Padding slots
// of a round (fewer than K commits) clamp to column N-1 and rewrite it with
// keys recomputed from the updated state, exactly as the reference does;
// the rewrite reproduces the value already there, because every row of M
// is at all times the pure function of its node's current state.
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "pair.cuh"
#include "refreshplan.cuh"

namespace {

constexpr uint8_t kPending = 1;
constexpr uint8_t kPlaced = 2;
constexpr uint8_t kAdmit = 4;    // quota: certainly admitted
constexpr uint8_t kReject = 8;   // quota: certainly rejected
constexpr uint8_t kCand = 16;    // quota: a candidate of the upper bound
constexpr long long kMinLL = (long long)(-0x7fffffffffffffffLL - 1);

// A block's node rows staged in shared memory for the key build, beside
// their capacities' reciprocals (koord_rcp): the pair function reads them
// through a NodeIn whose row r is node j0 + r.  Every block computes its
// rows' reciprocals once for its 128 pods.
__host__ __device__ inline size_t stage_bytes(int rows, int R, int Rf, int Rs) {
  return (size_t)rows * (8 * (4 * R + 2 * Rf + 3 * Rs + 2) + 1);
}

__device__ NodeIn stage_rows(const Cfg& c, const NodeIn& n, int j0, int rows,
                             unsigned char* smem) {
  const int R = c.R, Rf = c.Rf, Rs = c.Rs, T = blockDim.x, t = threadIdx.x;
  long long* w = (long long*)smem;
  NodeIn s = n;
  auto take = [&](const long long* src, int width) {
    long long* dst = w;
    for (int i = t; i < rows * width; i += T) dst[i] = src[(size_t)j0 * width + i];
    w += (size_t)rows * width;
    return dst;
  };
  auto recip = [&](const long long* src, int width) {
    unsigned long long* dst = (unsigned long long*)w;
    for (int i = t; i < rows * width; i += T) dst[i] = koord_rcp(src[(size_t)j0 * width + i]);
    w += (size_t)rows * width;
    return (const unsigned long long*)dst;
  };
  s.la_alloc = take(n.la_alloc, R);
  s.base_nonprod = take(n.base_nonprod, R);
  s.base_prod = take(n.base_prod, R);
  s.nf_alloc = take(n.nf_alloc, Rf);
  s.requested = take(n.requested, Rf);
  s.alloc_score = take(n.alloc_score, Rs);
  s.nreq_score = take(n.nreq_score, Rs);
  s.num_pods = take(n.num_pods, 1);
  s.allowed = take(n.allowed, 1);
  s.la_rcp = recip(n.la_alloc, R);
  s.as_rcp = recip(n.alloc_score, Rs);
  uint8_t* sv = (uint8_t*)w;
  for (int i = t; i < rows; i += T) sv[i] = n.score_valid[j0 + i];
  s.score_valid = sv;
  __syncthreads();
  return s;
}

// One thread per (pod, BS-row node block): blockIdx.y is the node block,
// staged once (stage_rows), blockIdx.x a range of 128 pods.  The LoadAware
// filter reads the node's global row (its fields are not staged); it is
// written to la_feas_T when the caller wants it (the round loop does, the
// scan does not: null).
template <bool CON, typename KT>
__global__ void build_keys(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                           const uint8_t* pod_ok, const int* salt, int P, int N, int BS,
                           long long TB, KT* M, KT* Mb, uint8_t* la_feas_T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, j0 = b * BS, rows = min(BS, N - j0);
  const NodeIn ns = stage_rows(c, n, j0, rows, smem);
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  const bool ok = pod_pass<CON>(pod_ok, k, q);
  KT best = KeyLane<KT>::neg;
  for (int i = 0; i < BS; ++i) {
    const int j = j0 + i;
    KT key = KeyLane<KT>::neg;
    if (i < rows) {
      const bool laf = la_fit(c, p, n, q, j);
      if (la_feas_T) la_feas_T[(size_t)j * P + q] = laf;
      key = key_of<CON, KT, false, true>(c, p, ns, k, x, P, q, j, laf && valid[j] && ok, salt[q],
                                         N, TB, i);
    }
    M[(size_t)j * P + q] = key;
    best = max(best, key);
  }
  Mb[(size_t)b * P + q] = best;
}

// Inclusive prefix count of `flag` over [0, P), each thread owning one
// contiguous chunk; the per-thread totals are scanned through warp
// shuffles and one shared array of warp sums.
__device__ void block_scan(const uint8_t* flag, int* rank, int P, int* warp_sums) {
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (T + 31) >> 5;
  const int chunk = (P + T - 1) / T;
  const int lo = min(P, t * chunk), hi = min(P, lo + chunk);
  int local = 0;
  for (int q = lo; q < hi; ++q) local += flag[q];
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31 || t == T - 1) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // the warp sums' exclusive scan, in one warp
    const int v = lane < nwarps ? warp_sums[lane] : 0;
    int run = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run += o;
    }
    if (lane < nwarps) warp_sums[lane] = run - v;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - local;
  for (int q = lo; q < hi; ++q) {
    run += flag[q];
    rank[q] = run;
  }
}

template <typename V>
__device__ __forceinline__ V warp_max(V v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// ---------------------------------------------------------------- quota
//
// The round kernel's quota scratch (int64 words, con_scratch_words in
// core/resolved.py): tp [Q, 2R] candidate totals | exc [P, cpd+1, 2R]
// exclusive prefixes at each pod's admission groups | gang counts [2, G] |
// int32: entry-list offsets [Q+1], entries [P * ad] (q * 32 + depth).

__device__ __forceinline__ long long eff_req(const ConIn& k, int q, int r) {
  return k.q_present[(size_t)q * k.Rq + r] ? k.q_req[(size_t)q * k.Rq + r] : 0;
}

// _admit_batched (resolved.py:184) for one pod: used + request <= limit on
// the present dimensions at its group and, with check_parent_depth, its
// ancestors; a non-preemptible pod also npu + request <= min at its group.
// `exc` (or null) adds the exclusive prefix at admission depth a.  The
// aggregates take atomic adds, so they are read from L2.
__device__ bool quota_admit(const ConIn& k, int q, const long long* exc) {
  const int R2 = 2 * k.Rq;
  int grp = k.q_row[q];
  for (int a = 0; a <= k.cpd; ++a) {
    if (a > 0) {
      grp = k.q_parent[grp];
      if (grp == 0) continue;
    }
    for (int r = 0; r < k.Rq; ++r) {
      if (!k.q_present[(size_t)q * k.Rq + r]) continue;
      const long long req = k.q_req[(size_t)q * k.Rq + r];
      const long long u = __ldcg(&k.q_used[(size_t)grp * k.Rq + r]) + (exc ? exc[a * R2 + r] : 0);
      if (!(u + req <= k.q_limit[(size_t)grp * k.Rq + r])) return false;
      if (a == 0 && k.q_np[q]) {
        const long long v = __ldcg(&k.q_npu[(size_t)grp * k.Rq + r]) + (exc ? exc[k.Rq + r] : 0);
        if (!(v + req <= k.q_min[(size_t)grp * k.Rq + r])) return false;
      }
    }
  }
  return true;
}

// ------------------------------------------------------------ rounds

constexpr int kRoundThreads = 1024;
constexpr int kStage = 16;      // touched rows staged in shared memory at a time
// a staged chunk: the assume-path and capacity fields of kStage node rows
// (7 of width <= KOORD_MAXR, num_pods and allowed as int64), score_valid,
// the columns
constexpr size_t kStageBytes = kStage * (8 * (7 * KOORD_MAXR + 2) + 1 + 1 + 4);
// A round record, kRecWords int64 words, one per distinct touched node
// row: the column, its live flag, score_valid, num_pods, allowed, then
// la_alloc, base_nonprod, base_prod [R], nf_alloc, requested [Rf],
// alloc_score, nreq_score [Rs] (rec_fields of them).
constexpr int kRecWords = 64;

__device__ __forceinline__ int rec_fields(const Cfg& c) {
  return 5 + 3 * c.R + 2 * c.Rf + 2 * c.Rs;
}

// the dynamic shared memory of the round loop's per-round temporaries (the
// serial middle's pod and slot arrays), which every block's sweep overlays
// with its [1,024] partial maxima and its rescoring with a staged chunk,
// for key lanes of `kb` bytes
__host__ __device__ inline size_t round_temp_bytes(int P, int K, int kb) {
  const size_t mid = (size_t)P * (kb + 2 * sizeof(int) + 2) + (size_t)K * 2 * sizeof(int);
  const size_t red = (size_t)kRoundThreads * kb;
  const size_t m = mid > red ? mid : red;
  return m > kStageBytes ? m : kStageBytes;
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// A round's synchronisation over co-resident blocks, on two words zeroed
// before the launch.  Every block arrives after its sweep (thread 0: a
// fence, then one atomicAdd on `arrived`); block 0 waits until all G
// arrivals of the round are in (`arrived` reaches G * round), runs the
// serial middle and releases the round (a fence, then `released` :=
// round); the other blocks wait only for the release.  The fences order
// each block's writes before its arrival or release and its later reads
// after the wait, as a grid barrier's do, at one barrier's cost a round
// instead of two: the other blocks have nothing to do in the serial middle.
// (An arrival flag a block, polled by as many threads of block 0, cost
// more: 3.6 us against 2.8 a round at 128 blocks on the H100.)
// A wait of more than ~10 s of SM cycles is a fault, not a slow round: the
// kernel traps, and the launch's caller sees an error instead of a hang.
constexpr long long kWaitTimeout = 20000000000LL;

__device__ __forceinline__ void arrive(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
  }
}

__device__ __forceinline__ void wait_for(const unsigned int* word, unsigned int target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(word) < target)
      if (clock64() - start > kWaitTimeout) __trap();
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void release(unsigned int* released, unsigned int round) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(released, round);
  }
}

// The pick sweep of one block: each pod of [lo, hi) gets its maximum over
// the NB block maxima, published to vmax through L2.  The block's pods,
// padded to a power of two w, are the fastest axis (coalesced rows of Mb);
// the threads that share a pod split the rows, fold within their warp by
// shuffles and across warps in `red` ([blockDim.x] keys).
template <typename KT>
__device__ void sweep(const KT* Mb, int P, int NB, int lo, int hi, KT* vmax, KT* red) {
  const int cnt = hi - lo, T = blockDim.x, t = threadIdx.x;
  if (cnt <= 0) return;
  if (cnt >= T) {  // a thread a pod, every row
    for (int i = t; i < cnt; i += T) {
      KT m = KeyLane<KT>::neg;
      for (int b = 0; b < NB; ++b) m = max(m, Mb[(size_t)b * P + lo + i]);
      __stcg(&vmax[lo + i], m);
    }
    return;
  }
  int w = 1;
  while (w < cnt) w <<= 1;
  const int i = t & (w - 1), ng = T / w;
  KT m = KeyLane<KT>::neg;
  if (i < cnt) {
#pragma unroll 8
    for (int b = t / w; b < NB; b += ng) m = max(m, Mb[(size_t)b * P + lo + i]);
  }
  for (int d = 16; d >= w; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (w >= 32) {
    red[t] = m;
  } else if ((t & 31) < w) {
    red[(t >> 5) * w + i] = m;
  }
  __syncthreads();
  // a warp a pod, a lane a group (at most 32 of them)
  const int groups = w >= 32 ? ng : T >> 5, lane = t & 31;
  for (int ii = t >> 5; ii < cnt; ii += T >> 5) {
    const KT v = warp_max(lane < groups ? red[lane * w + ii] : KeyLane<KT>::neg);
    if (lane == 0) __stcg(&vmax[lo + ii], v);
  }
}

// The round loop over G co-resident blocks of 1,024 threads (one
// cooperative launch).  Block g owns pods [g * ppb, (g+1) * ppb): their
// columns of M and Mb are written and read by it alone.  A round is
//   A. every block: the pick sweep of its pending pods -> vmax; arrive;
//   B. block 0, once all have arrived: the serial middle, the
//      single-block code of before (the decode, quota_certainty, the
//      node_first scatter-min, the first blocked pod, the prefix scan
//      capped at K, the commit of hosts and scores, the <= K node-row
//      updates, the quota consumption and the reservation nomination),
//      ending with the round's records (each touched row after its
//      update, and row N-1 once for the padding slots that clamp to it)
//      and the new commit frontier published through L2; release;
//   C. every block, once released: the records staged in shared memory
//      (kStage at a time, read through L2), its pods rescored on them and
//      the touched blocks of Mb re-reduced, then straight into the next
//      round's sweep, which reads only its own columns.
// The committed pods are always a prefix of the queue, [0, frontier), so
// the frontier alone tells a block which of its pods are pending, and
// frontier == P is the exit vote, read by every block after the release.
// Cross-block state (vmax, the records, their count, the frontier, the
// reservation allocations) is read through L2: a plain load could hit a
// line of this SM's L1 from before block 0 rewrote it.  The node rows are
// written and read by block 0 alone.
//
// scratch (int64 words, cuda.rounds_scratch_words): vmax [P] keys | the
// round records [K, kRecWords] | int32: the arrival count, the released
// round (both zeroed by launch_rounds), the frontier, the record count,
// node_first [N] (each written before it is read).
#ifdef KOORD_ROUND_STUDY
// The study build (csrc/roundstudy.cu) adds the phase split: SM cycles
// summed over the rounds (clock64, thread 0) of block 0, the middle block
// and the last, in each the phases: the sweep; the wait (for the arrivals
// in block 0, else for the release); block 0's serial middle as its
// decode, its cut and commit, its row updates and release; the rescoring
// as staging, pair evaluations and re-reduction.  koord_round_split reads
// it.
constexpr int kSplitPhases = 8;
constexpr int kSplitWords = 3 * kSplitPhases;
__device__ long long g_round_split[kSplitWords];
#endif
template <bool CON, typename KT>
__global__ void __launch_bounds__(kRoundThreads)
    rounds_kernel(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                  const uint8_t* pod_ok, const int* salt, int P, int N, int BS, long long TB,
                  int K, KT* M, KT* Mb, const uint8_t* la_feas_T, long long* scratch, int* hosts,
                  long long* scores, int* precommit, int* rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tb = round_temp_bytes(P, K, (int)sizeof(KT));
  // block 0's temporaries of one round (the serial middle) ...
  KT* s_vmax = (KT*)smem;  // first: the int64 lane's alignment
  int* s_pick = (int*)(s_vmax + P);
  int* s_rank = s_pick + P;
  int* s_cols = s_rank + P;
  int* s_pslot = s_cols + K;
  uint8_t* s_flag = (uint8_t*)(s_pslot + K);
  uint8_t* s_place = s_flag + P;
  KT* s_red = (KT*)smem;  // ... which the sweep's partials overlay
  // block 0's state across rounds: the committed flags; CON with quota:
  // each pod's chain of group rows
  uint8_t* s_comm = smem + tb;
  int* s_chain = (int*)(smem + ((tb + (size_t)P + 15) & ~(size_t)15));
  __shared__ int s_first_blocked, s_cut, s_last;
  __shared__ int s_warp[32];
  __shared__ long long s_mr[2 * KOORD_MAXR];

  const int T = blockDim.x, t = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (T + 31) >> 5;
  const int NB = (N + BS - 1) / BS;
  const int ppb = (P + G - 1) / G;
  const int lo = min(P, g * ppb), hi = min(P, lo + ppb), own = hi - lo;
  KT* g_vmax = (KT*)scratch;
  long long* g_rec = scratch + P;
  unsigned int* arrived = (unsigned int*)(g_rec + (size_t)K * kRecWords);
  unsigned int* released = arrived + 1;
  int* g_front = (int*)(released + 1);
  int* g_nrec = g_front + 1;
  int* node_first = g_nrec + 1;
  const int R2 = 2 * k.Rq;
  long long* tp = k.scratch;
  long long* exc = tp + (size_t)k.Q * R2;
  long long* g_count = exc + (size_t)P * (k.cpd + 1) * R2;
  int* ent_off = (int*)(g_count + 2 * (size_t)k.G);
  int* ent = ent_off + k.Q + 1;
  for (int j = g * T + t; j < N; j += G * T) node_first[j] = P;
  if (g == 0) {
    for (int q = t; q < P; q += T) {
      s_comm[q] = 0;
      hosts[q] = -1;
      scores[q] = 0;
    }
    if constexpr (CON) {
      if (k.has_quota) {
        // each pod's consumption chain, then per-group entry lists in queue
        // order: thread per group, two passes over the chains
        for (int q = t; q < P; q += T) {
          int gq = k.q_row[q];
          for (int d = 0; d < k.ad; ++d) {
            s_chain[q * k.ad + d] = gq;
            gq = k.q_parent[gq];
          }
        }
        __syncthreads();
        for (int gr = 1 + t; gr < k.Q; gr += T) {
          int cnt = 0;
          for (int e = 0; e < P * k.ad; ++e) cnt += s_chain[e] == gr;
          ent_off[gr + 1] = cnt;
        }
        __syncthreads();
        if (t == 0) {
          ent_off[0] = ent_off[1] = 0;
          for (int gr = 1; gr < k.Q; ++gr) ent_off[gr + 1] += ent_off[gr];
        }
        __syncthreads();
        for (int gr = 1 + t; gr < k.Q; gr += T) {
          int pos = ent_off[gr];
          for (int e = 0; e < P * k.ad; ++e)
            if (s_chain[e] == gr) ent[pos++] = (e / k.ad) * 32 + e % k.ad;
        }
      }
    }
  }
  __syncthreads();

#ifdef KOORD_ROUND_STUDY
  // the split's blocks: 0 (the serial middle), the middle one, the last
  __shared__ long long s_split[kSplitPhases];
  const int split_at = g == 0 ? 0 : g == G - 1 ? 2 : g == G / 2 ? 1 : -1;
  const bool timer = t == 0 && split_at >= 0;
  long long tick = clock64();
  if (timer)
    for (int i = 0; i < kSplitPhases; ++i) s_split[i] = 0;
#define KOORD_SPLIT(i)                   \
  if (timer) {                           \
    const long long now = clock64();     \
    s_split[i] += now - tick;            \
    tick = now;                          \
  }
#else
#define KOORD_SPLIT(i)
#endif

  int rounds = 0, ub_rounds = 0, frontier = 0;
  while (true) {
    // A. the pick sweep of this block's pending pods
    sweep<KT>(Mb, P, NB, max(lo, frontier), hi, g_vmax, s_red);
    KOORD_SPLIT(0);
    arrive(arrived);
    if (g == 0) {
      wait_for(arrived, (unsigned int)G * (rounds + 1));
      KOORD_SPLIT(1);
      // B. the serial middle: decode each pending pod's pick from the low
      // bits of its maximum
      if (t == 0) {
        s_first_blocked = P;
        s_cut = P;
        s_last = 0;
      }
      for (int q = t; q < P; q += T) {
        uint8_t f = 0;
        KT vmax = KeyLane<KT>::neg;
        int pick = 0;
        if (!s_comm[q]) {
          f = kPending;
          vmax = __ldcg(&g_vmax[q]);
          if (vmax > KeyLane<KT>::thresh) {
            f |= kPlaced;
            long long rot = TB - 1 - key_floor_mod(vmax, TB);
            pick = (int)((rot - salt[q] + N) % N);
          }
        }
        if constexpr (CON) f |= kAdmit;  // certain unless the quota says otherwise
        s_flag[q] = f;
        s_vmax[q] = vmax;
        s_pick[q] = pick;
      }
      KOORD_SPLIT(2);
      if constexpr (CON) {
        if (k.has_quota) {
          // quota_certainty: the lower-bound verdict, the candidates'
          // totals and the largest pending requests
          if (t < 2 * KOORD_MAXR) s_mr[t] = kMinLL;
          for (int i = t; i < k.Q * R2; i += T) tp[i] = 0;
          __syncthreads();
          for (int r = 0; r < k.Rq; ++r) {
            long long mr = kMinLL, mn = kMinLL;
            for (int q = t; q < P; q += T) {
              const bool pending = s_flag[q] & kPending;
              const long long e = eff_req(k, q, r);
              mr = max(mr, pending ? e : 0LL);
              mn = max(mn, pending && k.q_np[q] ? e : 0LL);
            }
            mr = warp_max(mr);
            mn = warp_max(mn);
            if (lane == 0) {
              atomicMax(&s_mr[r], mr);
              atomicMax(&s_mr[KOORD_MAXR + r], mn);
            }
          }
          for (int q = t; q < P; q += T) {
            const uint8_t f = s_flag[q];
            const bool pending = f & kPending;
            const bool npm = k.q_np[q];
            if (!pending) continue;
            const bool lo_ok = quota_admit(k, q, nullptr);
            uint8_t fq = f & ~kAdmit;
            if (!lo_ok) fq |= kReject;
            if (lo_ok && (f & kPlaced)) {
              fq |= kCand;
              int grp = k.q_row[q];
              for (int d = 0; d < k.ad; ++d, grp = k.q_parent[grp]) {
                if (grp == 0) continue;
                for (int r = 0; r < k.Rq; ++r) {
                  const long long e = eff_req(k, q, r);
                  atomicAdd((unsigned long long*)&tp[(size_t)grp * R2 + r],
                            (unsigned long long)e);
                  if (npm)
                    atomicAdd((unsigned long long*)&tp[(size_t)grp * R2 + k.Rq + r],
                              (unsigned long long)e);
                }
              }
            }
            if (lo_ok) fq |= 32;  // admitted under the lower bound, before the upper
            s_flag[q] = fq;
          }
          __syncthreads();
          int ok = 1;
          for (int i = k.Rq * 2 + t; i < k.Q * R2 && ok; i += T) {
            const int grp = i / R2, r = i % R2;
            if (r < k.Rq) {
              ok = __ldcg(&k.q_used[(size_t)grp * k.Rq + r]) + __ldcg(&tp[i]) + s_mr[r] <=
                   k.q_limit[(size_t)grp * k.Rq + r];
            } else {
              const int rr = r - k.Rq;
              ok = __ldcg(&k.q_npu[(size_t)grp * k.Rq + rr]) + __ldcg(&tp[i]) +
                       s_mr[KOORD_MAXR + rr] <=
                   k.q_min[(size_t)grp * k.Rq + rr];
            }
          }
          const bool safe = __syncthreads_and(ok);
          if (!safe) {
            // the exclusive prefix of earlier candidates' consumption at
            // each pod's admission groups: one warp per group and
            // dimension, a shuffle scan down the group's entries in queue
            // order
            ++ub_rounds;
            for (size_t i = t; i < (size_t)P * (k.cpd + 1) * R2; i += T) exc[i] = 0;
            __syncthreads();
            for (int job = warp; job < (k.Q - 1) * R2; job += nwarps) {
              const int grp = 1 + job / R2, r = job % R2, rr = r % k.Rq;
              const int elo = ent_off[grp], ehi = ent_off[grp + 1];
              long long run = 0;
              for (int base = elo; base < ehi; base += 32) {
                const int e = base + lane;
                int q = 0, d = k.cpd + 1;
                long long v = 0;
                if (e < ehi) {
                  q = ent[e] >> 5;
                  d = ent[e] & 31;
                  if ((s_flag[q] & kCand) && (r < k.Rq || k.q_np[q])) v = eff_req(k, q, rr);
                }
                long long incl = v;
                for (int sh = 1; sh < 32; sh <<= 1) {
                  const long long o = __shfl_up_sync(0xffffffffu, incl, sh);
                  if (lane >= sh) incl += o;
                }
                if (e < ehi && d <= k.cpd)
                  exc[((size_t)q * (k.cpd + 1) + d) * R2 + r] = run + incl - v;
                run += __shfl_sync(0xffffffffu, incl, 31);
              }
            }
            __syncthreads();
          }
          for (int q = t; q < P; q += T) {
            uint8_t f = s_flag[q];
            if (!(f & kPending)) continue;
            const bool lo_ok = f & 32;
            const bool hi_ok =
                safe ? lo_ok : quota_admit(k, q, exc + (size_t)q * (k.cpd + 1) * R2);
            f &= ~(kAdmit | 32);
            if (hi_ok) f |= kAdmit;
            s_flag[q] = f;
          }
        }
      }
      __syncthreads();
      // first picker of each node among the blockers (commit_core's
      // node_first scatter-min; a certain quota reject blocks nothing), and
      // the pods that may place: pending, placed (and admitted).  Below the
      // first blocked pod these are the places, so their ranks are the
      // places' ranks and the cut needs no second scan.
      for (int q = t; q < P; q += T) {
        const uint8_t f = s_flag[q];
        const bool pp = (f & (kPending | kPlaced)) == (kPending | kPlaced);
        if (pp && !(f & kReject)) atomicMin(&node_first[s_pick[q]], q);
        bool place = pp;
        if constexpr (CON) place &= (f & kAdmit) != 0;
        s_place[q] = place;
      }
      __syncthreads();
      block_scan(s_place, s_rank, P, s_warp);
      __syncthreads();
      int blocked_at = P, over_at = P;
      for (int q = t; q < P; q += T) {
        const uint8_t f = s_flag[q];
        if (s_place[q] && s_rank[q] > K) over_at = min(over_at, q);
        if ((f & (kPending | kPlaced)) != (kPending | kPlaced) || (f & kReject)) continue;
        bool blocked = __ldcg(&node_first[s_pick[q]]) != q;
        if constexpr (CON) blocked |= !(f & kAdmit);
        if (blocked) blocked_at = min(blocked_at, q);
      }
      blocked_at = __reduce_min_sync(0xffffffffu, blocked_at);
      over_at = __reduce_min_sync(0xffffffffu, over_at);
      if (lane == 0 && blocked_at < P) atomicMin(&s_first_blocked, blocked_at);
      if (lane == 0 && over_at < P) atomicMin(&s_cut, over_at);
      __syncthreads();
      // commit the prefix; release node_first for the next round
      const int cut = min(s_first_blocked, s_cut);
      for (int q = t; q < P; q += T) {
        uint8_t f = s_flag[q];
        if ((f & kPending) && q < cut) {
          s_comm[q] = 1;
          if (s_place[q]) {
            hosts[q] = s_pick[q];
            scores[q] = ((long long)s_vmax[q] - key_floor_mod(s_vmax[q], TB)) / TB;
            int slot = s_rank[q] - 1;
            s_cols[slot] = s_pick[q];
            s_pslot[slot] = q;
            if (s_pick[q] == N - 1) s_last = 1;
          }
        }
        if ((f & (kPending | kPlaced)) == (kPending | kPlaced)) node_first[s_pick[q]] = P;
      }
      if (t == 0) __stcg(g_front, cut);
      __syncthreads();
      KOORD_SPLIT(3);
      // the assume path: committed placements sit on distinct nodes.  The
      // round's records: the committed slots' rows after their update
      // and, when padding slots remain and no committed slot holds column
      // N-1, the unchanged row N-1 they clamp to (rescoring it once
      // rewrites what rescoring it for each padding slot would); one thread
      // a (record, field), so the rows' read-modify-writes overlap
      const int placed = cut > 0 ? s_rank[cut - 1] : 0;
      const int nrec = placed + (placed < K && !s_last ? 1 : 0);
      const int F = rec_fields(c);
      for (int i = t; i < nrec * F; i += T) {
        const int r = i / F, f = i - r * F;
        const bool ok = r < placed;
        const int j = ok ? s_cols[r] : N - 1, q = ok ? s_pslot[r] : 0;
        long long* rec = g_rec + (size_t)r * kRecWords;
        long long v;
        if (f == 0) {
          v = j;
        } else if (f == 1) {
          v = valid[j];
        } else if (f == 2) {
          v = n.score_valid[j];
        } else if (f == 3) {
          v = __ldcg(&n.num_pods[j]) + ok;
          if (ok) n.num_pods[j] = v;
        } else if (f == 4) {
          v = n.allowed[j];
        } else if (f < 5 + c.R) {
          v = n.la_alloc[(size_t)j * c.R + f - 5];
        } else if (f < 5 + 2 * c.R) {
          const int o = j * c.R + f - 5 - c.R;
          v = __ldcg(&n.base_nonprod[o]);
          if (ok) n.base_nonprod[o] = v += p.est[(size_t)q * c.R + f - 5 - c.R];
        } else if (f < 5 + 3 * c.R) {
          const int rr = f - 5 - 2 * c.R, o = j * c.R + rr;
          v = __ldcg(&n.base_prod[o]);
          if (ok && p.prod_class[q]) n.base_prod[o] = v += p.est[(size_t)q * c.R + rr];
        } else if (f < 5 + 3 * c.R + c.Rf) {
          v = n.nf_alloc[(size_t)j * c.Rf + f - 5 - 3 * c.R];
        } else if (f < 5 + 3 * c.R + 2 * c.Rf) {
          const int rr = f - 5 - 3 * c.R - c.Rf, o = j * c.Rf + rr;
          v = __ldcg(&n.requested[o]);
          if (ok) n.requested[o] = v += p.req[(size_t)q * c.Rf + rr];
        } else if (f < F - c.Rs) {
          v = n.alloc_score[(size_t)j * c.Rs + f - 5 - 3 * c.R - 2 * c.Rf];
        } else {
          const int rr = f - (F - c.Rs), o = j * c.Rs + rr;
          v = __ldcg(&n.nreq_score[o]);
          if (ok) n.nreq_score[o] = v += p.req_score[(size_t)q * c.Rs + rr];
        }
        __stcg(&rec[f], v);
      }
      if (t == 0) __stcg(g_nrec, nrec);
      for (int k2 = t; k2 < placed; k2 += T) {
        const int j = s_cols[k2], q = s_pslot[k2];
        if constexpr (CON) {
          if (k.has_quota) {
            // the pod's request up its group chain (root excluded)
            int grp = k.q_row[q];
            for (int d = 0; d < k.ad; ++d, grp = k.q_parent[grp]) {
              if (grp == 0) continue;
              for (int r = 0; r < k.Rq; ++r) {
                const long long e = eff_req(k, q, r);
                atomicAdd((unsigned long long*)&k.q_used[(size_t)grp * k.Rq + r],
                          (unsigned long long)e);
                if (k.q_np[q])
                  atomicAdd((unsigned long long*)&k.q_npu[(size_t)grp * k.Rq + r],
                            (unsigned long long)e);
              }
            }
          }
          if (k.has_rsv) {
            // nominate among the pod's matched reservations on node j: the
            // smallest positive rank, else the first largest rscore;
            // nominated rows are distinct because committed nodes are
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
      release(released, rounds + 1);
      KOORD_SPLIT(4);
    } else {
      wait_for(released, rounds + 1);
      KOORD_SPLIT(1);
    }
    frontier = __ldcg(g_front);
    // C. rescore this block's pods on the round's records (the touched
    // rows after their update), kStage records at a time staged in shared
    // memory, then re-reduce their blocks of Mb; records on one block of Mb
    // write the same maximum, a later chunk's after an earlier one's
    const int nrec = __ldcg(g_nrec);
    const int F = rec_fields(c);
    for (int base = 0; own > 0; base += kStage) {
      // the chunk's records are staged before the count is known (its
      // load and theirs in flight together); those past it go unread
      const int ns = min(kStage, K - base);
      long long* st_la = (long long*)smem;
      long long* st_bnp = st_la + kStage * c.R;
      long long* st_bp = st_bnp + kStage * c.R;
      long long* st_nfa = st_bp + kStage * c.R;
      long long* st_req = st_nfa + kStage * c.Rf;
      long long* st_as = st_req + kStage * c.Rf;
      long long* st_nrs = st_as + kStage * c.Rs;
      long long* st_np = st_nrs + kStage * c.Rs;
      long long* st_allow = st_np + kStage;
      uint8_t* st_sv = (uint8_t*)(st_allow + kStage);
      uint8_t* st_valid = st_sv + kStage;
      int* st_j = (int*)(st_valid + kStage);
      const long long* rec0 = g_rec + (size_t)base * kRecWords;
      for (int i = t; i < ns * F; i += T) {
        const int r = i / F, f = i - r * F;
        const long long v = __ldcg(&rec0[(size_t)r * kRecWords + f]);
        if (f == 0) {
          st_j[r] = (int)v;
        } else if (f == 1) {
          st_valid[r] = (uint8_t)v;
        } else if (f == 2) {
          st_sv[r] = (uint8_t)v;
        } else if (f == 3) {
          st_np[r] = v;
        } else if (f == 4) {
          st_allow[r] = v;
        } else if (f < 5 + c.R) {
          st_la[r * c.R + f - 5] = v;
        } else if (f < 5 + 2 * c.R) {
          st_bnp[r * c.R + f - 5 - c.R] = v;
        } else if (f < 5 + 3 * c.R) {
          st_bp[r * c.R + f - 5 - 2 * c.R] = v;
        } else if (f < 5 + 3 * c.R + c.Rf) {
          st_nfa[r * c.Rf + f - 5 - 3 * c.R] = v;
        } else if (f < 5 + 3 * c.R + 2 * c.Rf) {
          st_req[r * c.Rf + f - 5 - 3 * c.R - c.Rf] = v;
        } else if (f < F - c.Rs) {
          st_as[r * c.Rs + f - 5 - 3 * c.R - 2 * c.Rf] = v;
        } else {
          st_nrs[r * c.Rs + f - (F - c.Rs)] = v;
        }
      }
      __syncthreads();
      KOORD_SPLIT(5);
      const int nk = min(kStage, nrec - base);
      NodeIn nst = n;
      nst.la_alloc = st_la;
      nst.base_nonprod = st_bnp;
      nst.base_prod = st_bp;
      nst.score_valid = st_sv;
      nst.nf_alloc = st_nfa;
      nst.requested = st_req;
      nst.num_pods = st_np;
      nst.allowed = st_allow;
      nst.alloc_score = st_as;
      nst.nreq_score = st_nrs;
      for (int i = t; i < nk * own; i += T) {
        const int r = i / own, q = lo + (i - r * own), j = st_j[r];
        const bool pre = la_feas_T[(size_t)j * P + q] && st_valid[r] && pod_pass<CON>(pod_ok, k, q);
        M[(size_t)j * P + q] =
            key_of<CON, KT, true>(c, p, nst, k, x, P, q, j, pre, salt[q], N, TB, r);
      }
      __syncthreads();
      KOORD_SPLIT(6);
      for (int i = t; i < nk * own; i += T) {
        const int r = i / own, q = lo + (i - r * own), b = st_j[r] / BS;
        KT mx = KeyLane<KT>::neg;
        for (int rr = 0; rr < BS; ++rr) mx = max(mx, M[(size_t)(b * BS + rr) * P + q]);
        Mb[(size_t)b * P + q] = mx;
      }
      __syncthreads();
      if (base + kStage >= nrec) break;
    }
    KOORD_SPLIT(7);
    ++rounds;
    if (frontier >= P) break;
  }
#undef KOORD_SPLIT
#ifdef KOORD_ROUND_STUDY
  if (timer)
    for (int i = 0; i < kSplitPhases; ++i) g_round_split[split_at * kSplitPhases + i] = s_split[i];
#endif
  if (g != 0) return;
  if constexpr (CON) {
    // commit_gangs: a gang group whose gangs did not all reach minMember
    // (placed + bound children, or once satisfied) loses every placement,
    // unless the gang is non-strict
    long long* placed = g_count;
    long long* unsat = g_count + k.G;
    for (int gr = t; gr < 2 * k.G; gr += T) g_count[gr] = 0;
    for (int q = t; q < P; q += T) precommit[q] = hosts[q];
    __syncthreads();
    for (int q = t; q < P; q += T)
      if (hosts[q] >= 0) atomicAdd((unsigned long long*)&placed[k.gang_row[q]], 1ULL);
    __syncthreads();
    for (int gr = t; gr < k.G; gr += T)
      if (!(placed[gr] + k.g_bound[gr] >= k.g_min[gr] || k.g_once[gr]))
        atomicAdd((unsigned long long*)&unsat[k.g_group[gr]], 1ULL);
    __syncthreads();
    for (int q = t; q < P; q += T) {
      const int gq = k.gang_row[q];
      if (gq != 0 && unsat[k.g_group[gq]] != 0 && !k.g_nonstrict[gq]) {
        hosts[q] = -1;
        scores[q] = 0;
      }
    }
    if (t == 0) rounds_out[1] = ub_rounds;
  }
  if (t == 0) rounds_out[0] = rounds;
}

#ifdef KOORD_ROUND_STUDY
// the study build's round synchronisation alone, `iters` times: its cost.
// `sync` holds the two zeroed words.
__global__ void __launch_bounds__(kRoundThreads) sync_loop(unsigned int* sync, int iters) {
  for (int r = 1; r <= iters; ++r) {
    arrive(sync);
    if (blockIdx.x == 0) {
      wait_for(sync, gridDim.x * r);
      release(sync + 1, r);
    } else {
      wait_for(sync + 1, r);
    }
  }
}
#endif

// One block a (plan entry, 128 pods), the plan's words in the launch's
// parameters or, past them, in a device copy (`words`).  A node block's
// rows go in chunks of 16: each thread issues the loads of its pod's keys
// of the chunk's clean rows first, evaluates its pod on the chunk's dirty
// rows (the entry's mask) through the pair function while those loads are
// in flight, writes the dirty rows' keys and LoadAware filter, and only
// then folds the clean keys into the block maximum, which it writes from
// registers.  The node rows are read where they lie: staging the block's
// rows with their reciprocals, as the cold build does, measured slower here
// (a block evaluates about one row a pod at D = 128; PERF.md §6).
template <int CAP>
struct RefreshPlan {
  int entries;  // the plan's entries
  int stride;   // words an entry: kHead + mask_words(BS)
  unsigned int w[CAP];
};

constexpr int kRefreshChunk = 16;  // rows a thread has in flight: one mask half-word

template <bool CON, int CAP>
__global__ void refresh_kernel(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                               const uint8_t* pod_ok, const int* salt, int P, int N, int BS,
                               long long TB, const __grid_constant__ RefreshPlan<CAP> plan,
                               const unsigned int* words, int* M, int* Mb, uint8_t* la_feas_T) {
  const unsigned int* e = (words ? words : plan.w) + (size_t)blockIdx.x * plan.stride;
  const int b = (int)e[0], j0 = b * BS;
  const unsigned int* mask = e + koord_refresh::kHead;
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= P) return;
  const bool ok = pod_pass<CON>(pod_ok, k, q);
  int best = KOORD_NEGK;
  for (int c0 = 0; c0 < BS; c0 += kRefreshChunk) {
    const int rows = min(kRefreshChunk, BS - c0);
    const unsigned int dirty = (mask[c0 >> 5] >> (c0 & 31)) & ((1u << rows) - 1u);
    int clean[kRefreshChunk];
#pragma unroll
    for (int i = 0; i < kRefreshChunk; ++i)
      clean[i] = i < rows && !((dirty >> i) & 1u) ? M[(size_t)(j0 + c0 + i) * P + q] : KOORD_NEGK;
    for (unsigned int bits = dirty; bits; bits &= bits - 1u) {
      const int j = j0 + c0 + __ffs(bits) - 1;
      const bool laf = la_fit(c, p, n, q, j);
      la_feas_T[(size_t)j * P + q] = laf;
      const int key =
          key_of<CON, int>(c, p, n, k, x, P, q, j, laf && valid[j] && ok, salt[q], N, TB);
      M[(size_t)j * P + q] = key;
      best = max(best, key);
    }
#pragma unroll
    for (int i = 0; i < kRefreshChunk; ++i) best = max(best, clean[i]);
  }
  Mb[(size_t)b * P + q] = best;
}

// the round loop's dynamic shared memory for key lanes of `kb` bytes: the
// temporaries, then the committed flags
size_t rounds_smem(int P, int K, int kb) { return round_temp_bytes(P, K, kb) + (size_t)P; }

// the constrained instantiation adds, with quota, each pod's chain of `ad`
// group rows (16-byte aligned)
size_t rounds_smem_con(int P, int K, int kb, int ad, int has_quota) {
  const size_t base = (round_temp_bytes(P, K, kb) + (size_t)P + 15) & ~(size_t)15;
  return base + (has_quota ? (size_t)P * ad * sizeof(int) : 0);
}

template <typename KT>
int launch_keys(bool con, const void* const* pods, const void* const* nodes, const long long* cfg,
                const void* la_w, const ConIn& k, const XIn& x, const void* valid,
                const void* pod_ok, const void* salt, int P, int N, int BS, long long TB,
                void* M, void* Mb, void* la_feas_T, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, (N + BS - 1) / BS);
  auto kernel = con ? build_keys<true, KT> : build_keys<false, KT>;
  const Cfg c = koord_cfg(cfg, la_w);
  const size_t smem = stage_bytes(BS, c.R, c.Rf, c.Rs);
  if (smem > 48 * 1024) {  // a block size past the default limit
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      c, koord_pods(pods), koord_nodes(nodes), k, x, (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, (KT*)M, (KT*)Mb,
      (uint8_t*)la_feas_T);
  return (int)cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// What a round launch asks of the card once per device, then keeps: its
// SM count (-1: no cooperative launch), and each instantiation's largest
// dynamic shared memory set so far (it only grows, so a launch never sees
// a limit below its own).
cudaError_t prepare_rounds(const void* kernel, int inst, int device, size_t smem, int* sms) {
  static std::mutex mu;
  static int dev_sms[kMaxDevices] = {};
  static size_t dev_smem[kMaxDevices][4] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (dev_sms[device] == 0) {
    int coop = 0, n = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    dev_sms[device] = coop ? n : -1;
  }
  if (dev_sms[device] < 0) return cudaErrorNotSupported;
  *sms = dev_sms[device];
  if (dev_smem[device][inst] < smem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dev_smem[device][inst] = smem;
  }
  return cudaSuccess;
}

// One cooperative launch of G blocks (cuda.rounds_grid), which must all be
// co-resident: one a SM at most, as the barrier wants few arrivals (the
// launch itself refuses a grid that cannot be co-resident).  The round's
// two synchronisation words are zeroed on the stream first.
template <typename KT>
int launch_rounds(bool con, const void* const* pods, const void* const* nodes,
                  const long long* cfg, const void* la_w, ConIn k, const XIn& x,
                  const void* valid, const void* pod_ok, const void* salt, int P, int N, int BS,
                  long long TB, int K, int G, void* M, void* Mb, const void* la_feas_T,
                  void* scratch, void* hosts, void* scores, void* precommit, void* rounds,
                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int kb = (int)sizeof(KT);
  const size_t smem =
      con ? rounds_smem_con(P, K, kb, k.ad, k.has_quota) : rounds_smem(P, K, kb);
  void* kernel = con ? (void*)rounds_kernel<true, KT> : (void*)rounds_kernel<false, KT>;
  int sms = 0;
  e = prepare_rounds(kernel, (con ? 1 : 0) + (kb == 8 ? 2 : 0), device, smem, &sms);
  if (e != cudaSuccess) return (int)e;
  if (G < 1 || G > P || G > sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync((long long*)scratch + P + (size_t)K * kRecWords, 0,
                      2 * sizeof(unsigned int), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  Cfg c = koord_cfg(cfg, la_w);
  PodIn p = koord_pods(pods);
  NodeIn n = koord_nodes(nodes);
  XIn xx = x;
  const uint8_t* v = (const uint8_t*)valid;
  const uint8_t* ok = (const uint8_t*)pod_ok;
  const int* s = (const int*)salt;
  KT* m = (KT*)M;
  KT* mb = (KT*)Mb;
  const uint8_t* lf = (const uint8_t*)la_feas_T;
  long long* sc = (long long*)scratch;
  int* h = (int*)hosts;
  long long* o = (long long*)scores;
  int* pre = (int*)precommit;
  int* r = (int*)rounds;
  void* args[] = {&c, &p, &n, &k, &xx, &v, &ok, &s, &P, &N, &BS, &TB, &K, &m, &mb, &lf, &sc,
                  &h, &o, &pre, &r};
  e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(kRoundThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

constexpr int kRefreshLarge = 7168;  // plan words of the large parameter block (28 KB; a
                                     // launch takes 32,764 B)
// ... of the small one (2 KB), which the study build leaves out to time the
// large block on the same plans (csrc/refreshstudy.cu)
#ifdef KOORD_REFRESH_STUDY
constexpr int kRefreshSmall = 0;
#else
constexpr int kRefreshSmall = 512;
#endif

// the calling thread's last refresh plan, and the large parameter block
thread_local std::vector<unsigned int> g_refresh_words;
thread_local koord_refresh::Scratch g_refresh_scratch;
thread_local RefreshPlan<kRefreshLarge> g_refresh_large;

template <int CAP>
cudaError_t refresh_launch(bool con, const RefreshPlan<CAP>& plan, const unsigned int* words,
                           const Cfg& c, const PodIn& p, const NodeIn& n, const ConIn& k,
                           const XIn& x, const void* valid, const void* pod_ok, const void* salt,
                           int P, int N, int BS, long long TB, void* M, void* Mb, void* la_feas_T,
                           cudaStream_t st) {
  auto kernel = con ? refresh_kernel<true, CAP> : refresh_kernel<false, CAP>;
  const int threads = 128;
  kernel<<<dim3(plan.entries, (P + threads - 1) / threads), threads, 0, st>>>(
      c, p, n, k, x, (const uint8_t*)valid, (const uint8_t*)pod_ok, (const int*)salt, P, N, BS,
      TB, plan, words, (int*)M, (int*)Mb, (uint8_t*)la_feas_T);
  return cudaGetLastError();
}

// The warm refresh of the D host rows `dirty`: planned on the host
// (refreshplan.cuh), then one launch.  The plan rides in the launch's
// parameters (the 2-KB block up to kRefreshSmall words, else the 28-KB
// one); a plan past kRefreshLarge words (3,584 blocks at BS <= 32, at
// least 57,344 node columns) is copied into a stream-ordered device buffer
// first, freed behind the launch.
int launch_refresh(bool con, const void* const* pods, const void* const* nodes,
                   const long long* cfg, const void* la_w, const ConIn& k, const XIn& x,
                   const void* valid, const void* pod_ok, const void* salt, int P, int N, int BS,
                   long long TB, const int* dirty, int D, void* M, void* Mb, void* la_feas_T,
                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int entries =
      koord_refresh::build(dirty, D, BS, N, g_refresh_words, g_refresh_scratch);
  if (entries < 0 || P > 65535 * 128) return (int)cudaErrorInvalidValue;
  if (entries == 0 || P == 0) return (int)cudaSuccess;
  const Cfg c = koord_cfg(cfg, la_w);
  const PodIn p = koord_pods(pods);
  const NodeIn n = koord_nodes(nodes);
  const cudaStream_t st = (cudaStream_t)stream;
  const int stride = koord_refresh::kHead + koord_refresh::mask_words(BS);
  const size_t words = (size_t)entries * stride;
  const unsigned int* w = g_refresh_words.data();
  if (words <= (size_t)kRefreshSmall) {
    RefreshPlan<kRefreshSmall ? kRefreshSmall : 1> plan;
    plan.entries = entries;
    plan.stride = stride;
    std::copy(w, w + words, plan.w);
    return (int)refresh_launch(con, plan, nullptr, c, p, n, k, x, valid, pod_ok, salt, P, N, BS,
                               TB, M, Mb, la_feas_T, st);
  }
  RefreshPlan<kRefreshLarge>& plan = g_refresh_large;
  plan.entries = entries;
  plan.stride = stride;
  if (words <= (size_t)kRefreshLarge) {
    std::copy(w, w + words, plan.w);
    return (int)refresh_launch(con, plan, nullptr, c, p, n, k, x, valid, pod_ok, salt, P, N, BS,
                               TB, M, Mb, la_feas_T, st);
  }
  // pageable to device: the call returns once the host words are staged
  unsigned int* dw = nullptr;
  if ((e = cudaMallocAsync((void**)&dw, words * 4, st)) != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(dw, w, words * 4, cudaMemcpyHostToDevice, st);
  if (e == cudaSuccess)
    e = refresh_launch(con, plan, dw, c, p, n, k, x, valid, pod_ok, salt, P, N, BS, TB, M, Mb,
                       la_feas_T, st);
  const cudaError_t f = cudaFreeAsync(dw, st);
  return (int)(e != cudaSuccess ? e : f);
}

ConIn no_con() {
  ConIn k = {};
  return k;
}

XIn x_in(const void* feas, const void* sc) {
  return XIn{(const uint8_t*)feas, (const long long*)sc};
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every entry point takes, after the salts, the batch's extras (XIn):
// xfeas [N, P] bool and xsc [N, P] int64 in queue order, null when absent.
// The key builds' la_feas_T may be null (the scan's build reads none).

extern "C" int koord_sched_keys(const void* const* pods, const void* const* nodes,
                                const long long* cfg, const void* la_w, const void* valid,
                                const void* pod_ok, const void* salt, const void* xfeas,
                                const void* xsc, int P, int N, int BS, long long TB, void* M,
                                void* Mb, void* la_feas_T, int device, void* stream) {
  return launch_keys<int>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid, pod_ok,
                     salt, P, N, BS, TB, M, Mb, la_feas_T, device, stream);
}

extern "C" int koord_sched_keys_con(const void* const* pods, const void* const* nodes,
                                    const long long* cfg, const void* la_w, const void* valid,
                                    const void* pod_ok, const void* salt, const void* xfeas,
                                    const void* xsc, int P, int N, int BS, long long TB,
                                    const void* const* con, const long long* con_ints, void* M,
                                    void* Mb, void* la_feas_T, int device, void* stream) {
  return launch_keys<int>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), x_in(xfeas, xsc),
                     valid, pod_ok, salt, P, N, BS, TB, M, Mb, la_feas_T, device, stream);
}

extern "C" long long koord_sched_rounds_smem(int P, int K) {
  return (long long)rounds_smem(P, K, (int)sizeof(int));
}

// The round loops take, after K, the grid G (cuda.rounds_grid) and, in
// place of a node_first buffer, a scratch of
// cuda.rounds_scratch_words(P, K, N) int64 words.
extern "C" int koord_sched_rounds(const void* const* pods, const void* const* nodes,
                                  const long long* cfg, const void* la_w, const void* valid,
                                  const void* pod_ok, const void* salt, const void* xfeas,
                                  const void* xsc, int P, int N, int BS, long long TB, int K,
                                  int G, void* M, void* Mb, const void* la_feas_T, void* scratch,
                                  void* hosts, void* scores, void* rounds, int device,
                                  void* stream) {
  return launch_rounds<int>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid,
                            pod_ok, salt, P, N, BS, TB, K, G, M, Mb, la_feas_T, scratch, hosts,
                            scores, nullptr, rounds, device, stream);
}

extern "C" int koord_sched_rounds_con(const void* const* pods, const void* const* nodes,
                                      const long long* cfg, const void* la_w, const void* valid,
                                      const void* pod_ok, const void* salt, const void* xfeas,
                                      const void* xsc, int P, int N, int BS, long long TB, int K,
                                      int G, const void* const* con, const long long* con_ints,
                                      void* M, void* Mb, const void* la_feas_T, void* scratch,
                                      void* hosts, void* scores, void* precommit, void* rounds,
                                      int device, void* stream) {
  return launch_rounds<int>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints),
                            x_in(xfeas, xsc), valid, pod_ok, salt, P, N, BS, TB, K, G, M, Mb,
                            la_feas_T, scratch, hosts, scores, precommit, rounds, device, stream);
}

extern "C" int koord_sched_refresh(const void* const* pods, const void* const* nodes,
                                   const long long* cfg, const void* la_w, const void* valid,
                                   const void* pod_ok, const void* salt, const void* xfeas,
                                   const void* xsc, int P, int N, int BS, long long TB,
                                   const void* dirty, int D, void* M, void* Mb, void* la_feas_T,
                                   int device, void* stream) {
  return launch_refresh(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid, pod_ok,
                        salt, P, N, BS, TB, (const int*)dirty, D, M, Mb, la_feas_T, device,
                        stream);
}

extern "C" int koord_sched_refresh_con(const void* const* pods, const void* const* nodes,
                                       const long long* cfg, const void* la_w, const void* valid,
                                       const void* pod_ok, const void* salt, const void* xfeas,
                                       const void* xsc, int P, int N, int BS, long long TB,
                                       const void* const* con, const long long* con_ints,
                                       const void* dirty, int D, void* M, void* Mb,
                                       void* la_feas_T, int device, void* stream) {
  return launch_refresh(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), x_in(xfeas, xsc),
                        valid, pod_ok, salt, P, N, BS, TB, (const int*)dirty, D, M, Mb, la_feas_T,
                        device, stream);
}

// The int64-key matrix engine: the same launches over int64 key lanes
// (the cold key build and the round loop, plain and constrained).

extern "C" int koord_sched_keys64(const void* const* pods, const void* const* nodes,
                                  const long long* cfg, const void* la_w, const void* valid,
                                  const void* pod_ok, const void* salt, const void* xfeas,
                                  const void* xsc, int P, int N, int BS, long long TB, void* M,
                                  void* Mb, void* la_feas_T, int device, void* stream) {
  return launch_keys<long long>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid,
                                pod_ok, salt, P, N, BS, TB, M, Mb, la_feas_T, device, stream);
}

extern "C" int koord_sched_keys64_con(const void* const* pods, const void* const* nodes,
                                      const long long* cfg, const void* la_w, const void* valid,
                                      const void* pod_ok, const void* salt, const void* xfeas,
                                      const void* xsc, int P, int N, int BS, long long TB,
                                      const void* const* con, const long long* con_ints, void* M,
                                      void* Mb, void* la_feas_T, int device, void* stream) {
  return launch_keys<long long>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints),
                                x_in(xfeas, xsc), valid, pod_ok, salt, P, N, BS, TB, M, Mb,
                                la_feas_T, device, stream);
}

extern "C" int koord_sched_rounds64(const void* const* pods, const void* const* nodes,
                                    const long long* cfg, const void* la_w, const void* valid,
                                    const void* pod_ok, const void* salt, const void* xfeas,
                                    const void* xsc, int P, int N, int BS, long long TB, int K,
                                    int G, void* M, void* Mb, const void* la_feas_T,
                                    void* scratch, void* hosts, void* scores, void* rounds,
                                    int device, void* stream) {
  return launch_rounds<long long>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc),
                                  valid, pod_ok, salt, P, N, BS, TB, K, G, M, Mb, la_feas_T,
                                  scratch, hosts, scores, nullptr, rounds, device, stream);
}

extern "C" int koord_sched_rounds64_con(const void* const* pods, const void* const* nodes,
                                        const long long* cfg, const void* la_w,
                                        const void* valid, const void* pod_ok, const void* salt,
                                        const void* xfeas, const void* xsc, int P, int N, int BS,
                                        long long TB, int K, int G, const void* const* con,
                                        const long long* con_ints, void* M, void* Mb,
                                        const void* la_feas_T, void* scratch, void* hosts,
                                        void* scores, void* precommit, void* rounds, int device,
                                        void* stream) {
  return launch_rounds<long long>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints),
                                  x_in(xfeas, xsc), valid, pod_ok, salt, P, N, BS, TB, K, G, M,
                                  Mb, la_feas_T, scratch, hosts, scores, precommit, rounds,
                                  device, stream);
}

#ifdef KOORD_ROUND_STUDY
// The study build's entry points.  `iters` round synchronisations across G
// co-resident blocks of the round loop's size; `sync` two zeroed int32
// words.
extern "C" int koord_round_sync(int G, int iters, void* sync, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  unsigned int* b = (unsigned int*)sync;
  void* args[] = {&b, &iters};
  e = cudaLaunchCooperativeKernel((void*)sync_loop, dim3(G), dim3(kRoundThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The phase split of the last round launch on this device ([3, 8] int64
// SM cycles, rounds_kernel) into `out`, then zeroed for the next.
extern "C" int koord_round_split(void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbolAsync(out, g_round_split, sizeof(g_round_split), 0,
                                cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  void* addr = nullptr;
  e = cudaGetSymbolAddress(&addr, g_round_split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemsetAsync(addr, 0, sizeof(g_round_split), (cudaStream_t)stream);
}
#endif
