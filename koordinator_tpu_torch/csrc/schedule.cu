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
// 1. build_keys: the cold init.  One thread per (pod, 16-row node block)
//    evaluates the shared pair function (pair.cuh) down its block and
//    writes the packed keys M [N_pad, P] int32 (score * TB + rotated tie
//    bits, the sentinel in pad rows), the block maxima Mb [N_pad/BS, P]
//    and the LoadAware filter la_feas_T [N, P].  Under CON the gang
//    prefilter joins the pod mask and the pair function adds the
//    reservation restore and score (pair_key_con).  Bound on an H100: bytes
//    (5 bytes written per pair, ~84 MB at 16,384 x 1,024); each thread
//    writes coalesced rows and computes its block maximum in registers.
//
// 2. rounds: the whole round loop in ONE thread block, as the TPU runs it
//    inside one lax.while_loop (resolved.py:835) — no host sync per round
//    and no grid-wide sync.  Each round: per-pod max over Mb and decode of
//    the pick from the key's low bits; first-picker scatter-min into
//    node_first; prefix cut by a block min and a block scan capped at K
//    commits; the <= K node-row updates of commit_core; rescoring of the K
//    touched rows with the same pair function; re-reduction of their
//    blocks; exit on a block-wide vote.  Under CON, before the cut:
//    quota_certainty — the admission verdict under the committed quota
//    aggregates (lower bound); the candidates' totals; the `safe` check
//    (every group keeps headroom for one more maximal request after every
//    candidate consumed, so the bounds agree); only when not safe, the
//    exclusive prefix of earlier candidates' consumption at each pod's own
//    admission groups, from per-group entry lists built once per launch
//    (one warp per group, a shuffle scan per dimension), and the verdict
//    under it (upper bound).  The cut takes the certain admits and
//    rejects; each committed slot adds its request up its group chain and
//    nominates a matched reservation on its node (smallest positive rank,
//    else the first largest scoreReservation) and consumes from it; the
//    rescoring sees the restored remainders.  After the loop, commit_gangs
//    over [P] and [G] in the same block: `precommit` keeps the hosts before
//    it.  Bound on an H100: latency.  The operations and bytes per round
//    are small (the Mb column max reads 4 MB at 1,024 pods), but the rounds
//    are sequential and one block uses one SM's bandwidth.
//
// 3. refresh_rows + refresh_blocks: the warm carry's delta refresh.  For
//    each dirty node row j (a power-of-two index padded by repeating a
//    real row) and each pod, the real LoadAware filter into la_feas_T[j]
//    and the packed key into M[j] through the same pair function as the
//    cold build (under CON with the batch-start reservation allocations:
//    quota never enters the carry), so a refreshed key equals a cold-built
//    one bit for bit; then, after a kernel boundary, the block maximum of
//    every block that holds a dirty row.  In place.  Duplicate rows and
//    blocks write identical values.  Bound on an H100: bytes; at D = 128
//    and 1,024 pods launch latency dominates.
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

#include "pair.cuh"

namespace {

constexpr uint8_t kPending = 1;
constexpr uint8_t kPlaced = 2;
constexpr uint8_t kAdmit = 4;    // quota: certainly admitted
constexpr uint8_t kReject = 8;   // quota: certainly rejected
constexpr uint8_t kCand = 16;    // quota: a candidate of the upper bound
constexpr long long kMinLL = (long long)(-0x7fffffffffffffffLL - 1);

// the packed key of pod q on node j: the extra mask joins ``pre`` and the
// extra score the total, in the cold build, the refresh and the rounds'
// rescoring alike
template <bool CON, typename KT>
__device__ __forceinline__ KT key_of(const Cfg& c, const PodIn& p, const NodeIn& n,
                                     const ConIn& k, const XIn& x, int P, int q, int j, bool pre,
                                     int salt, int N, long long TB) {
  if (!pre || !x_feas(x, q, j, P)) return KeyLane<KT>::neg;
  const long long xadd = x_score(x, q, j, P);
  if constexpr (CON) return pair_key_con<KT>(c, p, n, k, q, j, true, salt, N, TB, xadd);
  return pair_key<KT>(c, p, n, q, j, true, salt, N, TB, xadd);
}

template <bool CON>
__device__ __forceinline__ bool pod_pass(const uint8_t* pod_ok, const ConIn& k, int q) {
  if constexpr (CON) return pod_ok[q] && gang_pass(k, q);
  return pod_ok[q];
}

template <bool CON, typename KT>
__global__ void build_keys(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                           const uint8_t* pod_ok, const int* salt, int P, int N, int BS,
                           long long TB, KT* M, KT* Mb, uint8_t* la_feas_T) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  int b = blockIdx.y;
  if (q >= P) return;
  const bool ok = pod_pass<CON>(pod_ok, k, q);
  KT best = KeyLane<KT>::neg;
  for (int i = 0; i < BS; ++i) {
    int j = b * BS + i;
    KT key = KeyLane<KT>::neg;
    if (j < N) {
      bool laf = la_fit(c, p, n, q, j);
      la_feas_T[(size_t)j * P + q] = laf;
      key = key_of<CON, KT>(c, p, n, k, x, P, q, j, laf && valid[j] && ok, salt[q], N, TB);
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
  if (t == 0) {
    int run = 0;
    for (int w = 0; w < nwarps; ++w) {
      int s = warp_sums[w];
      warp_sums[w] = run;
      run += s;
    }
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - local;
  for (int q = lo; q < hi; ++q) {
    run += flag[q];
    rank[q] = run;
  }
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
// `exc` (or null) adds the exclusive prefix at admission depth a.
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
      const long long u = k.q_used[(size_t)grp * k.Rq + r] + (exc ? exc[a * R2 + r] : 0);
      if (!(u + req <= k.q_limit[(size_t)grp * k.Rq + r])) return false;
      if (a == 0 && k.q_np[q]) {
        const long long v = k.q_npu[(size_t)grp * k.Rq + r] + (exc ? exc[k.Rq + r] : 0);
        if (!(v + req <= k.q_min[(size_t)grp * k.Rq + r])) return false;
      }
    }
  }
  return true;
}

// ------------------------------------------------------------ rounds

// one block of up to 1,024 threads: at most 64 registers a thread
template <bool CON, typename KT>
__global__ void __launch_bounds__(1024)
    rounds_kernel(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                  const uint8_t* pod_ok,
                  const int* salt, int P, int N, int BS, long long TB, int K, KT* M, KT* Mb,
                  const uint8_t* la_feas_T, int* node_first, int* hosts, long long* scores,
                  int* precommit, int* rounds_out) {
  extern __shared__ unsigned char smem[];
  KT* s_vmax = (KT*)smem;  // first: the int64 lane's alignment
  int* s_pick = (int*)(s_vmax + P);
  int* s_rank = s_pick + P;
  int* s_cols = s_rank + P;
  int* s_pslot = s_cols + K;
  uint8_t* s_comm = (uint8_t*)(s_pslot + K);
  uint8_t* s_flag = s_comm + P;
  uint8_t* s_place = s_flag + P;
  uint8_t* s_slotok = s_place + P;
  // CON: each pod's mask (pod_ok & gang prefilter), then its quota chain
  uint8_t* s_ok = s_slotok + K;
  int* s_chain = (int*)(smem + ((((size_t)P * (sizeof(KT) + 2 * sizeof(int) + 4) +
                                   (size_t)K * (2 * sizeof(int) + 1)) + 15) & ~(size_t)15));
  __shared__ int s_first_blocked, s_cut;
  __shared__ int s_warp[32];
  __shared__ long long s_mr[2 * KOORD_MAXR];

  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (T + 31) >> 5;
  const int NB = (N + BS - 1) / BS;
  const int R2 = 2 * k.Rq;
  long long* tp = k.scratch;
  long long* exc = tp + (size_t)k.Q * R2;
  long long* g_count = exc + (size_t)P * (k.cpd + 1) * R2;
  int* ent_off = (int*)(g_count + 2 * (size_t)k.G);
  int* ent = ent_off + k.Q + 1;
  for (int q = t; q < P; q += T) {
    s_comm[q] = 0;
    hosts[q] = -1;
    scores[q] = 0;
    if constexpr (CON) s_ok[q] = pod_pass<CON>(pod_ok, k, q);
  }
  for (int j = t; j < N; j += T) node_first[j] = P;
  if constexpr (CON) {
    if (k.has_quota) {
      // each pod's consumption chain, then per-group entry lists in queue
      // order: thread per group, two passes over the chains
      for (int q = t; q < P; q += T) {
        int g = k.q_row[q];
        for (int d = 0; d < k.ad; ++d) {
          s_chain[q * k.ad + d] = g;
          g = k.q_parent[g];
        }
      }
      __syncthreads();
      for (int g = 1 + t; g < k.Q; g += T) {
        int cnt = 0;
        for (int e = 0; e < P * k.ad; ++e) cnt += s_chain[e] == g;
        ent_off[g + 1] = cnt;
      }
      __syncthreads();
      if (t == 0) {
        ent_off[0] = ent_off[1] = 0;
        for (int g = 1; g < k.Q; ++g) ent_off[g + 1] += ent_off[g];
      }
      __syncthreads();
      for (int g = 1 + t; g < k.Q; g += T) {
        int pos = ent_off[g];
        for (int e = 0; e < P * k.ad; ++e)
          if (s_chain[e] == g) ent[pos++] = (e / k.ad) * 32 + e % k.ad;
      }
    }
  }
  __syncthreads();

  int rounds = 0, ub_rounds = 0;
  while (true) {
    // pick: per-pod max over the block maxima, decoded from the low bits
    if (t == 0) {
      s_first_blocked = P;
      s_cut = P;
    }
    for (int k2 = t; k2 < K; k2 += T) {
      s_cols[k2] = N;
      s_pslot[k2] = 0;
      s_slotok[k2] = 0;
    }
    for (int q = t; q < P; q += T) {
      uint8_t f = 0;
      KT vmax = KeyLane<KT>::neg;
      int pick = 0;
      if (!s_comm[q]) {
        f = kPending;
        for (int b = 0; b < NB; ++b) vmax = max(vmax, Mb[(size_t)b * P + q]);
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
    if constexpr (CON) {
      if (k.has_quota) {
        // quota_certainty: the lower-bound verdict, the candidates'
        // totals and the largest pending requests
        if (t < 2 * KOORD_MAXR) s_mr[t] = kMinLL;
        for (int i = t; i < k.Q * R2; i += T) tp[i] = 0;
        __syncthreads();
        for (int q = t; q < P; q += T) {
          const uint8_t f = s_flag[q];
          const bool pending = f & kPending;
          const bool npm = k.q_np[q];
          for (int r = 0; r < k.Rq; ++r) {
            const long long e = eff_req(k, q, r);
            atomicMax(&s_mr[r], pending ? e : 0LL);
            atomicMax(&s_mr[KOORD_MAXR + r], pending && npm ? e : 0LL);
          }
          if (!pending) continue;
          const bool lo = quota_admit(k, q, nullptr);
          uint8_t g = f & ~kAdmit;
          if (!lo) g |= kReject;
          if (lo && (f & kPlaced)) {
            g |= kCand;
            int grp = k.q_row[q];
            for (int d = 0; d < k.ad; ++d, grp = k.q_parent[grp]) {
              if (grp == 0) continue;
              for (int r = 0; r < k.Rq; ++r) {
                const long long e = eff_req(k, q, r);
                atomicAdd((unsigned long long*)&tp[(size_t)grp * R2 + r], (unsigned long long)e);
                if (npm)
                  atomicAdd((unsigned long long*)&tp[(size_t)grp * R2 + k.Rq + r],
                            (unsigned long long)e);
              }
            }
          }
          if (lo) g |= 32;  // admitted under the lower bound, before the upper
          s_flag[q] = g;
        }
        __syncthreads();
        int ok = 1;
        for (int i = k.Rq * 2 + t; i < k.Q * R2 && ok; i += T) {
          const int grp = i / R2, r = i % R2;
          if (r < k.Rq) {
            ok = k.q_used[(size_t)grp * k.Rq + r] + tp[i] + s_mr[r] <=
                 k.q_limit[(size_t)grp * k.Rq + r];
          } else {
            const int rr = r - k.Rq;
            ok = k.q_npu[(size_t)grp * k.Rq + rr] + tp[i] + s_mr[KOORD_MAXR + rr] <=
                 k.q_min[(size_t)grp * k.Rq + rr];
          }
        }
        const bool safe = __syncthreads_and(ok);
        if (!safe) {
          // the exclusive prefix of earlier candidates' consumption at each
          // pod's admission groups: one warp per group and dimension, a
          // shuffle scan down the group's entries in queue order
          ++ub_rounds;
          for (size_t i = t; i < (size_t)P * (k.cpd + 1) * R2; i += T) exc[i] = 0;
          __syncthreads();
          for (int job = warp; job < (k.Q - 1) * R2; job += nwarps) {
            const int grp = 1 + job / R2, r = job % R2, rr = r % k.Rq;
            const int lo = ent_off[grp], hi = ent_off[grp + 1];
            long long run = 0;
            for (int base = lo; base < hi; base += 32) {
              const int e = base + lane;
              int q = 0, d = k.cpd + 1;
              long long v = 0;
              if (e < hi) {
                q = ent[e] >> 5;
                d = ent[e] & 31;
                if ((s_flag[q] & kCand) && (r < k.Rq || k.q_np[q])) v = eff_req(k, q, rr);
              }
              long long incl = v;
              for (int s = 1; s < 32; s <<= 1) {
                const long long o = __shfl_up_sync(0xffffffffu, incl, s);
                if (lane >= s) incl += o;
              }
              if (e < hi && d <= k.cpd)
                exc[((size_t)q * (k.cpd + 1) + d) * R2 + r] = run + incl - v;
              run += __shfl_sync(0xffffffffu, incl, 31);
            }
          }
          __syncthreads();
        }
        for (int q = t; q < P; q += T) {
          uint8_t f = s_flag[q];
          if (!(f & kPending)) continue;
          const bool lo = f & 32;
          const bool hi = safe ? lo : quota_admit(k, q, exc + (size_t)q * (k.cpd + 1) * R2);
          f &= ~(kAdmit | 32);
          if (hi) f |= kAdmit;
          s_flag[q] = f;
        }
      }
    }
    __syncthreads();
    // first picker of each node among the blockers (commit_core's
    // node_first scatter-min); a certain quota reject blocks nothing
    for (int q = t; q < P; q += T) {
      const uint8_t f = s_flag[q];
      if ((f & (kPending | kPlaced)) == (kPending | kPlaced) && !(f & kReject))
        atomicMin(&node_first[s_pick[q]], q);
    }
    __syncthreads();
    for (int q = t; q < P; q += T) {
      const uint8_t f = s_flag[q];
      if ((f & (kPending | kPlaced)) != (kPending | kPlaced) || (f & kReject)) continue;
      bool blocked = node_first[s_pick[q]] != q;
      if constexpr (CON) blocked |= !(f & kAdmit);
      if (blocked) atomicMin(&s_first_blocked, q);
    }
    __syncthreads();
    const int fb = s_first_blocked;
    for (int q = t; q < P; q += T) {
      const uint8_t f = s_flag[q];
      bool place = (f & (kPending | kPlaced)) == (kPending | kPlaced) && q < fb;
      if constexpr (CON) place &= (f & kAdmit) != 0;
      s_place[q] = place;
    }
    __syncthreads();
    block_scan(s_place, s_rank, P, s_warp);
    __syncthreads();
    for (int q = t; q < P; q += T)
      if (s_place[q] && s_rank[q] > K) atomicMin(&s_cut, q);
    __syncthreads();
    // commit the prefix; release node_first for the next round
    const int cut = min(fb, s_cut);
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
          s_slotok[slot] = 1;
        }
      }
      if ((f & (kPending | kPlaced)) == (kPending | kPlaced)) node_first[s_pick[q]] = P;
    }
    __syncthreads();
    // the assume path: committed placements sit on distinct nodes
    for (int k2 = t; k2 < K; k2 += T) {
      if (!s_slotok[k2]) continue;
      const int j = s_cols[k2], q = s_pslot[k2];
      for (int r = 0; r < c.R; ++r) {
        long long e = p.est[(size_t)q * c.R + r];
        n.base_nonprod[(size_t)j * c.R + r] += e;
        if (p.prod_class[q]) n.base_prod[(size_t)j * c.R + r] += e;
      }
      for (int r = 0; r < c.Rf; ++r)
        n.requested[(size_t)j * c.Rf + r] += p.req[(size_t)q * c.Rf + r];
      for (int r = 0; r < c.Rs; ++r)
        n.nreq_score[(size_t)j * c.Rs + r] += p.req_score[(size_t)q * c.Rs + r];
      n.num_pods[j] += 1;
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
          // smallest positive rank, else the first largest rscore; nominated
          // rows are distinct because committed nodes are
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
    __syncthreads();
    // rescore the touched rows against the updated state (padding slots
    // clamp to N-1), then re-reduce their blocks
    for (int k2 = 0; k2 < K; ++k2) {
      const int j = min(s_cols[k2], N - 1);
      for (int q = t; q < P; q += T) {
        bool ok;
        if constexpr (CON) ok = s_ok[q];
        else ok = pod_ok[q];
        bool pre = la_feas_T[(size_t)j * P + q] && valid[j] && ok;
        M[(size_t)j * P + q] = key_of<CON, KT>(c, p, n, k, x, P, q, j, pre, salt[q], N, TB);
      }
    }
    __syncthreads();
    for (int k2 = 0; k2 < K; ++k2) {
      const int b = min(s_cols[k2], N - 1) / BS;
      for (int q = t; q < P; q += T) {
        KT m = KeyLane<KT>::neg;
        for (int i = 0; i < BS; ++i) m = max(m, M[(size_t)(b * BS + i) * P + q]);
        Mb[(size_t)b * P + q] = m;
      }
    }
    ++rounds;
    int open = 0;
    for (int q = t; q < P; q += T) open |= !s_comm[q];
    if (!__syncthreads_or(open)) break;
  }
  if constexpr (CON) {
    // commit_gangs: a gang group whose gangs did not all reach minMember
    // (placed + bound children, or once satisfied) loses every placement,
    // unless the gang is non-strict
    long long* placed = g_count;
    long long* unsat = g_count + k.G;
    for (int g = t; g < 2 * k.G; g += T) g_count[g] = 0;
    for (int q = t; q < P; q += T) precommit[q] = hosts[q];
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
    if (t == 0) rounds_out[1] = ub_rounds;
  }
  if (t == 0) rounds_out[0] = rounds;
}

// grid (pods / 128, min(D, 65535)); blockIdx.y strides over the dirty rows
template <bool CON>
__global__ void refresh_rows(Cfg c, PodIn p, NodeIn n, ConIn k, XIn x, const uint8_t* valid,
                             const uint8_t* pod_ok, const int* salt, int P, int N, long long TB,
                             const int* dirty, int D, int* M, uint8_t* la_feas_T) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  const bool ok = pod_pass<CON>(pod_ok, k, q);
  for (int d = blockIdx.y; d < D; d += gridDim.y) {
    const int j = dirty[d];
    const bool laf = la_fit(c, p, n, q, j);
    la_feas_T[(size_t)j * P + q] = laf;
    M[(size_t)j * P + q] =
        key_of<CON, int>(c, p, n, k, x, P, q, j, laf && valid[j] && ok, salt[q], N, TB);
  }
}

__global__ void refresh_blocks(const int* M, int* Mb, const int* dirty, int D, int P, int BS) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  for (int d = blockIdx.y; d < D; d += gridDim.y) {
    const int b = dirty[d] / BS;
    int m = KOORD_NEGK;
    for (int i = 0; i < BS; ++i) m = max(m, M[(size_t)(b * BS + i) * P + q]);
    Mb[(size_t)b * P + q] = m;
  }
}

// the round loop's dynamic shared memory for key lanes of `kb` bytes
size_t rounds_smem(int P, int K, int kb) {
  return (size_t)P * (kb + 2 * sizeof(int) + 3) + (size_t)K * (2 * sizeof(int) + 1);
}

// the constrained instantiation adds each pod's mask byte and, with quota,
// its chain of `ad` group rows (16-byte aligned)
size_t rounds_smem_con(int P, int K, int kb, int ad, int has_quota) {
  const size_t base =
      ((size_t)P * (kb + 2 * sizeof(int) + 4) + (size_t)K * (2 * sizeof(int) + 1) + 15) &
      ~(size_t)15;
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
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), k, x, (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, (KT*)M, (KT*)Mb,
      (uint8_t*)la_feas_T);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_rounds(bool con, const void* const* pods, const void* const* nodes,
                  const long long* cfg, const void* la_w, const ConIn& k, const XIn& x,
                  const void* valid, const void* pod_ok, const void* salt, int P, int N, int BS,
                  long long TB, int K, void* M, void* Mb, const void* la_feas_T, void* node_first, void* hosts,
                  void* scores, void* precommit, void* rounds, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int kb = (int)sizeof(KT);
  const size_t smem =
      con ? rounds_smem_con(P, K, kb, k.ad, k.has_quota) : rounds_smem(P, K, kb);
  auto kernel = con ? rounds_kernel<true, KT> : rounds_kernel<false, KT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = P >= 1024 ? 1024 : ((P + 31) / 32) * 32;
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), k, x, (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, K, (KT*)M, (KT*)Mb,
      (const uint8_t*)la_feas_T, (int*)node_first, (int*)hosts, (long long*)scores,
      (int*)precommit, (int*)rounds);
  return (int)cudaGetLastError();
}

int launch_refresh(bool con, const void* const* pods, const void* const* nodes,
                   const long long* cfg, const void* la_w, const ConIn& k, const XIn& x,
                   const void* valid, const void* pod_ok, const void* salt, int P, int N, int BS,
                   long long TB, const void* dirty, int D, void* M, void* Mb, void* la_feas_T, int device,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, D < 65535 ? D : 65535);
  auto kernel = con ? refresh_rows<true> : refresh_rows<false>;
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), k, x, (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, TB, (const int*)dirty, D, (int*)M,
      (uint8_t*)la_feas_T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  refresh_blocks<<<grid, threads, 0, (cudaStream_t)stream>>>((const int*)M, (int*)Mb,
                                                             (const int*)dirty, D, P, BS);
  return (int)cudaGetLastError();
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

extern "C" int koord_sched_rounds(const void* const* pods, const void* const* nodes,
                                  const long long* cfg, const void* la_w, const void* valid,
                                  const void* pod_ok, const void* salt, const void* xfeas,
                                  const void* xsc, int P, int N, int BS, long long TB, int K,
                                  void* M, void* Mb, const void* la_feas_T, void* node_first,
                                  void* hosts, void* scores, void* rounds, int device,
                                  void* stream) {
  return launch_rounds<int>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid, pod_ok,
                       salt, P, N, BS, TB, K, M, Mb, la_feas_T, node_first, hosts, scores,
                       nullptr, rounds, device, stream);
}

extern "C" int koord_sched_rounds_con(const void* const* pods, const void* const* nodes,
                                      const long long* cfg, const void* la_w, const void* valid,
                                      const void* pod_ok, const void* salt, const void* xfeas,
                                      const void* xsc, int P, int N, int BS, long long TB, int K,
                                      const void* const* con, const long long* con_ints, void* M,
                                      void* Mb, const void* la_feas_T, void* node_first,
                                      void* hosts, void* scores, void* precommit, void* rounds,
                                      int device, void* stream) {
  return launch_rounds<int>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), x_in(xfeas, xsc),
                       valid, pod_ok, salt, P, N, BS, TB, K, M, Mb, la_feas_T, node_first, hosts,
                       scores, precommit, rounds, device, stream);
}

extern "C" int koord_sched_refresh(const void* const* pods, const void* const* nodes,
                                   const long long* cfg, const void* la_w, const void* valid,
                                   const void* pod_ok, const void* salt, const void* xfeas,
                                   const void* xsc, int P, int N, int BS, long long TB,
                                   const void* dirty, int D, void* M, void* Mb, void* la_feas_T,
                                   int device, void* stream) {
  return launch_refresh(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc), valid, pod_ok,
                        salt, P, N, BS, TB, dirty, D, M, Mb, la_feas_T, device, stream);
}

extern "C" int koord_sched_refresh_con(const void* const* pods, const void* const* nodes,
                                       const long long* cfg, const void* la_w, const void* valid,
                                       const void* pod_ok, const void* salt, const void* xfeas,
                                       const void* xsc, int P, int N, int BS, long long TB,
                                       const void* const* con, const long long* con_ints,
                                       const void* dirty, int D, void* M, void* Mb,
                                       void* la_feas_T, int device, void* stream) {
  return launch_refresh(true, pods, nodes, cfg, la_w, koord_con(con, con_ints), x_in(xfeas, xsc),
                        valid, pod_ok, salt, P, N, BS, TB, dirty, D, M, Mb, la_feas_T, device,
                        stream);
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
                                    void* M, void* Mb, const void* la_feas_T, void* node_first,
                                    void* hosts, void* scores, void* rounds, int device,
                                    void* stream) {
  return launch_rounds<long long>(false, pods, nodes, cfg, la_w, no_con(), x_in(xfeas, xsc),
                                  valid, pod_ok, salt, P, N, BS, TB, K, M, Mb, la_feas_T,
                                  node_first, hosts, scores, nullptr, rounds, device, stream);
}

extern "C" int koord_sched_rounds64_con(const void* const* pods, const void* const* nodes,
                                        const long long* cfg, const void* la_w,
                                        const void* valid, const void* pod_ok, const void* salt,
                                        const void* xfeas, const void* xsc, int P, int N, int BS,
                                        long long TB, int K, const void* const* con,
                                        const long long* con_ints, void* M, void* Mb,
                                        const void* la_feas_T, void* node_first, void* hosts,
                                        void* scores, void* precommit, void* rounds, int device,
                                        void* stream) {
  return launch_rounds<long long>(true, pods, nodes, cfg, la_w, koord_con(con, con_ints),
                                  x_in(xfeas, xsc), valid, pod_ok, salt, P, N, BS, TB, K, M, Mb,
                                  la_feas_T, node_first, hosts, scores, precommit, rounds, device,
                                  stream);
}
