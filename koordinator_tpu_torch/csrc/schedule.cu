// SCHEDULE: the conflict-resolved cycle for plain pods (cold key build and
// round loop) and the warm carry's delta refresh.
//
// Replaces: the JAX package's `schedule` kernel, service/engine.py:155
// schedule_fn -> core/resolved.py:204 schedule_batch_resolved, engine
// matrix_packed (run_matrix_packed:757 with pack_keys:698, commit_core:494,
// touched_scores:585, refresh_blocks:782 and round_body:788), without the
// gang, quota and reservation branches.
//
// 1. build_keys: the cold init.  One thread per (pod, 16-row node block)
//    evaluates the shared pair function (pair.cuh) down its block and
//    writes the packed keys M [N_pad, P] int32 (score * TB + rotated tie
//    bits, the sentinel in pad rows), the block maxima Mb [N_pad/BS, P]
//    and the LoadAware filter la_feas_T [N, P].  Bound on an H100: bytes
//    (5 bytes written per pair, ~84 MB at 16,384 x 1,024); each thread
//    writes coalesced rows and computes its block maximum in registers,
//    so M is never read back.
//
// 2. rounds: the whole round loop in ONE thread block, as the TPU runs it
//    inside one lax.while_loop (resolved.py:835) — no host sync per round
//    and no grid-wide sync.  Each round: per-pod max over Mb and decode of
//    the pick from the key's low bits; first-picker scatter-min into
//    node_first; prefix cut by a block min and a block scan capped at K
//    commits; the <= K node-row updates of commit_core; rescoring of the K
//    touched rows with the same pair function; re-reduction of their
//    blocks; exit on a block-wide vote.  Bound on an H100: latency.  The
//    operations and bytes per round are small (the Mb column max reads
//    4 MB at 1,024 pods), but the rounds are sequential and one block uses
//    one SM's bandwidth.  Right before fast: spreading the per-round max
//    over the whole card is later work.
//
// 3. refresh_rows + refresh_blocks: the warm carry's delta refresh,
//    replacing the JAX package's `sched_refresh` (service/engine.py:208
//    sched_refresh_fn -> core/resolved.py:707-755, refresh_only).  For each
//    dirty node row j (a power-of-two index padded by repeating a real
//    row) and each pod, the real LoadAware filter into la_feas_T[j] and the
//    packed key into M[j] through the same pair function as the cold build,
//    so a refreshed key equals a cold-built one bit for bit; then, after a
//    kernel boundary, the block maximum of every block that holds a dirty
//    row.  In place (the JAX jit donates the carry).  Duplicate rows and
//    blocks write identical values.  Bound on an H100: bytes (5 bytes a
//    pair written for D rows, plus the re-read of the touched blocks); at
//    D = 128 and 1,024 pods it is a few microseconds of work, so launch
//    latency dominates.
//
// The warm rounds (`sched_rounds`, engine.py:238) are the rounds kernel
// launched on copies of the carry's M and Mb (core/resolved.py
// schedule_rounds_warm): the carry seeds the next cycle and is never
// written.
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

__global__ void build_keys(Cfg c, PodIn p, NodeIn n, const uint8_t* valid, const uint8_t* pod_ok,
                           const int* salt, int P, int N, int BS, long long TB, int* M, int* Mb,
                           uint8_t* la_feas_T) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  int b = blockIdx.y;
  if (q >= P) return;
  int best = KOORD_NEGK;
  for (int i = 0; i < BS; ++i) {
    int j = b * BS + i;
    int key = KOORD_NEGK;
    if (j < N) {
      bool laf = la_fit(c, p, n, q, j);
      la_feas_T[(size_t)j * P + q] = laf;
      key = pair_key(c, p, n, q, j, laf && valid[j] && pod_ok[q], salt[q], N, TB);
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

// one block of up to 1,024 threads: at most 64 registers a thread
__global__ void __launch_bounds__(1024) rounds_kernel(Cfg c, PodIn p, NodeIn n, const uint8_t* valid,
                              const uint8_t* pod_ok, const int* salt, int P, int N, int BS,
                              long long TB, int K, int* M, int* Mb, const uint8_t* la_feas_T,
                              int* node_first, int* hosts, long long* scores, int* rounds_out) {
  extern __shared__ unsigned char smem[];
  int* s_vmax = (int*)smem;
  int* s_pick = s_vmax + P;
  int* s_rank = s_pick + P;
  int* s_cols = s_rank + P;
  int* s_pslot = s_cols + K;
  uint8_t* s_comm = (uint8_t*)(s_pslot + K);
  uint8_t* s_flag = s_comm + P;
  uint8_t* s_place = s_flag + P;
  uint8_t* s_slotok = s_place + P;
  __shared__ int s_first_blocked, s_cut;
  __shared__ int s_warp[32];

  const int T = blockDim.x, t = threadIdx.x;
  const int NB = (N + BS - 1) / BS;
  for (int q = t; q < P; q += T) {
    s_comm[q] = 0;
    hosts[q] = -1;
    scores[q] = 0;
  }
  for (int j = t; j < N; j += T) node_first[j] = P;
  __syncthreads();

  int rounds = 0;
  while (true) {
    // pick: per-pod max over the block maxima, decoded from the low bits
    if (t == 0) {
      s_first_blocked = P;
      s_cut = P;
    }
    for (int k = t; k < K; k += T) {
      s_cols[k] = N;
      s_pslot[k] = 0;
      s_slotok[k] = 0;
    }
    for (int q = t; q < P; q += T) {
      uint8_t f = 0;
      int vmax = KOORD_NEGK, pick = 0;
      if (!s_comm[q]) {
        f = kPending;
        for (int b = 0; b < NB; ++b) vmax = max(vmax, Mb[(size_t)b * P + q]);
        if (vmax > KOORD_NEGK_THRESH) {
          f |= kPlaced;
          long long rot = TB - 1 - ((long long)vmax % TB);
          pick = (int)((rot - salt[q] + N) % N);
        }
      }
      s_flag[q] = f;
      s_vmax[q] = vmax;
      s_pick[q] = pick;
    }
    __syncthreads();
    // first picker of each node (commit_core's node_first scatter-min)
    for (int q = t; q < P; q += T)
      if (s_flag[q] == (kPending | kPlaced)) atomicMin(&node_first[s_pick[q]], q);
    __syncthreads();
    for (int q = t; q < P; q += T)
      if (s_flag[q] == (kPending | kPlaced) && node_first[s_pick[q]] != q)
        atomicMin(&s_first_blocked, q);
    __syncthreads();
    const int fb = s_first_blocked;
    for (int q = t; q < P; q += T) s_place[q] = s_flag[q] == (kPending | kPlaced) && q < fb;
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
        if (f & kPlaced) {
          hosts[q] = s_pick[q];
          scores[q] = (long long)s_vmax[q] / TB;
          int slot = s_rank[q] - 1;
          s_cols[slot] = s_pick[q];
          s_pslot[slot] = q;
          s_slotok[slot] = 1;
        }
      }
      if (f == (kPending | kPlaced)) node_first[s_pick[q]] = P;
    }
    __syncthreads();
    // the assume path: committed placements sit on distinct nodes
    for (int k = t; k < K; k += T) {
      if (!s_slotok[k]) continue;
      const int j = s_cols[k], q = s_pslot[k];
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
    }
    __syncthreads();
    // rescore the touched rows against the updated state (padding slots
    // clamp to N-1), then re-reduce their blocks
    for (int k = 0; k < K; ++k) {
      const int j = min(s_cols[k], N - 1);
      for (int q = t; q < P; q += T) {
        bool pre = la_feas_T[(size_t)j * P + q] && valid[j] && pod_ok[q];
        M[(size_t)j * P + q] = pair_key(c, p, n, q, j, pre, salt[q], N, TB);
      }
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const int b = min(s_cols[k], N - 1) / BS;
      for (int q = t; q < P; q += T) {
        int m = KOORD_NEGK;
        for (int i = 0; i < BS; ++i) m = max(m, M[(size_t)(b * BS + i) * P + q]);
        Mb[(size_t)b * P + q] = m;
      }
    }
    ++rounds;
    int open = 0;
    for (int q = t; q < P; q += T) open |= !s_comm[q];
    if (!__syncthreads_or(open)) break;
  }
  if (t == 0) *rounds_out = rounds;
}

// grid (pods / 128, min(D, 65535)); blockIdx.y strides over the dirty rows
__global__ void refresh_rows(Cfg c, PodIn p, NodeIn n, const uint8_t* valid, const uint8_t* pod_ok,
                             const int* salt, int P, int N, long long TB, const int* dirty, int D,
                             int* M, uint8_t* la_feas_T) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  for (int d = blockIdx.y; d < D; d += gridDim.y) {
    const int j = dirty[d];
    const bool laf = la_fit(c, p, n, q, j);
    la_feas_T[(size_t)j * P + q] = laf;
    M[(size_t)j * P + q] = pair_key(c, p, n, q, j, laf && valid[j] && pod_ok[q], salt[q], N, TB);
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

size_t rounds_smem(int P, int K) { return (size_t)P * (3 * sizeof(int) + 3) + (size_t)K * (2 * sizeof(int) + 1); }

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_sched_keys(const void* const* pods, const void* const* nodes,
                                const long long* cfg, const void* la_w, const void* valid,
                                const void* pod_ok, const void* salt, int P, int N, int BS,
                                long long TB, void* M, void* Mb, void* la_feas_T, int device,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, (N + BS - 1) / BS);
  build_keys<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, (int*)M, (int*)Mb,
      (uint8_t*)la_feas_T);
  return (int)cudaGetLastError();
}

extern "C" long long koord_sched_rounds_smem(int P, int K) { return (long long)rounds_smem(P, K); }

extern "C" int koord_sched_rounds(const void* const* pods, const void* const* nodes,
                                  const long long* cfg, const void* la_w, const void* valid,
                                  const void* pod_ok, const void* salt, int P, int N, int BS,
                                  long long TB, int K,
                                  void* M, void* Mb, const void* la_feas_T, void* node_first,
                                  void* hosts, void* scores, void* rounds, int device,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = rounds_smem(P, K);
  e = cudaFuncSetAttribute(rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = P >= 1024 ? 1024 : ((P + 31) / 32) * 32;
  rounds_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, BS, TB, K, (int*)M, (int*)Mb,
      (const uint8_t*)la_feas_T, (int*)node_first, (int*)hosts, (long long*)scores, (int*)rounds);
  return (int)cudaGetLastError();
}

extern "C" int koord_sched_refresh(const void* const* pods, const void* const* nodes,
                                   const long long* cfg, const void* la_w, const void* valid,
                                   const void* pod_ok, const void* salt, int P, int N, int BS,
                                   long long TB, const void* dirty, int D, void* M, void* Mb,
                                   void* la_feas_T, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, D < 65535 ? D : 65535);
  refresh_rows<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), (const uint8_t*)valid,
      (const uint8_t*)pod_ok, (const int*)salt, P, N, TB, (const int*)dirty, D, (int*)M,
      (uint8_t*)la_feas_T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  refresh_blocks<<<grid, threads, 0, (cudaStream_t)stream>>>((const int*)M, (int*)Mb,
                                                             (const int*)dirty, D, P, BS);
  return (int)cudaGetLastError();
}
