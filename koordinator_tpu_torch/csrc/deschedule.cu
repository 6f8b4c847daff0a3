// One LowNodeLoad descheduling round for one node pool, as one C call that
// enqueues a fixed sequence of launches on the caller's stream (the
// "deschedule_round" kernel family).
//
// Replaces the JAX package's jax.jit program `deschedule_round`
// (koordinator_tpu/core/deschedule.py:144-221, `_deschedule_round`):
// thresholds (float64 -> int64 truncation, the deviation mean), classify,
// the anomaly debounce, the reference's gates, the vectorised eviction walk
// (core/lownodeload.py:173-295), the total eviction rank, the per-node and
// total budget masks, and p50/p90/p99 of the node usage percent.
//
// The launches, in order:
//   nodes_kernel       per node: usage percent (NaN where it does not count),
//                      the weighted usage score, the valid-node count;
//   thresholds_kernel  one thread a resource: the deviation mean summed in
//                      node order, one node after the other (the order of
//                      the reference's Go loop and of the plain version), and
//                      the low/high percents;
//   classify_kernel    per node: the int64 thresholds, under/over, the
//                      overused resources, Mark(false), the gate counters and
//                      the destinations' headroom (integer atomics: exact in
//                      any order);
//   lexsort            the node order (-score, node) -> node_rank;
//   pods_kernel        per candidate: both pod scores, its node's rank;
//   lexsort x2         the walk order (node_rank, -masked score, k) and the
//                      eviction order (node_rank, -score, k) — the JAX
//                      lexsorts (-node_score, node, -score, k) and
//                      (node_rank, -score, k), since node_rank orders nodes by
//                      (-node_score, node);
//   the walk           per candidate in walk order, each running quantity a
//                      segmented exclusive sum (a tiled scan, less the sum at
//                      the node's first position): the node's
//                      usage before it (the continue condition), the
//                      failures before it (the prefix of evictions), the
//                      prefix evictions' usage against the shared headroom,
//                      the cut-off prefix evictions before the first failure
//                      (reset_mid);
//   state_kernel       per node: Reset(under), Reset(reset_mid),
//                      Mark(true) on the sources;
//   budget_kernel      per candidate in eviction order: the per-node cap (a
//                      segmented count), and rank = position in eviction
//                      order (both JAX orders of budget_cut group a node's
//                      candidates in rank order);
//   total_kernel       the total cap over the eviction order (a count);
//   util_kernel        one block per (percentile, resource): a radix select
//                      of the two order statistics JAX's quantile reads, and
//                      its interpolation.
//
// A node's candidates are contiguous in both orders, so a segmented sum is
// the global exclusive sum less its value at the node's first position; the
// scans are exact in any order (integers), and there is no per-node loop
// whose length depends on the data.
//
// What bounds it on an H100: the launches.  At 10,000 nodes x 32,768
// candidates the inputs and outputs are ~1.7 MB (well under a microsecond of
// memory time); each 8-bit radix pass over 64-bit score keys is two
// launches, each scan three, and a round makes about 100, most of them
// latency-bound at a few microseconds.  The design keeps every
// ordering exact (stable radix passes over whole int64 keys: the scores are
// not assumed to lie in 0..1000) and every sum in a stated order; no FMA is
// contracted by the compiler: the thresholds multiply with __dmul_rn, and the
// percentiles' one fused multiply-add is written out (__fma_rn), where the
// reference's own compiled program has it.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

using koord_radix::LexKey;
using koord_radix::u64;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 8;
constexpr int kScanTile = 2048;  // positions a block of the scans takes

struct Ctl {
  int nvalid, nsource, nunder, pad;
  u64 avail0[kMaxR];
  double lo[kMaxR], hi[kMaxR];
};

struct In {
  const bool* anomaly;
  const long long* ab;
  const long long* norm;
  const long long* usage;  // [N, R]
  const long long* alloc;  // [N, R]
  const bool* unsched;
  const bool* valid;
  const int* p_node;
  const long long* p_usage;  // [Pc, R]
  const bool* p_rm;
  const double* low_pct;  // [R]
  const double* high_pct;
  const long long* weights;
};

struct Out {
  bool* anomaly;
  long long* ab;
  long long* norm;
  bool* evicted;
  long long* rank;
  bool* under;
  bool* over;
  bool* source;
  double* util;  // [3, R]
};

struct Par {
  int N, Pc, R, use_dev;
  long long cons_ab, cons_norm, number_of_nodes, per_node_cap, total_cap;
};

// Scratch, carved from one buffer.
struct Scr {
  Ctl* ctl;
  double* pct;         // [R, N]
  long long* nscore;   // [N]
  long long* high_q;   // [N, R]
  unsigned char* over_bits;  // [N]
  unsigned char* reset_mid;  // [N]
  int* node_rank;      // [N]
  long long* pscore_w;  // [Pc]
  long long* pscore;   // [Pc]
  int* nrk;            // [Pc]
  int* order1;         // [Pc] walk order
  int* order2;         // [Pc] eviction order
  unsigned char* flags;  // [Pc] walk order
  unsigned char* evsel;  // [Pc] by candidate
  unsigned char* keep;   // [Pc] eviction order
  int* start1;         // [N] a node's first position in the walk order
  int* start2;         // [N] ... in the eviction order
  u64* scan;           // [Pc, R] exclusive sums
  u64* tile_sums;      // [Pc / kScanTile + 1, R] their tiles' sums
  koord_radix::Bufs rb;
};

using koord_radix::align256;

size_t scratch_bytes(long long N, long long Pc, long long R) {
  const long long M = N > Pc ? N : Pc;
  return align256(sizeof(Ctl)) + align256(8 * R * N) + align256(8 * N) + align256(8 * N * R) +
         2 * align256(N) + align256(4 * N) + 2 * align256(8 * Pc) + 3 * align256(4 * Pc) +
         3 * align256(Pc) + 2 * align256(4 * N) + align256(8 * Pc * R) +
         align256(8 * (Pc / kScanTile + 1) * R) + koord_radix::bufs_bytes(M);
}

Scr carve(unsigned char* p, long long N, long long Pc, long long R) {
  Scr s;
  auto take = [&](size_t bytes) {
    unsigned char* q = p;
    p += align256(bytes);
    return q;
  };
  s.ctl = (Ctl*)take(sizeof(Ctl));
  s.pct = (double*)take(8 * R * N);
  s.nscore = (long long*)take(8 * N);
  s.high_q = (long long*)take(8 * N * R);
  s.over_bits = take(N);
  s.reset_mid = take(N);
  s.node_rank = (int*)take(4 * N);
  s.pscore_w = (long long*)take(8 * Pc);
  s.pscore = (long long*)take(8 * Pc);
  s.nrk = (int*)take(4 * Pc);
  s.order1 = (int*)take(4 * Pc);
  s.order2 = (int*)take(4 * Pc);
  s.flags = take(Pc);
  s.evsel = take(Pc);
  s.keep = take(Pc);
  s.start1 = (int*)take(4 * N);
  s.start2 = (int*)take(4 * N);
  s.scan = (u64*)take(8 * Pc * R);
  s.tile_sums = (u64*)take(8 * (Pc / kScanTile + 1) * R);
  s.rb = koord_radix::carve(p, N > Pc ? N : Pc);
  return s;
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// ResourceUsageScorer (scorer.go:24-51), as core/lownodeload.py usage_score:
// the weights of resources outside `mask` are zero; int64 wraps.
__device__ long long usage_score(const long long* u, const long long* cap, const long long* w,
                                 unsigned mask, int R) {
  u64 s = 0, ws = 0;
  for (int r = 0; r < R; ++r) {
    const long long wr = ((mask >> r) & 1u) ? w[r] : 0;
    const long long c = cap[r];
    long long per = 0;
    if (c != 0) {
      const long long req = u[r] < c ? u[r] : c;
      per = floordiv((long long)((u64)req * 1000ULL), c);
    }
    s += (u64)per * (u64)wr;
    ws += (u64)wr;
  }
  const long long S = (long long)s, W = (long long)ws;
  return W == 0 ? 0 : floordiv(S, W);
}

__device__ __forceinline__ double nan64() { return __longlong_as_double(0x7FF8000000000000LL); }

// torch.clamp(x, 0, 100): NaN stays NaN
__device__ __forceinline__ double clamp_pct(double x) {
  return x < 0.0 ? 0.0 : (x > 100.0 ? 100.0 : x);
}

__device__ __forceinline__ bool proceed(const Ctl* c, const Par& p) {
  const bool reach = c->nsource > 0 && c->nunder > 0;
  return reach && (long long)c->nunder > p.number_of_nodes && c->nunder < p.N;
}

__device__ __forceinline__ int node_at(const In& in, const int* order, int q, int N) {
  int n = in.p_node[order[q]];
  return n < 0 ? 0 : (n >= N ? N - 1 : n);
}

__global__ void nodes_kernel(In in, Par p, Scr s) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  const bool v = in.valid[n];
  for (int r = 0; r < p.R; ++r) {
    const long long a = in.alloc[(size_t)n * p.R + r];
    const long long u = in.usage[(size_t)n * p.R + r];
    s.pct[(size_t)r * p.N + n] =
        (v && a > 0) ? __ddiv_rn(__dmul_rn(100.0, (double)u), (double)a) : nan64();
  }
  s.nscore[n] = usage_score(in.usage + (size_t)n * p.R, in.alloc + (size_t)n * p.R, in.weights,
                            0xFFu, p.R);
  if (v) atomicAdd(&s.ctl->nvalid, 1);
}

__global__ void thresholds_kernel(In in, Par p, Scr s) {
  const int r = threadIdx.x;
  if (r >= p.R) return;
  double lo = in.low_pct[r], hi = in.high_pct[r];
  if (p.use_dev) {
    const double* x = s.pct + (size_t)r * p.N;
    // in node order; a node that does not count adds +0.0 (the sum is never
    // -0.0, so that changes nothing), which keeps the loop branch-free and
    // lets the loads run ahead of the dependent adds
    double sum = 0.0;
#pragma unroll 16
    for (int n = 0; n < p.N; ++n) {
      const double v = x[n];
      sum = __dadd_rn(sum, v == v ? v : 0.0);
    }
    const int nv = s.ctl->nvalid > 1 ? s.ctl->nvalid : 1;
    const double avg = __ddiv_rn(sum, (double)nv);
    if (in.low_pct[r] == 0.0) {
      lo = hi = 100.0;
    } else {
      lo = clamp_pct(__dsub_rn(avg, in.low_pct[r]));
      hi = clamp_pct(__dadd_rn(avg, in.high_pct[r]));
    }
  }
  s.ctl->lo[r] = lo;
  s.ctl->hi[r] = hi;
}

__global__ void classify_kernel(In in, Out out, Par p, Scr s) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  bool all_le = true, any_gt = false;
  unsigned ob = 0;
  long long hq[kMaxR];
  for (int r = 0; r < p.R; ++r) {
    const double af = (double)in.alloc[(size_t)n * p.R + r];
    const long long u = in.usage[(size_t)n * p.R + r];
    const long long lq = (long long)__dmul_rn(__dmul_rn(s.ctl->lo[r], 0.01), af);
    hq[r] = (long long)__dmul_rn(__dmul_rn(s.ctl->hi[r], 0.01), af);
    s.high_q[(size_t)n * p.R + r] = hq[r];
    all_le = all_le && u <= lq;
    const bool gt = u > hq[r];
    any_gt = any_gt || gt;
    ob |= (unsigned)gt << r;
  }
  const bool v = in.valid[n];
  const bool under = all_le && !in.unsched[n] && v;
  const bool over = any_gt && !under && v;
  s.over_bits[n] = (unsigned char)ob;
  bool anom = in.anomaly[n];
  long long ab = in.ab[n], norm = in.norm[n];
  bool source = over;
  if (p.cons_ab > 1) {  // Mark(false) on every over node
    const bool trans = over && !anom && (ab + 1 > p.cons_ab);
    if (over) {
      ab = trans ? 0 : ab + 1;
      norm = 0;
    }
    anom = anom || trans;
    source = over && anom;
  }
  out.anomaly[n] = anom;
  out.ab[n] = ab;
  out.norm[n] = norm;
  out.under[n] = under;
  out.over[n] = over;
  out.source[n] = source;
  if (source) atomicAdd(&s.ctl->nsource, 1);
  if (under) {
    atomicAdd(&s.ctl->nunder, 1);
    for (int r = 0; r < p.R; ++r)
      atomicAdd(&s.ctl->avail0[r], (u64)hq[r] - (u64)in.usage[(size_t)n * p.R + r]);
  }
}

__global__ void node_rank_kernel(const int* order, int N, int* node_rank) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) node_rank[order[i]] = i;
}

__global__ void pods_kernel(In in, Par p, Scr s) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.Pc) return;
  int n = in.p_node[k];
  n = n < 0 ? 0 : (n >= p.N ? p.N - 1 : n);
  const long long* pu = in.p_usage + (size_t)k * p.R;
  const long long* cap = in.alloc + (size_t)n * p.R;
  s.pscore_w[k] = usage_score(pu, cap, in.weights, s.over_bits[n], p.R);
  s.pscore[k] = usage_score(pu, cap, in.weights, 0xFFu, p.R);
  s.nrk[k] = s.node_rank[n];
}

// flags (walk order): 16 active (removable on an effective source), 32
// still over its high threshold before it, 1 continue-condition failure,
// 2 no failure before it on its node, 4 a prefix eviction, 8 evicted after
// the headroom cut.
//
// Every per-node running quantity of the walk is a segmented exclusive sum:
// the global exclusive sum (scan, int64 lanes wrapping as int64
// does) less its value at the node's first position (start[node], written
// by the thread at that position); nodes are contiguous in both orders.

// start[node] = the node's first position in `order`.
__global__ void seg_start_kernel(In in, const int* order, Par p, int* start) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int node = node_at(in, order, q, p.N);
  if (q == 0 || node_at(in, order, q - 1, p.N) != node) start[node] = q;
}

// The lane values the scans sum, by position.
struct UsageOfActive {  // [R] usage of the active candidates
  const In in;
  const int* order;
  const unsigned char* flags;
  int R;
  __device__ u64 operator()(int q, int r) const {
    return (flags[q] & 16) ? (u64)in.p_usage[(size_t)order[q] * R + r] : 0ULL;
  }
};

struct UsageOfPrefix {  // [R] usage of the prefix evictions
  const In in;
  const int* order;
  const unsigned char* flags;
  int R;
  __device__ u64 operator()(int q, int r) const {
    return (flags[q] & 4) ? (u64)in.p_usage[(size_t)order[q] * R + r] : 0ULL;
  }
};

struct FlagCount {  // 1 where every bit of `all` and no bit of `none` is set
  const unsigned char* flags;
  unsigned char all, none;
  __device__ u64 operator()(int q, int) const {
    return (flags[q] & all) == all && !(flags[q] & none);
  }
};

struct Evicted {  // the walk's evictions, by eviction order
  const int* order;
  const unsigned char* evsel;
  __device__ u64 operator()(int q, int) const { return evsel[order[q]]; }
};

// out[q * R + r] = sum of val(q', r) over q' < q, in three launches: each
// tile's sums, the exclusive scan of the tile sums (one block), each tile's
// exclusive scan from its offset.  A thread takes a contiguous run of
// kScanTile / kThreads positions of its tile.
template <class Val>
__device__ void run_sums(int n, int R, int b, Val val, u64* total_by_r, u64* pre_by_r) {
  __shared__ u64 smem[32];
  const int per = kScanTile / kThreads;
  const int lo = b * kScanTile + threadIdx.x * per;
  for (int r = 0; r < R; ++r) {
    u64 sum = 0;
    for (int q = lo; q < lo + per && q < n; ++q) sum += val(q, r);
    pre_by_r[r] = koord_radix::block_excl_scan<u64>(sum, smem, &total_by_r[r]);
  }
}

template <class Val>
__global__ void tile_sum_kernel(int n, int R, Val val, u64* sums) {
  u64 total[kMaxR], pre[kMaxR];
  run_sums(n, R, blockIdx.x, val, total, pre);
  if (threadIdx.x == 0)
    for (int r = 0; r < R; ++r) sums[(size_t)blockIdx.x * R + r] = total[r];
}

// in place, one block: each thread a contiguous run of the B tile sums
__global__ void tile_offsets_kernel(int B, int R, u64* sums) {
  __shared__ u64 smem[32];
  const int per = (B + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per < B ? threadIdx.x * per : B;
  const int hi = lo + per < B ? lo + per : B;
  for (int r = 0; r < R; ++r) {
    u64 sum = 0, total;
    for (int b = lo; b < hi; ++b) sum += sums[(size_t)b * R + r];
    u64 pre = koord_radix::block_excl_scan<u64>(sum, smem, &total);
    for (int b = lo; b < hi; ++b) {
      const u64 x = sums[(size_t)b * R + r];
      sums[(size_t)b * R + r] = pre;
      pre += x;
    }
  }
}

template <class Val>
__global__ void tile_scan_kernel(int n, int R, Val val, const u64* offsets, u64* out) {
  u64 total[kMaxR], pre[kMaxR];
  run_sums(n, R, blockIdx.x, val, total, pre);
  const int per = kScanTile / kThreads;
  const int lo = blockIdx.x * kScanTile + threadIdx.x * per;
  for (int r = 0; r < R; ++r) {
    u64 acc = offsets[(size_t)blockIdx.x * R + r] + pre[r];
    for (int q = lo; q < lo + per && q < n; ++q) {
      out[(size_t)q * R + r] = acc;
      acc += val(q, r);
    }
  }
}

template <class Val>
void scan(int n, int R, Val val, u64* sums, u64* out, cudaStream_t st) {
  const int B = (n + kScanTile - 1) / kScanTile;
  tile_sum_kernel<<<B, kThreads, 0, st>>>(n, R, val, sums);
  tile_offsets_kernel<<<1, 1024, 0, st>>>(B, R, sums);
  tile_scan_kernel<<<B, kThreads, 0, st>>>(n, R, val, sums, out);
}

__global__ void active_kernel(In in, Out out, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int node = node_at(in, s.order1, q, p.N);
  s.flags[q] = (in.p_rm[s.order1[q]] && out.source[node] && proceed(s.ctl, p)) ? 16 : 0;
}

// the continue condition before each candidate: the node's usage less every
// active candidate before it on the node
__global__ void fail_kernel(In in, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int node = node_at(in, s.order1, q, p.N);
  const size_t q0 = (size_t)s.start1[node] * p.R, qr = (size_t)q * p.R;
  bool still = false;
  for (int r = 0; r < p.R; ++r) {
    const u64 before = s.scan[qr + r] - s.scan[q0 + r];
    const long long live = (long long)((u64)in.usage[(size_t)node * p.R + r] - before);
    still = still || live > s.high_q[(size_t)node * p.R + r];
  }
  const unsigned char f = s.flags[q];
  const bool fail = (f & 16) && !still;
  s.flags[q] = f | (still ? 32 : 0) | (fail ? 1 : 0);
}

// a prefix eviction: active, still over, no continue-condition failure
// before it on its node
__global__ void prefix_kernel(In in, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int node = node_at(in, s.order1, q, p.N);
  const unsigned char f = s.flags[q];
  const bool npf = s.scan[q] == s.scan[s.start1[node]];
  const bool pre = (f & 16) && (f & 32) && npf;
  s.flags[q] = f | (npf ? 2 : 0) | (pre ? 4 : 0);
}

// the shared headroom: a prefix eviction happens while every resource's
// headroom left (the destinations' total less the usage of the prefix
// evictions before it) is positive
__global__ void headroom_kernel(In in, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const unsigned char f = s.flags[q];
  bool head = true;
  for (int r = 0; r < p.R; ++r)
    head = head && (long long)(s.ctl->avail0[r] - s.scan[(size_t)q * p.R + r]) > 0;
  const bool ev = (f & 4) && head;
  s.flags[q] = f | (ev ? 8 : 0);
  s.evsel[s.order1[q]] = ev;
}

// reset_mid: a node's first continue-condition failure, when the walk
// reached it (no prefix eviction before it on the node was cut by the
// headroom)
__global__ void reset_mid_kernel(In in, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int node = node_at(in, s.order1, q, p.N);
  const unsigned char f = s.flags[q];
  if ((f & 1) && (f & 2) && s.scan[q] == s.scan[s.start1[node]]) s.reset_mid[node] = 1;
}

// the detector after the walk: Reset() of the underutilized nodes (when the
// gates reached it), Reset() of the nodes reset mid-walk, Mark(true) on
// every effective source
__global__ void state_kernel(Out out, Par p, Scr s) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N || p.cons_ab <= 1) return;
  const bool reach = s.ctl->nsource > 0 && s.ctl->nunder > 0;
  bool anom = out.anomaly[n];
  long long ab = out.ab[n], norm = out.norm[n];
  const bool masks[2] = {reach && out.under[n], s.reset_mid[n] != 0};
  for (int i = 0; i < 2; ++i) {
    if (masks[i]) {
      if (anom) ab = norm = 0;
      anom = false;
    }
  }
  if (out.source[n] && proceed(s.ctl, p)) {
    norm = norm + 1;
    ab = 0;
    if (anom && norm > p.cons_norm) {
      anom = false;
      ab = norm = 0;
    }
  }
  out.anomaly[n] = anom;
  out.ab[n] = ab;
  out.norm[n] = norm;
}

// the per-node cap in eviction order, and rank = position in it
__global__ void budget_kernel(In in, Out out, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const int k = s.order2[q];
  out.rank[k] = q;
  const int node = node_at(in, s.order2, q, p.N);
  const long long pn = p.per_node_cap < 0 ? (1LL << 40) : p.per_node_cap;
  const long long prior = (long long)(s.scan[q] - s.scan[s.start2[node]]);
  s.keep[q] = s.evsel[k] && prior < pn;
}

// the total cap over the eviction order
__global__ void total_kernel(Out out, Par p, Scr s) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.Pc) return;
  const long long tot = p.total_cap < 0 ? (1LL << 40) : p.total_cap;
  out.evicted[s.order2[q]] = s.keep[q] && (long long)s.scan[q] < tot;
}

// The k-th smallest (0-based) of the N float64 keys under f64_key's total
// order, by 8-bit radix select over one block of kSelectThreads: each warp
// counts the digits of its keys in a histogram of its own (keys that share
// their high bytes would serialise on one shared counter), the block sums
// the histograms, and the digit holding rank k extends the prefix.
constexpr int kSelectThreads = 1024;

__device__ double select_kth(const double* x, int N, int k, int (*wcnt)[256], int* pick) {
  const int warp = threadIdx.x >> 5;
  u64 prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 32 * 256; i += blockDim.x) wcnt[i >> 8][i & 255] = 0;
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const u64 key = koord_radix::f64_key(x[n]);
      if ((key & mask) == prefix) atomicAdd(&wcnt[warp][(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      int c = 0;
      for (int w = 0; w < 32; ++w) c += wcnt[w][threadIdx.x];
      wcnt[0][threadIdx.x] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = 0;
      while (d < 255 && k >= wcnt[0][d]) k -= wcnt[0][d++];
      pick[0] = d;
      pick[1] = k;
    }
    __syncthreads();
    prefix |= (u64)pick[0] << shift;
    mask |= 255ULL << shift;
    k = pick[1];
    __syncthreads();
  }
  return koord_radix::f64_of_key(prefix);
}

// jnp.nanpercentile(pct, [50, 90, 99], axis=0) as JAX's _quantile computes
// it (linear): q = p / 100 * (count - 1) over the non-NaN values, the floor
// and ceil order statistics, low * (1 - w) + high * w, rounded as XLA on the
// CPU rounds it: fma(high, w, low * (1 - w)), one product rounded, then one
// fused multiply-add (the plain version computes the same with exact
// rationals).
__global__ void util_kernel(Out out, Par p, Scr s) {
  __shared__ int cnt[32][256];
  __shared__ int pick[2];
  __shared__ int red[32];
  const int qi = blockIdx.x / p.R, r = blockIdx.x % p.R;
  const double* x = s.pct + (size_t)r * p.N;
  int c = 0;
  for (int n = threadIdx.x; n < p.N; n += blockDim.x) c += x[n] == x[n];
  int count;
  koord_radix::block_excl_scan<int>(c, red, &count);
  const double pcts[3] = {50.0, 90.0, 99.0};
  const double counts = (double)count;
  const double last = __dsub_rn(counts, 1.0);
  const double q = __dmul_rn(__ddiv_rn(pcts[qi], 100.0), last);
  double lo = floor(q), hi = ceil(q);
  const double hw = __dsub_rn(q, lo);
  const double lw = __dsub_rn(1.0, hw);
  lo = lo < last ? lo : last;
  lo = lo > 0.0 ? lo : 0.0;
  hi = hi < last ? hi : last;
  hi = hi > 0.0 ? hi : 0.0;
  const double vlo = select_kth(x, p.N, (int)lo, cnt, pick);
  const double vhi = select_kth(x, p.N, (int)hi, cnt, pick);
  if (threadIdx.x == 0) out.util[qi * p.R + r] = __fma_rn(vhi, hw, __dmul_rn(vlo, lw));
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

cudaError_t run(const In& in, const Out& out, const Par& p, unsigned char* scratch,
                cudaStream_t st) {
  const Scr s = carve(scratch, p.N, p.Pc, p.R);
  cudaError_t e = cudaMemsetAsync(s.ctl, 0, sizeof(Ctl), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(s.reset_mid, 0, p.N, st);
  if (e != cudaSuccess) return e;
  nodes_kernel<<<blocks(p.N), kThreads, 0, st>>>(in, p, s);
  thresholds_kernel<<<1, 32, 0, st>>>(in, p, s);
  classify_kernel<<<blocks(p.N), kThreads, 0, st>>>(in, out, p, s);
  const int* perm;
  LexKey node_key{s.nscore, 8, koord_radix::KEY_NEG_SIGNED, 64};
  if ((e = koord_radix::lexsort(&node_key, 1, p.N, s.rb, &perm, st)) != cudaSuccess) return e;
  node_rank_kernel<<<blocks(p.N), kThreads, 0, st>>>(perm, p.N, s.node_rank);
  pods_kernel<<<blocks(p.Pc), kThreads, 0, st>>>(in, p, s);
  int rank_bits = 0;
  while (rank_bits < 31 && ((p.N - 1) >> rank_bits) != 0) ++rank_bits;
  const long long* scores[2] = {s.pscore_w, s.pscore};
  int* orders[2] = {s.order1, s.order2};
  for (int i = 0; i < 2; ++i) {
    LexKey keys[2] = {{scores[i], 8, koord_radix::KEY_NEG_SIGNED, 64},
                      {s.nrk, 4, koord_radix::KEY_UNSIGNED, rank_bits}};
    if ((e = koord_radix::lexsort(keys, 2, p.Pc, s.rb, &perm, st)) != cudaSuccess) return e;
    if ((e = cudaMemcpyAsync(orders[i], perm, 4 * (size_t)p.Pc, cudaMemcpyDeviceToDevice, st)) !=
        cudaSuccess)
      return e;
  }
  const int gp = blocks(p.Pc);
  const unsigned char kFail = 1, kPrefix = 4, kEvicted = 8;
  seg_start_kernel<<<gp, kThreads, 0, st>>>(in, s.order1, p, s.start1);
  active_kernel<<<gp, kThreads, 0, st>>>(in, out, p, s);
  scan(p.Pc, p.R, UsageOfActive{in, s.order1, s.flags, p.R}, s.tile_sums, s.scan, st);
  fail_kernel<<<gp, kThreads, 0, st>>>(in, p, s);
  scan(p.Pc, 1, FlagCount{s.flags, kFail, 0}, s.tile_sums, s.scan, st);
  prefix_kernel<<<gp, kThreads, 0, st>>>(in, p, s);
  scan(p.Pc, p.R, UsageOfPrefix{in, s.order1, s.flags, p.R}, s.tile_sums, s.scan, st);
  headroom_kernel<<<gp, kThreads, 0, st>>>(in, p, s);
  scan(p.Pc, 1, FlagCount{s.flags, kPrefix, kEvicted}, s.tile_sums, s.scan, st);
  reset_mid_kernel<<<gp, kThreads, 0, st>>>(in, p, s);
  state_kernel<<<blocks(p.N), kThreads, 0, st>>>(out, p, s);
  seg_start_kernel<<<gp, kThreads, 0, st>>>(in, s.order2, p, s.start2);
  scan(p.Pc, 1, Evicted{s.order2, s.evsel}, s.tile_sums, s.scan, st);
  budget_kernel<<<gp, kThreads, 0, st>>>(in, out, p, s);
  scan(p.Pc, 1, FlagCount{s.keep, 1, 0}, s.tile_sums, s.scan, st);
  total_kernel<<<gp, kThreads, 0, st>>>(out, p, s);
  util_kernel<<<3 * p.R, kSelectThreads, 0, st>>>(out, p, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" long long koord_desched_scratch_bytes(long long N, long long Pc, long long R) {
  return (long long)scratch_bytes(N, Pc, R);
}

// ins: anomaly, ab, norm, usage, alloc, unschedulable, valid, pod node,
// pod usage, removable, low pct, high pct, weights.  outs: anomaly, ab,
// norm, evicted, rank, under, over, source, util.  params: N, Pc, R,
// use_deviation, consecutive abnormalities, consecutive normalities,
// number_of_nodes, per-node cap, total cap.
extern "C" int koord_deschedule_round(const void* const* ins, void* const* outs,
                                      const long long* params, void* scratch, int device,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  In in{(const bool*)ins[0], (const long long*)ins[1], (const long long*)ins[2],
        (const long long*)ins[3], (const long long*)ins[4], (const bool*)ins[5],
        (const bool*)ins[6], (const int*)ins[7], (const long long*)ins[8], (const bool*)ins[9],
        (const double*)ins[10], (const double*)ins[11], (const long long*)ins[12]};
  Out out{(bool*)outs[0], (long long*)outs[1], (long long*)outs[2], (bool*)outs[3],
          (long long*)outs[4], (bool*)outs[5], (bool*)outs[6], (bool*)outs[7],
          (double*)outs[8]};
  Par p{(int)params[0], (int)params[1], (int)params[2], (int)params[3], params[4], params[5],
        params[6], params[7], params[8]};
  if (p.N <= 0 || p.Pc <= 0 || p.R <= 0 || p.R > kMaxR) return (int)cudaErrorInvalidValue;
  return (int)run(in, out, p, (unsigned char*)scratch, (cudaStream_t)stream);
}
