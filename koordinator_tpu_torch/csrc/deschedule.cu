// One LowNodeLoad descheduling round for one node pool, as one cooperative
// launch on the caller's stream (the "deschedule_round" kernel).
//
// Replaces the JAX package's jax.jit program `deschedule_round`
// (koordinator_tpu/core/deschedule.py:144-221, `_deschedule_round`):
// thresholds (float64 -> int64 truncation, the deviation mean), classify,
// the anomaly debounce, the reference's gates, the vectorised eviction walk
// (core/lownodeload.py:173-295), the total eviction rank, the per-node and
// total budget masks, and p50/p90/p99 of the node usage percent.
//
// What bounds it on an H100: latency.  At 10,000 nodes x 32,768 candidates
// the inputs and outputs are ~1.7 MB (well under a microsecond of memory
// time), but the round is a chain of dependent steps: the node order, the
// two candidate orders, then six running sums of the walk, each reading
// what the one before wrote anywhere in the pool.  Launched as ~100
// kernels it was host-bound (the enqueue took longer than the device) and
// each step paid a launch.  The design:
//   - one cooperative launch of G main blocks of kThreads threads (G from
//     the larger axis, cuda.desched_grid) and U = 6R (+1 in deviation mode)
//     side blocks, co-resident; each dependent step ends in a grid barrier
//     over the main blocks (one arrival count and one generation word,
//     zeroed with the rest of Ctl before the launch), and cross-block
//     state is read through L2 (ld.global.cg), never from a stale L1 line;
//   - the side blocks join the first barrier only (the node percents are
//     then complete) and work beside the main blocks: one radix select of
//     one order statistic each (two make a percentile, the second to
//     finish interpolates), and in deviation mode the thresholds' mean,
//     summed in node order, one node after the other (the Go loop's
//     order, bit for bit), from the percents staged in shared memory; the
//     main blocks wait for its release word only when they classify;
//   - the orders are stable LSD radix sorts of the mapped 64-bit keys (the
//     np.lexsort order, -0.0 tying 0.0 and NaN last, as radix.cuh maps
//     them), less their minimum: subtracting the least key keeps the order
//     and leaves every digit above the keys' spread zero, so those passes
//     are never run; a pass whose digit is one value for every key (its
//     histogram says so) is skipped too, since a stable pass over a
//     constant digit is the identity.  The candidate orders' two keys
//     (node rank major, score minor) become one composite key when their
//     widths fit 64 bits, else two stages.  The scores are not assumed to
//     lie in a range;
//   - a pass is one phase: each block finds its offsets from every tile's
//     digit counts and places its tile stably (warp by warp, lanes by
//     __match_any_sync rank), counting each key's next digit into the
//     tile it lands in (atomics, one a warp's run of equal digit and
//     tile), so the next pass's counts are ready after the barrier; the
//     first pass's counts come with the key build; the two candidate
//     orders share their phases;
//   - each running sum of the walk is one phase: every block writes its
//     tile's exclusive sums and its tile total, and after the barrier any
//     block reads the sum at any position as the totals of the tiles before
//     it plus the position's own; a node's candidates are contiguous in
//     both orders, so a segmented sum is the sum at a position less the sum
//     at the node's first position.  Integer sums are exact in any order.
// What is left (PERF.md §6): 16 phases of 6 to 20 µs at bench_sim's shape,
// each a grid barrier and a few dependent L2 round trips; the candidate
// orders' passes are the largest.
// Every ordering stays exact and every float sum in its stated order; no
// FMA is contracted by the compiler: the thresholds multiply with __dmul_rn
// and the percentiles' one fused multiply-add is written out (__fma_rn),
// where the reference's own compiled program has it.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

using koord_radix::u64;

namespace {

constexpr int kThreads = 1024;  // a block of the launch, main or side
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;
constexpr int kMaxG = 132;  // main blocks at most (one an SM)
constexpr long long kWaitTimeout = 20000000000LL;  // SM cycles (~10 s): a fault, not a wait

// The launch's control words, zeroed on the stream before the launch.
struct Ctl {
  unsigned bar_count, bar_gen;  // the main blocks' grid barrier
  unsigned thr_flag;            // deviation mode: the thresholds released (the barrier's gen)
  unsigned pad;
  unsigned sel_done[3 * kMaxR];  // order statistics published of each percentile
  double lo[kMaxR], hi[kMaxR];   // deviation mode: the thresholds
  double sel_val[3 * kMaxR][2];  // the two order statistics of each percentile
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
  int G, U;  // main and side blocks
};

// Per-block partial results, summed by every block after the barrier.
struct NodePart {
  long long nvalid;
  u64 kmin, kmax;  // the mapped node keys
};
struct ClassPart {
  long long nsource, nunder;
  u64 avail0[kMaxR];
};
struct PodPart {
  u64 kmin[2], kmax[2];  // the mapped walk and eviction scores
};

// One radix sort's buffers: keys and payload twice (ping-pong), and the
// digit counts of every tile three times ([256][G] each: the pass's own,
// the next pass's being counted, and the one after being zeroed).
struct SortBufs {
  u64* k[2];
  int* v[2];
  int* hist[3];
};

struct Scr {
  Ctl* ctl;
  NodePart* npart;   // [G]
  ClassPart* cpart;  // [G]
  PodPart* ppart;    // [G]
  double* pct;       // [R, N]
  long long* nscore;  // [N]
  long long* high_q;  // [N, R]
  unsigned char* over_bits;  // [N]
  unsigned char* reset_mid;  // [N]
  int* node_rank;            // [N]
  long long* pscore_w;       // [Pc]
  long long* pscore;         // [Pc]
  int* nrk;                  // [Pc]
  unsigned char* flags;      // [Pc] walk order
  unsigned char* evsel;      // [Pc] by candidate
  unsigned char* keep;       // [Pc] eviction order
  int* start1;               // [N] a node's first position in the walk order
  int* start2;               // [N] ... in the eviction order
  u64* loc[2];               // [Pc, R] a tile's exclusive sums
  u64* sums[2];              // [G, R] the tiles' totals
  SortBufs ns;               // the node order, [N]
  SortBufs cs[2];            // the walk and eviction orders, [Pc]
};

using koord_radix::align256;

struct Carver {
  unsigned char* p;
  size_t used;
  unsigned char* take(size_t bytes) {
    unsigned char* q = p ? p + used : nullptr;
    used += align256(bytes);
    return q;
  }
};

SortBufs carve_sort(Carver& c, long long n, int G) {
  SortBufs s;
  for (int i = 0; i < 2; ++i) s.k[i] = (u64*)c.take(8 * n);
  for (int i = 0; i < 2; ++i) s.v[i] = (int*)c.take(4 * n);
  for (int i = 0; i < 3; ++i) s.hist[i] = (int*)c.take(4 * 256 * (size_t)G);
  return s;
}

// Carves the scratch from `p` (nullptr: only counts its bytes).
Scr carve(unsigned char* p, long long N, long long Pc, long long R, int G, size_t* bytes) {
  Carver c{p, 0};
  Scr s;
  s.ctl = (Ctl*)c.take(sizeof(Ctl));
  s.npart = (NodePart*)c.take(sizeof(NodePart) * G);
  s.cpart = (ClassPart*)c.take(sizeof(ClassPart) * G);
  s.ppart = (PodPart*)c.take(sizeof(PodPart) * G);
  s.pct = (double*)c.take(8 * R * N);
  s.nscore = (long long*)c.take(8 * N);
  s.high_q = (long long*)c.take(8 * N * R);
  s.over_bits = c.take(N);
  s.reset_mid = c.take(N);
  s.node_rank = (int*)c.take(4 * N);
  s.pscore_w = (long long*)c.take(8 * Pc);
  s.pscore = (long long*)c.take(8 * Pc);
  s.nrk = (int*)c.take(4 * Pc);
  s.flags = c.take(Pc);
  s.evsel = c.take(Pc);
  s.keep = c.take(Pc);
  s.start1 = (int*)c.take(4 * N);
  s.start2 = (int*)c.take(4 * N);
  for (int i = 0; i < 2; ++i) s.loc[i] = (u64*)c.take(8 * Pc * R);
  for (int i = 0; i < 2; ++i) s.sums[i] = (u64*)c.take(8 * (size_t)G * R);
  s.ns = carve_sort(c, N, G);
  for (int i = 0; i < 2; ++i) s.cs[i] = carve_sort(c, Pc, G);
  if (bytes) *bytes = c.used;
  return s;
}

// ------------------------------------------------------------ the arithmetic

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

// the negated int64, mapped to an unsigned key of the same order (wrapping,
// as int64 does: radix.cuh KEY_NEG_SIGNED)
__device__ __forceinline__ u64 neg_key(long long x) {
  return (0ULL - (u64)x) ^ 0x8000000000000000ULL;
}

__device__ __forceinline__ int bit_length(u64 x) { return x ? 64 - __clzll((long long)x) : 0; }

// ------------------------------------------------------------ the protocol

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ bool ldb(const bool* p) {
  return __ldcg((const unsigned char*)p) != 0;
}

#ifdef KOORD_DESCHED_STUDY
// The study build (csrc/deschedstudy.cu) records block 0's SM clock and
// the global nanosecond timer at its start and after each of its grid
// barriers (slots 0..59 of each, the count in slot 60 of the first), and
// the timer when the first side block and the thresholds' block end
// (slots 61 and 62 of the second), for koord_desched_split.
__device__ unsigned long long g_desched_split[2][64];
__device__ unsigned long long g_desched_steps[16];  // the first scatter's steps, block 0
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mark_split(bool first) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long k = first ? 0 : g_desched_split[0][60];
    if (k < 60) {
      g_desched_split[0][k] = clock64();
      g_desched_split[1][k] = global_ns();
    }
    g_desched_split[0][60] = k + 1;
  }
}
__device__ __forceinline__ void mark_side(int slot) {
  if (threadIdx.x == 0) g_desched_split[1][slot] = global_ns();
}
// block 0's SM clock at step `k` of its first scatter (slot 15 counts the
// scatters it began)
__device__ __forceinline__ void mark_step(int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (k == 0) ++g_desched_steps[15];
    if (g_desched_steps[15] == 1) g_desched_steps[k] = clock64();
  }
}
#else
__device__ __forceinline__ void mark_split(bool) {}
__device__ __forceinline__ void mark_side(int) {}
__device__ __forceinline__ void mark_step(int) {}
#endif

// A grid barrier over `expected` co-resident blocks: thread 0 of each
// reads the generation, arrives (a fence, then an atomic add); the last
// to arrive resets the count and releases the next generation, the others
// wait for it.  Returns the new generation.
__device__ unsigned grid_barrier(Ctl* ctl, unsigned expected, unsigned* s_gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(&ctl->bar_gen);
    __threadfence();
    if (atomicAdd(&ctl->bar_count, 1u) == expected - 1) {
      atomicExch(&ctl->bar_count, 0u);
      __threadfence();
      st_release(&ctl->bar_gen, g + 1);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(&ctl->bar_gen) == g)
        if (clock64() - t0 > kWaitTimeout) __trap();
    }
    __threadfence();
    *s_gen = g + 1;
  }
  mark_split(false);
  __syncthreads();
  return *s_gen;
}

// [lo, hi): block b's tile of an axis of n over G blocks, or a thread's
// contiguous run of its block's tile
struct Span {
  int lo, hi;
};

__device__ __forceinline__ int tile_size(int n, int G) { return (n + G - 1) / G; }

__device__ __forceinline__ Span tile_of(int n, int G, int b) {
  const int t = tile_size(n, G);
  const long long lo = (long long)b * t;
  const int l = lo < n ? (int)lo : n;
  return {l, l + t < n ? l + t : n};
}

__device__ __forceinline__ Span run_of(Span t) {
  const int per = (t.hi - t.lo + kThreads - 1) / kThreads;
  const long long lo = t.lo + (long long)threadIdx.x * per;
  const int l = lo < t.hi ? (int)lo : t.hi;
  return {l, l + per < t.hi ? l + per : t.hi};
}

// block-wide minimum and maximum (every thread calls it; thread 0 gets them)
__device__ void block_minmax(u64& mn, u64& mx, u64* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(0xffffffffu, mn, o), b = __shfl_xor_sync(0xffffffffu, mx, o);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) {
    smem[warp] = mn;
    smem[32 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = smem[lane];
    mx = smem[32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 a = __shfl_xor_sync(0xffffffffu, mn, o), b = __shfl_xor_sync(0xffffffffu, mx, o);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
  }
  __syncthreads();
}

// the block's sum (every thread calls it; every thread gets it)
__device__ __forceinline__ u64 block_sum(u64 v, u64* smem) {
  u64 total;
  koord_radix::block_excl_scan<u64>(v, smem, &total);
  return total;
}

// ------------------------------------------------------------ the sorts

// How a sort's key is built at a position: the mapped score less its
// minimum, below the node rank when composite, or the node rank of the
// position's payload (a second stage).
enum KeyKind : int { KEY_SCORE = 0, KEY_COMPOSITE = 1, KEY_RANK = 2 };

struct Stage {
  int kind, width;  // width: the key's significant bits (0: no pass)
  const long long* score;
  u64 min;
  int sb;  // KEY_COMPOSITE: the score's bits below the rank
};

// One sort's plan and state, the same in every block.
struct Sort {
  SortBufs b;
  int n;
  Stage st[2];
  int nst;
  int stage, shift, cur, h, phase;  // h: the counts the next scatter reads
};

enum : int { PH_BUILD = 0, PH_SCATTER = 1, PH_DONE = 2 };

struct Shared {
  alignas(16) int wcnt[kWarps][256];  // the scatter's counts by warp; the select's
  int cnt[256];
  int base[256];
  int flag;
  unsigned gen;
  u64 red[64];
  u64 off[kMaxG * kMaxR];  // the tiles' offsets of a running sum
  // the round's scalars, summed from the partials
  long long nvalid, nsource, nunder;
  u64 nkmin, nkmax, avail0[kMaxR];
  u64 pkmin[2], pkmax[2];
  double lo[kMaxR], hi[kMaxR];
  int red_i[32];
};

__device__ __forceinline__ u64 build_key(const Stage& s, const int* nrk, int pos, int pay) {
  if (s.kind == KEY_RANK) return (u64)__ldcg(&nrk[pay]);
  const u64 k = neg_key(__ldcg(&s.score[pos])) - s.min;
  if (s.kind == KEY_COMPOSITE) return ((u64)__ldcg(&nrk[pos]) << s.sb) | k;
  return k;
}

// this block's tile's digit counts at `shift` into column b of `hist`
__device__ void count_tile(const Sort& S, int shift, int* hist, Shared& sh, int G, int b) {
  const Span t = tile_of(S.n, G, b);
  if (threadIdx.x < 256) sh.cnt[threadIdx.x] = 0;
  __syncthreads();
  for (int i = t.lo + threadIdx.x; i < t.hi; i += kThreads)
    atomicAdd(&sh.cnt[(__ldcg(&S.b.k[S.cur][i]) >> shift) & 255], 1);
  __syncthreads();
  if (threadIdx.x < 256) hist[threadIdx.x * G + b] = sh.cnt[threadIdx.x];
  __syncthreads();
}

// block b's share of zeroing a [256][G] count buffer
__device__ __forceinline__ void zero_counts(int* hist, int b) {
  if (threadIdx.x < 256) hist[b * 256 + threadIdx.x] = 0;
}

// The stable scatter of this block's tile by the digit at `shift`, or
// nothing when one digit holds every key (returns whether it scattered;
// every block decides alike from the same counts).  With `next` (the next
// pass's counts, zeroed), each key's digit at shift + 8 is counted into
// the tile its position falls in.
__device__ bool scatter_tile(const Sort& S, int* next, Shared& sh, int G, int b) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  mark_step(0);
  // every tile's count of each digit: a warp takes 8 digits, its lanes a
  // digit's counts of 32 tiles at a time (one coalesced load), folded by
  // warp reductions into the warps' counts' space, not yet in use
  {
    constexpr int kPer = 256 / kWarps;
    const int* hist = S.b.hist[S.h];
    unsigned tot[kPer], bef[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // the first 32 tiles: every load in flight at once
      const unsigned c =
          lane < G ? (unsigned)__ldcg(&hist[(size_t)(warp + k * kWarps) * G + lane]) : 0u;
      tot[k] = c;
      bef[k] = lane < b ? c : 0u;
    }
    for (int j = lane + 32; j < G; j += 32)  // more than 32 tiles
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const unsigned c = (unsigned)__ldcg(&hist[(size_t)(warp + k * kWarps) * G + j]);
        tot[k] += c;
        bef[k] += j < b ? c : 0u;
      }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const unsigned a = __reduce_add_sync(0xffffffffu, tot[k]);
      const unsigned e = __reduce_add_sync(0xffffffffu, bef[k]);
      if (lane == 0) {
        sh.wcnt[0][warp + k * kWarps] = (int)a;
        sh.wcnt[1][warp + k * kWarps] = (int)e;
      }
    }
  }
  if (t == 0) sh.flag = 0;
  __syncthreads();
  int total = 0, before = 0;
  if (t < 256) {
    total = sh.wcnt[0][t];
    before = sh.wcnt[1][t];
    if (total == S.n) sh.flag = 1;
  }
  mark_step(1);
  int all;
  const int excl = koord_radix::block_excl_scan<int>(t < 256 ? total : 0, sh.red_i, &all);
  if (t < 256) sh.base[t] = excl + before;
  __syncthreads();
  mark_step(2);
  if (sh.flag) return false;
  const Span tile = tile_of(S.n, G, b);
  const int ts = tile_size(S.n, G);
  const u64* kin = S.b.k[S.cur];
  const int* vin = S.b.v[S.cur];
  u64* kout = S.b.k[1 - S.cur];
  int* vout = S.b.v[1 - S.cur];
  const unsigned lt = (1u << lane) - 1u;
  for (int c0 = tile.lo; c0 < tile.hi; c0 += kThreads) {
    const int i = c0 + t;
    const bool ok = i < tile.hi;
    const u64 key = ok ? __ldcg(&kin[i]) : 0ULL;
    const int val = ok ? __ldcg(&vin[i]) : 0;
    const int d = ok ? (int)((key >> S.shift) & 255) : 256;  // 256: no element
    for (int x = t; x < kWarps * 256 / 4; x += kThreads)
      reinterpret_cast<int4*>(&sh.wcnt[0][0])[x] = make_int4(0, 0, 0, 0);
    __syncthreads();
    mark_step(3);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt);
    if (ok && rank == 0) sh.wcnt[warp][d] = __popc(peers);
    __syncthreads();
    mark_step(4);
    int run = 0;
    if (t < 256)
      for (int w = 0; w < kWarps; ++w) {
        const int x = sh.wcnt[w][t];
        sh.wcnt[w][t] = run;
        run += x;
      }
    __syncthreads();
    mark_step(5);
    const int pos = ok ? sh.base[d] + sh.wcnt[warp][d] + rank : 0;
    if (ok) {
      kout[pos] = key;
      vout[pos] = val;
    }
    if (next) {
      // (next digit, landing tile), 256 * G for no element
      const int slot = ok ? (int)((key >> (S.shift + 8)) & 255) * G + pos / ts : 256 * G;
      const unsigned same = __match_any_sync(0xffffffffu, slot);
      if (ok && (same & lt) == 0) atomicAdd(&next[slot], __popc(same));
    }
    __syncthreads();
    mark_step(6);
    if (t < 256) sh.base[t] += run;
    __syncthreads();
  }
  mark_step(7);
  return true;
}

// One phase of a sort (the key build with the first pass's counts, or a
// pass); the caller's grid barrier follows every phase.  The three count
// buffers rotate: a pass reads hist[h], counts the next pass into
// hist[h + 1] (zeroed in the phase before) and zeroes hist[h + 2], last
// read in the phase before.
__device__ void sort_step(Sort& S, const int* nrk, Shared& sh, int G, int b) {
  if (S.phase == PH_DONE) return;
  if (S.phase == PH_BUILD) {
    const Stage& st = S.st[S.stage];
    const Span t = tile_of(S.n, G, b);
    if (threadIdx.x < 256) sh.cnt[threadIdx.x] = 0;
    __syncthreads();
    for (int i = t.lo + threadIdx.x; i < t.hi; i += kThreads) {
      const int pay = S.stage == 0 ? i : __ldcg(&S.b.v[S.cur][i]);
      const u64 key = build_key(st, nrk, i, pay);
      S.b.k[S.cur][i] = key;
      if (S.stage == 0) S.b.v[S.cur][i] = i;
      atomicAdd(&sh.cnt[key & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x < 256) S.b.hist[S.h][threadIdx.x * G + b] = sh.cnt[threadIdx.x];
    zero_counts(S.b.hist[(S.h + 1) % 3], b);
    __syncthreads();
    S.shift = 0;
    if (st.width > 0) {
      S.phase = PH_SCATTER;
    } else if (++S.stage >= S.nst) {
      S.phase = PH_DONE;
    }
    return;
  }
  // PH_SCATTER
  const bool more = S.shift + 8 < S.st[S.stage].width;
  int* next = S.b.hist[(S.h + 1) % 3];
  const bool moved = scatter_tile(S, more ? next : nullptr, sh, G, b);
  if (moved) {
    S.cur = 1 - S.cur;
  } else if (more) {
    count_tile(S, S.shift + 8, next, sh, G, b);  // the keys did not move: count in place
  }
  zero_counts(S.b.hist[(S.h + 2) % 3], b);
  __syncthreads();
  S.h = (S.h + 1) % 3;
  S.shift += 8;
  if (!more) S.phase = ++S.stage < S.nst ? PH_BUILD : PH_DONE;
}

__device__ Sort make_sort(SortBufs bufs, int n) {
  Sort S;
  S.b = bufs;
  S.n = n;
  S.nst = 1;
  S.stage = S.shift = S.cur = S.h = 0;
  S.phase = PH_BUILD;
  return S;
}

// ------------------------------------------------------------ the running sums

// This block's tile of a running sum over positions in `run` (each thread a
// contiguous run), L lanes: each position's exclusive sum within the tile
// into loc, the tile's total into sums[b].
template <class Val>
__device__ void tile_sums(Span run, int L, int b, Val val, u64* loc, u64* sums, u64* smem) {
  for (int r = 0; r < L; ++r) {
    u64 sum = 0;
    for (int q = run.lo; q < run.hi; ++q) sum += val(q, r);
    u64 total;
    u64 pre = koord_radix::block_excl_scan<u64>(sum, smem, &total);
    for (int q = run.lo; q < run.hi; ++q) {
      loc[(size_t)q * L + r] = pre;
      pre += val(q, r);
    }
    if (threadIdx.x == 0) sums[(size_t)b * L + r] = total;
  }
}

// the exclusive sum of the tiles before each tile, into sh.off ([G, L])
__device__ void tile_offsets(const u64* sums, int L, int G, Shared& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < L) {
    u64 carry = 0;
    for (int b0 = 0; b0 < G; b0 += 32) {
      const int b = b0 + lane;
      const u64 x = b < G ? __ldcg(&sums[(size_t)b * L + warp]) : 0ULL;
      u64 inc = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      if (b < G) sh.off[b * L + warp] = carry + inc - x;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
}

// the running sum at position x (lane r)
__device__ __forceinline__ u64 sum_at(const u64* loc, const Shared& sh, int L, int ts, int x,
                                      int r) {
  return sh.off[(x / ts) * L + r] + __ldcg(&loc[(size_t)x * L + r]);
}

__device__ __forceinline__ int node_at(const In& in, const int* order, int q, int N) {
  int n = in.p_node[__ldcg(&order[q])];
  return n < 0 ? 0 : (n >= N ? N - 1 : n);
}

// ------------------------------------------------------------ the side blocks

// The k-th smallest (0-based) of the N float64 keys under f64_key's total
// order, by 8-bit radix select over the block: each warp counts the digits
// of its keys in a histogram of its own, the block sums them, and the one
// digit whose running count holds rank k extends the prefix.
__device__ double select_kth(const double* x, int N, int k, Shared& sh) {
  const int t = threadIdx.x, warp = t >> 5;
  u64 prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = t; i < kWarps * 256; i += kThreads) (&sh.wcnt[0][0])[i] = 0;
    __syncthreads();
    for (int n = t; n < N; n += kThreads) {
      const u64 key = koord_radix::f64_key(__ldcg(&x[n]));
      if ((key & mask) == prefix) atomicAdd(&sh.wcnt[warp][(key >> shift) & 255], 1);
    }
    __syncthreads();
    int c = 0;
    if (t < 256)
      for (int w = 0; w < kWarps; ++w) c += sh.wcnt[w][t];
    int all;
    const int before = koord_radix::block_excl_scan<int>(c, sh.red_i, &all);
    if (t < 256 && k >= before && k < before + c) {
      sh.base[0] = t;
      sh.base[1] = k - before;
    }
    __syncthreads();
    prefix |= (u64)sh.base[0] << shift;
    mask |= 255ULL << shift;
    k = sh.base[1];
    __syncthreads();
  }
  return koord_radix::f64_of_key(prefix);
}

// jnp.nanpercentile(pct, [50, 90, 99], axis=0) as JAX's _quantile computes
// it (linear): q = p / 100 * (count - 1) over the non-NaN values, the floor
// and ceil order statistics, low * (1 - w) + high * w, rounded as XLA on the
// CPU rounds it: fma(high, w, low * (1 - w)), one product rounded, then one
// fused multiply-add (the plain version computes the same with exact
// rationals).  Side block u selects one of the two order statistics of
// percentile u / (2R) of resource (u / 2) % R; the second of the two to
// publish interpolates.
__device__ void percentile_block(const Out& out, const Par& p, const Scr& s, int u, Shared& sh) {
  const int qi = u / (2 * p.R), r = (u / 2) % p.R, which = u % 2;
  const double* x = s.pct + (size_t)r * p.N;
  int c = 0;
  for (int n = threadIdx.x; n < p.N; n += kThreads) {
    const double v = __ldcg(&x[n]);
    c += v == v;
  }
  int count;
  koord_radix::block_excl_scan<int>(c, sh.red_i, &count);
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
  const double v = select_kth(x, p.N, (int)(which ? hi : lo), sh);
  if (threadIdx.x == 0) {
    const int slot = qi * p.R + r;
    s.ctl->sel_val[slot][which] = v;
    __threadfence();
    if (atomicAdd(&s.ctl->sel_done[slot], 1u) == 1u) {
      __threadfence();
      const double vlo = __ldcg(&s.ctl->sel_val[slot][0]);
      const double vhi = __ldcg(&s.ctl->sel_val[slot][1]);
      out.util[slot] = __fma_rn(vhi, hw, __dmul_rn(vlo, lw));
    }
  }
}

// Deviation mode: the thresholds from the mean usage percent, summed in
// node order, one node after the other (the order of the reference's Go
// loop and of the plain version); a node that does not count adds +0.0
// (the sum is never -0.0, so that changes nothing).  The percents are
// staged in shared memory a chunk at a time, so the dependent adds wait
// on no load from L2; one warp a resource.  Released to the main blocks
// with `gen`.
constexpr int kThrStage = kWarps * 256 * 4 / 8;  // doubles the staging holds

__device__ void thresholds_block(const In& in, const Par& p, const Scr& s, unsigned gen,
                                 Shared& sh) {
  long long nv = 0;
  for (int b = threadIdx.x; b < p.G; b += kThreads) nv += __ldcg(&s.npart[b].nvalid);
  const long long nvalid = (long long)block_sum((u64)nv, sh.red);
  double* stage = (double*)&sh.wcnt[0][0];  // [R][chunk]
  const int chunk = kThrStage / p.R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double sum = 0.0;
  for (int n0 = 0; n0 < p.N; n0 += chunk) {
    const int m = p.N - n0 < chunk ? p.N - n0 : chunk;
    for (int i = threadIdx.x; i < p.R * chunk; i += kThreads) {
      const int r = i / chunk, j = i % chunk;
      if (j < m) stage[i] = __ldcg(&s.pct[(size_t)r * p.N + n0 + j]);
    }
    __syncthreads();
    if (warp < p.R && lane == 0) {
      const double* x = stage + (size_t)warp * chunk;
#pragma unroll 16
      for (int j = 0; j < m; ++j) {
        const double v = x[j];
        sum = __dadd_rn(sum, v == v ? v : 0.0);
      }
    }
    __syncthreads();
  }
  if (warp < p.R && lane == 0) {
    const int r = warp;
    const long long nv1 = nvalid > 1 ? nvalid : 1;
    const double avg = __ddiv_rn(sum, (double)nv1);
    double lo, hi;
    if (in.low_pct[r] == 0.0) {
      lo = hi = 100.0;
    } else {
      lo = clamp_pct(__dsub_rn(avg, in.low_pct[r]));
      hi = clamp_pct(__dadd_rn(avg, in.high_pct[r]));
    }
    s.ctl->lo[r] = lo;
    s.ctl->hi[r] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(&s.ctl->thr_flag, gen);
  }
}

// ------------------------------------------------------------ the walk's values

struct UsageOfActive {  // [R] usage of the active candidates
  const In in;
  const int* order;
  const unsigned char* flags;
  int R;
  __device__ u64 operator()(int q, int r) const {
    return (__ldcg(&flags[q]) & 16) ? (u64)in.p_usage[(size_t)__ldcg(&order[q]) * R + r] : 0ULL;
  }
};

struct UsageOfPrefix {  // [R] usage of the prefix evictions
  const In in;
  const int* order;
  const unsigned char* flags;
  int R;
  __device__ u64 operator()(int q, int r) const {
    return (__ldcg(&flags[q]) & 4) ? (u64)in.p_usage[(size_t)__ldcg(&order[q]) * R + r] : 0ULL;
  }
};

struct FlagCount {  // 1 where every bit of `all` and no bit of `none` is set
  const unsigned char* flags;
  unsigned char all, none;
  __device__ u64 operator()(int q, int) const {
    const unsigned char f = __ldcg(&flags[q]);
    return (f & all) == all && !(f & none);
  }
};

struct Evicted {  // the walk's evictions, by eviction order
  const int* order;
  const unsigned char* evsel;
  __device__ u64 operator()(int q, int) const {
    return __ldcg(&evsel[__ldcg(&order[q])]);
  }
};

__device__ __forceinline__ bool proceed(const Shared& sh, const Par& p) {
  const bool reach = sh.nsource > 0 && sh.nunder > 0;
  return reach && sh.nunder > p.number_of_nodes && sh.nunder < p.N;
}

// ------------------------------------------------------------ the round

__global__ void __launch_bounds__(kThreads, 1) round_kernel(In in, Out out, Par p, Scr s) {
  __shared__ Shared sh;
  const int G = p.G, b = blockIdx.x, t = threadIdx.x;
  const unsigned everyone = (unsigned)(G + p.U);
  if (b >= G) {  // a side block: after the node percents, its own work
    const unsigned gen = grid_barrier(s.ctl, everyone, &sh.gen);
    const int u = b - G;
    if (u < 6 * p.R) {
      percentile_block(out, p, s, u, sh);
      if (u == 0) mark_side(61);
    } else {
      thresholds_block(in, p, s, gen, sh);
      mark_side(62);
    }
    return;
  }
  mark_split(true);
  const int R = p.R, N = p.N, Pc = p.Pc;
  const int stride = G * kThreads;

  // 1. the nodes: usage percent, weighted usage score, the valid count and
  // the node keys' range
  {
    long long nv = 0;
    u64 mn = ~0ULL, mx = 0;
    for (int n = b * kThreads + t; n < N; n += stride) {
      const bool v = in.valid[n];
      for (int r = 0; r < R; ++r) {
        const long long a = in.alloc[(size_t)n * R + r];
        const long long us = in.usage[(size_t)n * R + r];
        s.pct[(size_t)r * N + n] =
            (v && a > 0) ? __ddiv_rn(__dmul_rn(100.0, (double)us), (double)a) : nan64();
      }
      const long long sc =
          usage_score(in.usage + (size_t)n * R, in.alloc + (size_t)n * R, in.weights, 0xFFu, R);
      s.nscore[n] = sc;
      s.reset_mid[n] = 0;
      const u64 k = neg_key(sc);
      mn = k < mn ? k : mn;
      mx = k > mx ? k : mx;
      nv += v;
    }
    const u64 total = block_sum((u64)nv, sh.red);
    block_minmax(mn, mx, sh.red);
    if (t == 0) s.npart[b] = NodePart{(long long)total, mn, mx};
  }
  const unsigned gen1 = grid_barrier(s.ctl, everyone, &sh.gen);

  // 2. the node order (-score, node) -> node_rank
  {
    long long nv = 0;
    u64 mn = ~0ULL, mx = 0;
    for (int j = t; j < G; j += kThreads) {
      const NodePart q{__ldcg(&s.npart[j].nvalid), __ldcg(&s.npart[j].kmin),
                       __ldcg(&s.npart[j].kmax)};
      nv += q.nvalid;
      mn = q.kmin < mn ? q.kmin : mn;
      mx = q.kmax > mx ? q.kmax : mx;
    }
    const u64 total = block_sum((u64)nv, sh.red);
    block_minmax(mn, mx, sh.red);
    if (t == 0) {
      sh.nvalid = (long long)total;
      sh.nkmin = mn;
      sh.nkmax = mx;
    }
    __syncthreads();
  }
  Sort ns = make_sort(s.ns, N);
  ns.st[0] = Stage{KEY_SCORE, bit_length(sh.nkmax - sh.nkmin), s.nscore, sh.nkmin, 0};
  while (ns.phase != PH_DONE) {
    sort_step(ns, s.nrk, sh, G, b);
    grid_barrier(s.ctl, G, &sh.gen);
  }

  // 3. node_rank; classify: the int64 thresholds, under/over, the
  // overused resources, Mark(false), the gate counters and the
  // destinations' headroom
  {
    const Span nt = tile_of(N, G, b);
    const int* perm = s.ns.v[ns.cur];
    for (int i = nt.lo + t; i < nt.hi; i += kThreads) s.node_rank[__ldcg(&perm[i])] = i;
    if (p.use_dev) {
      if (t == 0) {
        const long long t0 = clock64();
        while (ld_acquire(&s.ctl->thr_flag) != gen1)
          if (clock64() - t0 > kWaitTimeout) __trap();
        __threadfence();
      }
      __syncthreads();
      if (t < R) {
        sh.lo[t] = __ldcg(&s.ctl->lo[t]);
        sh.hi[t] = __ldcg(&s.ctl->hi[t]);
      }
    } else if (t < R) {
      sh.lo[t] = in.low_pct[t];
      sh.hi[t] = in.high_pct[t];
    }
    __syncthreads();
    long long nsrc = 0, nund = 0;
    u64 av[kMaxR];
    for (int r = 0; r < kMaxR; ++r) av[r] = 0;
    for (int n = b * kThreads + t; n < N; n += stride) {
      bool all_le = true, any_gt = false;
      unsigned ob = 0;
      for (int r = 0; r < R; ++r) {
        const double af = (double)in.alloc[(size_t)n * R + r];
        const long long u = in.usage[(size_t)n * R + r];
        const long long lq = (long long)__dmul_rn(__dmul_rn(sh.lo[r], 0.01), af);
        const long long hq = (long long)__dmul_rn(__dmul_rn(sh.hi[r], 0.01), af);
        s.high_q[(size_t)n * R + r] = hq;
        all_le = all_le && u <= lq;
        const bool gt = u > hq;
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
      nsrc += source;
      if (under) {
        ++nund;
        for (int r = 0; r < R; ++r)
          av[r] += (u64)s.high_q[(size_t)n * R + r] - (u64)in.usage[(size_t)n * R + r];
      }
    }
    const u64 a = block_sum((u64)nsrc, sh.red), c = block_sum((u64)nund, sh.red);
    if (t == 0) {
      s.cpart[b].nsource = (long long)a;
      s.cpart[b].nunder = (long long)c;
    }
    for (int r = 0; r < R; ++r) {
      const u64 x = block_sum(av[r], sh.red);
      if (t == 0) s.cpart[b].avail0[r] = x;
    }
  }
  grid_barrier(s.ctl, G, &sh.gen);

  // 4. the candidates: both scores, the node's rank, the scores' range
  const Span ct = tile_of(Pc, G, b);
  {
    long long nsrc = 0, nund = 0;
    for (int j = t; j < G; j += kThreads) {
      nsrc += __ldcg(&s.cpart[j].nsource);
      nund += __ldcg(&s.cpart[j].nunder);
    }
    const u64 a = block_sum((u64)nsrc, sh.red), c = block_sum((u64)nund, sh.red);
    for (int r = 0; r < R; ++r) {
      u64 x = 0;
      for (int j = t; j < G; j += kThreads) x += __ldcg(&s.cpart[j].avail0[r]);
      const u64 y = block_sum(x, sh.red);
      if (t == 0) sh.avail0[r] = y;
    }
    if (t == 0) {
      sh.nsource = (long long)a;
      sh.nunder = (long long)c;
    }
    u64 mn[2] = {~0ULL, ~0ULL}, mx[2] = {0, 0};
    for (int k = ct.lo + t; k < ct.hi; k += kThreads) {
      int n = in.p_node[k];
      n = n < 0 ? 0 : (n >= N ? N - 1 : n);
      const long long* pu = in.p_usage + (size_t)k * R;
      const long long* cap = in.alloc + (size_t)n * R;
      const long long sw = usage_score(pu, cap, in.weights, __ldcg(&s.over_bits[n]), R);
      const long long sa = usage_score(pu, cap, in.weights, 0xFFu, R);
      s.pscore_w[k] = sw;
      s.pscore[k] = sa;
      s.nrk[k] = __ldcg(&s.node_rank[n]);
      const u64 kw = neg_key(sw), ka = neg_key(sa);
      mn[0] = kw < mn[0] ? kw : mn[0];
      mx[0] = kw > mx[0] ? kw : mx[0];
      mn[1] = ka < mn[1] ? ka : mn[1];
      mx[1] = ka > mx[1] ? ka : mx[1];
    }
    for (int i = 0; i < 2; ++i) {
      block_minmax(mn[i], mx[i], sh.red);
      if (t == 0) {
        s.ppart[b].kmin[i] = mn[i];
        s.ppart[b].kmax[i] = mx[i];
      }
    }
  }
  grid_barrier(s.ctl, G, &sh.gen);

  // 5. the walk order (node_rank, -masked score, k) and the eviction order
  // (node_rank, -score, k), in shared phases
  int rank_bits = 0;
  while (rank_bits < 31 && ((N - 1) >> rank_bits) != 0) ++rank_bits;
  Sort cs[2] = {make_sort(s.cs[0], Pc), make_sort(s.cs[1], Pc)};
  for (int i = 0; i < 2; ++i) {
    u64 mn = ~0ULL, mx = 0;
    for (int j = t; j < G; j += kThreads) {
      const u64 a = __ldcg(&s.ppart[j].kmin[i]), c = __ldcg(&s.ppart[j].kmax[i]);
      mn = a < mn ? a : mn;
      mx = c > mx ? c : mx;
    }
    block_minmax(mn, mx, sh.red);
    if (t == 0) {
      sh.pkmin[i] = mn;
      sh.pkmax[i] = mx;
    }
    __syncthreads();
    const int sb = bit_length(sh.pkmax[i] - sh.pkmin[i]);
    const long long* sc = i == 0 ? s.pscore_w : s.pscore;
    if (rank_bits == 0) {  // one node: the score alone
      cs[i].st[0] = Stage{KEY_SCORE, sb, sc, sh.pkmin[i], 0};
    } else if (sb + rank_bits <= 64) {
      cs[i].st[0] = Stage{KEY_COMPOSITE, sb + rank_bits, sc, sh.pkmin[i], sb};
    } else {
      cs[i].st[0] = Stage{KEY_SCORE, sb, sc, sh.pkmin[i], 0};
      cs[i].st[1] = Stage{KEY_RANK, rank_bits, sc, 0, 0};
      cs[i].nst = 2;
    }
  }
  while (cs[0].phase != PH_DONE || cs[1].phase != PH_DONE) {
    sort_step(cs[0], s.nrk, sh, G, b);
    sort_step(cs[1], s.nrk, sh, G, b);
    grid_barrier(s.ctl, G, &sh.gen);
  }
  const int* order1 = s.cs[0].v[cs[0].cur];
  const int* order2 = s.cs[1].v[cs[1].cur];

  // 6. the walk, each running quantity a segmented exclusive sum.  flags
  // (walk order): 16 active (removable on an effective source), 32 still
  // over its high threshold before it, 1 continue-condition failure, 2 no
  // failure before it on its node, 4 a prefix eviction, 8 evicted after
  // the headroom cut.
  const Span run = run_of(ct);
  const int ts = tile_size(Pc, G);
  const bool go = proceed(sh, p);
  // 6a. each node's first position; the active candidates; the usage of
  // the active candidates before each
  for (int q = run.lo; q < run.hi; ++q) {
    const int node = node_at(in, order1, q, N);
    if (q == 0 || node_at(in, order1, q - 1, N) != node) s.start1[node] = q;
    s.flags[q] = (in.p_rm[__ldcg(&order1[q])] && ldb(&out.source[node]) && go) ? 16 : 0;
  }
  tile_sums(run, R, b, UsageOfActive{in, order1, s.flags, R}, s.loc[0], s.sums[0], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6b. the continue condition before each candidate: the node's usage
  // less every active candidate before it on the node
  tile_offsets(s.sums[0], R, G, sh);
  for (int q = run.lo; q < run.hi; ++q) {
    const int node = node_at(in, order1, q, N);
    const int q0 = __ldcg(&s.start1[node]);
    bool still = false;
    for (int r = 0; r < R; ++r) {
      const u64 before = sum_at(s.loc[0], sh, R, ts, q, r) - sum_at(s.loc[0], sh, R, ts, q0, r);
      const long long live = (long long)((u64)in.usage[(size_t)node * R + r] - before);
      still = still || live > __ldcg(&s.high_q[(size_t)node * R + r]);
    }
    const unsigned char f = __ldcg(&s.flags[q]);
    const bool fail = (f & 16) && !still;
    s.flags[q] = f | (still ? 32 : 0) | (fail ? 1 : 0);
  }
  tile_sums(run, 1, b, FlagCount{s.flags, 1, 0}, s.loc[1], s.sums[1], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6c. a prefix eviction: active, still over, no continue-condition
  // failure before it on its node
  tile_offsets(s.sums[1], 1, G, sh);
  for (int q = run.lo; q < run.hi; ++q) {
    const int node = node_at(in, order1, q, N);
    const unsigned char f = __ldcg(&s.flags[q]);
    const bool npf = sum_at(s.loc[1], sh, 1, ts, q, 0) ==
                     sum_at(s.loc[1], sh, 1, ts, __ldcg(&s.start1[node]), 0);
    const bool pre = (f & 16) && (f & 32) && npf;
    s.flags[q] = f | (npf ? 2 : 0) | (pre ? 4 : 0);
  }
  tile_sums(run, R, b, UsageOfPrefix{in, order1, s.flags, R}, s.loc[0], s.sums[0], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6d. the shared headroom: a prefix eviction happens while every
  // resource's headroom left (the destinations' total less the usage of
  // the prefix evictions before it) is positive
  tile_offsets(s.sums[0], R, G, sh);
  for (int q = run.lo; q < run.hi; ++q) {
    const unsigned char f = __ldcg(&s.flags[q]);
    bool head = true;
    for (int r = 0; r < R; ++r)
      head = head && (long long)(sh.avail0[r] - sum_at(s.loc[0], sh, R, ts, q, r)) > 0;
    const bool ev = (f & 4) && head;
    s.flags[q] = f | (ev ? 8 : 0);
    s.evsel[__ldcg(&order1[q])] = ev;
  }
  tile_sums(run, 1, b, FlagCount{s.flags, 4, 8}, s.loc[1], s.sums[1], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6e. reset_mid: a node's first continue-condition failure, when the
  // walk reached it (no prefix eviction before it on the node was cut by
  // the headroom); each node's first position in the eviction order; the
  // walk's evictions before each position of the eviction order
  tile_offsets(s.sums[1], 1, G, sh);
  for (int q = run.lo; q < run.hi; ++q) {
    const int node = node_at(in, order1, q, N);
    const unsigned char f = __ldcg(&s.flags[q]);
    if ((f & 1) && (f & 2) &&
        sum_at(s.loc[1], sh, 1, ts, q, 0) ==
            sum_at(s.loc[1], sh, 1, ts, __ldcg(&s.start1[node]), 0))
      s.reset_mid[node] = 1;
    const int node2 = node_at(in, order2, q, N);
    if (q == 0 || node_at(in, order2, q - 1, N) != node2) s.start2[node2] = q;
  }
  tile_sums(run, 1, b, Evicted{order2, s.evsel}, s.loc[0], s.sums[0], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6f. the detector after the walk: Reset() of the underutilized nodes
  // (when the gates reached it), Reset() of the nodes reset mid-walk,
  // Mark(true) on every effective source; the per-node cap in eviction
  // order, and rank = position in it
  tile_offsets(s.sums[0], 1, G, sh);
  if (p.cons_ab > 1) {
    const bool reach = sh.nsource > 0 && sh.nunder > 0;
    for (int n = b * kThreads + t; n < N; n += stride) {
      bool anom = out.anomaly[n];
      long long ab = out.ab[n], norm = out.norm[n];
      const bool masks[2] = {reach && out.under[n], __ldcg(&s.reset_mid[n]) != 0};
      for (int i = 0; i < 2; ++i) {
        if (masks[i]) {
          if (anom) ab = norm = 0;
          anom = false;
        }
      }
      if (out.source[n] && go) {
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
  }
  const long long pn = p.per_node_cap < 0 ? (1LL << 40) : p.per_node_cap;
  for (int q = run.lo; q < run.hi; ++q) {
    const int k = __ldcg(&order2[q]);
    out.rank[k] = q;
    const int node = node_at(in, order2, q, N);
    const long long prior = (long long)(sum_at(s.loc[0], sh, 1, ts, q, 0) -
                                        sum_at(s.loc[0], sh, 1, ts, __ldcg(&s.start2[node]), 0));
    s.keep[q] = __ldcg(&s.evsel[k]) && prior < pn;
  }
  tile_sums(run, 1, b, FlagCount{s.keep, 1, 0}, s.loc[1], s.sums[1], sh.red);
  grid_barrier(s.ctl, G, &sh.gen);
  // 6g. the total cap over the eviction order
  tile_offsets(s.sums[1], 1, G, sh);
  const long long tot = p.total_cap < 0 ? (1LL << 40) : p.total_cap;
  for (int q = run.lo; q < run.hi; ++q)
    out.evicted[__ldcg(&order2[q])] =
        __ldcg(&s.keep[q]) && (long long)sum_at(s.loc[1], sh, 1, ts, q, 0) < tot;
}

}  // namespace

#ifdef KOORD_DESCHED_STUDY
// The last launch's split, copied to `out` ([2, 64] uint64, host memory):
// block 0's SM clocks and global nanoseconds at its marks (its start,
// then after each barrier; their count in [0][60]), and the side blocks'
// ends in global nanoseconds ([1][61], [1][62]).
extern "C" int koord_desched_split(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_desched_split, sizeof(g_desched_split));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol((char*)out + sizeof(g_desched_split), g_desched_steps,
                             sizeof(g_desched_steps));
  return (int)e;
}
#endif

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" long long koord_desched_scratch_bytes(long long N, long long Pc, long long R,
                                                 long long G) {
  size_t bytes = 0;
  carve(nullptr, N, Pc, R, (int)G, &bytes);
  return (long long)bytes;
}

// ins: anomaly, ab, norm, usage, alloc, unschedulable, valid, pod node,
// pod usage, removable, low pct, high pct, weights.  outs: anomaly, ab,
// norm, evicted, rank, under, over, source, util.  params: N, Pc, R,
// use_deviation, consecutive abnormalities, consecutive normalities,
// number_of_nodes, per-node cap, total cap, the main blocks G
// (cuda.desched_grid).  The launch adds the side blocks: 6R, and one more
// in deviation mode.
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
        params[6], params[7], params[8], (int)params[9], 0};
  if (p.N <= 0 || p.Pc <= 0 || p.R <= 0 || p.R > kMaxR || p.G < 1 || p.G > kMaxG)
    return (int)cudaErrorInvalidValue;
  p.U = 6 * p.R + (p.use_dev ? 1 : 0);
  Scr s = carve((unsigned char*)scratch, p.N, p.Pc, p.R, p.G, nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  if ((e = cudaMemsetAsync(s.ctl, 0, sizeof(Ctl), st)) != cudaSuccess) return (int)e;
  void* args[] = {&in, &out, &p, &s};
  e = cudaLaunchCooperativeKernel((void*)round_kernel, dim3(p.G + p.U), dim3(kThreads), args, 0,
                                  st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
