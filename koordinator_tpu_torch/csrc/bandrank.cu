// The descheduler arbitrator's QoS/priority-band victim order: the PodSorter
// chain of pkg/descheduler/utils/sorter/pod.go as one lexsort, one launch.
//
// Replaces the JAX package's jax.jit program `pod_band_rank`
// (koordinator_tpu/core/deschedule.py:223-271, `_band_rank`): np.lexsort over
// (index, -create_time, [-usage], eviction_cost, deletion_cost, koord QoS
// rank, k8s QoS rank, priority, koord priority-class rank), minor to major ->
// the [P] eviction-order permutation, bit-identical to
// core/evictor.py pod_sort_order.
//
// What bounds it on an H100: latency.  The bytes (~1 MB at P = 32,768) take
// well under a microsecond; a sort is a chain of dependent passes.  Launched
// as two kernels a pass over every byte of every key (~79 launches) it was
// host-bound.  The design, after deschedule.cu's sorts:
//   - each key column maps to an unsigned 64-bit key of the same order
//     (signed: the sign bit flipped; negated int64: wrapping as int64 does;
//     negated float64: radix.cuh's f64_key, -0.0 tying 0.0 and NaN last),
//     less its minimum over the P pods, so its significant bits are its
//     spread's; a constant key has none and no pass;
//   - adjacent keys are packed, major in the high bits, into composite
//     64-bit words while their widths fit, and np.lexsort's stable passes
//     run word by word, minor first, 8 bits a pass, over each word's width
//     only; a pass whose digit is one value for every pod (the word's
//     bytewise minimum equals its maximum there) is skipped, since a stable
//     pass over a constant digit is the identity;
//   - a pass is stable at every level: digits in order, then blocks'
//     tiles, then each warp's contiguous run of its block's tile, then a
//     warp's chunks of 32, then lanes by __match_any_sync rank (one
//     ballot a digit bit instead measured slower); each block
//     counts its own tile's digits by warp, and in the cooperative launch
//     a pass's scatter also counts each pod's next digit into the tile it
//     lands in (atomics, one a warp's run of equal digit and tile), so the
//     tiles' counts for the next pass are complete at the barrier that
//     ends this one: one grid barrier a pass;
//   - up to kSmallMax pods, one block sorts keys and payload ping-pong in
//     shared memory (the path's size: a few thousand jobs); above it, a
//     cooperative launch of up to one block an SM over a device scratch,
//     each dependent step ending in a grid barrier (deschedule.cu's
//     protocol: one arrival count, one generation word, cross-block data
//     read through L2 with ld.global.cg);
//   - the int32 permutation is widened into the [P] int64 output.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

using koord_radix::u64;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 8;
constexpr int kMaxG = 132;
constexpr int kSmallMax = 8192;  // pods one block sorts in shared memory
constexpr int kCountBytes = 256 * kWarps * 4;  // a pass's digit counts by warp
constexpr long long kWaitTimeout = 20000000000LL;  // SM cycles (~10 s): a fault, not a wait

// How a key column maps to an unsigned key (core/deschedule.py pod_band_rank).
enum KeyMode : int {
  KEY_SIGNED = 1,      // a signed integer of 1, 4 or 8 bytes
  KEY_NEG_SIGNED = 2,  // the negated signed 64-bit integer (wrapping, as int64 does)
  KEY_NEG_F64 = 3,     // the negated float64
};

struct Key {
  const void* col;
  int elem, mode;
};

struct Desc {
  int K, P;
  Key key[kMaxKeys];  // minor first
};

// The sort's plan, the same in every block: the non-constant keys in
// order, packed into words.
struct Plan {
  int words;
  int first[kMaxKeys + 1];  // word w holds entries first[w] .. first[w + 1] - 1
  int key[kMaxKeys];        // an entry's key
  int shift[kMaxKeys];      // its bits' offset in its word
  int width[kMaxKeys];      // a word's significant bits
  u64 min[kMaxKeys];        // each key's minimum
};

struct Scratch {  // the cooperative launch's device scratch (koord_band_scratch_bytes)
  unsigned* bar;  // the grid barrier: arrival count, generation
  u64* part;      // [G][2 * kMaxKeys]: each tile's key minima and maxima; a word's byte bounds
  int* hist;      // [3][256][G] passes' digit counts by tile (read, counted into, zeroed)
  u64* k[2];      // [P] keys, ping-pong
  int* v[2];      // [P] the payload (pod indices)
};

struct Shared {
  Plan plan;
  u64 kmax[kMaxKeys];  // one block: each key's maximum
  int base[256];  // a digit's first position for this block
  int tot[256];   // a digit's count over every tile
  u64 red[64];
  int red_i[32];
  unsigned skip;  // the current word's constant digits (bit d)
  unsigned gen;
};

__device__ __forceinline__ long long load_int(const void* col, int elem, long long i) {
  if (elem == 1) return ((const signed char*)col)[i];
  if (elem == 4) return ((const int*)col)[i];
  return ((const long long*)col)[i];
}

__device__ __forceinline__ u64 map_key(const Key& k, long long i) {
  switch (k.mode) {
    case KEY_SIGNED:
      return (u64)load_int(k.col, k.elem, i) ^ 0x8000000000000000ULL;
    case KEY_NEG_SIGNED:
      return (0ULL - (u64)load_int(k.col, k.elem, i)) ^ 0x8000000000000000ULL;
    default:  // KEY_NEG_F64
      return koord_radix::f64_key(-((const double*)k.col)[i]);
  }
}

__device__ __forceinline__ int bit_length(u64 x) { return x ? 64 - __clzll((long long)x) : 0; }

// loads of data other blocks wrote: through L2 in the cooperative launch
template <bool kGrid, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kGrid) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// Every block's writes before it visible to every block after it: a grid
// barrier in the cooperative launch (deschedule.cu's), else the block's.
template <bool kGrid>
__device__ void sync_all(const Scratch& s, Shared& sh) {
  __syncthreads();
  if constexpr (kGrid) {
    if (threadIdx.x == 0) {
      const unsigned g = ld_acquire(&s.bar[1]);
      __threadfence();
      if (atomicAdd(&s.bar[0], 1u) == gridDim.x - 1) {
        atomicExch(&s.bar[0], 0u);
        __threadfence();
        st_release(&s.bar[1], g + 1);
      } else {
        const long long t0 = clock64();
        while (ld_acquire(&s.bar[1]) == g)
          if (clock64() - t0 > kWaitTimeout) __trap();
      }
      __threadfence();
      sh.gen = g + 1;
    }
    __syncthreads();
  }
}

struct Span {
  int lo, hi;
};

// block b's tile of the P pods, and warp w's contiguous run of a tile
__device__ __forceinline__ Span tile_of(int P, int G, int b) {
  const long long t = ((long long)P + G - 1) / G, lo = b * t;
  return {(int)(lo < P ? lo : P), (int)(lo + t < P ? lo + t : P)};
}

__device__ __forceinline__ Span run_of(Span t, int w) {
  const long long per = ((long long)(t.hi - t.lo) + kWarps - 1) / kWarps, lo = t.lo + w * per;
  return {(int)(lo < t.hi ? lo : t.hi), (int)(lo + per < t.hi ? lo + per : t.hi)};
}

// bytewise minimum and maximum of 64-bit words, as two 32-bit halves each
__device__ __forceinline__ u64 bytes_min(u64 a, u64 b) {
  return ((u64)__vminu4((unsigned)(a >> 32), (unsigned)(b >> 32)) << 32) |
         __vminu4((unsigned)a, (unsigned)b);
}

__device__ __forceinline__ u64 bytes_max(u64 a, u64 b) {
  return ((u64)__vmaxu4((unsigned)(a >> 32), (unsigned)(b >> 32)) << 32) |
         __vmaxu4((unsigned)a, (unsigned)b);
}

__device__ void block_bytes(u64& mn, u64& mx, u64* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = bytes_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = bytes_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) {
    red[warp] = mn;
    red[32 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = red[lane];
    mx = red[32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = bytes_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = bytes_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
  }
  __syncthreads();
}

// word w of pod e: each of its keys less the key's minimum at its offset
__device__ __forceinline__ u64 word_of(const Plan& pl, const Desc& d, int w, long long e) {
  u64 v = 0;
  for (int q = pl.first[w]; q < pl.first[w + 1]; ++q) {
    const int j = pl.key[q];
    v |= (map_key(d.key[j], e) - pl.min[j]) << pl.shift[q];
  }
  return v;
}

// Thread 0: the keys' widths from their minima and maxima, the constant
// keys dropped, the others packed into words minor first.
__device__ void make_plan(const u64* kmin, const u64* kmax, int K, Plan& pl) {
  int nw = 0, q = 0, used = 0;
  pl.first[0] = 0;
  for (int j = 0; j < K; ++j) {
    pl.min[j] = kmin[j];
    const int wd = bit_length(kmax[j] - kmin[j]);
    if (!wd) continue;
    if (used && used + wd > 64) {
      pl.width[nw] = used;
      pl.first[++nw] = q;
      used = 0;
    }
    pl.key[q] = j;
    pl.shift[q] = used;
    used += wd;
    ++q;
  }
  if (used) {
    pl.width[nw] = used;
    pl.first[++nw] = q;
  }
  pl.words = nw;
}

#ifdef KOORD_BAND_STUDY
// The study build (csrc/bandstudy.cu) records block 0's global nanosecond
// timer at each step (slots 0..254; the count in slot 255), for
// koord_band_split.
__device__ unsigned long long g_band_split[256];
__device__ __forceinline__ void mark_step() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long k = g_band_split[255];
    if (k < 255) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      g_band_split[k] = t;
    }
    g_band_split[255] = k + 1;
  }
}
#else
__device__ __forceinline__ void mark_step() {}
#endif

// Each warp's counts of the digit at `shift` over its run of this block's
// tile, then each digit's warps' offsets in the tile (`wcnt` [256][kWarps])
// and the tile's digit totals (sh.tot).
template <bool kGrid>
__device__ void count_warps(const Desc& d, Shared& sh, int* wcnt, const u64* kin, int shift) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const Span run = run_of(tile_of(d.P, gridDim.x, blockIdx.x), w);
  const unsigned lt = (1u << lane) - 1u;
  for (int x = t; x < 256 * kWarps; x += kThreads) wcnt[x] = 0;
  __syncthreads();
  // chunk by chunk; the lowest lane of a digit adds its peers (one writer a
  // digit a chunk)
  for (int c = run.lo; c < run.hi; c += 32) {
    const int i = c + lane;
    const int dg = i < run.hi ? (int)((ld<kGrid>(&kin[i]) >> shift) & 255) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < 256 && !(peers & lt)) wcnt[dg * kWarps + w] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // warp w' takes digits w' + 32q: an exclusive scan over the warps
  for (int dg = w; dg < 256; dg += kWarps) {
    const int v = wcnt[dg * kWarps + lane];
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    wcnt[dg * kWarps + lane] = inc - v;
    if (lane == 31) sh.tot[dg] = inc;
  }
  __syncthreads();
  mark_step();
}

// The stable scatter by the digit at `shift`, from buffer `cur` to
// 1 - cur, of this block's tile (count_warps before it).  In the
// cooperative launch the tiles' digit counts are `hread` ([256][G],
// complete), each pod's next digit (at next_shift, >= 0) is counted into
// `hfold` for the tile it lands in, and this block's column of `hzero` is
// zeroed for the pass after next; each block's step ends in a grid barrier.
template <bool kGrid>
__device__ void scatter_pass(const Desc& d, const Scratch& s, Shared& sh, int* wcnt,
                             u64* const* K2, int* const* V2, int cur, int shift, int next_shift,
                             const int* hread, int* hfold, int* hzero) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, G = gridDim.x, b = blockIdx.x;
  const Span run = run_of(tile_of(d.P, G, b), w);
  const unsigned lt = (1u << lane) - 1u;
  int before = 0;
  if constexpr (kGrid) {
    // every tile's count of each digit: a warp takes 8 digits, its lanes a
    // digit's counts of 32 tiles at a time
    constexpr int kPer = 256 / kWarps;
    int all[kPer], bef[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {  // the first 32 tiles: every load in flight at once
      const int c = lane < G ? __ldcg(&hread[(w + q * kWarps) * G + lane]) : 0;
      all[q] = c;
      bef[q] = lane < b ? c : 0;
    }
    for (int j = lane + 32; j < G; j += 32)
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int c = __ldcg(&hread[(w + q * kWarps) * G + j]);
        all[q] += c;
        bef[q] += j < b ? c : 0;
      }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int a = __reduce_add_sync(0xffffffffu, all[q]);
      const int e = __reduce_add_sync(0xffffffffu, bef[q]);
      if (lane == 0) {
        sh.tot[w + q * kWarps] = a;
        sh.base[w + q * kWarps] = e;
      }
    }
    if (t < 256) hzero[t * G + b] = 0;
    __syncthreads();
    if (t < 256) before = sh.base[t];
    mark_step();
  }
  int total;
  const int excl = koord_radix::block_excl_scan<int>(t < 256 ? sh.tot[t] : 0, sh.red_i, &total);
  if (t < 256) sh.base[t] = excl + before;
  __syncthreads();
  mark_step();
  // the warps' runs again, in order
  const long long ts = ((long long)d.P + G - 1) / G;
  const u64* kin = K2[cur];
  const int* vin = V2[cur];
  u64* kout = K2[1 - cur];
  int* vout = V2[1 - cur];
  for (int c = run.lo; c < run.hi; c += 32) {
    const int i = c + lane;
    const bool ok = i < run.hi;
    const u64 key = ok ? ld<kGrid>(&kin[i]) : 0ULL;
    const int val = ok ? ld<kGrid>(&vin[i]) : 0;
    const int dg = ok ? (int)((key >> shift) & 255) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    const int rank = __popc(peers & lt);
    const int pos = ok ? sh.base[dg] + wcnt[dg * kWarps + w] + rank : 0;
    if (ok) {
      kout[pos] = key;
      vout[pos] = val;
    }
    if constexpr (kGrid) {
      if (next_shift >= 0) {  // (next digit, landing tile); -1: no pod
        const int slot = ok ? (int)((key >> next_shift) & 255) * G + (int)(pos / ts) : -1;
        const unsigned same = __match_any_sync(0xffffffffu, slot);
        if (ok && !(same & lt)) atomicAdd(&hfold[slot], __popc(same));
      }
    }
    __syncwarp();
    if (ok && rank == 0) wcnt[dg * kWarps + w] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  mark_step();
  sync_all<kGrid>(s, sh);
  mark_step();
}

template <bool kGrid>
__global__ void __launch_bounds__(kThreads) band_kernel(Desc d, Scratch s, long long* out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  int* wcnt = (int*)dyn;
  u64* K2[2];
  int* V2[2];
  if constexpr (kGrid) {
    K2[0] = s.k[0], K2[1] = s.k[1], V2[0] = s.v[0], V2[1] = s.v[1];
  } else {
    K2[0] = (u64*)(dyn + kCountBytes);
    K2[1] = K2[0] + d.P;
    V2[0] = (int*)(K2[1] + d.P);
    V2[1] = V2[0] + d.P;
  }
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const Span tile = tile_of(d.P, G, b);
  mark_step();
  // 1. each key's minimum and maximum over the pods, every key's loads in
  // flight at once; the warps' bounds reduced through the counts' memory
  {
    u64 mn[kMaxKeys], mx[kMaxKeys];
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
      mn[j] = ~0ULL;
      mx[j] = 0ULL;
    }
    for (int i = tile.lo + t; i < tile.hi; i += kThreads) {
#pragma unroll
      for (int j = 0; j < kMaxKeys; ++j) {
        if (j < d.K) {
          const u64 k = map_key(d.key[j], i);
          mn[j] = k < mn[j] ? k : mn[j];
          mx[j] = k > mx[j] ? k : mx[j];
        }
      }
    }
    u64* red = (u64*)wcnt;  // [kWarps][2 * kMaxKeys]
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int j = 0; j < kMaxKeys; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const u64 a = __shfl_xor_sync(0xffffffffu, mn[j], o);
        const u64 c = __shfl_xor_sync(0xffffffffu, mx[j], o);
        mn[j] = a < mn[j] ? a : mn[j];
        mx[j] = c > mx[j] ? c : mx[j];
      }
      if (lane == 0) {
        red[warp * 2 * kMaxKeys + 2 * j] = mn[j];
        red[warp * 2 * kMaxKeys + 2 * j + 1] = mx[j];
      }
    }
    __syncthreads();
    if (t < 2 * kMaxKeys) {  // entry t: a key's minimum (even) or maximum (odd)
      u64 v = red[t];
      for (int x = 1; x < kWarps; ++x) {
        const u64 y = red[x * 2 * kMaxKeys + t];
        v = (t & 1) ? (y > v ? y : v) : (y < v ? y : v);
      }
      if constexpr (kGrid) {
        s.part[b * 2 * kMaxKeys + t] = v;
      } else if (t & 1) {
        sh.kmax[t >> 1] = v;
      } else {
        sh.plan.min[t >> 1] = v;
      }
    }
  }
  sync_all<kGrid>(s, sh);
  if (t == 0) {
    u64 kmin[kMaxKeys], kmax[kMaxKeys];
    for (int j = 0; j < d.K; ++j) {
      if constexpr (kGrid) {
        kmin[j] = ~0ULL;
        kmax[j] = 0ULL;
        for (int g = 0; g < G; ++g) {
          const u64 a = __ldcg(&s.part[g * 2 * kMaxKeys + 2 * j]);
          const u64 c = __ldcg(&s.part[g * 2 * kMaxKeys + 2 * j + 1]);
          kmin[j] = a < kmin[j] ? a : kmin[j];
          kmax[j] = c > kmax[j] ? c : kmax[j];
        }
      } else {
        kmin[j] = sh.plan.min[j];
        kmax[j] = sh.kmax[j];
      }
    }
    make_plan(kmin, kmax, d.K, sh.plan);
  }
  // every block has read the partials before a word's byte bounds reuse them
  sync_all<kGrid>(s, sh);
  mark_step();
  int cur = 0;
  for (int w = 0; w < sh.plan.words; ++w) {
    // 2. word w of each pod at its current position, and its bytes' bounds
    u64 bmin = ~0ULL, bmax = 0ULL;
    for (int i = tile.lo + t; i < tile.hi; i += kThreads) {
      const int e = w == 0 ? i : ld<kGrid>(&V2[cur][i]);
      const u64 key = word_of(sh.plan, d, w, e);
      K2[cur][i] = key;
      if (w == 0) V2[cur][i] = i;
      bmin = bytes_min(bmin, key);
      bmax = bytes_max(bmax, key);
    }
    block_bytes(bmin, bmax, sh.red);
    mark_step();
    if constexpr (kGrid) {
      if (t == 0) {
        s.part[b * 2 * kMaxKeys] = bmin;
        s.part[b * 2 * kMaxKeys + 1] = bmax;
      }
      sync_all<kGrid>(s, sh);
      if (t == 0) {
        bmin = ~0ULL;
        bmax = 0ULL;
        for (int g = 0; g < G; ++g) {
          bmin = bytes_min(bmin, __ldcg(&s.part[g * 2 * kMaxKeys]));
          bmax = bytes_max(bmax, __ldcg(&s.part[g * 2 * kMaxKeys + 1]));
        }
      }
    }
    if (t == 0) {
      unsigned skip = 0;
      for (int k = 0; k < 8; ++k)
        if (((bmin >> (8 * k)) & 255) == ((bmax >> (8 * k)) & 255)) skip |= 1u << k;
      sh.skip = skip;
    }
    __syncthreads();
    // 3. the passes over the word's digits that vary: at least one (a
    // word holds a key that is not constant), each ending in sync_all, so
    // every block has read this word's bounds before the next word's
    const unsigned vary = ~sh.skip & ((1u << ((sh.plan.width[w] + 7) / 8)) - 1u);
    int k = __ffs(vary) - 1;
    if (k < 0) {  // a word's keys vary, so some digit does; kept for the barrier's sake
      sync_all<kGrid>(s, sh);
      continue;
    }
    int* H[3] = {nullptr, nullptr, nullptr};
    if constexpr (kGrid) {
      H[0] = s.hist, H[1] = s.hist + 256 * G, H[2] = s.hist + 512 * G;
      // the first pass's tile counts, and the buffer its scatter counts
      // the next digit into zeroed
      count_warps<kGrid>(d, sh, wcnt, K2[cur], 8 * k);
      if (t < 256) {
        H[0][t * G + b] = sh.tot[t];
        H[1][t * G + b] = 0;
      }
      sync_all<kGrid>(s, sh);
    }
    for (bool first = true; k >= 0; first = false) {
      const unsigned later = vary & ~((2u << k) - 1u);
      const int next = later ? __ffs(later) - 1 : -1;
      if (!kGrid || !first) count_warps<kGrid>(d, sh, wcnt, K2[cur], 8 * k);
      scatter_pass<kGrid>(d, s, sh, wcnt, K2, V2, cur, 8 * k, next < 0 ? -1 : 8 * next, H[0],
                          H[1], H[2]);
      int* r = H[0];
      H[0] = H[1], H[1] = H[2], H[2] = r;
      cur ^= 1;
      k = next;
    }
  }
  // 4. the permutation, widened
  for (int i = tile.lo + t; i < tile.hi; i += kThreads)
    out[i] = sh.plan.words ? ld<kGrid>(&V2[cur][i]) : i;
}

struct Layout {
  size_t bar, part, hist, k0, k1, v0, v1, total;
};

Layout layout(long long P, int G) {
  using koord_radix::align256;
  Layout l;
  l.bar = 0;
  l.part = align256(2 * sizeof(unsigned));
  l.hist = l.part + align256((size_t)G * 2 * kMaxKeys * 8);
  l.k0 = l.hist + align256((size_t)3 * 256 * G * 4);
  l.k1 = l.k0 + align256((size_t)P * 8);
  l.v0 = l.k1 + align256((size_t)P * 8);
  l.v1 = l.v0 + align256((size_t)P * 4);
  l.total = l.v1 + align256((size_t)P * 4);
  return l;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef KOORD_BAND_STUDY
// The marks of the launches since the last call into out ([256] uint64,
// host memory; the count in [255]), and zeroed for the next.
extern "C" int koord_band_split(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_band_split, sizeof(g_band_split));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[256] = {};
  return (int)cudaMemcpyToSymbol(g_band_split, zeros, sizeof(zeros));
}
#endif

// The cooperative launch's scratch for P pods over G blocks (0 up to
// kSmallMax pods: one block, in shared memory).  The wrapper zeroes it
// once when it allocates it; the launch leaves the barrier's count at 0.
extern "C" long long koord_band_scratch_bytes(long long P, long long G) {
  return P <= kSmallMax ? 0 : (long long)layout(P, (int)G).total;
}

// desc: int64 words K, P, G, then K triples (column pointer, element bytes,
// koord KeyMode), MINOR key first; out: [P] int64 permutation; scratch:
// koord_band_scratch_bytes(P, G) bytes, zeroed at allocation (null up to
// kSmallMax pods).
extern "C" int koord_band_rank(const long long* desc, void* out, void* scratch, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Desc d;
  d.K = (int)desc[0];
  d.P = (int)desc[1];
  const int G = (int)desc[2];
  if (d.K <= 0 || d.K > kMaxKeys || d.P <= 0) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < d.K; ++j)
    d.key[j] = {(const void*)desc[3 + 3 * j], (int)desc[4 + 3 * j], (int)desc[5 + 3 * j]};
  const cudaStream_t st = (cudaStream_t)stream;
  Scratch s{};
  if (d.P <= kSmallMax) {
    const int smem = kCountBytes + 24 * d.P;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(band_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
      return (int)e;
    band_kernel<false><<<1, kThreads, smem, st>>>(d, s, (long long*)out);
    return (int)cudaGetLastError();
  }
  if (G < 1 || G > kMaxG || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Layout l = layout(d.P, G);
  unsigned char* p = (unsigned char*)scratch;
  s.bar = (unsigned*)(p + l.bar);
  s.part = (u64*)(p + l.part);
  s.hist = (int*)(p + l.hist);
  s.k[0] = (u64*)(p + l.k0);
  s.k[1] = (u64*)(p + l.k1);
  s.v[0] = (int*)(p + l.v0);
  s.v[1] = (int*)(p + l.v1);
  long long* o = (long long*)out;
  void* args[] = {&d, &s, &o};
  e = cudaLaunchCooperativeKernel((void*)band_kernel<true>, dim3(G), dim3(kThreads), args,
                                  kCountBytes, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
