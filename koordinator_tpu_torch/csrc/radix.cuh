// A stable LSD radix sort over 64-bit keys with an int32 index payload, a
// lexsort built on it, and block-level exclusive scans: the orderings of the
// descheduler's kernels (deschedule.cu, bandrank.cu).
//
// The sort is np.lexsort: keys from the minor to the major, each pass stable,
// ties left in index order (the payload starts as 0..n-1).  Every key column
// is first mapped to an unsigned 64-bit key whose unsigned order is the
// column's order (LexKey.mode), then sorted in 8-bit digit passes over the
// key's width (LexKey.bits).  A pass is two launches: a histogram of every
// tile's digits, then a scatter in which each tile finds its own offsets
// (the digit totals over all tiles, the tiles before it) and places its
// elements in order: chunk by chunk, warps in order, lanes by __match_any_sync
// rank.  No library sort or scan is used.
//
// Float keys follow np.lexsort and lax.sort: -0.0 and 0.0 compare equal (the
// tie falls through to the next key) and every NaN sorts last, equal to the
// other NaNs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace koord_radix {

typedef unsigned long long u64;

constexpr int kThreads = 256;  // threads of a histogram or scatter block
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 256;  // 8-bit digits
constexpr int kMaxTiles = 128;  // blocks of one pass, at most
constexpr int kMinTile = 8 * kThreads;

// How a key column maps to an unsigned key.
enum KeyMode : int {
  KEY_UNSIGNED = 0,  // a non-negative integer, as it is
  KEY_SIGNED = 1,    // a signed integer of `bits` bits
  KEY_NEG_SIGNED = 2,  // the negated signed 64-bit integer (wrapping, as int64 does)
  KEY_NEG_F64 = 3,   // the negated float64
};

struct LexKey {
  const void* col;  // [n] elements of `elem` bytes (1, 4 or 8)
  int elem;
  int mode;
  int bits;  // width of the mapped key; 0 = a constant key (no pass)
};

__device__ __forceinline__ u64 f64_key(double x) {
  if (x != x) return 0xFFF8000000000000ULL;  // every NaN: the canonical one, last
  if (x == 0.0) x = 0.0;                     // -0.0 == 0.0
  u64 b = (u64)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ULL);
}

__device__ __forceinline__ double f64_of_key(u64 k) {
  return __longlong_as_double((long long)((k >> 63) ? (k ^ 0x8000000000000000ULL) : ~k));
}

__device__ __forceinline__ long long load_int(const void* col, int elem, long long i) {
  if (elem == 1) return ((const signed char*)col)[i];
  if (elem == 4) return ((const int*)col)[i];
  return ((const long long*)col)[i];
}

__device__ __forceinline__ u64 map_key(const LexKey& k, long long i) {
  switch (k.mode) {
    case KEY_UNSIGNED:
      return (u64)load_int(k.col, k.elem, i);
    case KEY_SIGNED:
      return ((u64)load_int(k.col, k.elem, i) + (1ULL << (k.bits - 1))) &
             (k.bits == 64 ? ~0ULL : ((1ULL << k.bits) - 1));
    case KEY_NEG_SIGNED:
      return (0ULL - (u64)load_int(k.col, k.elem, i)) ^ 0x8000000000000000ULL;
    default:  // KEY_NEG_F64
      return f64_key(-((const double*)k.col)[i]);
  }
}

// Exclusive scan of one value a thread over the block (blockDim.x a multiple
// of 32, at most 1024; every thread calls it).  `smem` holds 32 values;
// `total` receives the block's sum.  Unsigned, so int64 sums wrap as int64
// arithmetic does.
template <typename T>
__device__ T block_excl_scan(T v, T* smem, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < nw ? smem[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    smem[lane] = s;
  }
  __syncthreads();
  T before = warp ? smem[warp - 1] : (T)0;
  *total = smem[nw - 1];
  __syncthreads();
  return before + x - v;
}

// keys[i] = the mapped key of element perm[i] of the column.
__global__ void lex_gather(LexKey key, const int* perm, int n, u64* keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = map_key(key, perm[i]);
}

__global__ void iota(int* v, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) v[i] = i;
}

// hist[d * B + b] = elements of tile b whose digit at `shift` is d.
__global__ void radix_hist(const u64* keys, int n, int shift, int tile, int* hist) {
  __shared__ int cnt[kBuckets];
  const int b = blockIdx.x, B = gridDim.x, t = threadIdx.x;
  cnt[t] = 0;
  __syncthreads();
  const int lo = b * tile, hi = min(n, lo + tile);
  for (int i = lo + t; i < hi; i += kThreads) atomicAdd(&cnt[(keys[i] >> shift) & 255], 1);
  __syncthreads();
  hist[t * B + b] = cnt[t];
}

// The stable scatter of tile b by the digit at `shift`.
__global__ void radix_scatter(const u64* kin, const int* vin, u64* kout, int* vout, int n,
                              int shift, int tile, const int* hist) {
  __shared__ int base[kBuckets];
  __shared__ int wcnt[kWarps][kBuckets];
  __shared__ int scan[32];
  const int b = blockIdx.x, B = gridDim.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  int total = 0, before = 0;
  for (int j = 0; j < B; ++j) {
    const int c = hist[t * B + j];
    total += c;
    if (j < b) before += c;
  }
  int all;
  base[t] = block_excl_scan<int>(total, scan, &all) + before;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const int lo = b * tile, hi = min(n, lo + tile);
  for (int c0 = lo; c0 < hi; c0 += kThreads) {
    const int i = c0 + t;
    const bool ok = i < hi;
    const u64 key = ok ? kin[i] : 0ULL;
    const int d = ok ? (int)((key >> shift) & 255) : kBuckets;  // kBuckets: no element
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][t] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt);
    if (ok && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = wcnt[w][t];
      wcnt[w][t] = run;
      run += x;
    }
    __syncthreads();
    if (ok) {
      const int pos = base[d] + wcnt[warp][d] + rank;
      kout[pos] = key;
      vout[pos] = vin[i];
    }
    __syncthreads();
    base[t] += run;
    __syncthreads();
  }
}

// Buffers of one sort: keys and payload twice (ping-pong) for up to `cap`
// elements, and the histogram.
struct Bufs {
  u64* k[2];
  int* v[2];
  int* hist;
};

__host__ inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

__host__ inline size_t bufs_bytes(long long cap) {
  return 2 * align256((size_t)cap * 8) + 2 * align256((size_t)cap * 4) +
         align256((size_t)kBuckets * kMaxTiles * 4);
}

__host__ inline Bufs carve(unsigned char*& p, long long cap) {
  Bufs b;
  for (int i = 0; i < 2; ++i) {
    b.k[i] = (u64*)p;
    p += align256((size_t)cap * 8);
  }
  for (int i = 0; i < 2; ++i) {
    b.v[i] = (int*)p;
    p += align256((size_t)cap * 4);
  }
  b.hist = (int*)p;
  p += align256((size_t)kBuckets * kMaxTiles * 4);
  return b;
}

__host__ inline int tile_of(int n) {
  long long t = kMinTile;
  if ((long long)n > (long long)kMaxTiles * t) {
    t = ((long long)n + kMaxTiles - 1) / kMaxTiles;
    t = (t + kThreads - 1) / kThreads * kThreads;
  }
  return (int)t;
}

// np.lexsort(keys[K-1], ..., keys[0]) with keys[0] the MINOR key (the
// order np.lexsort takes them in): *perm receives the buffer holding the n
// int32 indices in sorted order.  Launches only; nothing is synchronised.
__host__ inline cudaError_t lexsort(const LexKey* keys, int K, int n, Bufs b, const int** perm,
                                    cudaStream_t s) {
  int cur = 0;
  *perm = b.v[0];
  if (n <= 0) return cudaSuccess;
  const int g = (n + kThreads - 1) / kThreads;
  iota<<<g, kThreads, 0, s>>>(b.v[0], n);
  const int tile = tile_of(n);
  const int B = (n + tile - 1) / tile;
  for (int j = 0; j < K; ++j) {
    if (keys[j].bits <= 0) continue;
    lex_gather<<<g, kThreads, 0, s>>>(keys[j], b.v[cur], n, b.k[cur]);
    for (int shift = 0; shift < keys[j].bits; shift += 8) {
      radix_hist<<<B, kThreads, 0, s>>>(b.k[cur], n, shift, tile, b.hist);
      radix_scatter<<<B, kThreads, 0, s>>>(b.k[cur], b.v[cur], b.k[1 - cur], b.v[1 - cur], n,
                                           shift, tile, b.hist);
      cur = 1 - cur;
    }
  }
  *perm = b.v[cur];
  return cudaGetLastError();
}

}  // namespace koord_radix
