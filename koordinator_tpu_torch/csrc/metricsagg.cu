// The koordlet's NodeMetric aggregation: per series of T samples, the mean,
// the p50/p90/p95/p99 percentiles and the last value, one [6, S] buffer.
//
// Replaces the JAX package's jax.jit program `aggregate_node_metrics`
// (koordinator_tpu/core/metricsagg.py:54; the pieces agg_avg, agg_percentile,
// agg_last at :23-47), after pkg/koordlet/metriccache/util.go:
//   avg   = sum(valid ? v : 0.0) / count, 0 for an empty series;
//   p     = sorted(valid ? v : 1e300)[clip(int(float32(count) * float32(p)) - 1,
//           0, T - 1)], 0 for an empty series (fieldPercentileOfMetricList: the
//           float32 product and the -1 are the reference's);
//   last  = v at the first index of the largest (valid ? t : -1e300), 0 when
//           nothing is valid.
// The order is radix.cuh's float64 key (-0.0 ties 0.0, every NaN last), ties
// by index: jnp.sort's stable order.  The sum is the strided halving tree
// over the samples padded with zeros to a power of two Tp, then + 0.0 (the
// reduction's zero, which turns an all -0.0 sum into 0.0), divided with
// __ddiv_rn: the plain version (core/metricsagg.py) sums in the same order,
// so the two agree bit for bit; a NaN mean is the canonical quiet NaN in
// both.  The percentile index is __fmul_rn on floats, never promoted.
//
// What bounds it on an H100: bytes, and only those these inputs need.  The
// koordlet's windows are its store's whole ring (T = 256) with the samples
// inside the window's duration valid: 7 of 256 for the 60-s windows, 31,
// 61 and 181 for the 300-, 600- and 1,800-s ones.  Every valid byte has to
// be read, and the value and time of each valid sample (16 bytes), and
// the [6, S] output written: at the pod window's 62,500 series ~26 MB,
// ~8 us at 3.35 TB/s.  An invalid sample is 0.0 in the sum and 1e300 in
// the order and needs no load.
//
// agg_warp (T <= 256, every window of the port's store): one warp a
// series, 8 a block, no block barrier.  A lane loads its valid bytes
// (positions l, l + 32, ...: Tp / 32 of them, or one for Tp <= 32); ballots
// give the count and each valid sample's rank in index order, and the
// valid indices go to shared memory in that order.  The values and times
// are then loaded by rank, one a lane a chunk of 32, so a 7-of-256 window
// issues two loads a lane and fetches only the sectors its arc touches; an
// invalid sample is 0.0 in the sum and 1e300 in the order and is never
// read.  Each loaded value's key and the value itself go to shared memory
// by rank (5 KB a warp with the indices).  The sum's terms are placed back
// at their positions, so the halvings of w >= 32 are adds inside a lane
// and those of w < 32 shuffles, in exactly the plain version's
// association.  The last is a butterfly over the valid samples' (time
// key, -index, value); the invalid samples share one time key (-1e300's),
// so only when no valid time is above it is the first invalid index
// looked for.  The percentile's index q is at most count - 1, so unless a
// valid key is at or above 1e300's (one vote) the order statistics lie
// among the valid samples, and only their (key, rank) pairs are sorted,
// padded to a power of two (8 keys for 7 valid, one a lane up to 32, 8 a
// lane up to 256); otherwise all Tp (key, index) pairs, the old order
// exactly.  The sort is the bitonic network in registers over a blocked
// layout (lane l holds positions l * ES ...): partners fewer than ES apart
// are compared inside a lane, the others a __shfl_xor_sync of the key and
// the index away (15 of the 36 stages at 256 keys).  The percentile's
// value comes back from shared memory by rank (from device memory by
// index after the full sort): the key cannot give it, -0.0 and NaN
// payloads are lost in it.  At most 64 registers a thread, 32 warps an
// SM: the sparse windows are bound by the latency of two dependent loads
// and a chain of shuffles, not by their bytes.
//
// agg_kernel (256 < T <= 2,048): one block a series, the samples in shared
// memory, a bitonic sort over all Tp pairs with a barrier a stage (the
// first design, kept for the wide windows no path of the port builds).
// koord_aggregate_node_metrics chooses by T.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxT = 2048;  // MAX_T in core/metricsagg.py: 20 bytes a sample of shared memory
constexpr int kWarpMaxT = 256;  // agg_warp's widest series
constexpr int kWarps = 8;       // series a block of agg_warp
// blocks an SM: at most 64 registers a thread, 32 warps an SM in flight
// (the sparse windows are bound by latency: at 97 registers, 16 warps an
// SM, the pod window measured ~1.4 times slower)
constexpr int kBlocksPerSM = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
constexpr double kBig = 1e300;

__device__ __forceinline__ bool pair_less(u64 ka, int ia, u64 kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__global__ void agg_kernel(const double* values, const uint8_t* valid, const double* times,
                           int S, int T, int Tp, float p50, float p90, float p95, float p99,
                           double* out) {
  extern __shared__ u64 smem[];
  u64* key = smem;                        // [Tp]
  double* acc = (double*)(key + Tp);      // [Tp]
  int* idx = (int*)(acc + Tp);            // [Tp]
  __shared__ int cnt_s;
  __shared__ u64 best_k[kThreads];
  __shared__ int best_i[kThreads];

  const int s = blockIdx.x;
  const double* v = values + (size_t)s * T;
  const uint8_t* ok = valid + (size_t)s * T;
  const double* tm = times + (size_t)s * T;
  if (threadIdx.x == 0) cnt_s = 0;
  __syncthreads();

  int cnt = 0;
  u64 bk = 0;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < Tp; i += blockDim.x) {
    if (i < T) {
      const bool o = ok[i];
      const double x = v[i];
      cnt += o;
      key[i] = koord_radix::f64_key(o ? x : kBig);
      acc[i] = o ? x : 0.0;
      // the first index of the largest time, NaN above everything
      const u64 tk = koord_radix::f64_key(o ? tm[i] : -kBig);
      if (bi == 0x7fffffff || tk > bk) {
        bk = tk;
        bi = i;
      }
    } else {
      key[i] = ~0ULL;  // padding sorts after every sample, NaN included
      acc[i] = 0.0;
    }
    idx[i] = i;
  }
  atomicAdd(&cnt_s, cnt);
  best_k[threadIdx.x] = bk;
  best_i[threadIdx.x] = bi;
  __syncthreads();

  // the max reduction of (time key, -index)
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const int o = threadIdx.x + w;
      if (best_i[o] != 0x7fffffff &&
          (best_i[threadIdx.x] == 0x7fffffff || best_k[o] > best_k[threadIdx.x] ||
           (best_k[o] == best_k[threadIdx.x] && best_i[o] < best_i[threadIdx.x]))) {
        best_k[threadIdx.x] = best_k[o];
        best_i[threadIdx.x] = best_i[o];
      }
    }
    __syncthreads();
  }

  // the sum: strided halving over the padded samples
  for (int w = Tp / 2; w > 0; w >>= 1) {
    for (int i = threadIdx.x; i < w; i += blockDim.x) acc[i] = __dadd_rn(acc[i], acc[i + w]);
    __syncthreads();
  }

  // bitonic sort of (key, index) ascending
  for (int k = 2; k <= Tp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < Tp; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & k) == 0;
          const bool gt = pair_less(key[l], idx[l], key[i], idx[i]);
          if (gt == up) {
            const u64 tk = key[i];
            key[i] = key[l];
            key[l] = tk;
            const int ti = idx[i];
            idx[i] = idx[l];
            idx[l] = ti;
          }
        }
      }
      __syncthreads();
    }
  }

  if (threadIdx.x == 0) {
    const int c = cnt_s;
    const double avg = __ddiv_rn(__dadd_rn(acc[0], 0.0), (double)c);
    // a NaN mean is the canonical quiet NaN, whatever payload the adds kept
    out[s] = c == 0 ? 0.0 : (avg != avg ? __longlong_as_double(0x7FF8000000000000LL) : avg);
    const float ps[4] = {p50, p90, p95, p99};
    for (int r = 0; r < 4; ++r) {
      int q = (int)__fmul_rn((float)c, ps[r]) - 1;
      q = q < 0 ? 0 : (q > T - 1 ? T - 1 : q);
      const int src = idx[q];
      out[(size_t)(1 + r) * S + s] = c == 0 ? 0.0 : (ok[src] ? v[src] : kBig);
    }
    out[(size_t)5 * S + s] = c == 0 ? 0.0 : v[best_i[0]];
  }
}

// ------------------------------------------------------------ agg_warp

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The sort's layout is blocked: lane l holds positions l * ES ... l * ES +
// ES - 1, so partners fewer than ES apart share a lane (21 of the 36
// stages at 256 keys) and the others are a shuffle away (15 stages).

// One stage's compare-exchanges of partners JS positions apart in the same
// lane.  JS is a constant, so every slot index is, and the arrays stay in
// registers.
template <int ES, int JS>
__device__ __forceinline__ void in_lane(u64 (&key)[ES], int (&idx)[ES], int k, int lane) {
#pragma unroll
  for (int s = 0; s < ES; ++s) {
    const int t = s | JS;
    if ((s & JS) == 0 && t < ES) {
      const bool up = ((lane * ES + s) & k) == 0;
      if (pair_less(key[t], idx[t], key[s], idx[s]) == up) {
        const u64 tk = key[s];
        key[s] = key[t];
        key[t] = tk;
        const int ti = idx[s];
        idx[s] = idx[t];
        idx[t] = ti;
      }
    }
  }
}

// Bitonic sort, ascending by (key, index), of the n positions a warp holds
// (n a power of two: 32 * ES, or at most 32 with ES = 1, when the lanes
// from n on hold padding and sort among themselves).
template <int ES>
__device__ __forceinline__ void warp_bitonic(u64 (&key)[ES], int (&idx)[ES], int n, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < ES) {
        if (j == 1)
          in_lane<ES, 1>(key, idx, k, lane);
        else if (j == 2)
          in_lane<ES, 2>(key, idx, k, lane);
        else
          in_lane<ES, 4>(key, idx, k, lane);
      } else {
        const int lj = j / ES;  // the partner lane's distance
        const bool lower = (lane & lj) == 0;
        const bool up = ((lane * ES) & k) == 0;  // k > j >= ES: the slot's bits lie below k
#pragma unroll
        for (int s = 0; s < ES; ++s) {
          const u64 ok = __shfl_xor_sync(kFull, key[s], lj);
          const int oi = __shfl_xor_sync(kFull, idx[s], lj);
          // the lower position of an ascending pair keeps the smaller
          if (pair_less(ok, oi, key[s], idx[s]) == (lower == up)) {
            key[s] = ok;
            idx[s] = oi;
          }
        }
      }
    }
  }
}

// The index held at sorted position q, to every lane.
template <int ES>
__device__ __forceinline__ int held_at(const int (&idx)[ES], int q) {
  int sel = idx[0];
#pragma unroll
  for (int s = 1; s < ES; ++s)
    if ((q & (ES - 1)) == s) sel = idx[s];
  return __shfl_sync(kFull, sel, q / ES);
}

// The m keys of a warp's shared memory sorted by (key, position), n the
// power of two at or above m: the positions of the order statistics q.
// A compacted sample's position orders as the index it came from.
template <int ES>
__device__ __forceinline__ void sorted_at(const u64* sk, int m, int n, int lane,
                                          const int (&q)[4], int (&src)[4]) {
  u64 key[ES];
  int idx[ES];
#pragma unroll
  for (int s = 0; s < ES; ++s) {
    const int p = lane * ES + s;
    key[s] = p < m ? sk[p] : ~0ULL;  // padding: after every sample
    idx[s] = p;
  }
  warp_bitonic<ES>(key, idx, n, lane);
#pragma unroll
  for (int r = 0; r < 4; ++r) src[r] = held_at<ES>(idx, q[r]);
}

// ET: positions a lane, Tp / 32 (1 for Tp <= 32).
template <int ET>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
    agg_warp(const double* values, const uint8_t* valid, const double* times, int S, int T,
             int Tp, float p50, float p90, float p95, float p99, double* out) {
  __shared__ u64 skey[kWarps][kWarpMaxT];
  __shared__ double sval[kWarps][kWarpMaxT];
  __shared__ int sidx[kWarps][kWarpMaxT];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + w;
  if (s >= S) return;  // the whole warp
  const double* v = values + (size_t)s * T;
  const uint8_t* ok = valid + (size_t)s * T;
  const double* tm = times + (size_t)s * T;

  bool o[ET];
  unsigned bal[ET];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < ET; ++j) {
    const int i = lane + 32 * j;
    o[j] = i < T && ok[i];
  }
#pragma unroll
  for (int j = 0; j < ET; ++j) {
    bal[j] = __ballot_sync(kFull, o[j]);
    cnt += __popc(bal[j]);
  }
  // the valid samples' indices compacted in index order (ballot prefix)
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one
  {
    int base = 0;
#pragma unroll
    for (int j = 0; j < ET; ++j) {
      if (bal[j]) {  // warp-uniform: a slot with a valid sample
        if (o[j]) sidx[w][base + __popc(bal[j] & lt)] = lane + 32 * j;
        base += __popc(bal[j]);
      }
    }
  }
  __syncwarp();
  // their values and times, one a lane a chunk of 32, the chunks' loads
  // issued together: an invalid sample loads nothing
  double xs[ET], ts[ET];
#pragma unroll
  for (int c = 0; c < ET; ++c) {
    xs[c] = 0.0;
    ts[c] = 0.0;
    const int p = lane + 32 * c;
    if (32 * c < cnt && p < cnt) {
      const int i = sidx[w][p];
      xs[c] = v[i];
      ts[c] = tm[i];
    }
  }
  const u64 big = koord_radix::f64_key(kBig), low = koord_radix::f64_key(-kBig);
  bool huge = false;
  u64 bk = 0;  // the largest valid time key, its first index and value
  int bi = kNone;
  double bv = 0.0;
#pragma unroll
  for (int c = 0; c < ET; ++c) {
    const int p = lane + 32 * c;
    if (32 * c < cnt && p < cnt) {
      const u64 kx = koord_radix::f64_key(xs[c]);
      huge |= kx >= big;
      skey[w][p] = kx;  // for the order statistics
      sval[w][p] = xs[c];
      // the first index of the largest time, NaN above everything (the
      // compacted order is the index order)
      const u64 tk = koord_radix::f64_key(ts[c]);
      if (bi == kNone || tk > bk) {
        bk = tk;
        bi = sidx[w][p];
        bv = xs[c];
      }
    }
  }
  __syncwarp();
  // the sum's terms at their positions: a valid sample's value, else 0.0
  double a[ET];
  {
    int base = 0;
#pragma unroll
    for (int j = 0; j < ET; ++j) {
      a[j] = 0.0;
      if (bal[j]) {
        if (o[j]) a[j] = sval[w][base + __popc(bal[j] & lt)];
        base += __popc(bal[j]);
      }
    }
  }

  // the halving tree: w >= 32 inside a lane, then across lanes
#pragma unroll
  for (int h = ET / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) a[j] = __dadd_rn(a[j], a[j + h]);
  }
  double sum = a[0];
  for (int h = (Tp < 32 ? Tp : 32) / 2; h > 0; h >>= 1)
    sum = __dadd_rn(sum, __shfl_down_sync(kFull, sum, h));

  // the max of (time key, -index) over the valid samples of the warp
  for (int d = 16; d > 0; d >>= 1) {
    const u64 ok2 = __shfl_xor_sync(kFull, bk, d);
    const int oi = __shfl_xor_sync(kFull, bi, d);
    const double ov = __shfl_xor_sync(kFull, bv, d);
    if (oi != kNone && (bi == kNone || ok2 > bk || (ok2 == bk && oi < bi))) {
      bk = ok2;
      bi = oi;
      bv = ov;
    }
  }

  double* o0 = out + s;
  if (cnt == 0) {
    if (lane < 6) o0[(size_t)lane * S] = 0.0;
    return;
  }
  if (bk <= low) {
    // every valid time at or below -1e300, the key of every invalid sample:
    // the first invalid index may come first, and then its raw value is
    // the last, as the plain version gathers it
    int f = kNone;
#pragma unroll
    for (int j = ET - 1; j >= 0; --j) {
      const unsigned inv = __ballot_sync(kFull, !o[j] && lane + 32 * j < T);
      if (inv) f = 32 * j + __ffs(inv) - 1;
    }
    if (f != kNone && (bk < low || f < bi)) bv = v[f];
  }
  const float ps[4] = {p50, p90, p95, p99};
  int q[4], qmax = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q[r] = (int)__fmul_rn((float)cnt, ps[r]) - 1;
    q[r] = q[r] < 0 ? 0 : (q[r] > T - 1 ? T - 1 : q[r]);
    qmax = q[r] > qmax ? q[r] : qmax;
  }
  // The order statistics lie among the valid samples unless a valid key
  // is at or above 1e300's: then the full order, every position with the
  // invalid samples as 1e300 (the valid values loaded again, L1 hits).
  const bool full = __any_sync(kFull, huge) || qmax >= cnt;
  int m = cnt;
  if (full) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ET; ++j) {
      const int i = lane + 32 * j;
      skey[w][i] = i < T ? koord_radix::f64_key(o[j] ? v[i] : kBig) : ~0ULL;
    }
    m = Tp;
  }
  __syncwarp();
  int n = 1;
  while (n < m) n <<= 1;
  int src[4];
  if (n <= 32)
    sorted_at<1>(skey[w], m, n, lane, q, src);
  else if (n <= 64)
    sorted_at<cmin(ET, 2)>(skey[w], m, n, lane, q, src);
  else if (n <= 128)
    sorted_at<cmin(ET, 4)>(skey[w], m, n, lane, q, src);
  else
    sorted_at<cmin(ET, 8)>(skey[w], m, n, lane, q, src);
  double pv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    pv[r] = full ? (ok[src[r]] ? v[src[r]] : kBig) : sval[w][src[r]];

  if (lane == 0) {
    const double avg = __ddiv_rn(__dadd_rn(sum, 0.0), (double)cnt);
    // a NaN mean is the canonical quiet NaN, whatever payload the adds kept
    o0[0] = avg != avg ? __longlong_as_double(0x7FF8000000000000LL) : avg;
  } else if (lane <= 4) {
    o0[(size_t)lane * S] = lane == 1 ? pv[0] : lane == 2 ? pv[1] : lane == 3 ? pv[2] : pv[3];
  } else if (lane == 5) {
    o0[(size_t)5 * S] = bv;
  }
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// values, times: [S, T] float64; valid: [S, T] bool; ps: the four percentiles
// as float32; out: [6, S] float64 (avg, p50, p90, p95, p99, last).  agg_warp
// takes T <= kWarpMaxT, agg_kernel T up to kMaxT.
extern "C" int koord_aggregate_node_metrics(const void* values, const void* valid,
                                            const void* times, int S, int T, const float* ps,
                                            void* out, int device, void* stream) {
  if (S < 0 || T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  if (S == 0) return (int)cudaSuccess;
  int Tp = 1;
  while (Tp < T) Tp <<= 1;
  const double* v = (const double*)values;
  const uint8_t* ok = (const uint8_t*)valid;
  const double* tm = (const double*)times;
  double* o = (double*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (T <= kWarpMaxT) {
    const int blocks = (S + kWarps - 1) / kWarps;
    const int threads = kWarps * 32;
    if (Tp <= 32)
      agg_warp<1><<<blocks, threads, 0, st>>>(v, ok, tm, S, T, Tp, ps[0], ps[1], ps[2], ps[3], o);
    else if (Tp == 64)
      agg_warp<2><<<blocks, threads, 0, st>>>(v, ok, tm, S, T, Tp, ps[0], ps[1], ps[2], ps[3], o);
    else if (Tp == 128)
      agg_warp<4><<<blocks, threads, 0, st>>>(v, ok, tm, S, T, Tp, ps[0], ps[1], ps[2], ps[3], o);
    else
      agg_warp<8><<<blocks, threads, 0, st>>>(v, ok, tm, S, T, Tp, ps[0], ps[1], ps[2], ps[3], o);
  } else {
    const size_t smem = (size_t)Tp * (sizeof(u64) + sizeof(double) + sizeof(int));
    agg_kernel<<<S, kThreads, smem, st>>>(v, ok, tm, S, T, Tp, ps[0], ps[1], ps[2], ps[3], o);
  }
  return (int)cudaGetLastError();
}
