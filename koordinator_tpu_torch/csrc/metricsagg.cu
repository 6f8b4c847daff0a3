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
//
// One thread block a series.  The T samples go to shared memory as (key,
// index) pairs, the key radix.cuh's float64 order (-0.0 ties 0.0, every NaN
// last); a bitonic sort over the pairs is jnp.sort's stable order, ties by
// index.  The sum is the strided halving tree over the samples padded with
// zeros to a power of two, then + 0.0 (the reduction's zero, which turns an
// all -0.0 sum into 0.0), divided with __ddiv_rn: the plain version
// (core/metricsagg.py) sums in the same order, so the two agree bit for bit;
// a NaN mean is written as the canonical quiet NaN in both.
// The percentile index is __fmul_rn on floats, never promoted to double.
//
// What bounds it on an H100: the sort.  Reading the samples (17 bytes each)
// takes a few microseconds at 90,000 x 256; the sort does log2(T)^2 / 2
// compare-exchange steps over T / 2 pairs a series with a barrier each.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxT = 2048;  // MAX_T in core/metricsagg.py: 20 bytes a sample of shared memory
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

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// values, times: [S, T] float64; valid: [S, T] bool; ps: the four percentiles
// as float32; out: [6, S] float64 (avg, p50, p90, p95, p99, last).
extern "C" int koord_aggregate_node_metrics(const void* values, const void* valid,
                                            const void* times, int S, int T, const float* ps,
                                            void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S < 0 || T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  int Tp = 1;
  while (Tp < T) Tp <<= 1;
  const size_t smem = (size_t)Tp * (sizeof(u64) + sizeof(double) + sizeof(int));
  agg_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const double*)values, (const uint8_t*)valid, (const double*)times, S, T, Tp, ps[0], ps[1],
      ps[2], ps[3], (double*)out);
  return (int)cudaGetLastError();
}
