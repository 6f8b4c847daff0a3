// The reservation plugin's scores: the `rsv_rscore` and `rsv_score` kernels.
//
// Replaces: the JAX package's `rsv_rscore` (core/reservation.py:65
// score_reservation, registered at service/engine.py:298) and `rsv_score`
// (core/reservation.py:96 reservation_score, registered at
// service/engine.py:294; the library registration `reservation_score` at
// core/reservation.py:94 is the same function).
//
// rsv_rscore: one thread per (pod, reservation), a loop over the filter
//   axis: scoreReservation, MostAllocated over the reservation's non-zero
//   allocatable, sum of 100*req/cap over the fitting dimensions divided by
//   the dimension count (floor divisions).  Bound on an H100: bytes (the
//   [P, Rv] int64 output).
//
// rsv_score: one block per pod row.  Only the nodes that carry one of the
//   pod's matched reservations can score above 0, so the block (1) lists
//   the pod's matched reservations in index order (ballot compaction),
//   (2) for each distinct node among them takes the matched reservation
//   with the smallest order rank — ranks are dense 1-based (order, index)
//   ranks computed on the host, 0 when unordered — else the largest
//   scoreReservation, (3) gives the node of the pod's overall smallest rank
//   the most-preferred score 1000, (4) normalizes by the row maximum,
//   floor(s * 100 / max), an all-zero row staying 0, and writes the [N]
//   row: zeros, then the few scored nodes.  An empty node scores 0, which
//   is the segment min/max identity read as "none ordered" and "none
//   matched".  Bound on an H100: bytes (the [P, N] int64 output, mostly
//   zeros: 134 MB at 1,024 x 16,384).
#include <cuda_runtime.h>

#include <cstdint>

#define KOORD_RSV_MAX 4096  // reservations one rsv_score launch takes (shared lists)

namespace {

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// scoreReservation (scoring.go:183-203) of pod row `req` against
// reservation v
__device__ __forceinline__ long long score_rsv(const long long* req, const long long* alloc,
                                               const long long* allocated, int v, int Rf) {
  long long s = 0, w = 0;
  for (int r = 0; r < Rf; ++r) {
    const long long cap = alloc[(size_t)v * Rf + r];
    if (cap == 0) continue;
    ++w;
    const long long used = req[r] + allocated[(size_t)v * Rf + r];
    if (used <= cap) s += floordiv(used * 100, cap);
  }
  return w == 0 ? 0 : floordiv(s, w);
}

__global__ void rscore_kernel(const long long* req, const long long* alloc,
                              const long long* allocated, int P, int Rv, int Rf, long long* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * Rv) return;
  const int p = (int)(i / Rv), v = (int)(i % Rv);
  out[i] = score_rsv(req + (size_t)p * Rf, alloc, allocated, v, Rf);
}

__global__ void score_kernel(const long long* req, const int* node, const long long* alloc,
                             const long long* allocated, const long long* rank,
                             const uint8_t* matched, int Rv, int Rf, int N, long long* out) {
  __shared__ int s_list[KOORD_RSV_MAX];
  __shared__ int s_score[KOORD_RSV_MAX];  // per entry: its node's score (<= 1000), -1 repeated
  __shared__ int s_n, s_pref, s_max;
  const int p = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const uint8_t* m = matched + (size_t)p * Rv;
  const long long* preq = req + (size_t)p * Rf;
  // (1) the matched reservations in index order
  if (t < 32) {
    int n = 0;
    for (int base = 0; base < Rv; base += 32) {
      const int v = base + t;
      const bool hit = v < Rv && m[v];
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) s_list[n + __popc(mask & ((1u << t) - 1))] = v;
      n += __popc(mask);
    }
    if (t == 0) {
      s_n = n;
      s_max = 0;
    }
  }
  __syncthreads();
  const int n = s_n;
  // (2) the score of each distinct node among them, on its first entry
  for (int i = t; i < n; i += T) {
    const int j = node[s_list[i]];
    bool first = true;
    for (int k = 0; k < i && first; ++k) first = node[s_list[k]] != j;
    long long sc = -1;
    if (first) {
      long long best = -1, min_rank = (long long)Rv + 1, ordered = 0;
      for (int k = i; k < n; ++k) {
        const int v = s_list[k];
        if (node[v] != j) continue;
        const long long rs = score_rsv(preq, alloc, allocated, v, Rf);
        best = max(best, rs);
        const long long rk = rank[v];
        if (rk > 0 && rk < min_rank) {
          min_rank = rk;
          ordered = rs;
        }
      }
      sc = min_rank <= Rv ? ordered : best;
    }
    s_score[i] = (int)sc;
  }
  // (3) the pod's most-preferred reservation: its node scores 1000
  if (t == 0) {
    long long min_rank = (long long)Rv + 1;
    int pref = -1;
    for (int i = 0; i < n; ++i) {
      const long long rk = rank[s_list[i]];
      if (rk > 0 && rk < min_rank) {
        min_rank = rk;
        pref = node[s_list[i]];
      }
    }
    s_pref = pref;
  }
  __syncthreads();
  for (int i = t; i < n; i += T) {
    if (s_score[i] < 0) continue;
    if (node[s_list[i]] == s_pref) s_score[i] = 1000;
    atomicMax(&s_max, s_score[i]);
  }
  // (4) the normalized row
  long long* row = out + (size_t)p * N;
  for (int j = t; j < N; j += T) row[j] = 0;
  __syncthreads();
  const long long mx = s_max;
  for (int i = t; i < n; i += T)
    if (s_score[i] >= 0 && mx > 0)
      row[node[s_list[i]]] = floordiv((long long)s_score[i] * 100, mx);
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_rsv_rscore(const void* req, const void* node, const void* alloc,
                                const void* allocated, int P, int Rv, int Rf, void* out,
                                int device, void* stream) {
  (void)node;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)P * Rv;
  const int threads = 256;
  rscore_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const long long*)req, (const long long*)alloc, (const long long*)allocated, P, Rv, Rf,
      (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int koord_rsv_score(const void* req, const void* node, const void* alloc,
                               const void* allocated, const void* rank, const void* matched, int P,
                               int Rv, int Rf, int N, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (Rv > KOORD_RSV_MAX) return (int)cudaErrorInvalidValue;
  score_kernel<<<P, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)req, (const int*)node, (const long long*)alloc,
      (const long long*)allocated, (const long long*)rank, (const uint8_t*)matched, Rv, Rf, N,
      (long long*)out);
  return (int)cudaGetLastError();
}
