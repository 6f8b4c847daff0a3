// The reservation plugin's scores: the `rsv_rscore` and `rsv_score` kernels,
// one template a launch.
//
// Replaces: the JAX package's `rsv_rscore` (core/reservation.py:65
// score_reservation, registered at service/engine.py:298) and `rsv_score`
// (core/reservation.py:96 reservation_score, registered at
// service/engine.py:294; the library registration `reservation_score` at
// core/reservation.py:94 is the same function).
//
// rsv_kernel<SCORES>: one block a pod.  Without SCORES (`rsv_rscore`) the
//   block writes the pod's [Rv] scoreReservation row (scoring.go:183-203:
//   MostAllocated over the reservation's non-zero allocatable, the sum of
//   100*req/cap over the fitting dimensions divided by the dimension count,
//   floor divisions), one thread a reservation.  With SCORES (`rsv_score`,
//   and both rows in one launch when the rscore output is given) the block
//   (0) streams zeros over its [N] score row from its entry on, 16 bytes a
//   store, (1) scores its row and lists its matched reservations in index
//   order (ballots across all warps), staging each one's node, order rank
//   and scoreReservation in shared memory, (2) for each distinct node among
//   them takes the matched reservation with the smallest order rank —
//   ranks are dense 1-based (order, index) ranks from the host, 0 when
//   unordered — else the largest scoreReservation (0 when negative), (3)
//   gives the node of the pod's overall smallest rank the most-preferred
//   score 1000, (4) normalizes by the row maximum, floor(s * 100 / max), an
//   all-zero row staying 0, and after a block barrier, which orders them
//   behind the zeros at the same addresses, writes the few scored nodes.
//   An empty node scores 0, the segment min/max identity read as "none
//   ordered" and "none matched".
//
// Bound on an H100: bytes, the [P, N] int64 output (134 MB of mostly zeros
// at 1,024 x 16,384: 0.040 ms at 3.35 TB/s).  The store stream starts at
// the kernel's entry, so no thread waits on the serial parts before its
// zeros; the shared memory holds the matched entries, sized by Rv (32
// bytes a reservation: 8.3 KB at 256, 131 KB at KOORD_RSV_MAX, past 48 KB
// through cudaFuncSetAttribute).  The quotients take no 64-bit `/` where their
// operands are in range: 100*used/cap (0 <= used <= cap < 2**56) from a
// float estimate and one exact correction, the dimension mean and the
// normalization (operands below 2**31) in 32 bits; outside, the exact
// floor division.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define KOORD_RSV_MAX 4096  // reservations one rsv_score launch takes
#define KOORD_RSV_MAXR 8    // KOORD_MAXR in pair.cuh: the request's dimensions

namespace {

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// floor(a / b) for 0 <= a and 1 <= b, both below 2**31, in 32 bits; else
// the exact floor division
__device__ __forceinline__ long long floordiv_small(long long a, long long b) {
  if (((unsigned long long)a | (unsigned long long)b) < (1ULL << 31) && b > 0)
    return (long long)((unsigned)a / (unsigned)b);
  return floordiv(a, b);
}

// floor(100 * used / cap) for 0 <= used <= cap, 1 <= cap < 2**56 (so 100 *
// used < 2**63): the float quotient of the float operands is within 2e-5 of
// t = 100 * used / cap in [0, 100] (three roundings of 2**-24 relative and
// __fdividef's 2 ulp), so its truncation is floor(t) or one off either
// way, and the remainder's sign and size correct it exactly (the product
// q * cap stays below 101 * 2**56).  Outside, the exact floor division of
// the wrapped product, as the reference computes it.
__device__ __forceinline__ long long quot100(long long used, long long cap) {
  const long long a = (long long)((unsigned long long)used * 100ULL);
  if (used >= 0 && used <= cap && cap < (1LL << 56)) {
    const long long q = (long long)__fdividef((float)a, (float)cap);
    const long long r = a - q * cap;
    return q + (r >= cap ? 1 : 0) - (r < 0 ? 1 : 0);
  }
  return floordiv(a, cap);
}

// scoreReservation (scoring.go:183-203) of the pod's request `req` against
// reservation v
__device__ __forceinline__ long long score_rsv(const long long* req, const long long* alloc,
                                               const long long* allocated, int v, int Rf) {
  long long s = 0, w = 0;
  for (int r = 0; r < Rf; ++r) {
    const long long cap = alloc[(size_t)v * Rf + r];
    if (cap == 0) continue;
    ++w;
    const long long used =
        (long long)((unsigned long long)req[r] + (unsigned long long)allocated[(size_t)v * Rf + r]);
    if (used <= cap) s = (long long)((unsigned long long)s + (unsigned long long)quot100(used, cap));
  }
  return w == 0 ? 0 : floordiv_small(s, w);
}

// zeros over row[0, N) from 16-byte streaming stores; a row that starts 8
// bytes into a 16-byte line (odd p * N) takes a scalar head, an odd rest a
// scalar tail
__device__ __forceinline__ void zero_row(long long* row, int N, int t, int T) {
  const int head = (int)(((uintptr_t)row >> 3) & 1) & (N > 0 ? 1 : 0);
  const int pairs = (N - head) >> 1;
  longlong2* body = reinterpret_cast<longlong2*>(row + head);
  const longlong2 z = make_longlong2(0, 0);
  for (int i = t; i < pairs; i += T) __stcs(body + i, z);
  if (t == 0 && head) __stcs(row, 0LL);
  if (t == T - 1 && ((N - head) & 1)) __stcs(row + N - 1, 0LL);
}

struct RsvShared {
  long long* rs;     // [M] each matched entry's scoreReservation
  long long* rank;   // [M] its order rank
  long long* score;  // [M] on a node's first entry, the node's score
  int* node;         // [M] its node
  int* first;        // [M] 1 on the first entry of its node
  int* warp_base;    // [32] the warps' exclusive offsets within a chunk
  int* chunk;        // the chunk's matches
  int* n;            // the entries listed so far
  long long* max;    // the row maximum
  unsigned long long* pref;  // (rank << 32 | entry) of the pod's smallest rank
};

// the layout of rsv_smem(M) bytes of dynamic shared memory
__device__ __forceinline__ RsvShared rsv_shared(void* base, int M) {
  RsvShared s;
  s.rs = static_cast<long long*>(base);
  s.rank = s.rs + M;
  s.score = s.rank + M;
  s.max = s.score + M;
  s.pref = reinterpret_cast<unsigned long long*>(s.max + 1);
  s.node = reinterpret_cast<int*>(s.pref + 1);
  s.first = s.node + M;
  s.warp_base = s.first + M;
  s.chunk = s.warp_base + 32;
  s.n = s.chunk + 1;
  return s;
}

template <bool SCORES>
__global__ void rsv_kernel(const long long* __restrict__ req, const int* __restrict__ node,
                           const long long* __restrict__ alloc,
                           const long long* __restrict__ allocated,
                           const long long* __restrict__ rank, const uint8_t* __restrict__ matched,
                           int Rv, int Rf, int N, long long* __restrict__ rscore_out,
                           long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long s_req[KOORD_RSV_MAXR];
  const int p = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, warps = (T + 31) >> 5;
  long long* row = SCORES ? out + (size_t)p * N : nullptr;
  // (0) the zeros, first: nothing below waits on them until the barrier
  // before the scored entries
  if (SCORES) zero_row(row, N, t, T);
  if (t < Rf) s_req[t] = req[(size_t)p * Rf + t];
  RsvShared s{};
  if (SCORES) {
    s = rsv_shared(smem_raw, Rv);
    if (t == 0) {
      *s.n = 0;
      *s.max = 0;
      *s.pref = ~0ULL;
    }
  }
  __syncthreads();
  // (1) the rscore row, one thread a reservation, and the matched entries
  // in index order: a chunk of T reservations a pass, each warp's hits at
  // its exclusive offset
  const uint8_t* m = SCORES ? matched + (size_t)p * Rv : nullptr;
  long long* rrow = rscore_out ? rscore_out + (size_t)p * Rv : nullptr;
  for (int base = 0; base < Rv; base += T) {
    const int v = base + t;
    const bool in = v < Rv;
    const bool hit = SCORES && in && m[v];
    long long rs = 0;
    if (in && (rrow || hit)) rs = score_rsv(s_req, alloc, allocated, v, Rf);
    if (in && rrow) rrow[v] = rs;
    if (SCORES) {
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s.warp_base[warp] = __popc(ballot);
      __syncthreads();
      if (warp == 0) {
        const int c = lane < warps ? s.warp_base[lane] : 0;
        int inc = c;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, d);
          if (lane >= d) inc += y;
        }
        __syncwarp();
        if (lane < warps) s.warp_base[lane] = inc - c;
        if (lane == 31) *s.chunk = inc;
      }
      __syncthreads();
      const int k0 = *s.n;
      if (hit) {
        const int k = k0 + s.warp_base[warp] + __popc(ballot & ((1u << lane) - 1));
        s.rs[k] = rs;
        s.rank[k] = rank[v];
        s.node[k] = node[v];
      }
      __syncthreads();
      if (t == 0) *s.n = k0 + *s.chunk;
      __syncthreads();
    }
  }
  if constexpr (SCORES) {
    const int n = *s.n;
    // (2) each distinct node's score, on its first entry; the pod's
    // smallest positive rank (the first entry on a tie)
    const long long none = (long long)Rv + 1;
    for (int i = t; i < n; i += T) {
      const int j = s.node[i];
      const long long rk = s.rank[i];
      if (rk > 0 && rk < none) atomicMin(s.pref, ((unsigned long long)rk << 32) | (unsigned)i);
      bool first = true;
      for (int k = 0; k < i && first; ++k) first = s.node[k] != j;
      s.first[i] = first;
      if (!first) continue;
      long long best = LLONG_MIN, min_rank = none, ordered = 0;
      for (int k = i; k < n; ++k) {
        if (s.node[k] != j) continue;
        const long long r = s.rs[k];
        best = max(best, r);
        const long long q = s.rank[k];
        if (q > 0 && q < min_rank) {
          min_rank = q;
          ordered = r;
        }
      }
      s.score[i] = min_rank <= Rv ? ordered : (best >= 0 ? best : 0);
    }
    __syncthreads();
    // (3) the most-preferred node scores 1000; the row maximum (0 stands
    // for the other nodes' zeros; a score below 0 is never the maximum:
    // it is an ordered one, and then the preferred node holds 1000)
    const unsigned long long pk = *s.pref;
    const int pref = pk == ~0ULL ? -1 : s.node[(unsigned)(pk & 0xffffffffu)];
    for (int i = t; i < n; i += T) {
      if (!s.first[i]) continue;
      if (s.node[i] == pref) s.score[i] = 1000;
      atomicMax(s.max, s.score[i]);
    }
    __syncthreads();
    // (4) the normalized scores, behind the zeros (the barriers above order
    // every zero store of the block before these)
    const long long mx = *s.max;
    if (mx <= 0) return;
    for (int i = t; i < n; i += T) {
      const int j = s.node[i];
      if (!s.first[i] || j < 0 || j >= N) continue;
      const long long sc = s.score[i];
      row[j] = sc >= 0 && sc < (1LL << 24) ? floordiv_small(sc * 100, mx)
                                           : floordiv((long long)((unsigned long long)sc * 100ULL), mx);
    }
  }
}

// the dynamic shared memory of rsv_kernel<true> for M matched entries
// (rsv_shared's layout)
size_t rsv_smem(int M) {
  return (size_t)M * (3 * 8 + 2 * 4) + 2 * 8 + 34 * 4;
}

// the block: 1,024 threads, each streaming 8 of a 16,384-column row's
// 16-byte stores (256, 512 and 1,024 within noise at 1,024 and at 16 pods
// on an H100 80GB HBM3 at 700 W, `chip_smoke.py --rsv`)
constexpr int kRsvThreads = 1024;

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_rsv_rscore(const void* req, const void* alloc, const void* allocated, int P,
                                int Rv, int Rf, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (Rf > KOORD_RSV_MAXR) return (int)cudaErrorInvalidValue;
  const int threads = Rv < 256 ? ((Rv + 31) / 32) * 32 : 256;
  rsv_kernel<false><<<P, threads > 0 ? threads : 32, 0, (cudaStream_t)stream>>>(
      (const long long*)req, nullptr, (const long long*)alloc, (const long long*)allocated,
      nullptr, nullptr, Rv, Rf, 0, (long long*)out, nullptr);
  return (int)cudaGetLastError();
}

// One launch of rsv_kernel<true>: the [P, N] scores into `out` and, when
// `rscore` is not null, the [P, Rv] scoreReservation rows into it.
extern "C" int koord_rsv_score(const void* req, const void* node, const void* alloc,
                               const void* allocated, const void* rank, const void* matched, int P,
                               int Rv, int Rf, int N, void* rscore, void* out, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (Rv > KOORD_RSV_MAX || Rf > KOORD_RSV_MAXR) return (int)cudaErrorInvalidValue;
  const size_t smem = rsv_smem(Rv > 0 ? Rv : 1);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rsv_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsv_kernel<true><<<P, kRsvThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)req, (const int*)node, (const long long*)alloc,
      (const long long*)allocated, (const long long*)rank, (const uint8_t*)matched, Rv, Rf, N,
      (long long*)rscore, (long long*)out);
  return (int)cudaGetLastError();
}
