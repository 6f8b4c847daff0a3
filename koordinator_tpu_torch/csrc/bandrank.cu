// The descheduler arbitrator's QoS/priority-band victim order: the PodSorter
// chain of pkg/descheduler/utils/sorter/pod.go as one lexsort.
//
// Replaces the JAX package's jax.jit program `pod_band_rank`
// (koordinator_tpu/core/deschedule.py:223-271, `_band_rank`): np.lexsort over
// (index, -create_time, [-usage], eviction_cost, deletion_cost, koord QoS
// rank, k8s QoS rank, priority, koord priority-class rank), minor to major ->
// the [P] eviction-order permutation, bit-identical to
// core/evictor.py pod_sort_order.
//
// Each key is one run of stable 8-bit radix passes (radix.cuh) over its
// mapped 64-bit key: eight for the int64 and float64 columns, one for the
// int8 ranks; -0.0 and 0.0 tie and NaN create times sort last, as np.lexsort
// orders them.  What bounds it on an H100: the launches (two a pass, about
// seventy at P = 32,768); the bytes (~1 MB) take well under a microsecond.
#include <cuda_runtime.h>

#include <cstdint>

#include "radix.cuh"

namespace {

constexpr int kMaxKeys = 16;

__global__ void widen(const int* perm, int n, long long* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = perm[i];
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" long long koord_band_scratch_bytes(long long P) {
  return (long long)koord_radix::bufs_bytes(P);
}

// K key columns, MINOR first, each described by (pointer, element bytes,
// koord_radix::KeyMode, key bits); out: [P] int64 permutation.
extern "C" int koord_band_rank(const void* const* cols, const int* elems, const int* modes,
                               const int* bits, int K, int P, void* out, void* scratch,
                               int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K <= 0 || K > kMaxKeys || P <= 0) return (int)cudaErrorInvalidValue;
  koord_radix::LexKey keys[kMaxKeys];
  for (int j = 0; j < K; ++j) keys[j] = {cols[j], elems[j], modes[j], bits[j]};
  unsigned char* p = (unsigned char*)scratch;
  const koord_radix::Bufs b = koord_radix::carve(p, P);
  const cudaStream_t st = (cudaStream_t)stream;
  const int* perm;
  if ((e = koord_radix::lexsort(keys, K, P, b, &perm, st)) != cudaSuccess) return (int)e;
  widen<<<(P + koord_radix::kThreads - 1) / koord_radix::kThreads, koord_radix::kThreads, 0,
          st>>>(perm, P, (long long*)out);
  return (int)cudaGetLastError();
}
