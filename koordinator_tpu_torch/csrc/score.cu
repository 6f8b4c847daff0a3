// SCORE: every pending pod against every node, the [P, N] int64 totals and
// the [P, N] feasibility mask in one pass.
//
// Replaces: the JAX package's `score` kernel, service/engine.py:134
// score_fn -> core/cycle.py:195 score_batch (LoadAware least-requested +
// NodeFit under the configured strategy — LeastAllocated, MostAllocated or
// RequestedToCapacityRatio, pair.cuh nf_score —, weighted; LoadAware
// thresholds && NodeFit fit && the live-column mask), under the default
// profile's plugin weights, plus
// the batch's pre-weighted extra scores (deviceshare, amplified CPU; [P, N]
// int64, null when absent) as the JAX score_fn adds them.
//
// What bounds it on an H100: bytes.  The outputs alone are 9 bytes per
// pair (144 MB at 1,024 x 16,384), against a few dozen integer operations
// per pair; the node rows it reads are 1/P of that.  The design therefore
// writes each output once, coalesced (one thread per pair, consecutive
// threads on consecutive node columns of one pod row), keeps no
// intermediate in device memory, and reads the pod's row from cache
// (every thread of a block shares it).
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void score_kernel(Cfg c, PodIn p, NodeIn n, const uint8_t* valid,
                             const long long* xsc, int P, int N, long long* totals,
                             uint8_t* feasible) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int q = blockIdx.y;
  if (j >= N || q >= P) return;
  size_t o = (size_t)q * N + j;
  totals[o] = pair_total(c, p, n, q, j) + (xsc ? xsc[o] : 0);
  feasible[o] = valid[j] && la_fit(c, p, n, q, j) && nf_fit(c, p, n, q, j);
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_score(const void* const* pods, const void* const* nodes,
                           const long long* cfg, const void* la_w, const void* valid,
                           const void* xsc, int P, int N, void* totals, void* feasible,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, P);
  score_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), (const uint8_t*)valid,
      (const long long*)xsc, P, N, (long long*)totals, (uint8_t*)feasible);
  return (int)cudaGetLastError();
}
