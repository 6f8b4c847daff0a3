// The per-plugin scores of SCORE's breakdown and the LoadAware library
// entry point: one thread per (pod, node) pair over the [P, N] outputs,
// evaluating the pair functions of pair.cuh that every other kernel of the
// port shares.
//
// Replaces three jax.jit programs of the JAX package:
//   la_score  core/loadaware.py:77 loadaware_score (registered at
//             service/engine.py:1173): the raw LoadAware score, [P, N]
//             int64, no plugin weight folded in;
//   nf_score  core/nodefit.py:84 nodefit_score (registered at
//             service/engine.py:1169, the strategy static): the raw NodeFit
//             score under LeastAllocated, MostAllocated or
//             RequestedToCapacityRatio (the strategy id and the shape ride
//             in Cfg), [P, N] int64;
//   loadaware_score_and_filter  core/loadaware.py:133: the raw LoadAware
//             score and the LoadAware filter in one pass, [P, N] int64 and
//             [P, N] bool.
//
// What bounds them on an H100: bytes.  Each writes 8 bytes a pair (9 for
// the fused one) against a few dozen integer operations a pair; the node
// rows they read are 1/P of the output.  The design writes each output
// once, coalesced (consecutive threads on consecutive node columns of one
// pod row), keeps no intermediate in device memory, and reads the pod's
// row from cache (every thread of a block shares it).
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void la_score_kernel(Cfg c, PodIn p, NodeIn n, int P, int N, long long* out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int q = blockIdx.y;
  if (j >= N || q >= P) return;
  out[(size_t)q * N + j] = la_score(c, p, n, q, j);
}

__global__ void nf_score_kernel(Cfg c, PodIn p, NodeIn n, int P, int N, long long* out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int q = blockIdx.y;
  if (j >= N || q >= P) return;
  out[(size_t)q * N + j] = nf_score(c, p, n, q, j);
}

__global__ void la_score_filter_kernel(Cfg c, PodIn p, NodeIn n, int P, int N, long long* out,
                                       uint8_t* feasible) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int q = blockIdx.y;
  if (j >= N || q >= P) return;
  size_t o = (size_t)q * N + j;
  out[o] = la_score(c, p, n, q, j);
  feasible[o] = la_fit(c, p, n, q, j);
}

const int kThreads = 256;

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The pod and node pointer tables are laid out as koord_pods/koord_nodes
// read them; the entries a kernel does not read may be null.
extern "C" int koord_la_score(const void* const* pods, const void* const* nodes,
                              const long long* cfg, const void* la_w, int P, int N, void* out,
                              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kThreads - 1) / kThreads, P);
  la_score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), P, N, (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int koord_nf_score(const void* const* pods, const void* const* nodes,
                              const long long* cfg, int P, int N, void* out, int device,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kThreads - 1) / kThreads, P);
  nf_score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, nullptr), koord_pods(pods), koord_nodes(nodes), P, N, (long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int koord_la_score_filter(const void* const* pods, const void* const* nodes,
                                     const long long* cfg, const void* la_w, int P, int N,
                                     void* out, void* feasible, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kThreads - 1) / kThreads, P);
  la_score_filter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), P, N, (long long*)out,
      (uint8_t*)feasible);
  return (int)cudaGetLastError();
}
