// The device path's two kernels: joint-allocation feasibility and the
// deviceshare score, per (request signature, node column).
//
// 1. dev_feasible replaces the JAX package's `dev_feasible`
//    (service/engine.py:292 device_feasible_fn), the policy-free dense
//    check (the machine-wide spill decides existence, so per-device free
//    shares, the full-free count and the VF total suffice): a multi-GPU
//    request needs `count` fully free devices; a partial share needs ONE
//    device with core >= core_req and memory ratio >= ratio_req (a loop
//    over the node's Gm device slots; padded slots hold -1 and never
//    pass); then the node's VF total must hold rdma_need, and the
//    signature must be valid.  One thread per (signature, node); bound on
//    an H100 by bytes (8 * Gm + 8 read, 1 written a pair), each thread's
//    reads of its node's row contiguous.
//
// 2. ds_score replaces `ds_score` (engine.py:384, core/nodefit.py
//    nodefit_score) under the deviceshare static the engine passes
//    (engine.py:925-936): MostAllocated over the (core, memory ratio)
//    aggregates, weights (1, 1), a dimension bypassed when the request
//    asks none of it or the node has no capacity there.  An overcommitted
//    dimension clamps to the capacity.  The divisions floor, as the
//    reference's integer division does, also should a used share exceed the
//    inventory's.  One thread per (request, node); bound by bytes (32 read,
//    8 written).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Sigs {
  const uint8_t* has_gpu;
  const uint8_t* is_multi;
  const int* count;
  const int* core_req;
  const int* ratio_req;
  const int* rdma_need;
  const uint8_t* sig_valid;
};

__global__ void dev_feasible_kernel(const int* core, const int* mem, const int* full,
                                    const int* vfs, Sigs s, int M, int N, int Gm, uint8_t* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (j >= N || m >= M) return;
  bool gpu_ok = true;
  if (s.has_gpu[m]) {
    if (s.is_multi[m]) {
      gpu_ok = full[j] >= s.count[m];
    } else {
      gpu_ok = false;
      const int* c = core + (size_t)j * Gm;
      const int* r = mem + (size_t)j * Gm;
      for (int g = 0; g < Gm && !gpu_ok; ++g)
        gpu_ok = c[g] >= s.core_req[m] && r[g] >= s.ratio_req[m];
    }
  }
  out[(size_t)m * N + j] = gpu_ok && vfs[j] >= s.rdma_need[m] && s.sig_valid[m];
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void ds_score_kernel(const long long* req, const long long* alloc2,
                                const long long* used2, int M, int N, long long* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (j >= N || m >= M) return;
  long long acc = 0, wsum = 0;
  for (int r = 0; r < 2; ++r) {
    const long long cap = alloc2[(size_t)j * 2 + r];
    const long long preq = req[(size_t)m * 2 + r];
    if (cap == 0 || preq == 0) continue;  // no capacity, or bypassed
    long long tot = preq + used2[(size_t)j * 2 + r];
    if (tot > cap) tot = cap;  // the overcommit clamp
    acc += floor_div(tot * 100, cap);
    wsum += 1;
  }
  out[(size_t)m * N + j] = wsum == 0 ? 0 : floor_div(acc, wsum);
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_dev_feasible(const void* core, const void* mem, const void* full,
                                  const void* vfs, const void* has_gpu, const void* is_multi,
                                  const void* count, const void* core_req, const void* ratio_req,
                                  const void* rdma_need, const void* sig_valid, int M, int N,
                                  int Gm, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Sigs s = {(const uint8_t*)has_gpu,  (const uint8_t*)is_multi, (const int*)count,
            (const int*)core_req,     (const int*)ratio_req,    (const int*)rdma_need,
            (const uint8_t*)sig_valid};
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, M);
  dev_feasible_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)core, (const int*)mem, (const int*)full, (const int*)vfs, s, M, N, Gm,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int koord_ds_score(const void* req, const void* alloc2, const void* used2, int M,
                              int N, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, M);
  ds_score_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)req, (const long long*)alloc2, (const long long*)used2, M, N,
      (long long*)out);
  return (int)cudaGetLastError();
}
