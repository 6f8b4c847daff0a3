// The device path's two kernels: joint-allocation feasibility and the
// deviceshare score, per (request signature, node column).
//
// 1. dev_feasible replaces the JAX package's `dev_feasible`
//    (service/engine.py:292 device_feasible_fn), the policy-free dense
//    check (the machine-wide spill decides existence, so per-device free
//    shares, the full-free count and the VF total suffice): a multi-GPU
//    request needs `count` fully free devices; a partial share needs ONE
//    device with core >= core_req and memory ratio >= ratio_req (padded
//    slots hold -1 and never pass); then the node's VF total must hold
//    rdma_need, and the signature must be valid.  What bounds it on an
//    H100 is the launch: its bytes (8 Gm + 8 read a node, 1 written a
//    pair) take well under a microsecond.  The design:
//   - a thread owns one node column: it reads the node's Gm core and
//     memory slots once (16-byte vectors, Gm a template parameter for 8
//     and 16; a generic instantiation reads each slot where it lies) and
//     its full-free count and VF total once, into registers;
//   - the signatures ride in the launch's parameters, packed as kSigWords
//     int32 words each (core/placement.py pack_device_sigs), up to kSigCap
//     of them; past that the caller uploads the block in one copy ahead of
//     the launch and passes its device address;
//   - a block row (blockIdx.y) takes kSigChunk signatures, so many
//     signatures spread over the card, and stages their words in shared
//     memory once (read from the parameters word by word, every thread's
//     loads took the generic path: on an H100, 0.023 ms at 128 signatures
//     against 0.0095 at 200 from global memory); each signature's test
//     runs from registers against them (a warp reads the same words: one
//     broadcast), and row m of the [M, N] output is written coalesced;
//   - the node rows are bound once per set of resident rows on the host
//     (core/placement.py DeviceStage: a descriptor of their pointers, N,
//     Gm and the device), so a call passes the descriptor, the host block
//     of signatures, M and the output.
//
// 2. ds_score replaces `ds_score` (engine.py:384, core/nodefit.py
//    nodefit_score) under the deviceshare static the engine passes
//    (engine.py:925-936), with the engine's numa weight applied
//    (engine.py:899-944): MostAllocated over the (core, memory ratio)
//    aggregates, weights (1, 1), a dimension bypassed when the request
//    asks none of it or the node has no capacity there, the result times
//    `weight`.  An overcommitted dimension clamps to the capacity.  The
//    divisions floor, as the reference's integer division does, also
//    should a used share exceed the inventory's; sums and products wrap as
//    the plain version's int64 tensors do.  What bounds it on an H100 is
//    the launch: its bytes (32 read a node, 8 written a pair) take under a
//    microsecond at 16 x 16,384.  The design, dev_feasible's:
//   - a thread owns one node column of a chunk of kReqChunk requests: it
//     reads the node's alloc2 and used2 rows once (one 16-byte load each
//     when both rows are 16-byte aligned, a generic instantiation
//     otherwise) into registers and scores the chunk from them;
//   - the requests ride in the launch's parameters as int64 pairs, up to
//     kReqCap of them (past that, one upload the caller made); a block row
//     takes a chunk and stages it in shared memory once, and row m of the
//     [M, N] output is written coalesced;
//   - on the store's rows a capacity is 100 x the device count, so a
//     dimension whose total and capacity fit (0 <= total x 100 < 2**31,
//     0 < cap < 2**31) divides in 32 bits; any other takes floor_div.
//     The mean over one or two dimensions is the sum or its floor half
//     (an arithmetic shift), so no division remains there;
//   - the rows are the DeviceStage's (its descriptor holds their pointers
//     beside dev_feasible's), so a call passes the descriptor, the host
//     block of requests, M, the weight and the output.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "pair.cuh"

namespace {

// a packed signature (core/placement.py pack_device_sigs): its words and
// the bits of its flags word
constexpr int kSigWords = 5;
enum SigWord { kFlags = 0, kCount = 1, kCoreReq = 2, kRatioReq = 3, kRdmaNeed = 4 };
enum SigFlag { kHasGpu = 1, kIsMulti = 2, kValid = 4 };
// signatures the launch's parameters carry (2,560 bytes); more go to the
// card in one copy
constexpr int kSigCap = 128;
constexpr int kSigChunk = 16;  // signatures a block row takes
constexpr int kFeasThreads = 128;

struct SigBlock {
  int w[kSigCap * kSigWords];
};

// the bound node rows (DeviceStage's descriptor: the four pointers, N, Gm)
struct DevRows {
  const int* core;  // [N, Gm]
  const int* mem;   // [N, Gm]
  const int* full;  // [N]
  const int* vfs;   // [N]
  int N, Gm;
};

// a signature's test for a node with `full` fully free devices, `vfs` VFs
// and Gm device slots, slot(k) device k's (core, memory ratio)
template <class Slot>
__device__ __forceinline__ bool sig_ok(const int* g, int full, int vfs, int Gm, Slot slot) {
  const int f = g[kFlags];
  bool gpu_ok = true;
  if (f & kHasGpu) {
    if (f & kIsMulti) {
      gpu_ok = full >= g[kCount];
    } else {
      const int cr = g[kCoreReq], rr = g[kRatioReq];
      gpu_ok = false;
#pragma unroll
      for (int k = 0; k < Gm; ++k) {
        const int2 cm = slot(k);
        gpu_ok |= cm.x >= cr && cm.y >= rr;
      }
    }
  }
  return gpu_ok && vfs >= g[kRdmaNeed] && (f & kValid);
}

// GM > 0: the node's slots as GM / 4 16-byte vectors of each row, kept in
// registers (the rows 16-byte aligned); GM = 0: the Gm slots read where
// they lie.  DEV: the signatures in device memory (`dsig`), not in the
// parameters.
template <int GM, bool DEV>
__global__ void __launch_bounds__(kFeasThreads)
    dev_feasible_kernel(const DevRows r, int M, const __grid_constant__ SigBlock sb,
                        const int* dsig, uint8_t* out) {
  // the block row's signatures, staged once: a warp then reads each word
  // as one shared-memory broadcast
  __shared__ int sw[kSigChunk * kSigWords];
  const int s0 = blockIdx.y * kSigChunk, cnt = min(M - s0, kSigChunk);
  const int* src = (DEV ? dsig : sb.w) + (size_t)s0 * kSigWords;
  for (int t = threadIdx.x; t < cnt * kSigWords; t += kFeasThreads) sw[t] = src[t];
  __syncthreads();
  const int j = blockIdx.x * kFeasThreads + threadIdx.x;
  if (j >= r.N) return;
  const int full = r.full[j], vfs = r.vfs[j];
  uint8_t* o = out + (size_t)s0 * r.N + j;
  if constexpr (GM > 0) {
    int c[GM], m[GM];
    const int4* c4 = reinterpret_cast<const int4*>(r.core + (size_t)j * GM);
    const int4* m4 = reinterpret_cast<const int4*>(r.mem + (size_t)j * GM);
#pragma unroll
    for (int k = 0; k < GM / 4; ++k) {
      const int4 a = __ldg(c4 + k), b = __ldg(m4 + k);
      c[4 * k] = a.x, c[4 * k + 1] = a.y, c[4 * k + 2] = a.z, c[4 * k + 3] = a.w;
      m[4 * k] = b.x, m[4 * k + 1] = b.y, m[4 * k + 2] = b.z, m[4 * k + 3] = b.w;
    }
    for (int s = 0; s < cnt; ++s)
      o[(size_t)s * r.N] =
          sig_ok(sw + s * kSigWords, full, vfs, GM, [&](int k) { return make_int2(c[k], m[k]); });
  } else {
    const int* c = r.core + (size_t)j * r.Gm;
    const int* m = r.mem + (size_t)j * r.Gm;
    for (int s = 0; s < cnt; ++s)
      o[(size_t)s * r.N] = sig_ok(sw + s * kSigWords, full, vfs, r.Gm,
                                  [&](int k) { return make_int2(c[k], m[k]); });
  }
}

template <bool DEV>
void launch_feasible(const DevRows& r, int M, const SigBlock& sb, const int* dsig, uint8_t* out,
                     cudaStream_t st) {
  const dim3 grid((r.N + kFeasThreads - 1) / kFeasThreads, (M + kSigChunk - 1) / kSigChunk);
  const bool vec = (((uintptr_t)r.core | (uintptr_t)r.mem) & 15) == 0;
  if (vec && r.Gm == 8)
    dev_feasible_kernel<8, DEV><<<grid, kFeasThreads, 0, st>>>(r, M, sb, dsig, out);
  else if (vec && r.Gm == 16)
    dev_feasible_kernel<16, DEV><<<grid, kFeasThreads, 0, st>>>(r, M, sb, dsig, out);
  else
    dev_feasible_kernel<0, DEV><<<grid, kFeasThreads, 0, st>>>(r, M, sb, dsig, out);
}

// the calling thread's parameter block
thread_local SigBlock g_sigs;

// requests the launch's parameters carry (2,048 bytes); more go to the
// card in one copy
constexpr int kReqCap = 128;
// requests a block row takes: at 16 requests x 16,384 nodes a chunk of 16
// gave 128 blocks, four warps an SM, too few to hide each thread's run of
// divisions (device 0.0063 ms against the old thread-a-pair kernel's
// 0.0036 on an NVIDIA H100 80GB HBM3 at 700 W); 4 gives 512 blocks
constexpr int kReqChunk = 4;
constexpr int kScoreThreads = 128;

struct ReqBlock {
  long long w[kReqCap * 2];
};

// the aggregates' rows at the stage's columns (the descriptor's words 7
// and 8), N and the device
struct AggRows {
  const long long* alloc2;  // [N, 2]
  const long long* used2;   // [N, 2]
  int N;
};

// one dimension's MostAllocated share, req * 100 / cap after the clamp;
// the caller has excluded cap == 0 and preq == 0
__device__ __forceinline__ long long ds_dim(long long preq, long long used, long long cap) {
  long long tot = wrap_add(preq, used);
  if (tot > cap) tot = cap;  // the overcommit clamp
  if ((unsigned long long)tot <= 21474836ULL && (unsigned long long)cap - 1ULL < 0x7fffffffULL)
    return (long long)((unsigned)(tot * 100) / (unsigned)cap);
  return floor_div(wrap_mul(tot, 100), cap);
}

// VEC: the node's two rows as one 16-byte load each; DEV: the requests in
// device memory (`dreq`), not in the parameters
template <bool VEC, bool DEV>
__global__ void __launch_bounds__(kScoreThreads)
    ds_score_kernel(const AggRows r, int M, long long weight, const __grid_constant__ ReqBlock rb,
                    const long long* dreq, long long* out) {
  __shared__ long long sr[kReqChunk * 2];
  const int s0 = blockIdx.y * kReqChunk, cnt = min(M - s0, kReqChunk);
  const long long* src = (DEV ? dreq : rb.w) + (size_t)s0 * 2;
  for (int t = threadIdx.x; t < cnt * 2; t += kScoreThreads) sr[t] = src[t];
  __syncthreads();
  const int j = blockIdx.x * kScoreThreads + threadIdx.x;
  if (j >= r.N) return;
  long long c0, c1, u0, u1;
  if constexpr (VEC) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(r.alloc2) + j);
    const longlong2 u = __ldg(reinterpret_cast<const longlong2*>(r.used2) + j);
    c0 = a.x, c1 = a.y, u0 = u.x, u1 = u.y;
  } else {
    c0 = r.alloc2[(size_t)j * 2], c1 = r.alloc2[(size_t)j * 2 + 1];
    u0 = r.used2[(size_t)j * 2], u1 = r.used2[(size_t)j * 2 + 1];
  }
  long long* o = out + (size_t)s0 * r.N + j;
  for (int s = 0; s < cnt; ++s) {
    const long long q0 = sr[2 * s], q1 = sr[2 * s + 1];
    long long acc = 0;
    int wsum = 0;
    if (c0 != 0 && q0 != 0) acc = ds_dim(q0, u0, c0), wsum = 1;
    if (c1 != 0 && q1 != 0) acc = wrap_add(acc, ds_dim(q1, u1, c1)), ++wsum;
    // floor(acc / 2) is the arithmetic shift, for any sign
    const long long score = wsum == 2 ? (acc >> 1) : acc;
    o[(size_t)s * r.N] = wrap_mul(score, weight);
  }
}

template <bool DEV>
void launch_score(const AggRows& r, int M, long long weight, const ReqBlock& rb,
                  const long long* dreq, long long* out, cudaStream_t st) {
  const dim3 grid((r.N + kScoreThreads - 1) / kScoreThreads, (M + kReqChunk - 1) / kReqChunk);
  if ((((uintptr_t)r.alloc2 | (uintptr_t)r.used2) & 15) == 0)
    ds_score_kernel<true, DEV><<<grid, kScoreThreads, 0, st>>>(r, M, weight, rb, dreq, out);
  else
    ds_score_kernel<false, DEV><<<grid, kScoreThreads, 0, st>>>(r, M, weight, rb, dreq, out);
}

// the calling thread's parameter block
thread_local ReqBlock g_reqs;

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dev_feasible over the rows of `desc` (int64 [7]: core, mem, full, vfs,
// N, Gm, the device) for M signatures (int32 [M, kSigWords]) into the [M,
// N] bool output; nothing to do when M or N is 0.  Up to kSigCap
// signatures ride in the launch's parameters, copied from the host block
// `sigs`; more are read from `dsigs`, the same block the caller uploaded.
extern "C" int koord_dev_feasible(const long long* desc, const int* sigs, const int* dsigs, int M,
                                  void* out, void* stream) {
  const DevRows r = {(const int*)desc[0], (const int*)desc[1], (const int*)desc[2],
                     (const int*)desc[3], (int)desc[4],       (int)desc[5]};
  if (M < 0 || r.N < 0 || r.Gm < 0 || (M > kSigCap && !dsigs) ||
      (M + kSigChunk - 1) / kSigChunk > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || r.N == 0) return (int)cudaSuccess;
  const cudaError_t e = cudaSetDevice((int)desc[6]);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  uint8_t* o = (uint8_t*)out;
  if (M <= kSigCap) {
    std::copy(sigs, sigs + (size_t)M * kSigWords, g_sigs.w);
    launch_feasible<false>(r, M, g_sigs, nullptr, o, st);
  } else {
    launch_feasible<true>(r, M, g_sigs, dsigs, o, st);
  }
  return (int)cudaGetLastError();
}

// ds_score over the aggregates of `desc` (DeviceStage's int64 [9]: core,
// mem, full, vfs, N, Gm, the device, alloc2, used2) for M requests (int64
// [M, 2]: core percent, memory ratio) into the [M, N] int64 output, each
// score times `weight`; nothing to do when M or N is 0.  Up to kReqCap
// requests ride in the launch's parameters, copied from the host block
// `reqs`; more are read from `dreqs`, the same block the caller uploaded.
extern "C" int koord_ds_score(const long long* desc, const long long* reqs,
                              const long long* dreqs, int M, long long weight, void* out,
                              void* stream) {
  const AggRows r = {(const long long*)desc[7], (const long long*)desc[8], (int)desc[4]};
  if (M < 0 || r.N < 0 || !r.alloc2 || !r.used2 || (M > kReqCap && !dreqs) ||
      (M + kReqChunk - 1) / kReqChunk > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || r.N == 0) return (int)cudaSuccess;
  const cudaError_t e = cudaSetDevice((int)desc[6]);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  long long* o = (long long*)out;
  if (M <= kReqCap) {
    std::copy(reqs, reqs + (size_t)M * 2, g_reqs.w);
    launch_score<false>(r, M, weight, g_reqs, nullptr, o, st);
  } else {
    launch_score<true>(r, M, weight, g_reqs, dreqs, o, st);
  }
  return (int)cudaGetLastError();
}
