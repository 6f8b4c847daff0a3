// The placement-policy mask: which node columns are open to each pod
// signature under node selectors, hard taints and required anti-affinity.
//
// Replaces: the JAX package's `placement` kernel, service/engine.py:276
// placement_mask_fn — four int32 matrix products of [M, vocab] indicator
// rows into the [N, vocab] policy rows.  The pod side is sparse (a selector
// names a few label pairs; a signature's untolerated taints, matching
// holder selectors and selected label sets are short lists), so each
// signature's four lists arrive as index lists built on the host, and a
// node is open to signature m iff
//   1. the selector pairs present on the node number sel_cnt[m] (a pair
//      absent from the vocab counts there but never matches);
//   2. none of its listed taints is set on the node;
//   3. its listed holder columns sum to <= 0 on the node (an assigned
//      pod's anti-affinity selects the signature);
//   4. its listed label-set columns sum to <= 0 (the signature's own
//      anti-affinity selects an assigned pod).
// Sums are over the list entries (an index listed twice counts twice), in
// 64 bits, as the matrix products sum them.
//
// Bound on an H100: bytes, of which the node rows' columns the M lists
// name are nearly all.  A thread per (signature, node) walking the lists
// reads each (node, column) once per signature that lists it, each read a
// sector of its own (rows are Lb bytes apart).  Here the host checks the
// lists and rewrites them as positions in the union of the columns they
// name, per table (placeplan.cuh, in this library: a few microseconds
// where numpy took ~0.1 ms), and a block takes a tile of kTile node
// columns:
//   - it gathers each of its nodes' union columns into shared memory once
//     (node-major, so a node's adjacent columns load together), so every
//     (node, union column) is read from device memory once per call;
//   - then a thread takes kRun adjacent nodes and a share of the M
//     signatures, and evaluates them out of shared memory, each list entry
//     read once for its kRun nodes; consecutive threads on consecutive
//     runs, so each row of the [M, N] output is written in runs of kTile
//     bytes.
// The gather issues kUnroll loads a thread before it stores any, so a
// block waits on one round trip to device memory, not one a column.  The
// descriptor travels in the launch's parameters (up to kParamWords words:
// the path's few signatures and the study's 256 alike), read through
// __grid_constant__; a larger one is copied to a device buffer first.  A
// call is then one host plan and one launch, with no copy and no event.
// A union wider than the shared memory the plan allows goes in phases:
// each phase gathers as many union columns as fit (a table split across
// two phases is a chunk in each), the sums of a table still open carry to
// the next phase in a [M, N] int64 scratch, and each (signature, node)'s
// verdict so far in the output itself.  Each thread reads back only what
// it wrote.
#include <cuda_runtime.h>

#include <cstdint>

#include "placeplan.cuh"

namespace {

using namespace koord_place;

constexpr int kRun = 4;       // adjacent node columns a thread evaluates
constexpr int kGroups = 16;   // threads a run, each a share of the signatures
constexpr int kThreads = (kTile / kRun) * kGroups;
constexpr int kUnroll = 8;    // gather loads a thread has in flight
constexpr int kMaxCols = 640;  // union columns a phase: the budget / (kTile bytes)
constexpr int kSmallWords = 512;   // descriptor words of the small parameter block
constexpr int kParamWords = 7680;  // ... of the large one (30 KB; a launch takes 32,764 B)

template <int kW>
struct Words {
  int w[kW];
};

struct Tables {
  const uint8_t* labels;
  const uint8_t* taints;
  const int* aa;
  const int* sig;
  int Lb, Tb, Sb, Gb;
};

__device__ __forceinline__ int load_cell(const Tables& tb, int t, long long row, int col) {
  switch (t) {
    case 0: return tb.labels[row * tb.Lb + col];
    case 1: return tb.taints[row * tb.Tb + col];
    case 2: return tb.aa[row * tb.Sb + col];
    default: return tb.sig[row * tb.Gb + col];
  }
}

// kW > 1: the descriptor in the launch's parameters; 1: at `gdesc`.
template <int kW>
__global__ void __launch_bounds__(kThreads)
    placement_tile(const __grid_constant__ Words<kW> p, const int* __restrict__ gdesc, Tables tb,
                   int N, long long* __restrict__ acc, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int seg[kMaxSegs][kSegWords];
  __shared__ int el[kMaxSegs + 1];  // each segment's first gather element, then the end
  __shared__ int scol[kMaxCols];    // the phase's union columns
  const int* desc = kW > 1 ? p.w : gdesc;
  const int M = desc[0], phases = desc[1];
  const int* sel_cnt = desc + desc[3];
  const int* segs = desc + kHead + 2 * phases;
  const int j0 = blockIdx.x * kTile;
  const int r0 = (threadIdx.x % (kTile / kRun)) * kRun, g = threadIdx.x / (kTile / kRun);
  const int rows = min(kTile, N - j0);
  for (int ph = 0; ph < phases; ++ph) {
    const int s0 = desc[kHead + 2 * ph], ns = desc[kHead + 2 * ph + 1] - s0;
    __syncthreads();  // the phase before has read its segments and columns
    if (threadIdx.x < kMaxSegs * kSegWords) {  // a word a thread; no segment: no table
      const int s = threadIdx.x / kSegWords, x = threadIdx.x % kSegWords;
      seg[s][x] = s < ns ? segs[(s0 + s) * kSegWords + x] : (x == W_TABLE ? -1 : 0);
    }
    // the phase's union columns, each less its table's shift, and each
    // segment's first gather element (a node-major [rows][U] block each),
    // from the descriptor itself (the segments' copy is not yet visible)
    int cols = 0;
    for (int s = 0; s < ns; ++s) {
      const int* w = segs + (s0 + s) * kSegWords;
      const int u0 = w[W_U0], U = w[W_U1] - u0;
      for (int u = threadIdx.x; u < U; u += kThreads)
        scol[w[W_AT] + u] = desc[w[W_COLS] + u0 + u] - w[W_BASE];
      if (threadIdx.x == 0) el[s] = rows * w[W_AT];
      cols = w[W_AT] + U;
    }
    if (threadIdx.x <= kMaxSegs && threadIdx.x >= ns) el[threadIdx.x] = rows * cols;
    __syncthreads();
    // the gather: each (node, union column) of the phase once, a node's
    // columns on consecutive threads, kUnroll loads in flight a thread
    const int E = el[kMaxSegs];
    for (int i0 = threadIdx.x; i0 < E; i0 += kThreads * kUnroll) {
      int val[kUnroll], at[kUnroll];
      bool wide[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k * kThreads;
        at[k] = -1;
        val[k] = 0;
        wide[k] = false;
        if (i < E) {
          const int s = (i >= el[1]) + (i >= el[2]) + (i >= el[3]);
          const int U = seg[s][W_U1] - seg[s][W_U0], local = i - el[s];
          const int n = local / U, u = local - n * U;
          const int t = seg[s][W_TABLE];
          val[k] = load_cell(tb, t, j0 + n, scol[seg[s][W_AT] + u]);
          wide[k] = t >= 2;
          at[k] = seg[s][W_SMEM] + (n * seg[s][W_STRIDE] + u) * (wide[k] ? 4 : 1);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (at[k] < 0) continue;
        if (wide[k])
          *(int*)(smem + at[k]) = val[k];
        else
          smem[at[k]] = (uint8_t)val[k];
      }
    }
    __syncthreads();
    if (j0 + r0 >= N) continue;
    // the signatures over this thread's run of nodes, out of shared memory
    const int nr = min(kRun, N - j0 - r0);
    for (int m = g; m < M; m += kGroups) {
      const size_t o = (size_t)m * N + j0 + r0;
      bool ok[kRun];
#pragma unroll
      for (int q = 0; q < kRun; ++q) ok[q] = ph == 0 || (q < nr && out[o + q]);
      for (int s = 0; s < kMaxSegs; ++s) {
        const int t = seg[s][W_TABLE], flags = seg[s][W_FLAGS];
        if (t < 0) continue;
        const int u0 = seg[s][W_U0], stride = seg[s][W_STRIDE];
        const unsigned U = seg[s][W_U1] - u0;
        const int b = desc[seg[s][W_BEG] + m], e = desc[seg[s][W_END] + m];
        const int* pos = desc + seg[s][W_POS];
        long long sum[kRun];
#pragma unroll
        for (int q = 0; q < kRun; ++q) sum[q] = (flags & SEG_FIRST) || q >= nr ? 0 : acc[o + q];
        // an entry outside [u0, u1) is another segment's (a table split
        // across phases)
        if (t < 2) {
          const uint8_t* v = smem + seg[s][W_SMEM] + r0 * stride;
          for (int k = b; k < e; ++k) {
            const unsigned x = pos[k] - u0;
            if (x < U) {
#pragma unroll
              for (int q = 0; q < kRun; ++q) sum[q] += v[q * stride + x];
            }
          }
        } else {
          const int* v = (const int*)(smem + seg[s][W_SMEM]) + r0 * stride;
          for (int k = b; k < e; ++k) {
            const unsigned x = pos[k] - u0;
            if (x < U) {
#pragma unroll
              for (int q = 0; q < kRun; ++q) sum[q] += v[q * stride + x];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          if (!(flags & SEG_LAST)) {
            if (q < nr) acc[o + q] = sum[q];
          } else if (t == 0) {
            ok[q] = ok[q] && sum[q] == sel_cnt[m];
          } else {
            ok[q] = ok[q] && sum[q] <= 0;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRun; ++q)
        if (q < nr) out[o + q] = ok[q];
    }
  }
}

// the calling thread's last plan (koord_placement_plan), launched by
// koord_placement
thread_local Plan g_plan;
thread_local Words<kParamWords> g_words;

template <int kW>
cudaError_t launch(const Words<kW>& w, const int* gdesc, const Tables& tb, int N, void* acc,
                   void* out, cudaStream_t st) {
  const int smem = g_plan.smem;
  cudaError_t e;
  if (smem > 48 * 1024 - 4096 &&
      (e = cudaFuncSetAttribute(placement_tile<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess)
    return e;
  placement_tile<kW><<<(N + kTile - 1) / kTile, kThreads, smem, st>>>(
      w, gdesc, tb, N, (long long*)acc, (uint8_t*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Checks and plans one call on the host (placeplan.cuh) for the calling
// thread's next koord_placement: flat, the wrapper's concatenated lists;
// dims, each list's entries then each table's width; budget, a phase's
// shared memory.  info: [0] 0, or -1 when the lists are refused; [1] the
// descriptor's words; [2] the largest phase's shared memory; [3] whether a
// table spans two phases (the launch then needs an [M, N] int64 scratch).
extern "C" int koord_placement_plan(const int* flat, int M, const int* dims, int budget,
                                    int* info) {
  info[0] = budget > kMaxCols * kTile ? -1 : make_plan(flat, M, dims, dims + 4, budget, g_plan);
  info[1] = (int)g_plan.desc.size();
  info[2] = g_plan.smem;
  info[3] = g_plan.carries;
  return 0;
}

// The calling thread's last plan's descriptor into out (cap words); its
// words, or -1 when it does not fit.
extern "C" int koord_placement_desc(int* out, int cap) {
  const int n = (int)g_plan.desc.size();
  if (n > cap) return -1;
  std::copy(g_plan.desc.begin(), g_plan.desc.end(), out);
  return n;
}

extern "C" int koord_placement_param_words() { return kParamWords; }

// Launches the calling thread's last plan: labels, taints [N, Lb], [N, Tb]
// bool; aa_cnt, sig_cnt [N, Sb], [N, Gb] int32; acc: an [M, N] int64
// scratch when the plan carries, else null; ddesc: a device buffer of the
// descriptor's words when it exceeds kParamWords (copied there first),
// else null; out: [M, N] bool.
extern "C" int koord_placement(const void* labels, const void* taints, const void* aa_cnt,
                               const void* sig_cnt, int Lb, int Tb, int Sb, int Gb, int N,
                               void* acc, void* ddesc, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int words = (int)g_plan.desc.size();
  if (N <= 0 || words < kHead || (g_plan.carries && !acc)) return (int)cudaErrorInvalidValue;
  const Tables tb{(const uint8_t*)labels, (const uint8_t*)taints, (const int*)aa_cnt,
                  (const int*)sig_cnt, Lb, Tb, Sb, Gb};
  const cudaStream_t st = (cudaStream_t)stream;
  if (words <= kSmallWords) {
    Words<kSmallWords> w;
    std::copy(g_plan.desc.begin(), g_plan.desc.end(), w.w);
    return (int)launch(w, nullptr, tb, N, acc, out, st);
  }
  if (words <= kParamWords) {
    std::copy(g_plan.desc.begin(), g_plan.desc.end(), g_words.w);
    return (int)launch(g_words, nullptr, tb, N, acc, out, st);
  }
  if (!ddesc) return (int)cudaErrorInvalidValue;
  if ((e = cudaMemcpyAsync(ddesc, g_plan.desc.data(), (size_t)words * 4, cudaMemcpyHostToDevice,
                           st)) != cudaSuccess)
    return (int)e;
  return (int)launch(Words<1>{}, (const int*)ddesc, tb, N, acc, out, st);
}
