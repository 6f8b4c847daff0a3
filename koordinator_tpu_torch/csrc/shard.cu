// SCORE over one node shard of the mesh: the column block [col0, col0 + Nb)
// of every pending pod's row, written into a [P, N] totals buffer and a [P, N]
// feasibility mask at the same columns.
//
// Replaces: the JAX package's `shard_score_map` (koordinator_tpu/service/
// sharding.py:456-520, `_smap_fn`; the body `build`/`blk` at :480-505): under
// shard_map each mesh device evaluates core/cycle.py:195 score_batch over its
// block of the node axis (LoadAware least-requested + NodeFit under the
// configured strategy, weighted), adds the block's extra scores and ANDs the
// block's live-column mask.  Here each mesh device takes one launch over its
// block: with every block on one card they write straight into one [P, N]
// buffer (col0 = the block's first column, N the buffer's leading
// dimension); a block on a card of its own reads its copies of the node rows
// (col0 = 0, N = Nb) and the caller copies its [P, Nb] result back once.
//
// The pair function is csrc/pair.cuh's, shared with the `score` kernel, so all
// three NodeFit strategies are served and a block equals the same columns of
// the unsharded `score` kernel's output.  What bounds it on an H100: bytes, as
// the `score` kernel (9 output bytes a pair); one thread a pair, consecutive
// threads on consecutive columns of one pod row.
#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

__global__ void shard_score_kernel(Cfg c, PodIn p, NodeIn n, const uint8_t* valid,
                                   const long long* xsc, int P, int N, int col0, int Nb,
                                   long long* totals, uint8_t* feasible) {
  const int j = col0 + blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (j >= col0 + Nb || q >= P) return;
  const size_t o = (size_t)q * N + j;
  totals[o] = pair_total(c, p, n, q, j) + (xsc ? xsc[o] : 0);
  feasible[o] = valid[j] && la_fit(c, p, n, q, j) && nf_fit(c, p, n, q, j);
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// pods, nodes, cfg, la_w, valid: the pair tables of `koord_score` over N node
// columns; xsc: [P, N] int64 extra scores or null; the block is columns
// [col0, col0 + Nb) of N; totals [P, N] int64, feasible [P, N] bool.
extern "C" int koord_shard_score(const void* const* pods, const void* const* nodes,
                                 const long long* cfg, const void* la_w, const void* valid,
                                 const void* xsc, int P, int N, int col0, int Nb, void* totals,
                                 void* feasible, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (P < 0 || Nb < 0 || col0 < 0 || col0 + Nb > N || P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (P == 0 || Nb == 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid((Nb + threads - 1) / threads, P);
  shard_score_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      koord_cfg(cfg, la_w), koord_pods(pods), koord_nodes(nodes), (const uint8_t*)valid,
      (const long long*)xsc, P, N, col0, Nb, (long long*)totals, (uint8_t*)feasible);
  return (int)cudaGetLastError();
}
