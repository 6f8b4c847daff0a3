// The placement-policy mask: which node columns are open to each pod
// signature under node selectors, hard taints and required anti-affinity.
//
// Replaces: the JAX package's `placement` kernel, service/engine.py:276
// placement_mask_fn — four int32 matrix products of [M, vocab] indicator
// rows into the [N, vocab] policy rows.  The pod side is sparse (a selector
// names a few label pairs; a signature's untolerated taints, matching
// holder selectors and selected label sets are short lists), so here each
// signature's four lists arrive as CSR index lists built on the host, and
// one thread per (signature, node) walks them:
//   1. the selector pairs present on the node are counted against sel_cnt
//      (a pair absent from the vocab counts there but never matches);
//   2. any listed taint set on the node closes it;
//   3. any listed holder column with a positive count closes it (an
//      assigned pod's anti-affinity selects the signature);
//   4. any listed label-set column with a positive count closes it (the
//      signature's own anti-affinity selects an assigned pod).
// The counts of 3 and 4 are summed, as the matrix products sum them.
//
// Bound on an H100: bytes.  Each thread reads its signature's lists (from
// cache: a block's threads share m) and a few scattered bytes of its node's
// rows; the output is one byte per pair.  Consecutive threads take
// consecutive nodes, so the output writes coalesce.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Lists {
  const int* sel_off;
  const int* sel_idx;
  const int* sel_cnt;
  const int* tol_off;
  const int* tol_idx;
  const int* hold_off;
  const int* hold_idx;
  const int* aa_off;
  const int* aa_idx;
};

__global__ void placement_kernel(Lists s, const uint8_t* labels, const uint8_t* taints,
                                 const int* aa_cnt, const int* sig_cnt, int Lb, int Tb, int Sb,
                                 int Gb, int M, int N, uint8_t* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (j >= N || m >= M) return;
  int present = 0;
  for (int k = s.sel_off[m]; k < s.sel_off[m + 1]; ++k)
    present += labels[(size_t)j * Lb + s.sel_idx[k]];
  bool ok = present == s.sel_cnt[m];
  for (int k = s.tol_off[m]; ok && k < s.tol_off[m + 1]; ++k)
    ok = !taints[(size_t)j * Tb + s.tol_idx[k]];
  long long held = 0;
  for (int k = s.hold_off[m]; k < s.hold_off[m + 1]; ++k)
    held += aa_cnt[(size_t)j * Sb + s.hold_idx[k]];
  long long sel = 0;
  for (int k = s.aa_off[m]; k < s.aa_off[m + 1]; ++k)
    sel += sig_cnt[(size_t)j * Gb + s.aa_idx[k]];
  out[(size_t)m * N + j] = ok && held <= 0 && sel <= 0;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_placement(const void* sel_off, const void* sel_idx, const void* sel_cnt,
                               const void* tol_off, const void* tol_idx, const void* hold_off,
                               const void* hold_idx, const void* aa_off, const void* aa_idx,
                               const void* labels, const void* taints, const void* aa_cnt,
                               const void* sig_cnt, int Lb, int Tb, int Sb, int Gb, int M, int N,
                               void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Lists s = {(const int*)sel_off,  (const int*)sel_idx,  (const int*)sel_cnt,
             (const int*)tol_off,  (const int*)tol_idx,  (const int*)hold_off,
             (const int*)hold_idx, (const int*)aa_off,   (const int*)aa_idx};
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, M);
  placement_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      s, (const uint8_t*)labels, (const uint8_t*)taints, (const int*)aa_cnt, (const int*)sig_cnt,
      Lb, Tb, Sb, Gb, M, N, (uint8_t*)out);
  return (int)cudaGetLastError();
}
