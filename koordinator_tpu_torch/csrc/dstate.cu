// The device residency's three kernels: delta scatter, vocabulary-axis
// widening and time gating of the resident node tables.
//
// 1. scatter_rows replaces the JAX package's `dstate_scatter`
//    (koordinator_tpu/service/state.py:200 scatter_fn): for every resident
//    buffer a, buf_a[idx[k]] = vals_a[k].  The wrapper packs the index and
//    every array's rows into ONE device buffer (one host->device copy);
//    one launch walks a descriptor table of (buffer, row bytes, offset of
//    its rows in the packed buffer), grid.y = the array.  Duplicate
//    indices (the power-of-two padding repeats a real row) carry identical
//    bytes, so any writer is right.  Bound on an H100: bytes (D rows of
//    19 arrays, ~0.2 KB a row), in practice the launch latency; a
//    byte-wise copy keeps every row width and alignment right.
//
// 2. extend replaces `dstate_extend` (state.py:208 extend_fn): widen a
//    resident table's vocabulary axis, [N, c] -> a fresh [N, c'] buffer
//    whose old columns are the resident bytes and whose new columns hold
//    the fill the host growth wrote (False, 0 or -1).  One launch widens
//    every buffer of a table, grid.y = the buffer, walking a descriptor
//    table of (source, destination, widths, element size, fill); the old
//    buffers are only read, so a launch still reading them is safe.  Bound
//    on an H100: bytes (the old table read once, the new one written
//    once).
//
// 3. gate replaces `dstate_gate` (state.py:222 gate_fn), the device twin
//    of snapshot.loadaware.gate_node_rows: raw resident rows + now -> the
//    four gated [N] masks.  Elementwise, bound by bytes (12 bytes read and
//    4 written a node).  The expiry test is the reference's float64
//    comparison `!(now - update_time < exp)`, so a NaN update time counts
//    as expired; no fast-math, so the compare is IEEE exact.
#include <cuda_runtime.h>

#include <cstdint>

#define KOORD_DSTATE_MAX_ARRAYS 32

namespace {

struct ScatterDesc {
  unsigned char* dst[KOORD_DSTATE_MAX_ARRAYS];
  long long row_bytes[KOORD_DSTATE_MAX_ARRAYS];
  long long src_off[KOORD_DSTATE_MAX_ARRAYS];
};

__global__ void scatter_rows(ScatterDesc s, const unsigned char* packed, int D) {
  const int a = blockIdx.y;
  const int* idx = (const int*)packed;
  const long long rb = s.row_bytes[a];
  const long long total = (long long)D * rb;
  const unsigned char* src = packed + s.src_off[a];
  unsigned char* dst = s.dst[a];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long k = i / rb;
    dst[(long long)idx[k] * rb + (i - k * rb)] = src[i];
  }
}

struct ExtendDesc {
  const unsigned char* src[KOORD_DSTATE_MAX_ARRAYS];
  unsigned char* dst[KOORD_DSTATE_MAX_ARRAYS];
  long long old_cols[KOORD_DSTATE_MAX_ARRAYS];
  long long new_cols[KOORD_DSTATE_MAX_ARRAYS];
  int elem[KOORD_DSTATE_MAX_ARRAYS];
  long long fill[KOORD_DSTATE_MAX_ARRAYS];
};

template <typename T>
__device__ void widen(const T* src, T* dst, long long oc, long long nc, long long rows, T fill) {
  const long long total = rows * nc;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / nc, c = i - r * nc;
    dst[i] = c < oc ? src[r * oc + c] : fill;
  }
}

__global__ void extend(ExtendDesc d, long long rows) {
  const int a = blockIdx.y;
  const long long oc = d.old_cols[a], nc = d.new_cols[a];
  switch (d.elem[a]) {
    case 1:
      widen<uint8_t>(d.src[a], d.dst[a], oc, nc, rows, (uint8_t)d.fill[a]);
      break;
    case 4:
      widen<int>((const int*)d.src[a], (int*)d.dst[a], oc, nc, rows, (int)d.fill[a]);
      break;
    default:
      widen<long long>((const long long*)d.src[a], (long long*)d.dst[a], oc, nc, rows,
                       d.fill[a]);
  }
}

__global__ void gate(int N, const uint8_t* has_metric, const double* update_time,
                     const uint8_t* filter_active, const uint8_t* prod_active,
                     const uint8_t* has_prod_thr, double now, int has_exp, int exp_pos, double exp,
                     int fexp, uint8_t* score_valid, uint8_t* filter_active_out,
                     uint8_t* prod_active_out, uint8_t* has_prod_thr_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  bool expired = false;
  if (has_exp) {
    const double ut = update_time[j];
    expired = isnan(ut);
    if (exp_pos) expired = expired || !(now - ut < exp);
  }
  const bool filter_live = fexp ? !expired : true;
  score_valid[j] = has_metric[j] && !expired;
  filter_active_out[j] = filter_active[j] && filter_live;
  prod_active_out[j] = prod_active[j] && filter_live;
  has_prod_thr_out[j] = has_prod_thr[j] && filter_live;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_dstate_scatter(int n, const void* const* dst, const long long* row_bytes,
                                    const void* packed, const long long* src_off, int D,
                                    int device, void* stream) {
  if (n < 1 || n > KOORD_DSTATE_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ScatterDesc s;
  long long widest = 0;
  for (int a = 0; a < n; ++a) {
    s.dst[a] = (unsigned char*)dst[a];
    s.row_bytes[a] = row_bytes[a];
    s.src_off[a] = src_off[a];
    if (row_bytes[a] > widest) widest = row_bytes[a];
  }
  const int threads = 256;
  long long blocks = ((long long)D * widest + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  scatter_rows<<<dim3((unsigned)blocks, n), threads, 0, (cudaStream_t)stream>>>(
      s, (const unsigned char*)packed, D);
  return (int)cudaGetLastError();
}

extern "C" int koord_dstate_extend(int n, const void* const* src, void* const* dst,
                                   const long long* old_cols, const long long* new_cols,
                                   const int* elem, const long long* fill, int rows, int device,
                                   void* stream) {
  if (n < 1 || n > KOORD_DSTATE_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ExtendDesc d;
  long long widest = 0;
  for (int a = 0; a < n; ++a) {
    if (elem[a] != 1 && elem[a] != 4 && elem[a] != 8) return (int)cudaErrorInvalidValue;
    d.src[a] = (const unsigned char*)src[a];
    d.dst[a] = (unsigned char*)dst[a];
    d.old_cols[a] = old_cols[a];
    d.new_cols[a] = new_cols[a];
    d.elem[a] = elem[a];
    d.fill[a] = fill[a];
    if (new_cols[a] > widest) widest = new_cols[a];
  }
  const int threads = 256;
  long long blocks = ((long long)rows * widest + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  extend<<<dim3((unsigned)blocks, n), threads, 0, (cudaStream_t)stream>>>(d, rows);
  return (int)cudaGetLastError();
}

extern "C" int koord_dstate_gate(int N, const void* has_metric, const void* update_time,
                                 const void* filter_active, const void* prod_active,
                                 const void* has_prod_thr, double now, int has_exp, int exp_pos,
                                 double exp, int fexp, void* score_valid, void* filter_active_out,
                                 void* prod_active_out, void* has_prod_thr_out, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  gate<<<(N + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      N, (const uint8_t*)has_metric, (const double*)update_time, (const uint8_t*)filter_active,
      (const uint8_t*)prod_active, (const uint8_t*)has_prod_thr, now, has_exp, exp_pos, exp, fexp,
      (uint8_t*)score_valid, (uint8_t*)filter_active_out, (uint8_t*)prod_active_out,
      (uint8_t*)has_prod_thr_out);
  return (int)cudaGetLastError();
}
