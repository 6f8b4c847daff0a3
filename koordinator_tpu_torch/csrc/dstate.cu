// The device residency's three kernels: delta scatter, vocabulary-axis
// widening and time gating of the resident node tables.
//
// 1. scatter_rows replaces the JAX package's `dstate_scatter`
//    (koordinator_tpu/service/state.py:200 scatter_fn): for every resident
//    buffer a, buf_a[idx[k]] = vals_a[k].  The host packs the index and
//    every array's rows into one staging buffer (service/state.py
//    ScatterStage: pinned, grown by doubling and reused, the dirty rows
//    gathered straight into it); koord_dstate_scatter copies it to the
//    device with one cudaMemcpyAsync and launches once over a descriptor
//    built once per set of resident buffers ([n, 2] int64: destination,
//    row bytes; each array's rows start at the next 16-byte boundary of
//    the packed bytes, scatter_layout).  Duplicate indices (the power-of-
//    two padding repeats a real row) carry identical bytes, so any writer
//    is right.  Bound on an H100: the packed bytes over PCIe (D rows of
//    19 arrays, ~0.25 KB a row: ~32 KB, ~0.5 us at 64 GB/s), the device
//    bytes far less; in practice the host's share of a call.  The kernel
//    walks rows, not bytes: a group of lanes (a power of two up to 32, as
//    wide as the row) owns a row of one array and copies it in the widest
//    unit (16, 8, 4, 2 or 1 bytes) that divides the row and both
//    pointers; no per-byte division (the first design divided a 64-bit
//    index by the row width for every byte).
//
// 2. extend replaces `dstate_extend` (state.py:208 extend_fn): widen a
//    resident table's vocabulary axis, [N, c] -> a fresh [N, c'] buffer
//    whose old columns are the resident bytes and whose new columns hold
//    the fill the host growth wrote (False, 0 or -1).  One launch widens
//    every buffer of a table, grid.y = the buffer; the old buffers are
//    only read, so a launch still reading them is safe.  Bound on an
//    H100: bytes (the old table read once, the new one written once), a
//    few microseconds at the residency's 16,384 rows; so in practice the
//    host's share of a call and the launch.  The design walks rows, not
//    flat elements: a group of lanes (a power of two up to 32, as wide as
//    the row) owns a row and copies its old bytes and writes the fill in
//    16-byte vectors wherever both row widths in bytes and both pointers
//    are multiples of 16 (the residency's tables are: the bool table 256
//    -> 512 B a row, the int32 one 32 -> 64 B), else element by element;
//    no per-element division.  The host passes one packed int64
//    descriptor ([n, 6]: source, destination, old and new columns,
//    element size, fill), checks the device without setting it, and the
//    wrapper (service/state.py dstate_extend) validates in one pass and
//    allocates each output with one torch.empty (cheaper on the H100's
//    host than carving one allocation into views).  What is left is host
//    time: PERF.md gives the call and a run of 100 calls beside F.pad's.
//
// 3. gate replaces `dstate_gate` (state.py:222 gate_fn), the device twin
//    of snapshot.loadaware.gate_node_rows: raw resident rows + now -> the
//    four gated [N] masks.  Elementwise, bound by bytes (12 bytes read and
//    4 written a node: ~0.08 us at 16,384 rows), so a call is its launch
//    and the host work around it.  The expiry test is the reference's
//    float64 comparison `!(now - update_time < exp)`, so a NaN update time
//    counts as expired; no fast-math, so the compare is IEEE exact.  The
//    host binds the five inputs once per set of resident rows
//    (service/state.py GateStage: their pointers, N and the device in one
//    int64 descriptor, checked once), so a call passes the descriptor,
//    now, exp, one flags word, one [4, N] output (the masks as its rows)
//    and the stream.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#define KOORD_DSTATE_MAX_ARRAYS 32

namespace {

// KOORD_SCATTER_FIELDS int64 words a buffer in the host descriptor
#define KOORD_SCATTER_FIELDS 2

struct ScatterArr {
  unsigned char* dst;
  long long rb;   // row bytes
  long long off;  // the rows' offset in the packed bytes
  int unit_log;   // log2 of the copy unit: 4 (16 bytes) down to 0
  int lanes_log;  // log2 of the lanes that share a row
};

struct ScatterDesc {
  ScatterArr a[KOORD_DSTATE_MAX_ARRAYS];
};

template <typename U>
__device__ __forceinline__ void copy_row(const unsigned char* src, unsigned char* dst,
                                         long long units, int sub, int lanes) {
  for (long long u = sub; u < units; u += lanes) ((U*)dst)[u] = ((const U*)src)[u];
}

__global__ void scatter_rows(ScatterDesc d, const unsigned char* packed, int D) {
  const ScatterArr& a = d.a[blockIdx.y];
  const int lanes = 1 << a.lanes_log, sub = threadIdx.x & (lanes - 1);
  const int per_block = blockDim.x >> a.lanes_log;
  const int* idx = (const int*)packed;
  const long long units = a.rb >> a.unit_log;
  for (int k = blockIdx.x * per_block + (threadIdx.x >> a.lanes_log); k < D;
       k += gridDim.x * per_block) {
    const unsigned char* src = packed + a.off + (long long)k * a.rb;
    unsigned char* dst = a.dst + (long long)idx[k] * a.rb;
    switch (a.unit_log) {
      case 4: copy_row<uint4>(src, dst, units, sub, lanes); break;
      case 3: copy_row<unsigned long long>(src, dst, units, sub, lanes); break;
      case 2: copy_row<unsigned>(src, dst, units, sub, lanes); break;
      case 1: copy_row<unsigned short>(src, dst, units, sub, lanes); break;
      default: copy_row<unsigned char>(src, dst, units, sub, lanes);
    }
  }
}

// KOORD_EXTEND_FIELDS int64 words a buffer in the packed host descriptor
#define KOORD_EXTEND_FIELDS 6

struct ExtendBuf {
  const unsigned char* src;
  unsigned char* dst;
  long long oc, nc;  // old and new columns
  long long fill;
  uint4 pat;         // the fill repeated over 16 bytes
  int elem;          // element bytes: 1, 4 or 8
  int vec;           // 16-byte vectors (rows and pointers 16-byte aligned)
  int lanes_log;     // log2 of the lanes that share a row
};

struct ExtendDesc {
  ExtendBuf b[KOORD_DSTATE_MAX_ARRAYS];
};

template <typename T>
__device__ __forceinline__ void widen_row(const T* src, T* dst, long long oc, long long nc,
                                          T fill, int sub, int lanes) {
  for (long long c = sub; c < nc; c += lanes) dst[c] = c < oc ? src[c] : fill;
}

__global__ void extend(ExtendDesc d, int rows) {
  const ExtendBuf& b = d.b[blockIdx.y];
  const int lanes = 1 << b.lanes_log, sub = threadIdx.x & (lanes - 1);
  const int per_block = blockDim.x >> b.lanes_log;
  const long long ob = b.oc * b.elem, nb = b.nc * b.elem;
  for (int r = blockIdx.x * per_block + (threadIdx.x >> b.lanes_log); r < rows;
       r += gridDim.x * per_block) {
    const unsigned char* src = b.src + r * ob;
    unsigned char* dst = b.dst + r * nb;
    if (b.vec) {
      const int ov = (int)(ob >> 4), nv = (int)(nb >> 4);
      for (int v = sub; v < nv; v += lanes)
        ((uint4*)dst)[v] = v < ov ? __ldg((const uint4*)src + v) : b.pat;
    } else if (b.elem == 1) {
      widen_row<uint8_t>(src, dst, b.oc, b.nc, (uint8_t)b.fill, sub, lanes);
    } else if (b.elem == 4) {
      widen_row<int>((const int*)src, (int*)dst, b.oc, b.nc, (int)b.fill, sub, lanes);
    } else {
      widen_row<long long>((const long long*)src, (long long*)dst, b.oc, b.nc, b.fill, sub,
                           lanes);
    }
  }
}

// the flags word: an expiry is configured, it is > 0, expired metrics
// also switch the filters off
#define KOORD_GATE_HAS_EXP 1
#define KOORD_GATE_EXP_POS 2
#define KOORD_GATE_FEXP 4

struct GateIn {
  const uint8_t* has_metric;
  const double* update_time;
  const uint8_t* filter_active;
  const uint8_t* prod_active;
  const uint8_t* has_prod_thr;
};

// out: [4, N] bool, rows score_valid, filter_active, prod_filter_active,
// has_prod_thresholds
__global__ void gate(GateIn g, int N, double now, double exp, int flags, uint8_t* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  bool expired = false;
  if (flags & KOORD_GATE_HAS_EXP) {
    const double ut = g.update_time[j];
    expired = isnan(ut);
    if (flags & KOORD_GATE_EXP_POS) expired = expired || !(now - ut < exp);
  }
  const bool filter_live = (flags & KOORD_GATE_FEXP) ? !expired : true;
  out[j] = g.has_metric[j] && !expired;
  out[N + j] = g.filter_active[j] && filter_live;
  out[2 * (size_t)N + j] = g.prod_active[j] && filter_live;
  out[3 * (size_t)N + j] = g.has_prod_thr[j] && filter_live;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// desc: n rows of KOORD_SCATTER_FIELDS int64 words (destination, row
// bytes); host: the packed staging bytes (pinned), laid out as D int32
// indices, then each array's D rows from the next 16-byte boundary on;
// dev: a device buffer of `capacity` bytes that takes them.
extern "C" int koord_dstate_scatter(int n, const long long* desc, const void* host, void* dev,
                                    long long capacity, int D, int device, void* stream) {
  if (n < 1 || n > KOORD_DSTATE_MAX_ARRAYS || D < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  ScatterDesc s;
  long long end = 4LL * D, blocks = 1;
  for (int i = 0; i < n; ++i) {
    ScatterArr& a = s.a[i];
    a.dst = (unsigned char*)desc[(size_t)i * KOORD_SCATTER_FIELDS];
    a.rb = desc[(size_t)i * KOORD_SCATTER_FIELDS + 1];
    if (a.rb < 1) return (int)cudaErrorInvalidValue;
    end = (end + 15) & ~15LL;
    a.off = end;
    end += (long long)D * a.rb;
    const long long align = a.rb | (long long)a.dst | ((long long)dev + a.off);
    a.unit_log = 4;
    while (a.unit_log > 0 && (align & ((1LL << a.unit_log) - 1))) --a.unit_log;
    const long long units = a.rb >> a.unit_log;
    a.lanes_log = 0;
    while (a.lanes_log < 5 && (1LL << a.lanes_log) < units) ++a.lanes_log;
    const long long per_block = threads >> a.lanes_log;
    const long long need = (D + per_block - 1) / per_block;
    if (need > blocks) blocks = need;
  }
  if (end > capacity) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(dev, host, (size_t)end, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  if (blocks > 1024) blocks = 1024;
  scatter_rows<<<dim3((unsigned)blocks, n), threads, 0, (cudaStream_t)stream>>>(
      s, (const unsigned char*)dev, D);
  return (int)cudaGetLastError();
}

// desc: n packed rows of KOORD_EXTEND_FIELDS int64 words (source,
// destination, old columns, new columns, element size, fill)
extern "C" int koord_dstate_extend(int n, const long long* desc, int rows, int device,
                                   void* stream) {
  if (n < 1 || n > KOORD_DSTATE_MAX_ARRAYS || rows < 0) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  const int threads = 256;
  ExtendDesc d;
  long long blocks = 1;
  for (int a = 0; a < n; ++a) {
    const long long* f = desc + (size_t)a * KOORD_EXTEND_FIELDS;
    ExtendBuf& b = d.b[a];
    b.src = (const unsigned char*)f[0];
    b.dst = (unsigned char*)f[1];
    b.oc = f[2];
    b.nc = f[3];
    b.elem = (int)f[4];
    b.fill = f[5];
    if ((b.elem != 1 && b.elem != 4 && b.elem != 8) || b.oc < 0 || b.nc < b.oc)
      return (int)cudaErrorInvalidValue;
    const long long ob = b.oc * b.elem, nb = b.nc * b.elem;
    b.vec = ob % 16 == 0 && nb % 16 == 0 && (f[0] | f[1]) % 16 == 0;
    unsigned char bytes[16];
    for (int i = 0; i < 16; ++i) bytes[i] = (unsigned char)(b.fill >> (8 * (i % b.elem)));
    memcpy(&b.pat, bytes, 16);
    const long long units = b.vec ? nb / 16 : b.nc;  // per row
    b.lanes_log = 0;
    while (b.lanes_log < 5 && (1LL << b.lanes_log) < units) ++b.lanes_log;
    const long long per_block = threads >> b.lanes_log;
    const long long need = (rows + per_block - 1) / per_block;
    if (need > blocks) blocks = need;
  }
  if (rows == 0) return 0;
  if (blocks > 4096) blocks = 4096;
  extend<<<dim3((unsigned)blocks, n), threads, 0, (cudaStream_t)stream>>>(d, rows);
  return (int)cudaGetLastError();
}

// desc: the gate's host descriptor (GateStage.bind), seven int64 words:
// has_metric, update_time, filter_active, prod_active, has_prod_thr, N, the
// device; flags: the KOORD_GATE_* bits; out: [4, N] bool
extern "C" int koord_dstate_gate(const long long* desc, double now, double exp, int flags,
                                 void* out, void* stream) {
  const long long N = desc[5];
  if (N < 0 || N > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int device = (int)desc[6];
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  if (cur != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  const GateIn g{(const uint8_t*)desc[0], (const double*)desc[1], (const uint8_t*)desc[2],
                 (const uint8_t*)desc[3], (const uint8_t*)desc[4]};
  const int threads = 256;
  gate<<<(unsigned)((N + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      g, (int)N, now, exp, flags, (uint8_t*)out);
  return (int)cudaGetLastError();
}
