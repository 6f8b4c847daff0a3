// ElasticQuota runtime refresh: the `quota` and `quota_limit` kernels.
//
// Replaces: the JAX package's `quota` kernel (core/quota.py:138
// refresh_runtime, registered at service/engine.py:303) and `quota_limit`
// (service/engine.py:316 quota_limit_fn: refresh_runtime with row 0 set to
// the 2**60 sentinel QuotaSnapshot.used_limit writes).
//
// The inputs are tiny ([Q, R], Q up to a few hundred groups), so ONE thread
// block runs the whole refresh, level by level, with __syncthreads between
// the steps the reference runs as separate array programs:
//   1. aggregate_requests, bottom-up over the BFS levels: a child adds
//      min(Request, Max) to its parent, Request floored at Min when the
//      group does not lend;
//   2. per level, top-down: the min-quota auto-scaling (_scaled_min), then
//      the segmented water-fill (_segment_waterfill): every parent of the
//      level fills its children at once, the loop running while any
//      (parent, dimension) pair is live.  Dead pairs are no-ops, so the
//      lock-step loop equals each pair looping on its own.
// Segment sums are 64-bit atomicAdd on global words: int64 sums are exact
// in any order.  The float64 steps round exactly as XLA's:
//   delta  = int64(float64(w) * float64(to_part) / float64(tw) + 0.5)
//   scaled = int64(float64(avail) * float64(min) / float64(esum))
// each op round-to-nearest (__dmul_rn, __ddiv_rn, __dadd_rn: no fused
// multiply-add, whatever the compiler flags) and the conversion truncating
// toward zero.  Bound on an H100: latency (a few dozen block-wide steps of
// a few hundred elements each).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the caller's scratch: 10 [Q, R] int64 arrays (QUOTA_SCRATCH in
// core/quota.py), laid out at the top of quota_kernel

struct QuotaIn {
  const int* parent;           // [Q]
  const long long* min;        // [Q, R]
  const long long* max_eff;    // [Q, R]
  const long long* weight;     // [Q, R]
  const long long* guarantee;  // [Q, R]
  const long long* own;        // [Q, R]
  const uint8_t* allow_lent;   // [Q]
  const uint8_t* enable;       // [Q]
  const long long* total;      // [R]
};

__device__ __forceinline__ long long trunc_f64(double x) { return __double2ll_rz(x); }

__device__ __forceinline__ double f64(long long x) { return __ll2double_rn(x); }

__device__ __forceinline__ void zero(long long* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = 0;
}

// levels: offsets [L+1], then the flat member rows of every level
__global__ void quota_kernel(QuotaIn q, const int* levels, int L, int Q, int R, int scale_min,
                             int row0, long long* runtime, long long* scratch) {
  const int T = blockDim.x, t = threadIdx.x;
  const int QR = Q * R;
  long long* child = scratch;         // child sums (aggregate_requests)
  long long* request = child + QR;    // per-group Request
  long long* esum = request + QR;     // enable-scale min sums per parent
  long long* dsum = esum + QR;        // the other children's min sums
  long long* to_part = dsum + QR;     // per-parent amount left to hand out
  long long* tw = to_part + QR;       // per-parent active weight
  long long* seg = tw + QR;           // per-parent segment sums
  long long* lim = seg + QR;          // per-member min(Request, Max)
  long long* active = lim + QR;       // per-member still below its limit
  long long* rt = active + QR;        // per-member runtime of the level
  const int* offs = levels;
  const int* flat = levels + L + 1;

  for (int i = t; i < QR; i += T) {
    child[i] = q.own[i];
    request[i] = q.own[i];
    runtime[i] = i < R ? q.total[i] : 0;
  }
  __syncthreads();
  // 1. aggregate_requests, deepest level first; a level's parents sit in
  //    the level above, so reads and adds never touch the same rows
  for (int l = L - 1; l >= 0; --l) {
    const int lo = offs[l], n = (offs[l + 1] - lo) * R;
    for (int k = t; k < n; k += T) {
      const int i = flat[lo + k / R], r = k % R, ir = i * R + r;
      const long long agg = child[ir];
      const long long req = q.allow_lent[i] ? agg : max(agg, q.min[ir]);
      request[ir] = req;
      atomicAdd((unsigned long long*)&child[q.parent[i] * R + r],
                (unsigned long long)min(req, q.max_eff[ir]));
    }
    __syncthreads();
  }
  // 2. top-down, level by level
  for (int l = 0; l < L; ++l) {
    const int lo = offs[l], n = (offs[l + 1] - lo) * R;
    if (scale_min) {
      zero(esum, QR);
      zero(dsum, QR);
      __syncthreads();
      for (int k = t; k < n; k += T) {
        const int i = flat[lo + k / R], r = k % R;
        long long* dst = q.enable[i] ? esum : dsum;
        atomicAdd((unsigned long long*)&dst[q.parent[i] * R + r],
                  (unsigned long long)q.min[i * R + r]);
      }
      __syncthreads();
    }
    for (int k = t; k < n; k += T) {
      const int i = flat[lo + k / R], r = k % R, ir = i * R + r, pr = q.parent[i] * R + r;
      long long mn = q.min[ir];
      if (scale_min && q.enable[i]) {
        const long long tot = runtime[pr], e = esum[pr], d = dsum[pr];
        if (tot < e + d) {
          const long long avail = tot - d;
          mn = (avail <= 0 || e <= 0)
                   ? 0
                   : trunc_f64(__ddiv_rn(__dmul_rn(f64(avail), f64(mn)), f64(e == 0 ? 1 : e)));
        }
      }
      const long long em = max(mn, q.guarantee[ir]);
      const long long lr = min(request[ir], q.max_eff[ir]);
      const bool adjust = lr > em;
      lim[ir] = lr;
      active[ir] = adjust;
      rt[ir] = adjust ? em : (q.allow_lent[i] ? lr : em);
    }
    zero(seg, QR);
    __syncthreads();
    for (int k = t; k < n; k += T) {
      const int i = flat[lo + k / R], r = k % R;
      atomicAdd((unsigned long long*)&seg[q.parent[i] * R + r], (unsigned long long)rt[i * R + r]);
    }
    __syncthreads();
    for (int i = t; i < QR; i += T) to_part[i] = runtime[i] - seg[i];
    __syncthreads();
    // the water-fill: each iteration hands every live parent's remainder
    // to its active children by weight, caps those that reach their
    // limit, and collects the surplus for the next iteration
    while (true) {
      zero(tw, QR);
      zero(seg, QR);
      __syncthreads();
      for (int k = t; k < n; k += T) {
        const int i = flat[lo + k / R], r = k % R, ir = i * R + r;
        if (active[ir])
          atomicAdd((unsigned long long*)&tw[q.parent[i] * R + r], (unsigned long long)q.weight[ir]);
      }
      __syncthreads();
      int any = 0;
      for (int i = t; i < QR; i += T) any |= to_part[i] > 0 && tw[i] > 0;
      if (!__syncthreads_or(any)) break;
      for (int k = t; k < n; k += T) {
        const int i = flat[lo + k / R], r = k % R, ir = i * R + r, pr = q.parent[i] * R + r;
        const bool live = to_part[pr] > 0 && tw[pr] > 0;
        if (!(active[ir] && live)) continue;
        const long long w = tw[pr] == 0 ? 1 : tw[pr];
        const long long delta = trunc_f64(
            __dadd_rn(__ddiv_rn(__dmul_rn(f64(q.weight[ir]), f64(to_part[pr])), f64(w)), 0.5));
        const long long cand = rt[ir] + delta;
        if (cand >= lim[ir]) {
          atomicAdd((unsigned long long*)&seg[pr], (unsigned long long)(cand - lim[ir]));
          active[ir] = 0;
        }
        rt[ir] = min(cand, lim[ir]);
      }
      __syncthreads();
      for (int i = t; i < QR; i += T)
        if (to_part[i] > 0 && tw[i] > 0) to_part[i] = seg[i];
      __syncthreads();
    }
    for (int k = t; k < n; k += T) {
      const int i = flat[lo + k / R], r = k % R;
      runtime[i * R + r] = rt[i * R + r];
    }
    __syncthreads();
  }
  if (row0)
    for (int r = t; r < R; r += T) runtime[r] = 1LL << 60;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int koord_quota(const void* parent, const void* min, const void* max_eff,
                           const void* weight, const void* guarantee, const void* own,
                           const void* allow_lent, const void* enable, const void* total,
                           const void* levels, int L, int Q, int R, int scale_min, int row0,
                           void* runtime, void* scratch, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  QuotaIn q;
  q.parent = (const int*)parent;
  q.min = (const long long*)min;
  q.max_eff = (const long long*)max_eff;
  q.weight = (const long long*)weight;
  q.guarantee = (const long long*)guarantee;
  q.own = (const long long*)own;
  q.allow_lent = (const uint8_t*)allow_lent;
  q.enable = (const uint8_t*)enable;
  q.total = (const long long*)total;
  quota_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(q, (const int*)levels, L, Q, R, scale_min,
                                                     row0, (long long*)runtime,
                                                     (long long*)scratch);
  return (int)cudaGetLastError();
}
