// ElasticQuota runtime refresh: the `quota` and `quota_limit` kernels.
//
// Replaces: the JAX package's `quota` kernel (core/quota.py:138
// refresh_runtime, registered at service/engine.py:303) and `quota_limit`
// (service/engine.py:316 quota_limit_fn: refresh_runtime with row 0 set to
// the 2**60 sentinel QuotaSnapshot.used_limit writes).
//
// The inputs are tiny ([Q, R], Q up to a few thousand groups), so ONE
// thread block runs the whole refresh, level by level, as the reference
// does:
//   1. aggregate_requests, bottom-up over the BFS levels: a child adds
//      min(Request, Max) to its parent, Request floored at Min when the
//      group does not lend;
//   2. per level, top-down: the min-quota auto-scaling (_scaled_min), then
//      the segmented water-fill (_segment_waterfill): every parent of the
//      level fills its children, looping while its (parent, dimension)
//      pair is live.  A pair's loop reads and writes only its own children,
//      so the pairs loop independently, as the reference's lock-step loop
//      amounts to (a dead pair is a no-op there).
// The host plans each tree once (core/quota.py quota_plan, held on the
// card by a QuotaStage): each level's members sorted by parent, so that a
// parent's children are one contiguous run, and the runs' parents.  A warp
// takes one (run, dimension) pair at a time and does all of that pair's
// work on its own: the segment sums are warp reductions over the run
// (int64 sums are exact in any order, so no atomics), and the water-fill
// iterations need no block barrier.  The only barriers are one a level,
// each way: a level reads its parents' rows, which the level above wrote.
// The float64 steps round exactly as XLA's:
//   delta  = int64(float64(w) * float64(to_part) / float64(tw) + 0.5)
//   scaled = int64(float64(avail) * float64(min) / float64(esum))
// each op round-to-nearest (__dmul_rn, __ddiv_rn, __dadd_rn: no fused
// multiply-add, whatever the compiler flags) and the conversion truncating
// toward zero.
//
// Two size tiers of one kernel.  Where they fit a block's 227 KB
// (quota_smem_bytes: ~128 bytes a group at R = 2, so up to ~1,800 groups),
// the working rows (Request, runtime, the water-fill's limits and active
// flags), the per-group inputs the passes read (min, max, weight,
// guarantee, the two flags) and the plan are staged in shared memory by
// the whole block at once; above, the working rows live in the caller's
// global scratch (quota_scratch_bytes) and the rest is read where it lies.
// Bound on an H100: latency (2 L block barriers and each pair's few
// water-fill iterations over its run).
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may take
constexpr int kMaxDevices = 64;

struct QuotaIn {
  const long long* min;        // [Q, R]
  const long long* max_eff;    // [Q, R]
  const long long* weight;     // [Q, R]
  const long long* guarantee;  // [Q, R]
  const long long* own;        // [Q, R]
  const uint8_t* allow_lent;   // [Q]
  const uint8_t* enable;       // [Q]
  const long long* total;      // [R]
};

// The global tier's scratch: Request, runtime and the limits [Q, R] int64,
// then the active flags [Q, R] bytes (quota_scratch_bytes in core/quota.py).
__host__ __device__ inline size_t quota_scratch_bytes(int Q, int R) {
  return ((size_t)Q * R * 25 + 15) & ~(size_t)15;
}

// The shared tier's bytes: the scratch's rows, then min, max, weight and
// guarantee [Q, R] int64, the two flags [Q] bytes, and the plan's words
// (quota_smem_bytes in core/quota.py).
__host__ __device__ inline size_t quota_smem_bytes(int Q, int R, int plan_words) {
  return (((size_t)Q * R * 57 + (size_t)Q * 2 + 15) & ~(size_t)15) + (size_t)plan_words * 4;
}

__device__ __forceinline__ long long trunc_f64(double x) { return __double2ll_rz(x); }

__device__ __forceinline__ double f64(long long x) { return __ll2double_rn(x); }

// int64 sums wrap as the reference's do; unsigned words make the wrap defined
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// plan: level run offsets [L+1], the runs' parents [runs], the runs' member
// offsets [runs+1], then the members (group rows) in run order
template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
    quota_kernel(QuotaIn g, const int* __restrict__ gplan, int plan_words, int L, int runs, int Q,
                 int R, int scale_min, int row0, long long* __restrict__ out,
                 long long* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int QR = Q * R, t = threadIdx.x, T = blockDim.x;
  long long* request = SHARED ? (long long*)smem : scratch;
  long long* runtime = request + QR;
  long long* lim = runtime + QR;
  QuotaIn q = g;
  const int* plan = gplan;
  uint8_t* active;
  if constexpr (SHARED) {
    long long* w = lim + QR;
    for (int i = t; i < QR; i += T) {
      w[i] = g.min[i];
      w[QR + i] = g.max_eff[i];
      w[2 * QR + i] = g.weight[i];
      w[3 * QR + i] = g.guarantee[i];
    }
    q.min = w;
    q.max_eff = w + QR;
    q.weight = w + 2 * QR;
    q.guarantee = w + 3 * QR;
    active = (uint8_t*)(w + 4 * QR);
    uint8_t* flags = active + QR;
    for (int i = t; i < Q; i += T) {
      flags[i] = g.allow_lent[i];
      flags[Q + i] = g.enable[i];
    }
    q.allow_lent = flags;
    q.enable = flags + Q;
    int* sp = (int*)(smem + quota_smem_bytes(Q, R, 0));
    for (int i = t; i < plan_words; i += T) sp[i] = gplan[i];
    plan = sp;
  } else {
    active = (uint8_t*)(lim + QR);
  }
  const int* lrun = plan;
  const int* rpar = lrun + L + 1;
  const int* roff = rpar + runs;
  const int* mem = roff + runs + 1;
  const int lane = t & 31, warp = t >> 5, W = T >> 5;

  for (int i = t; i < QR; i += T) {
    request[i] = q.own[i];
    runtime[i] = i < R ? q.total[i] : 0;
  }
  __syncthreads();
  // 1. aggregate_requests, deepest level first; a level's parents are rows
  //    of the levels above (quota_plan checks it), so a run's warp reads and
  //    writes only its own members and adds its sum into one parent row
  for (int l = L - 1; l >= 0; --l) {
    for (int it = lrun[l] * R + warp; it < lrun[l + 1] * R; it += W) {
      const int run = it / R, r = it - run * R;
      unsigned long long sum = 0;
      for (int m = roff[run] + lane; m < roff[run + 1]; m += 32) {
        const int i = mem[m], ir = i * R + r;
        const long long agg = request[ir];
        const long long req = q.allow_lent[i] ? agg : max(agg, q.min[ir]);
        request[ir] = req;
        sum += (unsigned long long)min(req, q.max_eff[ir]);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        long long* p = &request[rpar[run] * R + r];
        *p = (long long)((unsigned long long)*p + sum);
      }
    }
    __syncthreads();
  }
  // 2. top-down, level by level: each (run, dimension) pair's min scaling,
  //    starting runtime and water-fill, the sums warp-wide
  for (int l = 0; l < L; ++l) {
    for (int it = lrun[l] * R + warp; it < lrun[l + 1] * R; it += W) {
      const int run = it / R, r = it - run * R;
      const int m0 = roff[run], m1 = roff[run + 1];
      const long long tot = runtime[rpar[run] * R + r];
      long long esum = 0, dsum = 0;
      if (scale_min) {
        unsigned long long e = 0, d = 0;
        for (int m = m0 + lane; m < m1; m += 32) {
          const int i = mem[m];
          const unsigned long long v = (unsigned long long)q.min[i * R + r];
          if (q.enable[i])
            e += v;
          else
            d += v;
        }
        esum = (long long)warp_sum(e);
        dsum = (long long)warp_sum(d);
      }
      unsigned long long seg = 0;
      for (int m = m0 + lane; m < m1; m += 32) {
        const int i = mem[m], ir = i * R + r;
        long long mn = q.min[ir];
        if (scale_min && q.enable[i] && tot < esum + dsum) {
          const long long avail = tot - dsum;
          mn = (avail <= 0 || esum <= 0)
                   ? 0
                   : trunc_f64(__ddiv_rn(__dmul_rn(f64(avail), f64(mn)), f64(esum)));
        }
        const long long em = max(mn, q.guarantee[ir]);
        const long long lr = min(request[ir], q.max_eff[ir]);
        const bool adjust = lr > em;
        lim[ir] = lr;
        active[ir] = adjust;
        const long long rt = adjust ? em : (q.allow_lent[i] ? lr : em);
        runtime[ir] = rt;
        seg += (unsigned long long)rt;
      }
      long long to_part = tot - (long long)warp_sum(seg);
      // the water-fill: each iteration hands the remainder to the active
      // children by weight, caps those that reach their limit, and takes
      // the surplus into the next iteration
      while (true) {
        unsigned long long tw = 0;
        for (int m = m0 + lane; m < m1; m += 32) {
          const int ir = mem[m] * R + r;
          if (active[ir]) tw += (unsigned long long)q.weight[ir];
        }
        const long long w = (long long)warp_sum(tw);
        if (!(to_part > 0 && w > 0)) break;
        unsigned long long surplus = 0;
        for (int m = m0 + lane; m < m1; m += 32) {
          const int ir = mem[m] * R + r;
          if (!active[ir]) continue;
          const long long delta = trunc_f64(
              __dadd_rn(__ddiv_rn(__dmul_rn(f64(q.weight[ir]), f64(to_part)), f64(w)), 0.5));
          const long long cand = runtime[ir] + delta;
          if (cand >= lim[ir]) {
            surplus += (unsigned long long)(cand - lim[ir]);
            active[ir] = 0;
          }
          runtime[ir] = min(cand, lim[ir]);
        }
        to_part = (long long)warp_sum(surplus);
      }
    }
    __syncthreads();
  }
  for (int i = t; i < QR; i += T) out[i] = row0 && i < R ? 1LL << 60 : runtime[i];
}

// Opens the shared-memory tier's full 227 KB once per device.
cudaError_t prepare(int device) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[device]) {
    const cudaError_t e = cudaFuncSetAttribute((const void*)quota_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
    if (e != cudaSuccess) return e;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* koord_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" long long koord_quota_smem_bytes(long long Q, long long R, long long plan_words) {
  return (long long)quota_smem_bytes((int)Q, (int)R, (int)plan_words);
}

// One refresh: the eight per-group arrays and the total; the tree's plan
// (QuotaStage) with its words, level and run counts; Q, R; scratch: null
// for the shared-memory tier, else quota_scratch_bytes(Q, R) of device
// memory; the flags; the [Q, R] output.
extern "C" int koord_quota(const void* min, const void* max_eff, const void* weight,
                           const void* guarantee, const void* own, const void* allow_lent,
                           const void* enable, const void* total, const void* plan,
                           int plan_words, int L, int runs, int Q, int R, void* scratch,
                           int scale_min, int row0, void* runtime, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = quota_smem_bytes(Q, R, plan_words);
  if (Q < 1 || R < 1 || (!scratch && bytes > (size_t)kMaxSmem)) return (int)cudaErrorInvalidValue;
  const QuotaIn q{(const long long*)min,       (const long long*)max_eff,
                  (const long long*)weight,    (const long long*)guarantee,
                  (const long long*)own,       (const uint8_t*)allow_lent,
                  (const uint8_t*)enable,      (const long long*)total};
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch) {
    quota_kernel<false><<<1, kThreads, 0, st>>>(q, (const int*)plan, plan_words, L, runs, Q, R,
                                                scale_min, row0, (long long*)runtime,
                                                (long long*)scratch);
  } else {
    if (bytes > 48 * 1024 && (e = prepare(device)) != cudaSuccess) return (int)e;
    quota_kernel<true><<<1, kThreads, bytes, st>>>(q, (const int*)plan, plan_words, L, runs, Q,
                                                   R, scale_min, row0, (long long*)runtime,
                                                   nullptr);
  }
  return (int)cudaGetLastError();
}
