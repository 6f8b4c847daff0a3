// The per-(pod, node) score and feasibility shared by every kernel of the
// port: the SCORE kernel (score.cu), the SCHEDULE key builds and round
// loops' rescoring of touched rows (schedule.cu) and the greedy scan
// (scan.cu).  One __device__ definition guarantees that all of them
// evaluate the same int64 arithmetic, which the resolved engine's exactness
// argument needs (a rescored key must equal the key a cold build would
// produce).
//
// The arithmetic is the JAX package's score_batch (core/cycle.py:195) under
// the default profile's plugin weights (1 each), as the JAX engine's
// score_fn and schedule_fn call it, for the three NodeFit scoring
// strategies (core/nodefit.py:163-234), chosen by the strategy id in Cfg:
//   total = loadaware_score + nodefit_score
//   feasible = loadaware_filter && nodefit_filter (&& caller's masks)
// Every division floors, as the plain versions' torch.div(...,
// rounding_mode="floor") does (floor_div): a dividend is negative under a
// negative weight, a negative request total or a product that wrapped, and
// there C++ `/` would truncate.  The exception is the
// RequestedToCapacityRatio shape's interpolation on a decreasing segment,
// whose numerator is negative: there the reference truncates toward zero
// as Go does, and so does C++ `/`.  Sums and products wrap as the plain
// versions' int64 tensors wrap (they are formed in unsigned arithmetic).
// The packed keys are decoded with floor division (key_floor_mod), since
// extra scores may make a total negative.
//
// The score functions are templates over RCP.  RCP = false divides with
// floor_div: the H100 has no 64-bit integer divide instruction, so each is
// a subroutine of tens of instructions.  RCP = true (the key build and the
// scan's rescoring, which stage node rows beside their reciprocals) divides
// by a node's capacity with div_cap and the weight sums and the RTC
// interpolation in 32 bits where their operands are proven to fit
// (div_small, broken_linear); every other operand keeps floor_div.  Both
// give the same quotient for every input, so a key rescored by one equals
// a key built by the other.
#pragma once

#include <climits>
#include <cstdint>

#define KOORD_MAXR 8
#define KOORD_NEGK (-(1 << 30))      // packed-key infeasible sentinel
#define KOORD_NEGK_THRESH (-(1 << 29))
#define KOORD_MAX_SHAPE 101  // RTC shape points: strictly increasing utilizations in 0..100

// NodeFit scoring strategies (core/config.py ScoringStrategyType)
#define KOORD_LEAST_ALLOCATED 0
#define KOORD_MOST_ALLOCATED 1
#define KOORD_REQUESTED_TO_CAPACITY_RATIO 2

// The configuration, passed by value as a kernel parameter: the axis
// widths and NodeFit's static config (weights, filter classes, the scoring
// strategy and the RequestedToCapacityRatio shape with its scores scaled to
// 0..100), built once on the host, and the LoadAware resource weights, read
// on the device.
struct Cfg {
  int R, Rf, Rs;
  const long long* la_w;  // [R], device
  long long nf_w[KOORD_MAXR];
  int always[KOORD_MAXR];
  int bypass[KOORD_MAXR];
  int strategy;  // KOORD_LEAST_ALLOCATED, ...
  int npts;      // RTC shape points, >= 1 under that strategy
  int shp_u[KOORD_MAX_SHAPE];
  int shp_s[KOORD_MAX_SHAPE];
};

// Pending pods, row-major, in the order the caller chose (queue order for
// SCHEDULE).  Booleans are torch.bool bytes.
struct PodIn {
  const long long* est;        // [P, R]
  const uint8_t* prod_score;   // [P]
  const uint8_t* prod_class;   // [P]
  const uint8_t* daemonset;    // [P]
  const long long* req;        // [P, Rf]
  const long long* req_score;  // [P, Rs]
  const uint8_t* has_any;      // [P]
};

// Node rows.  The five assume-path fields are writable: the round loop
// applies commits to private copies of them.
struct NodeIn {
  const long long* la_alloc;         // [N, R]
  long long* base_nonprod;           // [N, R]
  long long* base_prod;              // [N, R]
  const uint8_t* score_valid;        // [N]
  const long long* filter_usage;     // [N, R]
  const uint8_t* filter_active;      // [N]
  const long long* thresholds;       // [N, R]
  const long long* prod_usage;       // [N, R]
  const uint8_t* prod_active;        // [N]
  const long long* prod_thresholds;  // [N, R]
  const uint8_t* has_prod_thr;       // [N]
  const long long* nf_alloc;         // [N, Rf]
  long long* requested;              // [N, Rf]
  long long* num_pods;               // [N]
  const long long* allowed;          // [N]
  const long long* alloc_score;      // [N, Rs]
  long long* nreq_score;             // [N, Rs]
  // koord_rcp of la_alloc and alloc_score, read by the RCP instantiations
  // alone (staged rows; null in the tables the host passes)
  const unsigned long long* la_rcp;  // [N, R]
  const unsigned long long* as_rcp;  // [N, Rs]
};

#define KOORD_NUM_POD_PTRS 7
#define KOORD_NUM_NODE_PTRS 17
#define KOORD_CFG_LEN (3 + 3 * KOORD_MAXR + 2 + 2 * KOORD_MAX_SHAPE)

inline Cfg koord_cfg(const long long* c, const void* la_w) {
  Cfg g;
  g.R = (int)c[0];
  g.Rf = (int)c[1];
  g.Rs = (int)c[2];
  g.la_w = (const long long*)la_w;
  for (int i = 0; i < KOORD_MAXR; ++i) {
    g.nf_w[i] = c[3 + i];
    g.always[i] = (int)c[3 + KOORD_MAXR + i];
    g.bypass[i] = (int)c[3 + 2 * KOORD_MAXR + i];
  }
  const long long* t = c + 3 + 3 * KOORD_MAXR;
  g.strategy = (int)t[0];
  g.npts = (int)t[1];
  for (int i = 0; i < KOORD_MAX_SHAPE; ++i) {
    g.shp_u[i] = (int)t[2 + i];
    g.shp_s[i] = (int)t[2 + KOORD_MAX_SHAPE + i];
  }
  return g;
}

inline PodIn koord_pods(const void* const* p) {
  PodIn o;
  o.est = (const long long*)p[0];
  o.prod_score = (const uint8_t*)p[1];
  o.prod_class = (const uint8_t*)p[2];
  o.daemonset = (const uint8_t*)p[3];
  o.req = (const long long*)p[4];
  o.req_score = (const long long*)p[5];
  o.has_any = (const uint8_t*)p[6];
  return o;
}

inline NodeIn koord_nodes(const void* const* p) {
  NodeIn o;
  o.la_alloc = (const long long*)p[0];
  o.base_nonprod = (long long*)p[1];
  o.base_prod = (long long*)p[2];
  o.score_valid = (const uint8_t*)p[3];
  o.filter_usage = (const long long*)p[4];
  o.filter_active = (const uint8_t*)p[5];
  o.thresholds = (const long long*)p[6];
  o.prod_usage = (const long long*)p[7];
  o.prod_active = (const uint8_t*)p[8];
  o.prod_thresholds = (const long long*)p[9];
  o.has_prod_thr = (const uint8_t*)p[10];
  o.nf_alloc = (const long long*)p[11];
  o.requested = (long long*)p[12];
  o.num_pods = (long long*)p[13];
  o.allowed = (const long long*)p[14];
  o.alloc_score = (const long long*)p[15];
  o.nreq_score = (long long*)p[16];
  o.la_rcp = nullptr;
  o.as_rcp = nullptr;
  return o;
}

// floor(a / b) for b != 0, as the plain versions' torch.div(...,
// rounding_mode="floor") divides, out of line: the rare case of every
// caller (a negative operand; under RCP any fallback)
__host__ __device__ __noinline__ long long floor_div_slow(long long a, long long b) {
  const long long q = a / b;  // one division; the remainder from it
  return (a - q * b != 0 && (a ^ b) < 0) ? q - 1 : q;
}

// floor(a / b) for b != 0: both operands non-negative (the rule) take the
// unsigned division, cheaper than the signed one `/` is
__host__ __device__ __forceinline__ long long floor_div(long long a, long long b) {
  if ((a | b) >= 0) return (long long)((unsigned long long)a / (unsigned long long)b);
  return floor_div_slow(a, b);
}

// a + b, a - b and a * b as int64 tensors compute them: wrapping modulo 2**64
__host__ __device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__host__ __device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__host__ __device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

// Division by an invariant integer (after Granlund and Montgomery): the
// reciprocal of a divisor d >= 1 is m = floor((2**64 - 1) / d), computed
// once per staged node row; 0 stands for d <= 0, which no caller divides by.
__host__ __device__ __forceinline__ unsigned long long koord_rcp(long long d) {
  return d > 0 ? ~0ULL / (unsigned long long)d : 0ULL;
}

// floor(n / d) for d != 0 with m = koord_rcp(d).  For 0 <= n < 2**63 and
// d >= 1 the high word of n * m is the quotient q or q - 1: m * d > 2**64 -
// 1 - d, so n / d - n * m / 2**64 < n * (d + 1) / (d * 2**64) <= 2 n /
// 2**64 < 1; one correction step on the remainder makes it exact.  A
// negative n (a product that wrapped, a negative request) or d keeps
// floor_div.
template <bool RCP>
__device__ __forceinline__ long long div_cap(long long n, long long d, unsigned long long m) {
  if constexpr (RCP) {
    if (n >= 0 && d > 0) {
      const unsigned long long u = (unsigned long long)n, v = (unsigned long long)d;
      unsigned long long q = __umul64hi(u, m);
      if (u - q * v >= v) ++q;
      return (long long)q;
    }
    return floor_div_slow(n, d);
  }
  return floor_div(n, d);
}

// floor(n / d) for d != 0: in 32 bits when both are in [0, 2**32) (the
// weight sums and what they divide), else floor_div
template <bool RCP>
__device__ __forceinline__ long long div_small(long long n, long long d) {
  if constexpr (RCP) {
    if ((((unsigned long long)n | (unsigned long long)d) >> 32) == 0)
      return (long long)((unsigned)n / (unsigned)d);
    return floor_div_slow(n, d);
  }
  return floor_div(n, d);
}

// loadaware_score (core/loadaware.py:77): weighted least-requested over
// the R resources, 0 on nodes without a live NodeMetric.  The weights sum
// to > 0 (the caller's contract, as in the reference).
template <bool RCP = false>
__device__ __forceinline__ long long la_score(const Cfg& c, const PodIn& p, const NodeIn& n,
                                              int q, int j) {
  if (!n.score_valid[j]) return 0;
  const long long* base = p.prod_score[q] ? n.base_prod : n.base_nonprod;
  long long acc = 0, wsum = 0;
  for (int r = 0; r < c.R; ++r) {
    const size_t o = (size_t)j * c.R + r;
    long long cap = n.la_alloc[o];
    long long used = wrap_add(p.est[(size_t)q * c.R + r], base[o]);
    long long s = (cap == 0 || used > cap) ? 0
                                           : div_cap<RCP>(wrap_mul(wrap_sub(cap, used), 100), cap,
                                                          RCP ? n.la_rcp[o] : 0);
    long long w = c.la_w[r];
    acc = wrap_add(acc, wrap_mul(s, w));
    wsum = wrap_add(wsum, w);
  }
  return div_small<RCP>(acc, wsum);
}

// least_allocated_score (core/nodefit.py:163): weighted mean over the
// included resources of the scoring axis; 0 when none is included.
template <bool RCP = false>
__device__ __forceinline__ long long nf_least(const Cfg& c, const PodIn& p, const NodeIn& n,
                                              int q, int j) {
  long long acc = 0, wsum = 0;
  for (int r = 0; r < c.Rs; ++r) {
    const size_t o = (size_t)j * c.Rs + r;
    long long cap = n.alloc_score[o];
    long long preq = p.req_score[(size_t)q * c.Rs + r];
    if (cap == 0 || (c.bypass[r] && preq == 0)) continue;
    long long req = wrap_add(preq, n.nreq_score[o]);
    long long s = req > cap ? 0
                            : div_cap<RCP>(wrap_mul(wrap_sub(cap, req), 100), cap,
                                           RCP ? n.as_rcp[o] : 0);
    acc = wrap_add(acc, wrap_mul(s, c.nf_w[r]));
    wsum = wrap_add(wsum, c.nf_w[r]);
  }
  return wsum == 0 ? 0 : div_small<RCP>(acc, wsum);
}

// most_allocated_score (core/nodefit.py:181): req * 100 / cap per included
// resource, an overcommitted resource clamped to its capacity (it scores
// 100, not 0), weighted mean as above.
template <bool RCP = false>
__device__ __forceinline__ long long nf_most(const Cfg& c, const PodIn& p, const NodeIn& n,
                                             int q, int j) {
  long long acc = 0, wsum = 0;
  for (int r = 0; r < c.Rs; ++r) {
    const size_t o = (size_t)j * c.Rs + r;
    long long cap = n.alloc_score[o];
    long long preq = p.req_score[(size_t)q * c.Rs + r];
    if (cap == 0 || (c.bypass[r] && preq == 0)) continue;
    long long req = wrap_add(preq, n.nreq_score[o]);
    if (req > cap) req = cap;
    acc = wrap_add(acc, wrap_mul(div_cap<RCP>(wrap_mul(req, 100), cap, RCP ? n.as_rcp[o] : 0),
                                 c.nf_w[r]));
    wsum = wrap_add(wsum, c.nf_w[r]);
  }
  return wsum == 0 ? 0 : div_small<RCP>(acc, wsum);
}

// _broken_linear (core/nodefit.py:199): the shape's score at utilization
// u, interpolated on the first segment whose end is >= u.  On a decreasing
// segment the numerator is negative and `/` truncates toward zero, as Go's
// integer division does.  The denominator is in [1, 100] (utilizations
// strictly increase in 0..100, cuda.cfg_array); under RCP a numerator that
// fits int32 divides in 32 bits, which truncates toward zero the same way.
template <bool RCP = false>
__device__ __forceinline__ long long broken_linear(const Cfg& c, long long u) {
  if (u <= c.shp_u[0]) return c.shp_s[0];
  for (int i = 1; i < c.npts; ++i) {
    if (u <= c.shp_u[i]) {
      const long long u0 = c.shp_u[i - 1], s0 = c.shp_s[i - 1];
      const long long num = (c.shp_s[i] - s0) * (u - u0), den = c.shp_u[i] - u0;
      if (RCP && num >= INT_MIN && num <= INT_MAX) return s0 + (int)num / (int)den;
      return s0 + num / den;
    }
  }
  return c.shp_s[c.npts - 1];
}

// requested_to_capacity_ratio_score (core/nodefit.py:216): the shape at the
// utilization "100 minus the free percent" (100 when overcommitted); a
// resource enters the weight sum only where its raw score is > 0; the mean
// rounds half up.
template <bool RCP = false>
__device__ __forceinline__ long long nf_rtc(const Cfg& c, const PodIn& p, const NodeIn& n, int q,
                                            int j) {
  long long acc = 0, wsum = 0;
  for (int r = 0; r < c.Rs; ++r) {
    const size_t o = (size_t)j * c.Rs + r;
    long long cap = n.alloc_score[o];
    long long preq = p.req_score[(size_t)q * c.Rs + r];
    if (cap == 0 || (c.bypass[r] && preq == 0)) continue;
    long long req = wrap_add(preq, n.nreq_score[o]);
    long long util = req > cap ? 100
                               : wrap_sub(100, div_cap<RCP>(wrap_mul(wrap_sub(cap, req), 100),
                                                            cap, RCP ? n.as_rcp[o] : 0));
    long long s = broken_linear<RCP>(c, util);
    if (s > 0) {
      acc = wrap_add(acc, wrap_mul(s, c.nf_w[r]));
      wsum = wrap_add(wsum, c.nf_w[r]);
    }
  }
  return wsum == 0 ? 0 : div_small<RCP>(wrap_add(wrap_mul(2, acc), wsum), wrap_mul(2, wsum));
}

// nodefit_score (core/nodefit.py:71): the configured strategy
template <bool RCP = false>
__device__ __forceinline__ long long nf_score(const Cfg& c, const PodIn& p, const NodeIn& n,
                                              int q, int j) {
  if (c.strategy == KOORD_MOST_ALLOCATED) return nf_most<RCP>(c, p, n, q, j);
  if (c.strategy == KOORD_REQUESTED_TO_CAPACITY_RATIO) return nf_rtc<RCP>(c, p, n, q, j);
  return nf_least<RCP>(c, p, n, q, j);
}

// nodefit_filter (core/nodefit.py:94).
__device__ __forceinline__ bool nf_fit(const Cfg& c, const PodIn& p, const NodeIn& n, int q,
                                       int j) {
  if (!(n.num_pods[j] + 1 <= n.allowed[j])) return false;
  if (!p.has_any[q]) return true;
  for (int r = 0; r < c.Rf; ++r) {
    long long req = p.req[(size_t)q * c.Rf + r];
    long long free_ = n.nf_alloc[(size_t)j * c.Rf + r] - n.requested[(size_t)j * c.Rf + r];
    if ((c.always[r] || req > 0) && req > free_) return false;
  }
  return true;
}

__device__ __forceinline__ bool la_reject(const long long* usage, const long long* total,
                                          const long long* thr, int R, int j) {
  for (int r = 0; r < R; ++r) {
    long long t = thr[(size_t)j * R + r];
    long long tot = total[(size_t)j * R + r];
    long long u = usage[(size_t)j * R + r];
    if (t > 0 && tot > 0 && 200 * u + tot >= 2 * tot * t) return true;
  }
  return false;
}

// loadaware_filter (core/loadaware.py:115): threshold rejection with the
// prod branch and the DaemonSet bypass.
__device__ __forceinline__ bool la_fit(const Cfg& c, const PodIn& p, const NodeIn& n, int q,
                                       int j) {
  if (p.daemonset[q]) return true;
  if (p.prod_class[q] && n.has_prod_thr[j]) {
    return !(n.prod_active[j] && la_reject(n.prod_usage, n.la_alloc, n.prod_thresholds, c.R, j));
  }
  return !(n.filter_active[j] && la_reject(n.filter_usage, n.la_alloc, n.thresholds, c.R, j));
}

template <bool RCP = false>
__device__ __forceinline__ long long pair_total(const Cfg& c, const PodIn& p, const NodeIn& n,
                                                int q, int j) {
  return wrap_add(la_score<RCP>(c, p, n, q, j), nf_score<RCP>(c, p, n, q, j));
}

// ------------------------------------------------------------ constraints
//
// The gang, quota and reservation inputs of the constrained SCHEDULE
// kernels (core/resolved.py ConInputs), passed by value.  Pod axes are in
// queue order (q) unless noted; the reservation scores are read through
// `xs`, the queue position -> submission row map.
struct ConIn {
  int G, Q, Rq, Rv, Mm, cpd, ad;
  long long w_rsv;  // the reservation plugin weight
  int has_quota, has_rsv;
  const int* gang_row;         // [P]
  const long long* g_min;      // [G]
  const long long* g_members;  // [G]
  const uint8_t* g_init;       // [G]
  const uint8_t* g_once;       // [G]
  const int* g_group;          // [G]
  const long long* g_bound;    // [G]
  const uint8_t* g_nonstrict;  // [G]
  const int* q_row;            // [P]
  const long long* q_req;      // [P, Rq]
  const uint8_t* q_present;    // [P, Rq]
  const uint8_t* q_np;         // [P]
  long long* q_used;           // [Q, Rq], the round kernel's private copy
  long long* q_npu;            // [Q, Rq], likewise
  const long long* q_limit;    // [Q, Rq]
  const long long* q_min;      // [Q, Rq]
  const int* q_parent;         // [Q]
  const int* r_node;           // [Rv]
  const long long* r_alloc;    // [Rv, Rf]
  long long* r_allocated;      // [Rv, Rf], the round kernel's private copy
  const long long* r_rank;     // [Rv] dense (order, index) ranks, 0 = unordered
  const int* midx;             // [P, Mm] matched rows ascending, -1 past the last
  const long long* rscore;     // [P_sub, Rv] submission order
  const long long* rscores;    // [P_sub, N] submission order
  const int* xs;               // [P]
  long long* scratch;          // the round kernel's global scratch
};

#define KOORD_NUM_CON_PTRS 26
#define KOORD_NUM_CON_INTS 10

inline ConIn koord_con(const void* const* p, const long long* c) {
  ConIn k;
  k.G = (int)c[0];
  k.Q = (int)c[1];
  k.Rq = (int)c[2];
  k.Rv = (int)c[3];
  k.Mm = (int)c[4];
  k.cpd = (int)c[5];
  k.ad = (int)c[6];
  k.w_rsv = c[7];
  k.has_quota = (int)c[8];
  k.has_rsv = (int)c[9];
  k.gang_row = (const int*)p[0];
  k.g_min = (const long long*)p[1];
  k.g_members = (const long long*)p[2];
  k.g_init = (const uint8_t*)p[3];
  k.g_once = (const uint8_t*)p[4];
  k.g_group = (const int*)p[5];
  k.g_bound = (const long long*)p[6];
  k.g_nonstrict = (const uint8_t*)p[7];
  k.q_row = (const int*)p[8];
  k.q_req = (const long long*)p[9];
  k.q_present = (const uint8_t*)p[10];
  k.q_np = (const uint8_t*)p[11];
  k.q_used = (long long*)p[12];
  k.q_npu = (long long*)p[13];
  k.q_limit = (const long long*)p[14];
  k.q_min = (const long long*)p[15];
  k.q_parent = (const int*)p[16];
  k.r_node = (const int*)p[17];
  k.r_alloc = (const long long*)p[18];
  k.r_allocated = (long long*)p[19];
  k.r_rank = (const long long*)p[20];
  k.midx = (const int*)p[21];
  k.rscore = (const long long*)p[22];
  k.rscores = (const long long*)p[23];
  k.xs = (const int*)p[24];
  k.scratch = (long long*)p[25];
  return k;
}

// gang_prefilter (core/gang.py:71): PreFilter fast-fail, state-free per pod
__device__ __forceinline__ bool gang_pass(const ConIn& k, int q) {
  const int g = k.gang_row[q];
  return g == 0 || (k.g_init[g] && (k.g_once[g] || k.g_members[g] >= k.g_min[g]));
}

// The reservations' allocations are state the SCHEDULE round loop commits
// into: it rewrites them on one SM and rescores against them on the
// others, so its instantiation (L2 = true) reads them through L2
// (ld.global.cg), never from a stale line of the reading SM's L1; every
// other kernel reads them as plain loads.
template <bool L2>
__device__ __forceinline__ long long ld_state(const long long* p) {
  if constexpr (L2) return __ldcg(p);
  return *p;
}

// nodefit_filter with the reservation restore (core/nodefit.py:94,
// core/reservation.py:50): the free capacity of node j gains, for each of
// pod q's matched reservations bound to j, its unallocated remainder.
// `row` (when >= 0) is where node j's row sits in `n`, if not at j.
template <bool L2 = false>
__device__ __forceinline__ bool nf_fit_rsv(const Cfg& c, const PodIn& p, const NodeIn& n,
                                           const ConIn& k, int q, int j, int row = -1) {
  const int jn = row < 0 ? j : row;
  if (!(n.num_pods[jn] + 1 <= n.allowed[jn])) return false;
  if (!p.has_any[q]) return true;
  const int* mi = k.midx + (size_t)q * k.Mm;
  bool hit = false;
  for (int m = 0; m < k.Mm && mi[m] >= 0; ++m) hit |= k.r_node[mi[m]] == j;
  for (int r = 0; r < c.Rf; ++r) {
    long long req = p.req[(size_t)q * c.Rf + r];
    long long free_ = n.nf_alloc[(size_t)jn * c.Rf + r] - n.requested[(size_t)jn * c.Rf + r];
    if (hit)
      for (int m = 0; m < k.Mm && mi[m] >= 0; ++m) {
        const int v = mi[m];
        if (k.r_node[v] == j)
          free_ += k.r_alloc[(size_t)v * c.Rf + r] -
                   ld_state<L2>(&k.r_allocated[(size_t)v * c.Rf + r]);
      }
    if ((c.always[r] || req > 0) && req > free_) return false;
  }
  return true;
}

// The batch's frozen placement-and-devices inputs (core/resolved.py
// ExtraInputs), node-major [N, P] in queue order, each null when absent: a
// mask ANDed into every pair's feasibility and pre-weighted scores (the
// deviceshare and amplified-CPU plugins) added to every pair's total.
struct XIn {
  const uint8_t* feas;
  const long long* sc;
};

__device__ __forceinline__ bool x_feas(const XIn& x, int q, int j, int P) {
  return !x.feas || x.feas[(size_t)j * P + q];
}

__device__ __forceinline__ long long x_score(const XIn& x, int q, int j, int P) {
  return x.sc ? x.sc[(size_t)j * P + q] : 0;
}

// The key lanes: the packed int32 keys of the matrix_packed engine (the
// sentinel KOORD_NEGK) and the int64 keys of the matrix engine, which hold
// the same composite key with the JAX package's NEG = -(1 << 40) sentinel.
template <typename KT>
struct KeyLane;
template <>
struct KeyLane<int> {
  static constexpr int neg = KOORD_NEGK;
  static constexpr int thresh = KOORD_NEGK_THRESH;
};
template <>
struct KeyLane<long long> {
  static constexpr long long neg = -(1LL << 40);
  static constexpr long long thresh = -(1LL << 39);
};

// the composite key's low part, floor(key) mod TB (TB > 0), for any sign
__device__ __forceinline__ long long key_floor_mod(long long key, long long TB) {
  const long long m = key % TB;
  return m < 0 ? m + TB : m;
}

// the rotated index (j + salt) % N of column j in [0, N); under RCP a salt
// in [0, N) (every caller's: tie_salt, or 0) takes one conditional
// subtraction instead of the 32-bit remainder
template <bool RCP>
__device__ __forceinline__ long long rot_of(int j, int salt, int N) {
  if constexpr (RCP) {
    if ((unsigned)salt < (unsigned)N) {
      const int r = j + salt;
      return r >= N ? r - N : r;
    }
  }
  return (j + salt) % N;
}

// pack_keys (core/resolved.py:698): score * TB + (TB-1 - rotated index),
// or the sentinel when infeasible.  ``pre`` carries every mask the caller
// already evaluated (loadaware filter, live column, real pod, the extra
// mask); ``xadd`` is the pair's extra score.  ``row`` (when >= 0) is where
// node j's row sits in ``n``: the round loop's rescoring passes rows it
// staged in shared memory.
template <typename KT, bool RCP = false>
__device__ __forceinline__ KT pair_key(const Cfg& c, const PodIn& p, const NodeIn& n, int q, int j,
                                       bool pre, int salt, int N, long long TB, long long xadd,
                                       int row = -1) {
  const int jn = row < 0 ? j : row;
  if (!pre || !nf_fit(c, p, n, q, jn)) return KeyLane<KT>::neg;
  const long long rot = rot_of<RCP>(j, salt, N);
  return (KT)wrap_add(wrap_mul(wrap_add(pair_total<RCP>(c, p, n, q, jn), xadd), TB),
                     TB - 1 - rot);
}

// pair_key under the constraints: the gang prefilter is in ``pre``; the
// reservation restore enters the fit and the frozen reservation score the
// total (core/resolved.py masked_totals / touched_scores).
template <typename KT, bool L2 = false, bool RCP = false>
__device__ __forceinline__ KT pair_key_con(const Cfg& c, const PodIn& p, const NodeIn& n,
                                           const ConIn& k, int q, int j, bool pre, int salt, int N,
                                           long long TB, long long xadd, int row = -1) {
  if (!k.has_rsv) return pair_key<KT, RCP>(c, p, n, q, j, pre, salt, N, TB, xadd, row);
  if (!pre || !nf_fit_rsv<L2>(c, p, n, k, q, j, row)) return KeyLane<KT>::neg;
  const long long total =
      wrap_add(wrap_add(pair_total<RCP>(c, p, n, q, row < 0 ? j : row),
                        wrap_mul(k.rscores[(size_t)k.xs[q] * N + j], k.w_rsv)),
               xadd);
  const long long rot = rot_of<RCP>(j, salt, N);
  return (KT)wrap_add(wrap_mul(total, TB), TB - 1 - rot);
}

// the key of pod q on node j: the extra mask joins ``pre`` and the extra
// score the total, in the cold build, the refresh, the rounds' rescoring
// and the scan's alike (a rescoring passes node j's row staged at ``row``
// of ``n``; the round loop's reads the reservation allocations through
// L2); RCP divides by the staged reciprocals
template <bool CON, typename KT, bool L2 = false, bool RCP = false>
__device__ __forceinline__ KT key_of(const Cfg& c, const PodIn& p, const NodeIn& n,
                                     const ConIn& k, const XIn& x, int P, int q, int j, bool pre,
                                     int salt, int N, long long TB, int row = -1) {
  if (!pre || !x_feas(x, q, j, P)) return KeyLane<KT>::neg;
  const long long xadd = x_score(x, q, j, P);
  if constexpr (CON)
    return pair_key_con<KT, L2, RCP>(c, p, n, k, q, j, true, salt, N, TB, xadd, row);
  return pair_key<KT, RCP>(c, p, n, q, j, true, salt, N, TB, xadd, row);
}

// the pod mask of the SCHEDULE kernels: a real pod row and, under CON,
// the gang prefilter
template <bool CON>
__device__ __forceinline__ bool pod_pass(const uint8_t* pod_ok, const ConIn& k, int q) {
  if constexpr (CON) return pod_ok[q] && gang_pass(k, q);
  return pod_ok[q];
}
