// The host side of the placement kernel (placement.cu): one call's checks
// and descriptor, in plain C++ (no CUDA), so that it builds with any C++17
// compiler (the CPU tests build it with g++ and read the descriptor as the
// kernel reads it).
//
// Input: the wrapper's one concatenated host array of the signatures'
// lists (core/placement.py placement): the four tables' [M + 1] offsets
// (selector pairs, untolerated taints, holder columns, label-set columns),
// sel_cnt [M], then the four index lists; each list's entries and each
// table's width.  The checks: each table's offsets a partition of its
// entries, every index inside its table.  Then, per table, the sorted
// union of the columns the lists name; every entry rewritten as its
// position in the union of all four (table t's columns shifted by the
// widths of the tables before it); and the gather's phases: the union
// columns cut greedily, in table order, into phases whose node tiles fit
// `budget` bytes of shared memory, a table split across phases where its
// columns do not fit.
//
// The descriptor (int32):
//   [0] M, [1] phases, [2] segments, [3] the offset of sel_cnt;
//   [kHead ...] each phase's first and end segment;
//   then each segment's kSegWords words (SegWord);
//   then the four tables' [M + 1] offsets, sel_cnt [M], the union (each
//   column shifted, W_BASE), and each list entry's position in it.
// A segment is the union positions [u0, u1) of one table; a signature's
// entries of that table are [beg[m], end[m]) (the table's offsets), those
// outside [u0, u1) left to the table's other segments.
#pragma once

#include <algorithm>
#include <cstdint>
#include <vector>

namespace koord_place {

constexpr int kTile = 64;  // node columns a block of the kernel
constexpr int kHead = 4;
constexpr int kSegWords = 12;
constexpr int kMaxSegs = 4;  // segments a phase: at most one a table
enum SegWord : int {
  W_TABLE, W_U0, W_U1, W_STRIDE, W_SMEM, W_FLAGS, W_BEG, W_END, W_POS, W_COLS, W_BASE,
  W_AT,  // the segment's first column among its phase's (the phase's columns before it)
};
enum SegFlag : int { SEG_FIRST = 1, SEG_LAST = 2 };  // the table's first / last chunk
constexpr int kElem[4] = {1, 1, 4, 4};                // labels, taints: bool; aa, sig: int32

// Shared memory of k union columns of a tile: node-major rows of an odd
// stride (k | 1 elements: a warp's threads, on different nodes, read other
// banks), 16-byte aligned.
inline int seg_bytes(int k, int elem) { return (kTile * (k | 1) * elem + 15) & ~15; }

struct Plan {
  std::vector<int> desc;
  int smem = 0;     // the largest phase's shared memory
  int carries = 0;  // a table spans two phases: an [M, N] int64 scratch carries its sums
  // reused between calls: a column's last call and its union position
  std::vector<uint32_t> stamp;
  std::vector<int> where;
  uint32_t gen = 0;
};

// Checks and plans one call into p; 0, or -1 when an offset array is not a
// partition of its entries or an index lies outside its table.
inline int make_plan(const int* flat, int M, const int* nnz, const int* vocab, int budget,
                     Plan& p) {
  const int* X = flat + 4 * (M + 1) + M;
  long long total = 0, base[4];
  int first[4], n = 0;
  for (int t = 0; t < 4; ++t) {
    const int* o = flat + t * (M + 1);
    if (o[0] != 0 || o[M] != nnz[t]) return -1;
    for (int m = 0; m < M; ++m)
      if (o[m + 1] < o[m]) return -1;
    for (int k = 0; k < nnz[t]; ++k)
      if (X[n + k] < 0 || X[n + k] >= vocab[t]) return -1;
    base[t] = total;
    first[t] = n;
    total += vocab[t];
    n += nnz[t];
  }
  if (budget < seg_bytes(1, 4)) return -1;
  if ((long long)p.stamp.size() < total) {
    p.stamp.assign(total, 0);
    p.where.assign(total, 0);
    p.gen = 0;
  }
  if (++p.gen == 0) {  // the stamps wrapped: start them anew
    std::fill(p.stamp.begin(), p.stamp.end(), 0);
    p.gen = 1;
  }
  // each table's union: the columns named, once each, sorted; then each
  // entry's position in it
  std::vector<int> uni, pos(n);
  uni.reserve(n);
  int start[5];
  for (int t = 0; t < 4; ++t) {
    start[t] = (int)uni.size();
    for (int k = first[t]; k < first[t] + nnz[t]; ++k) {
      const long long c = base[t] + X[k];
      if (p.stamp[c] != p.gen) {
        p.stamp[c] = p.gen;
        uni.push_back((int)c);
      }
    }
    std::sort(uni.begin() + start[t], uni.end());
    for (int u = start[t]; u < (int)uni.size(); ++u) p.where[uni[u]] = u;
    for (int k = first[t]; k < first[t] + nnz[t]; ++k) pos[k] = p.where[base[t] + X[k]];
  }
  start[4] = (int)uni.size();
  // the phases: (table, u0, u1 within the table's union, shared memory, flags)
  struct Seg {
    int t, u0, u1, smem, flags, at;
  };
  std::vector<Seg> segs;
  std::vector<int> bounds;
  int used = 0, phase0 = 0, cols = 0;
  p.smem = 0;
  p.carries = 0;
  auto close = [&]() {
    bounds.push_back(phase0);
    bounds.push_back((int)segs.size());
    phase0 = (int)segs.size();
    p.smem = std::max(p.smem, used);
    used = cols = 0;
  };
  for (int t = 0; t < 4; ++t) {
    const int U = start[t + 1] - start[t], per = kTile * kElem[t];
    int u0 = 0;
    bool head = true;
    while (true) {
      const int left = U - u0;
      int k = std::min(left, std::max(0, (budget - used) / per));
      while (k && used + seg_bytes(k, kElem[t]) > budget) --k;
      if (left && !k) {  // nothing more fits: the next phase
        close();
        continue;
      }
      const bool last = u0 + k == U;
      segs.push_back(
          {t, u0, u0 + k, used, (head ? SEG_FIRST : 0) | (last ? SEG_LAST : 0), cols});
      cols += k;
      if (!(head && last)) p.carries = 1;
      used += k ? seg_bytes(k, kElem[t]) : 0;
      u0 += k;
      head = false;
      if (last) break;
      close();
    }
  }
  close();
  const int phases = (int)bounds.size() / 2, nseg = (int)segs.size();
  const int n_head = kHead + 2 * phases + kSegWords * nseg;
  const int at_u = n_head + 5 * M + 4, at_x = at_u + (int)uni.size();
  p.desc.resize((size_t)at_x + n);
  int* d = p.desc.data();
  d[0] = M;
  d[1] = phases;
  d[2] = nseg;
  d[3] = n_head + 4 * (M + 1);
  std::copy(bounds.begin(), bounds.end(), d + kHead);
  int* w = d + kHead + 2 * phases;
  for (const Seg& s : segs) {
    const int s0 = start[s.t];
    const int rec[kSegWords] = {s.t, s0 + s.u0, s0 + s.u1, (s.u1 - s.u0) | 1, s.smem, s.flags,
                                n_head + s.t * (M + 1), n_head + s.t * (M + 1) + 1,
                                at_x + first[s.t], at_u, (int)base[s.t], s.at};
    std::copy(rec, rec + kSegWords, w);
    w += kSegWords;
  }
  std::copy(flat, flat + 5 * M + 4, d + n_head);
  std::copy(uni.begin(), uni.end(), d + at_u);
  std::copy(pos.begin(), pos.end(), d + at_x);
  return 0;
}

}  // namespace koord_place
