// The host side of the warm refresh (schedule.cu refresh_kernel): the plan of
// one call, in plain C++ (no CUDA), so that it builds with any C++17
// compiler (the CPU tests build it with g++ and walk the plan as the kernel
// walks it).
//
// Input: the dirty node rows as the engine hands them over (a power-of-two
// index padded by repeating a real row, in any order), the node blocks'
// height BS and the node count N.  The plan holds each distinct node block
// once, in the order its first dirty row comes, as kHead + W words: the
// block's index, then a mask of its dirty rows (bit i of word i / 32 for
// row b * BS + i), W = mask_words(BS).  Padding duplicates and rows that
// share a block collapse into one entry, so the kernel evaluates each dirty
// row once and each block maximum once.
#pragma once

#include <cstdint>
#include <vector>

namespace koord_refresh {

constexpr int kHead = 1;  // an entry's words before its mask

inline int mask_words(int BS) { return (BS + 31) / 32; }

// The block masks of the calling thread's last plans, indexed by block and
// kept all zero between calls (a plan clears the words it set).
struct Scratch {
  std::vector<uint32_t> mask;
  std::vector<int> blocks;
};

// Plans D dirty rows into `out` (entries of kHead + mask_words(BS) words);
// returns the entry count, or -1 when BS < 1 or a row lies outside [0, N).
inline int build(const int* dirty, int D, int BS, int N, std::vector<uint32_t>& out,
                 Scratch& s) {
  if (BS < 1) return -1;
  for (int d = 0; d < D; ++d)
    if (dirty[d] < 0 || dirty[d] >= N) return -1;
  const int W = mask_words(BS), NB = (N + BS - 1) / BS;
  if (s.mask.size() < (size_t)NB * W) s.mask.assign((size_t)NB * W, 0u);
  s.blocks.clear();
  for (int d = 0; d < D; ++d) {
    const int j = dirty[d], b = j / BS, i = j - b * BS;
    uint32_t* m = s.mask.data() + (size_t)b * W;
    bool fresh = true;
    for (int k = 0; k < W; ++k) fresh = fresh && m[k] == 0;
    if (fresh) s.blocks.push_back(b);
    m[i >> 5] |= 1u << (i & 31);
  }
  out.resize(s.blocks.size() * (kHead + W));
  uint32_t* o = out.data();
  for (int b : s.blocks) {
    *o++ = (uint32_t)b;
    uint32_t* m = s.mask.data() + (size_t)b * W;
    for (int k = 0; k < W; ++k) {
      *o++ = m[k];
      m[k] = 0;
    }
  }
  return (int)s.blocks.size();
}

}  // namespace koord_refresh
