// Shared pieces of the packed-operator kernels (fused_yc, combine,
// compress_gather, expand, expand_planar, compress_planar): the packed
// layout constants, the byte-packed table decode, the two-hop gather
// (X rows -> cluster slots -> element lanes) and the per-slot incidence
// sum; and the asynchronous copies into shared memory that fused_yc and
// cluster_compress stage their tables with.
#pragma once

#include "common.cuh"

namespace tpufem {

// cp.async of N = 4, 8 or 16 bytes from global to shared memory; with
// `from_src` false it writes N zero bytes and reads nothing.  A thread sees
// its own copies after cp_async_wait; other threads after a barrier.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool from_src = true) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 B");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(from_src ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(N), "r"(from_src ? N : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `n` 4-byte words from global to shared memory with the kThreads
// threads of a block (t = 0..kThreads-1), 16 bytes a copy where both ends
// are 16-byte aligned and n is a multiple of 4, else a word a copy.
template <int kThreads>
__device__ __forceinline__ void stage_words(void* dst, const void* src,
                                            int64_t n, int t) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
                   (n & 3) == 0;
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
  if (vec) {
    for (int64_t i = t; i < n / 4; i += kThreads)
      cp_async<16>(d + 16 * i, s + 16 * i);
  } else {
    for (int64_t i = t; i < n; i += kThreads) cp_async<4>(d + 4 * i, s + 4 * i);
  }
}

// Ask for the 128-byte lines of [p, p + nbytes) to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t nbytes,
                                            int t, int nthreads) {
  const auto* c = static_cast<const unsigned char*>(p);
  for (int64_t off = 128 * static_cast<int64_t>(t); off < nbytes;
       off += 128 * static_cast<int64_t>(nthreads))
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

constexpr int kSlots = 128;      // slots per cluster = nodes per packed row
constexpr int kRow = 3 * kSlots; // lanes per packed row: component c at c*128
constexpr int kMaxChunks = 16;   // 128-lane chunks of element lanes (k*E_c <= 2048)
constexpr size_t kMaxSmem = 232448;   // shared memory a block can use (H100)

// Per-128-lane-chunk widths of a cluster bucket's incidence lists.
struct VWidths {
  int n;
  int w[kMaxChunks];
};

// Byte `b` (0..3) of a packed table word.  The top byte can hold 128
// (lane 127 + 1), so the shift is unsigned (tpufem: shift_right_logical).
__device__ __forceinline__ int packed_byte(int word, int b) {
  return static_cast<int>((static_cast<unsigned>(word) >> (8 * b)) & 0xFFu);
}

// Hop 1 for one slot: its three components from a row of X read by index,
//   v[c] = X[win_row[ws], c*128 + js]
// where ws = wslot[b, s], js = jslot[b, s] and win_row = win_nodes[b, :].
// An empty slot (ws >= wk, the bucket's window width) or a padded window
// row (== Nb) leaves v as it is (the callers pass zeros).
template <typename T>
__device__ __forceinline__ void hop1_slot(const T* __restrict__ X, int64_t Nb,
                                          const int* __restrict__ win_row,
                                          int wk, int ws, int js, T v[3]) {
  if (ws < wk) {
    const int row = win_row[ws];
    if (row < Nb) {
      const T* xr = X + static_cast<int64_t>(row) * kRow + js;
      v[0] = xr[0];
      v[1] = xr[kSlots];
      v[2] = xr[2 * kSlots];
    }
  }
}

// Hop 1 for the 128 slots of cluster b, one per thread (t = slot), into
// the cluster's slot values uc [3][128] (shared memory).
template <typename T>
__device__ __forceinline__ void hop1_cluster(
    const T* __restrict__ X, int64_t Nb, const int* __restrict__ win_nodes,
    int Wn, int wk, const int* __restrict__ wslot,
    const int* __restrict__ jslot, int64_t b, bool valid, int t, T* uc) {
  T v[3] = {T(0), T(0), T(0)};
  if (valid)
    hop1_slot<T>(X, Nb, win_nodes + b * Wn, wk, wslot[b * kSlots + t],
                 jslot[b * kSlots + t], v);
  uc[t] = v[0];
  uc[kSlots + t] = v[1];
  uc[2 * kSlots + t] = v[2];
}

// Hop 2 for one element lane: the three components of slot `slot`.
template <typename T>
__device__ __forceinline__ void hop2_lane(const T* uc, int slot, T v[3]) {
  v[0] = uc[slot];
  v[1] = uc[kSlots + slot];
  v[2] = uc[2 * kSlots + slot];
}

// Element-lane values of one cluster, lane-major: fe[c * stride + r].
template <typename T>
struct LaneMajor {
  const T* fe;
  int stride;
  __device__ __forceinline__ T operator()(int c, int lane) const {
    return fe[c * stride + lane];
  }
};

// Slot s's incidence sum for one cluster:
//   acc[c] += fe(c, g * 128 + byte - 1)
// for every nonzero byte of entry v of chunk g, v ascending within g and g
// ascending — the fixed order of tpufem's _compress_gather_kernel.  `fe`
// reads element lane r of component c (LaneMajor, or the planar accessor
// of compress_planar.cu).  The chunk loop is unrolled so that `vw` is read
// at constant offsets.
template <typename T, typename Fe>
__device__ __forceinline__ void compress_slot(
    const int* __restrict__ cinc_row /* [Wp, 128] words */, int s,
    const Fe& fe, const VWidths& vw, T acc[3]) {
  int off = 0;
#pragma unroll
  for (int g = 0; g < kMaxChunks; ++g) {
    if (g >= vw.n) break;
    const int vg = vw.w[g];
    for (int v = 0; v < vg; ++v) {
      const int vi = off + v;
      const int byte = packed_byte(cinc_row[(vi >> 2) * kSlots + s], vi & 3);
      if (byte) {
        const int lane = g * kSlots + byte - 1;
        acc[0] += fe(0, lane);
        acc[1] += fe(1, lane);
        acc[2] += fe(2, lane);
      }
    }
    off += vg;
  }
}

}  // namespace tpufem
