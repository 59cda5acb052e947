// Shared pieces of the packed-operator kernels (fused_yc, combine,
// compress_gather, expand, expand_planar, compress_planar): the packed
// layout constants, the byte-packed table decode, the two-hop gather
// (X rows -> cluster slots -> element lanes) and the per-slot incidence
// sum.
#pragma once

#include "common.cuh"

namespace tpufem {

constexpr int kSlots = 128;      // slots per cluster = nodes per packed row
constexpr int kRow = 3 * kSlots; // lanes per packed row: component c at c*128
constexpr int kMaxChunks = 16;   // 128-lane chunks of element lanes (k*E_c <= 2048)

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
