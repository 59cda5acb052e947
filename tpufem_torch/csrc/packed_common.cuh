// Shared pieces of the packed-operator kernels (fused_yc, combine,
// compress_gather): the packed layout constants, the byte-packed table
// decode and the per-slot incidence sum.
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

// Slot s's incidence sum for one cluster:
//   acc[c] += fe[c * fe_stride + g * 128 + byte - 1]
// for every nonzero byte of entry v of chunk g, v ascending within g and g
// ascending — the fixed order of tpufem's _compress_gather_kernel.  The
// chunk loop is unrolled so that `vw` is read at constant offsets.
template <typename T>
__device__ __forceinline__ void compress_slot(
    const int* __restrict__ cinc_row /* [Wp, 128] words */, int s,
    const T* fe, int fe_stride, const VWidths& vw, T acc[3]) {
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
        acc[0] += fe[lane];
        acc[1] += fe[fe_stride + lane];
        acc[2] += fe[2 * fe_stride + lane];
      }
    }
    off += vg;
  }
}

}  // namespace tpufem
