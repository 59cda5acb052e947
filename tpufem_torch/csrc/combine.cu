// combine: cluster slot sums -> node rows (the cross-cluster sum).
//
// Replaces tpufem/ops/packed_kernels.py `combine` (_combine_kernel), the
// Pallas kernel that reads window rows Ycw [Nb, Wc, 384] gathered into HBM
// beforehand.  Here the kernel reads rows of Yc by index (winc), so no
// Ycw is ever materialized.
//
//   F[j, c*128 + l] = sum_w Yc[winc[j, w], c*128 + byte_w(l) - 1]
//   byte_w(l) = byte w%4 of slotidx[j, w/4, l]  (0 = node absent)
//
// summed over w = 0..wk_j - 1 in order from 0, where wk_j is row j's
// window width; a zero byte or winc[j, w] >= B adds nothing.
//
// Bound on the H100: bytes.  Per node block it streams winc and the
// byte-packed slotidx (4 windows per int32 word), reads the ~3 * 128 Yc
// values its nodes take (each Yc value is read by exactly one node) and
// writes one row; the arithmetic is one add per read.  The Yc values a
// row reads are scattered over up to wk cluster rows, so they are 4- or
// 8-byte gathers that L2 serves, not full-line streams.
//
// Design: one launch for all rows (each row's width from a per-row table,
// PackedPlan.row_wk), one 128-thread block per row j; thread l owns node
// lane l.  A row is latency-bound: each window is a chain (its slot word
// and its cluster index, then the Yc values they address).  So the block
// first copies the row's cluster indices and slot words (up to 64 windows
// at a time) into shared memory with cp.async; then each thread issues
// the Yc loads of 8 windows, unconditionally from an address clamped to
// Yc's first row where the window adds nothing, and only then adds the
// ones that count, in w order.  The fixed order makes the sum
// deterministic and bitwise equal to the plain PyTorch version (pure
// adds, no atomics).  Rows of width 0 are written as zeros.  (ptxas keeps
// 32 registers and interleaves the loads with the adds; fencing them
// apart, or 16 windows a group, moved the sweep by under 4%.)

#include "packed_common.cuh"

namespace tpufem {

constexpr int kChunk = 64;   // windows staged in shared memory at a time
constexpr int kGroup = 8;    // windows whose Yc loads are in flight together

template <typename T>
__global__ void __launch_bounds__(kSlots)
combine_kernel(const T* __restrict__ Yc, int64_t B,
               const int* __restrict__ winc, int Wc,
               const int* __restrict__ slotidx, int Wp,
               const int* __restrict__ row_wk, int wmax,
               T* __restrict__ out) {
  __shared__ int s_cl[kChunk];
  __shared__ __align__(16) int s_word[kChunk / 4 * kSlots];
  const int64_t j = blockIdx.x;
  const int l = threadIdx.x;
  const int wk = B > 0 ? min(max(row_wk[j], 0), wmax) : 0;
  const int* wrow = winc + j * Wc;
  const int* srow = slotidx + j * Wp * kSlots;
  T a0 = 0, a1 = 0, a2 = 0;
  for (int w0 = 0; w0 < wk; w0 += kChunk) {
    const int nw = min(kChunk, wk - w0);
    if (w0 > 0) __syncthreads();           // the last chunk is read
    stage_words<kSlots>(s_word, srow + (w0 >> 2) * kSlots,
                        ((nw + 3) >> 2) * kSlots, l);
    if (l < nw) cp_async<4>(&s_cl[l], wrow + w0 + l);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int g = 0; g < nw; g += kGroup) {
      T v[kGroup][3];
      bool ok[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int w = g + i;
        const int byte =
            w < nw ? packed_byte(s_word[(w >> 2) * kSlots + l], w & 3) : 0;
        const int cl = w < nw ? s_cl[w] : 0;
        ok[i] = byte != 0 && static_cast<uint64_t>(cl) <
                                 static_cast<uint64_t>(B);
        const T* y =
            Yc + (ok[i] ? static_cast<int64_t>(cl) * kRow + (byte - 1) : 0);
        v[i][0] = y[0];
        v[i][1] = y[kSlots];
        v[i][2] = y[2 * kSlots];
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (ok[i]) {
          a0 += v[i][0];
          a1 += v[i][1];
          a2 += v[i][2];
        }
      }
    }
  }
  T* o = out + j * kRow + l;
  o[0] = a0;
  o[kSlots] = a1;
  o[2 * kSlots] = a2;
}

template <typename T>
int launch(const void* Yc, int64_t B, const void* winc, int Wc,
           const void* slotidx, int Wp, const void* row_wk, void* out,
           int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const int wmax = Wc < 4 * Wp ? Wc : 4 * Wp;
    combine_kernel<T><<<static_cast<unsigned>(n), kSlots, 0, stream>>>(
        static_cast<const T*>(Yc), B, static_cast<const int*>(winc), Wc,
        static_cast<const int*>(slotidx), Wp,
        static_cast<const int*>(row_wk), wmax, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpufem

// Yc [B, 384]; winc [n, Wc] int32; slotidx [n, Wp, 128] int32; row_wk [n]
// int32, each row's window width (cut to [0, min(Wc, 4 Wp)]); out [n, 384].
extern "C" int tpufem_combine(int is_f64, const void* Yc, int64_t B,
                              const void* winc, int Wc, const void* slotidx,
                              int Wp, const void* row_wk, void* out,
                              int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::launch<double>(Yc, B, winc, Wc, slotidx, Wp, row_wk,
                                         out, n, s)
                : tpufem::launch<float>(Yc, B, winc, Wc, slotidx, Wp, row_wk,
                                        out, n, s);
}
