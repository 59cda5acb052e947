// relayout_fwd and relayout_inv: the [64, 32] <-> [16, 128] row-major
// relayouts of the relayout probe (ops/probe_reshape.py), batched over T
// tiles.
//
// Replace the Pallas kernels of scripts/probe_reshape.py: make_kernel(fn)
// (:39) with its four candidates cand_reshape, cand_slice_strided,
// cand_reshape3 and cand_getitem_strided, and scratch_kernel (:49), each
// [64, 32] -> [16, 128]; inv_kernel (:92) and inv_scratch_kernel (:111),
// [16, 128] -> [64, 32].  The probe asked which relayouts Mosaic compiles:
// on a TPU a tile lives in (8, 128) sublane/lane registers, and the
// row-major reshape moves values between lanes.  In row-major memory the
// relayout is the identity on flat indices, out[r, 32i + c] = x[4r + i, c]
// since r * 128 + 32i + c = (4r + i) * 32 + c: Hopper has no register
// layout to convert.  The kernels still compute each candidate's own index
// map, so each candidate is checked on its own:
//   forward 0 (reshape, reshape3): flat index f of out <- flat index f of x
//   forward 1 (slice_strided, getitem_strided): out[r, 32i + c] <- x[4r + i, c]
//   forward 2 (scratch_strided): the tile is loaded coalesced into shared
//       memory, then read back at the strided rows of forward 1
//   inverse 1 (inv_stack_reshape): out[4r + i, c] <- x[r, 32i + c]
//   inverse 2 (inv_scratch): x's column blocks are written into shared
//       memory at row stride 4, then stored coalesced
//
// Bound on the H100: bytes, one read and one write of each 8 KB tile, no
// arithmetic.  Design: one 128-thread block per tile, 16-byte loads and
// stores (a float4 never straddles a 32-column block), so each warp moves
// 512 contiguous bytes of the tile on at least one side.

#include "common.cuh"

namespace tpufem {

constexpr int kTileRows = 64, kTileCols = 32;  // the [64, 32] side
constexpr int kWideCols = 128;                 // the [16, 128] side
constexpr int kTileVec = kTileRows * kTileCols / 4;   // 512 float4 per tile
constexpr int kRelayoutThreads = 128;

// float4 q of the [16, 128] side -> float4 of the [64, 32] side under
// out[r, 32i + c] = x[4r + i, c]
__device__ __forceinline__ int strided_row_vec(int q) {
  const int f = 4 * q;
  const int r = f / kWideCols, j = f % kWideCols;     // j = 32i + c
  return ((4 * r + j / kTileCols) * kTileCols + j % kTileCols) / 4;
}

// float4 p of the [64, 32] side -> float4 of the [16, 128] side under
// out[4r + i, c] = x[r, 32i + c]
__device__ __forceinline__ int stacked_block_vec(int p) {
  const int f = 4 * p;
  const int row = f / kTileCols, c = f % kTileCols;   // row = 4r + i
  return ((row / 4) * kWideCols + (row % 4) * kTileCols + c) / 4;
}

template <int V>
__global__ void __launch_bounds__(kRelayoutThreads)
relayout_fwd_kernel(const float4* __restrict__ x, float4* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileVec;
  const float4* xt = x + base;
  float4* ot = out + base;
  if constexpr (V == 2) {
    __shared__ float4 s[kTileVec];
    for (int q = threadIdx.x; q < kTileVec; q += kRelayoutThreads) s[q] = xt[q];
    __syncthreads();
    for (int q = threadIdx.x; q < kTileVec; q += kRelayoutThreads)
      ot[q] = s[strided_row_vec(q)];
  } else {
    for (int q = threadIdx.x; q < kTileVec; q += kRelayoutThreads)
      ot[q] = xt[V == 0 ? q : strided_row_vec(q)];
  }
}

template <int V>
__global__ void __launch_bounds__(kRelayoutThreads)
relayout_inv_kernel(const float4* __restrict__ x, float4* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileVec;
  const float4* xt = x + base;
  float4* ot = out + base;
  if constexpr (V == 2) {
    // x[r, 32i + c] goes to scratch row 4r + i: stride-4 row writes
    __shared__ float4 s[kTileVec];
    for (int q = threadIdx.x; q < kTileVec; q += kRelayoutThreads)
      s[strided_row_vec(q)] = xt[q];
    __syncthreads();
    for (int p = threadIdx.x; p < kTileVec; p += kRelayoutThreads) ot[p] = s[p];
  } else {
    for (int p = threadIdx.x; p < kTileVec; p += kRelayoutThreads)
      ot[p] = xt[stacked_block_vec(p)];
  }
}

template <int V>
int launch_fwd(const void* x, int64_t T, void* out, cudaStream_t stream) {
  relayout_fwd_kernel<V><<<static_cast<unsigned>(T), kRelayoutThreads, 0,
                           stream>>>(static_cast<const float4*>(x),
                                     static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_inv(const void* x, int64_t T, void* out, cudaStream_t stream) {
  relayout_inv_kernel<V><<<static_cast<unsigned>(T), kRelayoutThreads, 0,
                           stream>>>(static_cast<const float4*>(x),
                                     static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpufem

// x [T, 64, 32] f32; out [T, 16, 128]; variant 0, 1 or 2.
extern "C" int tpufem_relayout_fwd(int variant, const void* x, int64_t T,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  switch (variant) {
    case 0: return tpufem::launch_fwd<0>(x, T, out, s);
    case 1: return tpufem::launch_fwd<1>(x, T, out, s);
    case 2: return tpufem::launch_fwd<2>(x, T, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [T, 16, 128] f32; out [T, 64, 32]; variant 1 or 2.
extern "C" int tpufem_relayout_inv(int variant, const void* x, int64_t T,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  switch (variant) {
    case 1: return tpufem::launch_inv<1>(x, T, out, s);
    case 2: return tpufem::launch_inv<2>(x, T, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
