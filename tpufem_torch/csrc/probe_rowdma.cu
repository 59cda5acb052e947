// row_accumulate: sums of indexed 384-float rows, the access pattern of the
// row-read probe (ops/probe_rowdma.py):
//   out[g, 0, :] = sum over r = 0..127, in order, of src[idx[128 g + r], :]
//
// Replaces scripts/probe_rowdma.py `kern` (:75, called in f_dma :97), a
// Pallas kernel that keeps K = 8 single-row DMAs from HBM in flight
// (semaphore-paced, indices scalar-prefetched) and adds each row as it
// lands.  The probe measures how fast rows can be read by index compared
// with a materialised gather; K1's hop 1, K2, K4 and K7a read rows of 384
// values in the same way.
//
// Bound on the H100: bytes.  Every indexed row is 1536 B read from device
// memory (src is larger than the 50 MB L2 at the probe's size), plus the
// indices and one output row per 128 reads; one add per value read.
//
// Design: one block per 128 reads, 96 threads, each owning one float4 of
// the row.  A ring of K = 8 row buffers in shared memory is filled with
// cp.async (16 bytes per thread, one commit group per row): Hopper's
// counterpart of the probe's K DMAs in flight.  A thread copies its own 16
// bytes of each row and reads back only those, so it waits on its own
// copies (cp.async.wait_group) and the block synchronises only once, after
// loading its indices.  Every step commits one group (empty at the tail),
// so wait_group K-1 always leaves the next K-1 rows in flight.  Each
// thread sums its four lanes in r order from zero, the order of the Pallas
// kernel and of the plain version: only adds, so the result is bitwise the
// plain version's.  An index outside [0, n_src) copies zeros (cp.async's
// zero fill), so no read leaves src.

#include "common.cuh"

namespace tpufem {

constexpr int kRowVec = 384 / 4;   // float4 per row: one per thread
constexpr int kReads = 128;        // rows summed per output row
constexpr int kInFlight = 8;       // ring depth K

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kRowVec)
row_accumulate_kernel(const int* __restrict__ idx,
                      const float4* __restrict__ src, int64_t n_src,
                      float4* __restrict__ out) {
  __shared__ int rows[kReads];
  __shared__ float4 ring[kInFlight][kRowVec];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.x;
  for (int r = t; r < kReads; r += kRowVec) rows[r] = idx[g * kReads + r];
  __syncthreads();

  auto start = [&](int r) {
    const int row = rows[r];
    const bool in = row >= 0 && row < n_src;
    cp_async16(&ring[r % kInFlight][t],
               src + (in ? static_cast<int64_t>(row) * kRowVec + t : 0),
               in ? 16 : 0);
  };
#pragma unroll
  for (int r = 0; r < kInFlight; ++r) {
    start(r);
    cp_async_commit();
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int r = 0; r < kReads; ++r) {
    cp_async_wait<kInFlight - 1>();        // row r has landed
    const float4 v = ring[r % kInFlight][t];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    if (r + kInFlight < kReads) start(r + kInFlight);
    cp_async_commit();
  }
  out[g * kRowVec + t] = acc;
}

}  // namespace tpufem

// src [n_src, 384] f32; idx [n_rd] int32, n_rd = 128 * n_out;
// out [n_out, 1, 384].
extern "C" int tpufem_row_accumulate(const void* src, int64_t n_src,
                                     const void* idx, int64_t n_out,
                                     void* out, void* stream) {
  if (n_out > 0) {
    tpufem::row_accumulate_kernel<<<static_cast<unsigned>(n_out),
                                    tpufem::kRowVec, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float4*>(src), n_src,
        static_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
