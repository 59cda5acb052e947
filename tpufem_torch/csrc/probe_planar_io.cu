// planar_write and planar_read: element lanes between the lane-major
// layout [B, 3, Rp] and the planar layout [3, k, B, E_c] of the planar-I/O
// probe (ops/probe_planar_io.py):
//   write: out[c, kk, b, e] = x[b, c, kk * E_c + e]
//   read:  out[b, c, l] = p[c, l / E_c, b, l % E_c] for l < k * E_c, and 0
//          for the padding lanes k * E_c .. Rp - 1
// (128 % E_c == 0, Rp = ceil(k * E_c / 128) * 128: the probe's layout, in
// which lane kk * E_c + e of chunk g holds node kk of element e).
//
// Replace scripts/probe_planar_io.py `_write_kernel` (:23) and
// `_read_kernel` (:36), which move [TB, 128] lane chunks of TB clusters to
// and from E_c-wide planar slices in VMEM; the probe asked whether the
// packed operator's expand and compress could emit and read the planar
// element layout directly (K5a, K5b).
//
// Bound on the H100: bytes.  Write reads the k * E_c valid lanes of x and
// writes as many planar values; read reads them and writes all Rp lanes.
// No arithmetic.
//
// Design: one 128-thread block per (b, c) row of the lane-major side;
// thread l walks lanes l, l + 128, ... of the row.  The lane-major row moves
// as contiguous 512-byte runs per step, the planar side as runs of E_c
// consecutive values (128 bytes at E_c = 32).  E_c is a power of two, so a
// lane splits into (kk, e) by a shift and a mask.  Any B: no tiling.

#include "common.cuh"

namespace tpufem {

constexpr int kPlanarThreads = 128;

__global__ void __launch_bounds__(kPlanarThreads)
planar_write_kernel(const float* __restrict__ x, int64_t B, int k,
                    int log2_ec, int Rp, float* __restrict__ out) {
  const int64_t row = blockIdx.x;                  // b * 3 + c
  const int64_t b = row / 3;
  const int c = static_cast<int>(row - b * 3);
  const int ec = 1 << log2_ec;
  const int kE = k << log2_ec;
  const float* xr = x + row * Rp;
  for (int l = threadIdx.x; l < kE; l += kPlanarThreads) {
    const int kk = l >> log2_ec, e = l & (ec - 1);
    out[(static_cast<int64_t>(c * k + kk) * B + b) * ec + e] = xr[l];
  }
}

__global__ void __launch_bounds__(kPlanarThreads)
planar_read_kernel(const float* __restrict__ p, int64_t B, int k,
                   int log2_ec, int Rp, float* __restrict__ out) {
  const int64_t row = blockIdx.x;                  // b * 3 + c
  const int64_t b = row / 3;
  const int c = static_cast<int>(row - b * 3);
  const int ec = 1 << log2_ec;
  const int kE = k << log2_ec;
  float* orow = out + row * Rp;
  for (int l = threadIdx.x; l < Rp; l += kPlanarThreads) {
    float v = 0.f;
    if (l < kE) {
      const int kk = l >> log2_ec, e = l & (ec - 1);
      v = p[(static_cast<int64_t>(c * k + kk) * B + b) * ec + e];
    }
    orow[l] = v;
  }
}

}  // namespace tpufem

// x [B, 3, Rp] f32 -> out [3, k, B, E_c], E_c = 2^log2_ec.
extern "C" int tpufem_planar_write(const void* x, int64_t B, int k,
                                   int log2_ec, int Rp, void* out,
                                   void* stream) {
  if (B > 0) {
    tpufem::planar_write_kernel<<<static_cast<unsigned>(3 * B),
                                  tpufem::kPlanarThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), B, k, log2_ec, Rp,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// p [3, k, B, E_c] f32 -> out [B, 3, Rp], E_c = 2^log2_ec.
extern "C" int tpufem_planar_read(const void* p, int64_t B, int k,
                                  int log2_ec, int Rp, void* out,
                                  void* stream) {
  if (B > 0) {
    tpufem::planar_read_kernel<<<static_cast<unsigned>(3 * B),
                                 tpufem::kPlanarThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), B, k, log2_ec, Rp,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
