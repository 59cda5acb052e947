// compress_gather and compress_planar: element-lane values -> cluster slot
// sums.
//
// compress_gather replaces tpufem/ops/packed_kernels.py `compress_gather`
// (_compress_gather_kernel).  It builds the Jacobi and block-Jacobi
// diagonals (PackedPartialOperator.diagonal, block_diagonal) and is the
// last step of the staged apply; fused_yc runs the same device function
// on shared memory.
//
//   Yc[b, c*128 + s] = sum over incidence entries v of slot s:
//                      Fe[b, c, g*128 + byte_v(s) - 1]
//   byte_v(s) = byte v%4 of cinc[b, v/4, s]   (0 = unused entry)
//
// compress_planar replaces `compress_planar` (_compress_planar_kernel):
// the same sum reading planar Fe3 [3, k, B, E_c], where lane l of chunk g
// is element e = l mod E_c of node kk = g * (128 / E_c) + l / E_c (lane
// r = kk * E_c + e), and a lane with kk >= k reads 0.  It walks the same
// (g, v) order, so it is bitwise equal to compress_gather on the
// transposed input.  Fe3 may be a bucket's rows of a larger planar array:
// `plane` is the distance between its (c, kk) planes.
//
// Bound on the H100: bytes.  Each reads Fe (3 * k * E_c values per
// cluster) and the byte-packed incidence words once, and writes 384
// values per cluster; one add per value read.
//
// Design: one 128-thread block per cluster, thread s owns slot s and walks
// the bucket's chunk widths in order (compress_slot, packed_common.cuh);
// Fe is read from global memory (a cluster's values sit in a few short
// runs, so the reads stay in L1/L2).  Fixed order, pure adds: bitwise
// equal to the plain PyTorch versions.  Launched once per cluster bucket.

#include "packed_common.cuh"

namespace tpufem {

// Planar element-lane values of one cluster: fe3 points at element 0 of
// the cluster in plane (0, 0).
template <typename T>
struct Planar {
  const T* fe3;
  int64_t plane;
  int k, E_c;
  __device__ __forceinline__ T operator()(int c, int lane) const {
    const int kk = lane / E_c;
    const int e = lane - kk * E_c;
    return kk < k ? fe3[(c * k + kk) * plane + e] : T(0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kSlots)
compress_gather_kernel(const T* __restrict__ fe, int Rp,
                       const int* __restrict__ cinc, int Wp, VWidths vw,
                       T* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int s = threadIdx.x;
  T acc[3] = {T(0), T(0), T(0)};
  compress_slot<T>(cinc + b * Wp * kSlots, s,
                   LaneMajor<T>{fe + b * 3 * Rp, Rp}, vw, acc);
  T* o = out + b * kRow + s;
  o[0] = acc[0];
  o[kSlots] = acc[1];
  o[2 * kSlots] = acc[2];
}

template <typename T>
__global__ void __launch_bounds__(kSlots)
compress_planar_kernel(const T* __restrict__ fe3, int64_t plane, int k,
                       int E_c, const int* __restrict__ cinc, int Wp,
                       VWidths vw, T* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int s = threadIdx.x;
  T acc[3] = {T(0), T(0), T(0)};
  compress_slot<T>(cinc + b * Wp * kSlots, s,
                   Planar<T>{fe3 + b * E_c, plane, k, E_c}, vw, acc);
  T* o = out + b * kRow + s;
  o[0] = acc[0];
  o[kSlots] = acc[1];
  o[2 * kSlots] = acc[2];
}

template <typename T>
int launch(const void* fe, int Rp, const void* cinc, int Wp,
           const VWidths& vw, void* out, int64_t n, cudaStream_t stream) {
  if (n > 0) {
    compress_gather_kernel<T><<<static_cast<unsigned>(n), kSlots, 0,
                                stream>>>(
        static_cast<const T*>(fe), Rp, static_cast<const int*>(cinc), Wp,
        vw, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_planar(const void* fe3, int64_t plane, int k, int E_c,
                  const void* cinc, int Wp, const VWidths& vw, void* out,
                  int64_t n, cudaStream_t stream) {
  if (n > 0) {
    compress_planar_kernel<T><<<static_cast<unsigned>(n), kSlots, 0,
                                stream>>>(
        static_cast<const T*>(fe3), plane, k, E_c,
        static_cast<const int*>(cinc), Wp, vw, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool make_widths(const int* widths, int n_widths, VWidths* vw) {
  if (n_widths > kMaxChunks) return false;
  vw->n = n_widths;
  for (int g = 0; g < n_widths; ++g) vw->w[g] = widths[g];
  return true;
}

}  // namespace tpufem

// fe [n, 3, Rp]; cinc [n, Wp, 128] int32; widths[n_widths] host ints;
// out [n, 384].
extern "C" int tpufem_compress_gather(int is_f64, const void* fe, int Rp,
                                      const void* cinc, int Wp,
                                      const int* widths, int n_widths,
                                      void* out, int64_t n, void* stream) {
  tpufem::VWidths vw{};
  if (!tpufem::make_widths(widths, n_widths, &vw))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::launch<double>(fe, Rp, cinc, Wp, vw, out, n, s)
                : tpufem::launch<float>(fe, Rp, cinc, Wp, vw, out, n, s);
}

// fe3: element (c, kk, b, e) at fe3[(c * k + kk) * plane + b * E_c + e]
// for b < n; cinc [n, Wp, 128] int32; widths[n_widths] host ints;
// out [n, 384].
extern "C" int tpufem_compress_planar(int is_f64, const void* fe3,
                                      int64_t plane, int k, int E_c,
                                      const void* cinc, int Wp,
                                      const int* widths, int n_widths,
                                      void* out, int64_t n, void* stream) {
  tpufem::VWidths vw{};
  if (!tpufem::make_widths(widths, n_widths, &vw) || E_c <= 0 ||
      tpufem::kSlots % E_c)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::launch_planar<double>(fe3, plane, k, E_c, cinc, Wp,
                                                vw, out, n, s)
                : tpufem::launch_planar<float>(fe3, plane, k, E_c, cinc, Wp,
                                               vw, out, n, s);
}
