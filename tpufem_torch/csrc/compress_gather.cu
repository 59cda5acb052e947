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
// compress_gather: one 128-thread block per cluster, thread s owns slot s
// and walks the bucket's chunk widths in order (compress_slot,
// packed_common.cuh); Fe is read from global memory (a cluster's values
// sit in a few short runs, so the reads stay in L1/L2).
//
// compress_planar: a cluster's planar values are 3k runs of E_c values in
// 3k planes.  One 128-thread block per cluster brings them into shared
// memory by cp.async (16 bytes a copy where the runs allow it) in the
// lane-major order of compress_gather ([3][128 n_chunks], zeros where
// kk >= k), together with the cluster's incidence words; thread s then
// walks slot s on shared memory with compress_slot, so the walk has no
// division, no branch on kk and no global load.  (Two and four clusters
// per block, whose (c, kk) runs join into one, measured 1% and 4% slower
// on the H100: PERF.md.)
//
// Fixed order, pure adds: bitwise equal to the plain PyTorch versions.
// Launched once per cluster bucket.

#include "packed_common.cuh"

namespace tpufem {

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

// Planar Fe3 -> Yc for cluster blockIdx.x of the bucket; lg = log2(E_c).
template <typename T>
__global__ void __launch_bounds__(kSlots)
compress_planar_kernel(const T* __restrict__ fe3, int64_t plane, int k,
                       int lg, const int* __restrict__ cinc, int Wp,
                       VWidths vw, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Rs = vw.n * kSlots;                   // staged lanes
  T* fes = reinterpret_cast<T*>(smem_raw);        // [3][Rs]
  int* words = reinterpret_cast<int*>(fes + 3 * Rs);   // [Wp][128]
  const int s = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int E_c = 1 << lg;

  stage_words<kSlots>(words, cinc + b * Wp * kSlots,
                      static_cast<int64_t>(Wp) * kSlots, s);
  // the planar runs: (c, kk < k) holds the cluster's E_c values at
  // fe3 + (c k + kk) plane + b E_c, lanes kk E_c .. kk E_c + E_c - 1
  const int kk_max = min(k, Rs >> lg);
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool vec = E_c % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(fe3) |
                     static_cast<uintptr_t>(plane * sizeof(T))) & 15) == 0;
  const int step = vec ? V : 1;
  const int per_run = E_c / step;
  const T* src0 = fe3 + (b << lg);
  for (int i = s; i < 3 * kk_max * per_run; i += kSlots) {
    const int r = i / per_run;
    const int j = (i - r * per_run) * step;
    const int c = r / kk_max, kk = r - c * kk_max;
    const T* src = src0 + (static_cast<int64_t>(c) * k + kk) * plane + j;
    T* dst = fes + c * Rs + (kk << lg) + j;
    if (vec)
      cp_async<16>(dst, src);
    else
      cp_async<static_cast<int>(sizeof(T))>(dst, src);
  }
  // lanes of nodes kk >= k read zero
  const int zlo = kk_max << lg;
  for (int i = s; i < 3 * (Rs - zlo); i += kSlots) {
    const int c = i / (Rs - zlo);
    fes[c * Rs + zlo + (i - c * (Rs - zlo))] = T(0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  T acc[3] = {T(0), T(0), T(0)};
  compress_slot<T>(words, s, LaneMajor<T>{fes, Rs}, vw, acc);
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
  int lg = 0;
  while ((1 << lg) < E_c) ++lg;
  // shared memory of a cluster: its staged lanes and incidence words
  const size_t smem = 3 * static_cast<size_t>(vw.n) * kSlots * sizeof(T) +
                      static_cast<size_t>(Wp) * kSlots * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    // the attribute is per device, so it is set at every launch that needs it
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          compress_planar_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    compress_planar_kernel<T><<<static_cast<unsigned>(n), kSlots, smem,
                                stream>>>(
        static_cast<const T*>(fe3), plane, k, lg,
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
