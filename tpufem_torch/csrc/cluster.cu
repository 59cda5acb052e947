// cluster_expand and cluster_compress: the in-cluster gather and sum of the
// clustered operator (ops/clustered.py, ClusteredOperator).
//
// Replace tpufem/ops/pallas_kernels.py `cluster_expand` (_expand_kernel)
// and `cluster_compress` (_compress_kernel).  The Pallas kernels build a
// one-hot [R, L] selection from lconn in VMEM and contract it on the MXU;
// here the same selections are an indexed read and a fixed-order sum:
//   expand:   ue[b, r, c] = Uc[b, lconn[b, r], c]
//   compress: Yc[b, l, c] = sum over r ascending with lconn[b, r] == l of
//             Fe[b, r, c], starting from 0
// (lconn [B, R] int32 is ClusterPlan.lconn flattened element-major,
// r = e * k + kk; its entries lie in [0, L)).
//
// Bound on the H100: bytes.  Expand reads lconn (R ints) and Uc (L * nd
// values) and writes R * nd values per cluster; compress reads lconn and
// Fe (R * nd) and writes L * nd values.  Neither does arithmetic beyond
// one add per Fe value.
//
// Design.  Expand: one thread per output value, consecutive threads on
// consecutive values (coalesced writes; Uc rows are read by index and stay
// in L1/L2, 1.5 KB per cluster in f32).  Compress: one block per cluster
// stages lconn[b] and Fe[b] in shared memory; thread l walks r = 0..R-1 in
// order and adds the rows that belong to slot l.  No atomics: the sum
// order is fixed, so the result is bitwise that of the plain PyTorch
// version, which sums in the same order.

#include "common.cuh"

namespace tpufem {

constexpr int kExpandThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kExpandThreads)
cluster_expand_kernel(const int* __restrict__ lconn, const T* __restrict__ uc,
                      int R, int L, int nd, int64_t total,
                      T* __restrict__ out) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kExpandThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t br = idx / nd;                 // cluster b, lane r
  const int c = static_cast<int>(idx - br * nd);
  const int64_t b = br / R;
  const int l = lconn[br];
  out[idx] = static_cast<unsigned>(l) < static_cast<unsigned>(L)
                 ? uc[(b * L + l) * nd + c]
                 : T(0);
}

constexpr int kNd = 3;   // values per node: the solid operator's u_x, u_y, u_z

template <typename T>
__global__ void cluster_compress_kernel(const int* __restrict__ lconn,
                                        const T* __restrict__ fe, int R,
                                        int L, T* __restrict__ out) {
  constexpr int ND = kNd;
  extern __shared__ unsigned char smem_raw[];
  T* fs = reinterpret_cast<T*>(smem_raw);      // [R, ND]
  int* ls = reinterpret_cast<int*>(fs + R * ND);   // [R]
  const int64_t b = blockIdx.x;
  for (int p = threadIdx.x; p < R * ND; p += blockDim.x)
    fs[p] = fe[b * R * ND + p];
  for (int p = threadIdx.x; p < R; p += blockDim.x) ls[p] = lconn[b * R + p];
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T acc[ND];
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[c] = T(0);
    for (int r = 0; r < R; ++r) {
      if (ls[r] != l) continue;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[c] += fs[r * ND + c];
    }
    T* o = out + (b * L + l) * ND;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[c] = acc[c];
  }
}

template <typename T>
int expand(const void* lconn, const void* uc, int64_t B, int R, int L,
           int nd, void* out, cudaStream_t stream) {
  const int64_t total = B * R * nd;
  if (total > 0) {
    const unsigned grid =
        static_cast<unsigned>((total + kExpandThreads - 1) / kExpandThreads);
    cluster_expand_kernel<T><<<grid, kExpandThreads, 0, stream>>>(
        static_cast<const int*>(lconn), static_cast<const T*>(uc), R, L, nd,
        total, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int compress(const void* lconn, const void* fe, int64_t B, int R, int L,
             int nd, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * (kNd * sizeof(T) + sizeof(int));
  if (nd != kNd || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const int threads = L < 1024 ? ((L + 31) / 32) * 32 : 1024;
    cluster_compress_kernel<T>
        <<<static_cast<unsigned>(B), threads, smem, stream>>>(
            static_cast<const int*>(lconn), static_cast<const T*>(fe), R, L,
            static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpufem

// lconn [B, R] int32; uc [B, L, nd]; out [B, R, nd].
extern "C" int tpufem_cluster_expand(int is_f64, const void* lconn,
                                     const void* uc, int64_t B, int R, int L,
                                     int nd, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::expand<double>(lconn, uc, B, R, L, nd, out, s)
                : tpufem::expand<float>(lconn, uc, B, R, L, nd, out, s);
}

// lconn [B, R] int32; fe [B, R, 3]; out [B, L, 3]; nd must be 3.
extern "C" int tpufem_cluster_compress(int is_f64, const void* lconn,
                                       const void* fe, int64_t B, int R,
                                       int L, int nd, void* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::compress<double>(lconn, fe, B, R, L, nd, out, s)
                : tpufem::compress<float>(lconn, fe, B, R, L, nd, out, s);
}
