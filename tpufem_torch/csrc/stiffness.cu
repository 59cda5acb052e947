// stiffness_fused: element stiffness K [M, 3k, 3k] of isotropic solids.
//
// Replaces tpufem/ops/stiffness_kernels.py `stiffness_fused`
// (_stiffness_kernel).  Per element and quadrature point q:
//   J = dN^T X (J[a][b] = dx_b / dxi_a), its cofactors, det, inv_det = 1/det,
//   J^-1 = cofactor * inv_det, W_q = w_q det,
//   g[kk][i] = sum_a J^-1[i][a] dN[q][kk][a]   (physical gradients),
// then the isotropic closed form of B^T D B, summed over q from q = 0:
//   K[(kk,c),(ll,e)] = sum_q W_q (lam g_kk[c] g_ll[e] + mu g_kk[e] g_ll[c])
//                      + [c == e] (g_kk . g_ll) (mu W_q).
// Every sum over reference weights skips the zero weights and starts at
// the first non-zero term, in tpufem's order; lam, mu, dN and w are
// rounded to the working type once.  Built with -fmad=false, the kernel
// rounds exactly like stiffness_fused_plain, and the two agree bitwise.
// The entry for (ll,e),(kk,c) is computed, not copied: its products
// commute with those of (kk,c),(ll,e), so it comes out bitwise the same.
//
// Bound on the H100: bytes.  It writes 9 k^2 values per element (3.6 KB
// for c3d10 in f32) and reads k node ids and 3k coordinates; its ~5.3k
// multiply-adds per c3d10 element take a sixth of the write time at the
// f32 rate.
//
// Design: one 256-thread block takes EB elements (EB from the shared
// memory an element needs, at most 64); one element's 495 accumulators do
// not fit one thread's registers, so the work is split in three phases
// through shared memory:
//   0. the block's node coordinates and the reference table (as T);
//   1. one thread per (element, q): J, its inverse, W_q, mu W_q and g;
//   2. one thread per (element, node pair kk, ll): the 3x3 block's nine
//      sums over q in registers, written straight to K (row-major, the
//      block's EB elements are one contiguous run of K).
// The last block masks the ragged edge (no padded elements).  k and q are
// template parameters; instantiated for c3d4 (4, 1), c3d10 (10, 4),
// c3d8 (8, 8) and c3d6 (6, 6), the types tpufem's router sends here.

#include "common.cuh"

namespace tpufem {

constexpr int kStiffThreads = 256;

template <int K, int Q>
struct RefTable {
  double dN[Q][K][3];   // reference gradients
  double w[Q];          // quadrature weights
};

template <typename T, int K, int Q>
__host__ __device__ constexpr int elems_per_block() {
  // shared bytes per element: X (3k), g (3kq), W and mu W (2q)
  constexpr int per = static_cast<int>(sizeof(T)) * (3 * K + 3 * K * Q + 2 * Q);
  constexpr int eb = 40960 / per;
  return eb > 64 ? 64 : eb;
}

template <typename T, int K, int Q>
__global__ void __launch_bounds__(kStiffThreads)
stiffness_kernel(const T* __restrict__ xyz, const int* __restrict__ conn,
                 int64_t M, const RefTable<K, Q> ref, double lam_d,
                 double mu_d, T* __restrict__ out) {
  constexpr int EB = elems_per_block<T, K, Q>();
  constexpr int D = 3 * K;
  __shared__ T xs[EB][K][3];
  __shared__ T gs[EB][Q][K][3];
  __shared__ T ws[EB][Q];
  __shared__ T mws[EB][Q];
  __shared__ T dNs[Q][K][3];
  __shared__ T wq[Q];

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * EB;
  const int ne = static_cast<int>(M - m0 < EB ? M - m0 : EB);
  const T lam = static_cast<T>(lam_d);
  const T mu = static_cast<T>(mu_d);

  // 0. coordinates and the reference table
  for (int p = t; p < ne * K; p += kStiffThreads) {
    const int e = p / K, kk = p - e * K;
    const int64_t node = conn[(m0 + e) * K + kk];
    xs[e][kk][0] = xyz[node * 3];
    xs[e][kk][1] = xyz[node * 3 + 1];
    xs[e][kk][2] = xyz[node * 3 + 2];
  }
  for (int p = t; p < Q * K * 3; p += kStiffThreads)
    (&dNs[0][0][0])[p] = static_cast<T>((&ref.dN[0][0][0])[p]);
  for (int p = t; p < Q; p += kStiffThreads) wq[p] = static_cast<T>(ref.w[p]);
  __syncthreads();

  // 1. one thread per (element, quadrature point)
  for (int p = t; p < ne * Q; p += kStiffThreads) {
    const int e = p / Q, qi = p - e * Q;
    T J[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T s = T(0);
        bool any = false;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const T c = dNs[qi][kk][a];
          if (c == T(0)) continue;
          const T v = c * xs[e][kk][b];
          s = any ? s + v : v;
          any = true;
        }
        J[a][b] = s;
      }
    }
    const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const T c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const T c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const T c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const T c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const T c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const T c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const T c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const T det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
    const T inv_det = T(1) / det;
    const T Ji[3][3] = {{c00 * inv_det, c01 * inv_det, c02 * inv_det},
                        {c10 * inv_det, c11 * inv_det, c12 * inv_det},
                        {c20 * inv_det, c21 * inv_det, c22 * inv_det}};
    const T Wq = wq[qi] * det;
    ws[e][qi] = Wq;
    mws[e][qi] = mu * Wq;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        T s = T(0);
        bool any = false;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T c = dNs[qi][kk][a];
          if (c == T(0)) continue;
          const T v = c * Ji[i][a];
          s = any ? s + v : v;
          any = true;
        }
        gs[e][qi][kk][i] = s;
      }
    }
  }
  __syncthreads();

  // 2. one thread per (element, node pair): a 3x3 block of K
  for (int p = t; p < ne * K * K; p += kStiffThreads) {
    const int e = p / (K * K);
    const int r = p - e * K * K;
    const int kk = r / K, ll = r - kk * K;
    T acc[3][3];
#pragma unroll
    for (int qi = 0; qi < Q; ++qi) {
      const T* gk = gs[e][qi][kk];
      const T* gl = gs[e][qi][ll];
      const T Wq = ws[e][qi];
      const T dot = (gk[0] * gl[0] + gk[1] * gl[1] + gk[2] * gl[2])
                    * mws[e][qi];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          T v = Wq * (lam * (gk[c] * gl[f]) + mu * (gk[f] * gl[c]));
          if (c == f) v = v + dot;
          acc[c][f] = qi == 0 ? v : acc[c][f] + v;
        }
      }
    }
    T* o = out + (m0 + e) * D * D + (3 * kk) * D + 3 * ll;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int f = 0; f < 3; ++f) o[c * D + f] = acc[c][f];
    }
  }
}

template <typename T, int K, int Q>
int launch(const void* xyz, const void* conn, int64_t M, const double* dN,
           const double* w, double lam, double mu, void* out,
           cudaStream_t stream) {
  RefTable<K, Q> ref;
  for (int i = 0; i < Q * K * 3; ++i) (&ref.dN[0][0][0])[i] = dN[i];
  for (int i = 0; i < Q; ++i) ref.w[i] = w[i];
  constexpr int EB = elems_per_block<T, K, Q>();
  if (M > 0) {
    const unsigned grid = static_cast<unsigned>((M + EB - 1) / EB);
    stiffness_kernel<T, K, Q><<<grid, kStiffThreads, 0, stream>>>(
        static_cast<const T*>(xyz), static_cast<const int*>(conn), M, ref,
        lam, mu, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int k, int q, const void* xyz, const void* conn, int64_t M,
             const double* dN, const double* w, double lam, double mu,
             void* out, cudaStream_t s) {
  if (k == 4 && q == 1)
    return launch<T, 4, 1>(xyz, conn, M, dN, w, lam, mu, out, s);
  if (k == 10 && q == 4)
    return launch<T, 10, 4>(xyz, conn, M, dN, w, lam, mu, out, s);
  if (k == 8 && q == 8)
    return launch<T, 8, 8>(xyz, conn, M, dN, w, lam, mu, out, s);
  if (k == 6 && q == 6)
    return launch<T, 6, 6>(xyz, conn, M, dN, w, lam, mu, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tpufem

// xyz [N, 3] node coordinates in the working type; conn [M, k] int32;
// dN [q, k, 3] and w [q] host doubles; out [M, 3k, 3k].
extern "C" int tpufem_stiffness_fused(int is_f64, int k, int q,
                                      const void* xyz, const void* conn,
                                      int64_t M, const double* dN,
                                      const double* w, double lam, double mu,
                                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::dispatch<double>(k, q, xyz, conn, M, dN, w, lam,
                                           mu, out, s)
                : tpufem::dispatch<float>(k, q, xyz, conn, M, dN, w, lam, mu,
                                          out, s);
}
