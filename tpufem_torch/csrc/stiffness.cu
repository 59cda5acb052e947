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
// Like tpufem's kernel it computes the node pairs kk <= ll only and copies
// each block to its transposed place: the products of the entry
// (ll,e),(kk,c) commute with those of (kk,c),(ll,e), so the copy is what
// computing it would give.
//
// Bound on the H100: bytes.  It writes 9 k^2 values per element (7.2 KB
// for c3d10 in f64, 3.6 KB in f32) and reads k node ids and 3k
// coordinates; its ~14k operations per c3d10 element over the k (k + 1) / 2
// node pairs take about 40% of the write time at the f64 rate.
//
// Design: one 128-thread block takes EB elements; each element's whole
// D x D tile (D = 3k) is built in shared memory, so that the block's EB
// tiles, one contiguous run of K, leave with coalesced 16-byte stores
// marked evict-first (K is >100x the L2).  EB is the count that fits 36 KB
// and leaves the fewest threads idle in the node-pair phase (c3d10: 4 in
// f64, 8 in f32), so six blocks share an SM and the stores of some drain
// while the others compute.  `__launch_bounds__(128, 1)`: without the
// minimum of one block, ptxas spills in f64 and runs 9% slower (PERF.md).
// The phases, each through shared memory:
//   0. the block's node coordinates and the reference table (as T);
//   1. one thread per (element, q): J, its inverse, W_q and mu W_q;
//   2. one thread per (element, q, node): the gradient g[kk];
//   3. one thread per (element, node pair kk <= ll): the 3x3 block's nine
//      sums over q in registers, written to the tile and mirrored;
//   4. the tiles to K, 16 bytes a thread, neighbouring threads on
//      neighbouring addresses.
// The last block takes the ragged edge (no padded elements).  k and q are
// template parameters; instantiated for c3d4 (4, 1), c3d10 (10, 4),
// c3d8 (8, 8) and c3d6 (6, 6), the types tpufem's router sends here.
// Offsets into K are 64-bit: in f64 K passes 2^32 bytes.

#include <type_traits>

#include "common.cuh"

namespace tpufem {

template <int V>
using Int = std::integral_constant<int, V>;

constexpr int kStiffThreads = 128;
constexpr int kStiffSmem = 36 * 1024;   // dynamic shared memory per block

template <int K, int Q>
struct RefTable {
  double dN[Q][K][3];   // reference gradients
  double w[Q];          // quadrature weights
};

// Shared bytes per element: the tile (9k^2), g (3kq), J^-1 (9q), X (3k),
// W and mu W (2q).
template <typename T, int K, int Q>
__host__ __device__ constexpr int stiff_elem_bytes() {
  return static_cast<int>(sizeof(T)) *
         (9 * K * K + 3 * K * Q + 9 * Q + 3 * K + 2 * Q);
}

// Elements per block: of the counts whose shared memory fits kStiffSmem,
// the one that leaves the fewest threads idle in phase 3 (its EB k(k+1)/2
// pair tasks over rounds of kStiffThreads); a tie goes to the larger count.
template <typename T, int K, int Q>
__host__ __device__ constexpr int elems_per_block() {
  constexpr int P = K * (K + 1) / 2;
  constexpr int emax = kStiffSmem / stiff_elem_bytes<T, K, Q>();
  int best = 1;
  long long best_used = P, best_slots = kStiffThreads;
  for (int e = 1; e <= emax; ++e) {
    const long long used = static_cast<long long>(e) * P;
    const long long slots =
        (used + kStiffThreads - 1) / kStiffThreads * kStiffThreads;
    if (used * best_slots >= best_used * slots) {
      best = e;
      best_used = used;
      best_slots = slots;
    }
  }
  return best;
}

template <typename T, int K, int Q>
__global__ void __launch_bounds__(kStiffThreads, 1)
stiffness_kernel(const T* __restrict__ xyz, const int* __restrict__ conn,
                 int64_t M, const RefTable<K, Q> ref, double lam_d,
                 double mu_d, T* __restrict__ out) {
  static_assert(K % 2 == 0, "a tile of 9 k^2 values is 16-byte whole");
  constexpr int EB = elems_per_block<T, K, Q>();
  constexpr int D = 3 * K;
  constexpr int P = K * (K + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);          // [EB][D][D]
  T* gs = tile + EB * D * D;                         // [EB][Q][K][3]
  T* jis = gs + EB * Q * K * 3;                      // [EB][Q][9]
  T* xs = jis + EB * Q * 9;                          // [EB][K][3]
  T* ws = xs + EB * K * 3;                           // [EB][Q]
  T* mws = ws + EB * Q;                              // [EB][Q]
  __shared__ T dNs[Q][K][3];
  __shared__ T wq[Q];

  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * EB;
  const int ne = static_cast<int>(M - m0 < EB ? M - m0 : EB);
  const T lam = static_cast<T>(lam_d);
  const T mu = static_cast<T>(mu_d);

  // 0. coordinates and the reference table
  const int* cn = conn + m0 * K;
  for (int p = t; p < ne * K; p += kStiffThreads) {
    const int64_t node = cn[p];
    xs[p * 3] = xyz[node * 3];
    xs[p * 3 + 1] = xyz[node * 3 + 1];
    xs[p * 3 + 2] = xyz[node * 3 + 2];
  }
  for (int p = t; p < Q * K * 3; p += kStiffThreads)
    (&dNs[0][0][0])[p] = static_cast<T>((&ref.dN[0][0][0])[p]);
  for (int p = t; p < Q; p += kStiffThreads) wq[p] = static_cast<T>(ref.w[p]);
  __syncthreads();

  // 1. one thread per (element, quadrature point): J^-1, W_q, mu W_q
  for (int p = t; p < ne * Q; p += kStiffThreads) {
    const int e = p / Q, qi = p - e * Q;
    const T* x = xs + e * K * 3;
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
          const T v = c * x[kk * 3 + b];
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
    T* ji = jis + p * 9;
    ji[0] = c00 * inv_det;
    ji[1] = c01 * inv_det;
    ji[2] = c02 * inv_det;
    ji[3] = c10 * inv_det;
    ji[4] = c11 * inv_det;
    ji[5] = c12 * inv_det;
    ji[6] = c20 * inv_det;
    ji[7] = c21 * inv_det;
    ji[8] = c22 * inv_det;
    const T Wq = wq[qi] * det;
    ws[p] = Wq;
    mws[p] = mu * Wq;
  }
  __syncthreads();

  // 2. one thread per (element, quadrature point, node): g[kk]
  for (int p = t; p < ne * Q * K; p += kStiffThreads) {
    const int eq = p / K, kk = p - eq * K;
    const int qi = eq % Q;
    const T* ji = jis + eq * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T s = T(0);
      bool any = false;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T c = dNs[qi][kk][a];
        if (c == T(0)) continue;
        const T v = c * ji[i * 3 + a];
        s = any ? s + v : v;
        any = true;
      }
      gs[p * 3 + i] = s;
    }
  }
  __syncthreads();

  // 3. one thread per (element, node pair kk <= ll): a 3x3 block of K
  // into the tile, and its transpose into the mirrored place
  for (int p = t; p < ne * P; p += kStiffThreads) {
    const int e = p / P;
    int kk = 0, ll = p - e * P;
    while (ll >= K - kk) {
      ll -= K - kk;
      ++kk;
    }
    ll += kk;
    T acc[3][3];
#pragma unroll
    for (int qi = 0; qi < Q; ++qi) {
      const T* gk = gs + ((e * Q + qi) * K + kk) * 3;
      const T* gl = gs + ((e * Q + qi) * K + ll) * 3;
      const T gk0 = gk[0], gk1 = gk[1], gk2 = gk[2];
      const T gl0 = gl[0], gl1 = gl[1], gl2 = gl[2];
      const T gkv[3] = {gk0, gk1, gk2};
      const T glv[3] = {gl0, gl1, gl2};
      const T Wq = ws[e * Q + qi];
      const T dot = (gk0 * gl0 + gk1 * gl1 + gk2 * gl2) * mws[e * Q + qi];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          T v = Wq * (lam * (gkv[c] * glv[f]) + mu * (gkv[f] * glv[c]));
          if (c == f) v = v + dot;
          acc[c][f] = qi == 0 ? v : acc[c][f] + v;
        }
      }
    }
    T* o = tile + e * D * D;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int f = 0; f < 3; ++f) o[(3 * kk + c) * D + 3 * ll + f] = acc[c][f];
    }
    if (ll != kk) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int f = 0; f < 3; ++f)
          o[(3 * ll + f) * D + 3 * kk + c] = acc[c][f];
      }
    }
  }
  __syncthreads();

  // 4. the block's tiles are K's run [m0 D^2, (m0 + ne) D^2): 16-byte
  // stores, evict-first.  Not unrolled: unrolled, this loop set the
  // kernel's register count (f32 with 256 threads: 64 instead of 40, 12%
  // slower).
  const int nvec = ne * D * D * static_cast<int>(sizeof(T)) / 16;
  const float4* src = reinterpret_cast<const float4*>(tile);
  float4* dst = reinterpret_cast<float4*>(out + m0 * D * D);
#pragma unroll 1
  for (int i = t; i < nvec; i += kStiffThreads) __stcs(dst + i, src[i]);
}

template <typename T, int K, int Q>
int launch(const void* xyz, const void* conn, int64_t M, const double* dN,
           const double* w, double lam, double mu, void* out,
           cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  RefTable<K, Q> ref;
  for (int i = 0; i < Q * K * 3; ++i) (&ref.dN[0][0][0])[i] = dN[i];
  for (int i = 0; i < Q; ++i) ref.w[i] = w[i];
  constexpr int EB = elems_per_block<T, K, Q>();
  constexpr int smem = EB * stiff_elem_bytes<T, K, Q>();
  if (M > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness_kernel<T, K, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>((M + EB - 1) / EB);
    stiffness_kernel<T, K, Q><<<grid, kStiffThreads, smem, stream>>>(
        static_cast<const T*>(xyz), static_cast<const int*>(conn), M, ref,
        lam, mu, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// f(Int<k>, Int<q>) for the instantiated (k, q); -1 for any other.
template <typename F>
int with_kq(int k, int q, F&& f) {
  if (k == 4 && q == 1) return f(Int<4>{}, Int<1>{});
  if (k == 10 && q == 4) return f(Int<10>{}, Int<4>{});
  if (k == 8 && q == 8) return f(Int<8>{}, Int<8>{});
  if (k == 6 && q == 6) return f(Int<6>{}, Int<6>{});
  return -1;
}

}  // namespace tpufem

// xyz [N, 3] node coordinates in the working type; conn [M, k] int32;
// dN [q, k, 3] and w [q] host doubles; out [M, 3k, 3k], 16-byte aligned.
extern "C" int tpufem_stiffness_fused(int is_f64, int k, int q,
                                      const void* xyz, const void* conn,
                                      int64_t M, const double* dN,
                                      const double* w, double lam, double mu,
                                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = tpufem::with_kq(k, q, [&](auto kc, auto qc) {
    constexpr int K = decltype(kc)::value, Q = decltype(qc)::value;
    return is_f64 ? tpufem::launch<double, K, Q>(xyz, conn, M, dN, w, lam, mu,
                                                 out, s)
                  : tpufem::launch<float, K, Q>(xyz, conn, M, dN, w, lam, mu,
                                                out, s);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

// The kernel's elements per block for (k, q) in the working type; -1 for a
// (k, q) without an instantiation.
extern "C" int tpufem_stiffness_elems_per_block(int is_f64, int k, int q) {
  return tpufem::with_kq(k, q, [&](auto kc, auto qc) {
    constexpr int K = decltype(kc)::value, Q = decltype(qc)::value;
    return is_f64 ? tpufem::elems_per_block<double, K, Q>()
                  : tpufem::elems_per_block<float, K, Q>();
  });
}
