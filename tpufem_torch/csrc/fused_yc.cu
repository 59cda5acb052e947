// fused_yc: the whole cluster stage of the packed operator in one pass.
//
// Replaces tpufem/ops/fused_kernels.py `fused_yc` (_fused_kernel, element
// math _pa_planes).  The Pallas kernel reads window rows Xw [B, Wn, 384]
// that XLA gathered into HBM first; this kernel reads rows of X by index
// (win_nodes), so no Xw is materialized.  Per cluster b:
//   1. hop 1: slot s takes X[win_nodes[b, wslot[b,s]], c*128 + jslot[b,s]]
//      (zero for an empty slot, wslot >= wk, or a padded row, == Nb);
//   2. hop 2: element e's node kk takes slot lconn[b, kk*E_c + e];
//   3. the isotropic partial-assembly action at each quadrature point:
//      H = J^-1 (dN^T u_e), sig = lam tr(H) I + mu (H + H^T),
//      f_e = dN (W J^-T sig), in the operation order of _pa_planes;
//   4. slot s sums its element lanes through the byte-packed incidence
//      cinc in the fixed order (compress_slot, packed_common.cuh).
//
// Bound on the H100: bytes.  Per cluster it reads the slot tables
// (wslot, jslot: 1 KB), lconn (Rp ints), the bucket's incidence words,
// the geometry (qJ*9 + q values per element) and 384 X values, and writes
// 384 Yc values; the element math is ~2k flops per c3d10 element, far
// below what the bytes take at 67 TFLOP/s f32.
//
// Design: a 128-thread block takes kClusters = 4 clusters, a
// compile-time count, and puts every load of the block in flight before
// it uses any:
//   a. cp.async copies the block's contiguous incidence words and lconn
//      rows into shared memory (16 B a copy), and the block's geometry is
//      asked into L2 (prefetch), while
//   b. hop 1 runs for all four clusters at once: each thread loads its
//      slot's wslot/jslot of every cluster, then the four window rows,
//      then cp.async's the twelve X values into the slot values uc
//      (a zero fill for an empty slot or a padded row).
// One wait and one barrier later, step 2-3 runs one thread per element
// (4 E_c elements a block, so E_c < 32 leaves threads idle and E_c > 32
// loops), with the element's 3k values and 3k force accumulators in
// registers; k and q are template parameters, so every dN weight is a
// constant-offset parameter read and zero weights are skipped as
// _pa_planes skips them.  The forces go to shared memory, whole 128-lane
// chunks per component with the lanes past k*E_c zero (what the plain
// version's chunks read there), and step 4 runs one thread per slot over
// the incidence words in shared memory.  Built with
// -fmad=false: the kernel rounds exactly like the plain PyTorch version.
// Launched once per cluster bucket.

#include "packed_common.cuh"

namespace tpufem {

template <typename T, int K, int Q>
struct PaParams {
  T dN[Q * K * 3];   // reference gradients [q, k, 3]
  T lam, mu;
};

constexpr int kClusters = 4;   // clusters per block

// A block's shared memory: incidence words [kClusters][Wp][128], lconn
// [kClusters][Rp], slot values uc [kClusters][3][128] and element forces
// fe [kClusters][3][n_chunks * 128]; each part a multiple of 16 bytes.
inline size_t smem_bytes(int Wp, int Rp, int n_chunks, size_t item) {
  return kClusters * (static_cast<size_t>(Wp) * kSlots * 4 +
                      static_cast<size_t>(Rp) * 4 +
                      (kRow + static_cast<size_t>(3) * n_chunks * kSlots) *
                          item);
}

// No minimum of blocks per SM in __launch_bounds__: on the H100 ptxas
// then gives f32 c3d10 152 registers (3 blocks per SM) and c3d8 119 (4)
// with no spills; a minimum of 1 gave 168 and 239 (c3d8: 2 blocks), and
// a minimum of 3 or 4 (caps of 168 or 128 registers) made it spill.
template <typename T, int K, int Q>
__global__ void __launch_bounds__(kSlots)
fused_yc_kernel(const T* __restrict__ X, int64_t Nb,
                const int* __restrict__ win_nodes, int Wn, int wk,
                const int* __restrict__ wslot, const int* __restrict__ jslot,
                const int* __restrict__ lconn, int Rp,
                const int* __restrict__ cinc, int Wp,
                const T* __restrict__ jinv, int qJ,
                const T* __restrict__ wgt, int E_c,
                const PaParams<T, K, Q> P, const VWidths vw,
                T* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RS = vw.n * kSlots;          // element lanes per component in fe
  int* cs = reinterpret_cast<int*>(smem_raw);          // incidence words
  int* ls = cs + kClusters * Wp * kSlots;              // lconn rows
  T* uc = reinterpret_cast<T*>(ls + kClusters * Rp);   // slot values
  T* fe = uc + kClusters * kRow;                       // element forces
  const int t = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kClusters;
  const int nc = static_cast<int>(
      n - b0 < kClusters ? n - b0 : static_cast<int64_t>(kClusters));

  // 1a. the block's contiguous tables: into shared memory, geometry to L2
  stage_words<kSlots>(cs, cinc + b0 * Wp * kSlots,
                      static_cast<int64_t>(nc) * Wp * kSlots, t);
  stage_words<kSlots>(ls, lconn + b0 * Rp, static_cast<int64_t>(nc) * Rp, t);
  prefetch_l2(jinv + b0 * qJ * 9 * E_c,
              static_cast<int64_t>(nc) * qJ * 9 * E_c * sizeof(T), t, kSlots);
  prefetch_l2(wgt + b0 * Q * E_c,
              static_cast<int64_t>(nc) * Q * E_c * sizeof(T), t, kSlots);

  // 1b. hop 1, the four clusters' loads issued together: slot t's table
  // entries, then its window rows, then its X values (cp.async into uc)
  int ws[kClusters], js[kClusters];
#pragma unroll
  for (int i = 0; i < kClusters; ++i) {
    ws[i] = wk;
    js[i] = 0;
    if (i < nc) {
      ws[i] = wslot[(b0 + i) * kSlots + t];
      js[i] = jslot[(b0 + i) * kSlots + t];
    }
  }
#pragma unroll
  for (int i = 0; i < kClusters; ++i) {
    int64_t row = Nb;
    if (ws[i] < wk) row = win_nodes[(b0 + i) * Wn + ws[i]];
    const bool hit = row < Nb;
    const T* src = X + (hit ? row * kRow + js[i] : 0);
    T* dst = uc + i * kRow + t;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cp_async<sizeof(T)>(dst + c * kSlots, src + c * kSlots, hit);
  }
  cp_async_commit();

  // the lanes past the elements read zero, as in the plain version
  const int KE = K * E_c;
  const int tail = RS - KE;
  for (int p = t; p < kClusters * 3 * tail; p += kSlots) {
    const int rowi = p / tail;
    fe[rowi * RS + KE + (p - rowi * tail)] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2-3. one thread per element: gather its nodes, apply the action
  for (int el = t; el < nc * E_c; el += kSlots) {
    const int cl = el / E_c;
    const int e = el - cl * E_c;
    const int64_t b = b0 + cl;
    const T* u = uc + cl * kRow;
    const int* lc = ls + cl * Rp + e;
    T ue[3][K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      T v[3];
      hop2_lane<T>(u, lc[kk * E_c], v);
      ue[0][kk] = v[0];
      ue[1][kk] = v[1];
      ue[2][kk] = v[2];
    }
    T F[3][K];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int kk = 0; kk < K; ++kk) F[c][kk] = T(0);
    const T* jb = jinv + b * (qJ * 9) * E_c + e;
    const T* wb = wgt + b * Q * E_c + e;
#pragma unroll
    for (int qi = 0; qi < Q; ++qi) {
      const int qj = qi < qJ ? qi : qJ - 1;
      T J[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) J[i][j] = jb[(qj * 9 + 3 * i + j) * E_c];
      // Hhat[a][c] = sum_kk dN[qi, kk, a] * ue[c][kk]  (zero weights skipped)
      T Hh[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T acc = T(0);
#pragma unroll
          for (int kk = 0; kk < K; ++kk) {
            const T w = P.dN[(qi * K + kk) * 3 + a];
            if (w != T(0)) acc = acc + w * ue[c][kk];
          }
          Hh[a][c] = acc;
        }
      // H[i][c] = sum_j J[i][j] * Hhat[j][c]
      T H[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T h = J[i][0] * Hh[0][c];
          h = h + J[i][1] * Hh[1][c];
          h = h + J[i][2] * Hh[2][c];
          H[i][c] = h;
        }
      const T tr = (H[0][0] + H[1][1]) + H[2][2];
      T sig[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) sig[i][c] = P.mu * (H[i][c] + H[c][i]);
#pragma unroll
      for (int i = 0; i < 3; ++i) sig[i][i] = sig[i][i] + P.lam * tr;
      // T[j][c] = W * sum_i J[i][j] * sig[i][c]
      const T Wq = wb[qi * E_c];
      T Tm[3][3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T s = J[0][j] * sig[0][c];
          s = s + J[1][j] * sig[1][c];
          s = s + J[2][j] * sig[2][c];
          Tm[j][c] = Wq * s;
        }
      // Fe[c][kk] += sum_j dN[qi, kk, j] * T[j][c]
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const T w = P.dN[(qi * K + kk) * 3 + j];
            if (w != T(0)) acc = acc + w * Tm[j][c];
          }
          F[c][kk] = F[c][kk] + acc;
        }
    }
    T* fo = fe + cl * 3 * RS + e;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int kk = 0; kk < K; ++kk) fo[c * RS + kk * E_c] = F[c][kk];
  }
  __syncthreads();

  // 4. per-slot incidence sums from the words in shared memory
#pragma unroll
  for (int cl = 0; cl < kClusters; ++cl) {
    if (cl >= nc) break;
    T acc[3] = {T(0), T(0), T(0)};
    compress_slot<T>(cs + cl * Wp * kSlots, t,
                     LaneMajor<T>{fe + cl * 3 * RS, RS}, vw, acc);
    T* o = out + (b0 + cl) * kRow + t;
    o[0] = acc[0];
    o[kSlots] = acc[1];
    o[2 * kSlots] = acc[2];
  }
}

struct Args {
  const void* X;
  int64_t Nb;
  const void* win_nodes;
  int Wn, wk;
  const void* wslot;
  const void* jslot;
  const void* lconn;
  int Rp;
  const void* cinc;
  int Wp;
  const void* jinv;
  int qJ;
  const void* w;
  int E_c;
  void* out;
  int64_t n;
};

template <typename T, int K, int Q>
int launch(const Args& a, const double* dN, double lam, double mu,
           const VWidths& vw, cudaStream_t stream) {
  PaParams<T, K, Q> P;
  for (int i = 0; i < Q * K * 3; ++i) P.dN[i] = static_cast<T>(dN[i]);
  P.lam = static_cast<T>(lam);
  P.mu = static_cast<T>(mu);
  const size_t smem = smem_bytes(a.Wp, a.Rp, vw.n, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fused_yc_kernel<T, K, Q>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.n > 0) {
    const unsigned grid =
        static_cast<unsigned>((a.n + kClusters - 1) / kClusters);
    kern<<<grid, kSlots, smem, stream>>>(
        static_cast<const T*>(a.X), a.Nb, static_cast<const int*>(a.win_nodes),
        a.Wn, a.wk, static_cast<const int*>(a.wslot),
        static_cast<const int*>(a.jslot), static_cast<const int*>(a.lconn),
        a.Rp, static_cast<const int*>(a.cinc), a.Wp,
        static_cast<const T*>(a.jinv), a.qJ, static_cast<const T*>(a.w),
        a.E_c, P, vw, static_cast<T*>(a.out), a.n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, int Q>
int occupancy(int Wp, int Rp, int n_chunks) {
  const size_t smem = smem_bytes(Wp, Rp, n_chunks, sizeof(T));
  auto kern = fused_yc_kernel<T, K, Q>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, kSlots, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Built for the default rules of c3d10 (k = 10, q = 4), c3d4 (4, 1) and
// c3d8 (8, 8); ops/fused_kernels.py KERNEL_KQ lists the same pairs.
template <typename T>
int dispatch(int k, int q, const Args& a, const double* dN, double lam,
             double mu, const VWidths& vw, cudaStream_t s) {
  if (k == 10 && q == 4) return launch<T, 10, 4>(a, dN, lam, mu, vw, s);
  if (k == 4 && q == 1) return launch<T, 4, 1>(a, dN, lam, mu, vw, s);
  if (k == 8 && q == 8) return launch<T, 8, 8>(a, dN, lam, mu, vw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_occupancy(int k, int q, int Wp, int Rp, int n_chunks) {
  if (k == 10 && q == 4) return occupancy<T, 10, 4>(Wp, Rp, n_chunks);
  if (k == 4 && q == 1) return occupancy<T, 4, 1>(Wp, Rp, n_chunks);
  if (k == 8 && q == 8) return occupancy<T, 8, 8>(Wp, Rp, n_chunks);
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tpufem

// X [Nb, 384]; win_nodes [n, Wn]; wslot, jslot [n, 128]; lconn [n, Rp];
// cinc [n, Wp, 128]; jinv [n, qJ*9, E_c]; w [n, q, E_c]; out [n, 384].
// dN [q, k, 3] and widths[n_widths] are host arrays.
extern "C" int tpufem_fused_yc(int is_f64, int k, int q, const void* X,
                               int64_t Nb, const void* win_nodes, int Wn,
                               int wk, const void* wslot, const void* jslot,
                               const void* lconn, int Rp, const void* cinc,
                               int Wp, const void* jinv, int qJ,
                               const void* w, int E_c, const double* dN,
                               double lam, double mu, const int* widths,
                               int n_widths, void* out, int64_t n,
                               void* stream) {
  if (n_widths > tpufem::kMaxChunks || E_c <= 0 || tpufem::kSlots % E_c)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::VWidths vw{};
  vw.n = n_widths;
  for (int g = 0; g < n_widths; ++g) vw.w[g] = widths[g];
  tpufem::Args a{X, Nb, win_nodes, Wn, wk, wslot, jslot, lconn, Rp, cinc,
                 Wp, jinv, qJ, w, E_c, out, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::dispatch<double>(k, q, a, dN, lam, mu, vw, s)
                : tpufem::dispatch<float>(k, q, a, dN, lam, mu, vw, s);
}

// Blocks of the (k, q) instantiation that one SM holds at once for a
// bucket's table widths (the occupancy the register budget and the shared
// memory allow), or minus a CUDA error code.
extern "C" int tpufem_fused_yc_occupancy(int is_f64, int k, int q, int Wp,
                                         int Rp, int n_chunks) {
  return is_f64 ? tpufem::dispatch_occupancy<double>(k, q, Wp, Rp, n_chunks)
                : tpufem::dispatch_occupancy<float>(k, q, Wp, Rp, n_chunks);
}
