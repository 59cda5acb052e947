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
// Bytes and operations: per cluster it reads the slot tables (wslot,
// jslot: 1 KB), lconn (Rp ints), the bucket's incidence words, the
// geometry (qJ*9 + q values per element) and 384 X values, and writes 384
// Yc values; the element math is ~2k operations per c3d10 element.  The
// kernel takes several times either bound: it waits on the latency of its
// loads and of its dependent arithmetic, which only warps in flight hide.
// When one thread held a whole c3d10 element (its 30 displacements, 30
// force accumulators and the per-point tensors), f32 took 152 registers
// (3 blocks of 4 warps an SM) and f64 255 with spills (2 blocks); forced
// to fewer blocks it ran 1.30x slower at 2 and 2.17x at 1 (f32), 1.61x at
// 1 (f64): occupancy-bound.
//
// Design: a 128-thread block takes kClusters = 2 clusters (compile-time)
// and splits the element action over its threads in stages separated by
// barriers, each stage's intermediates in shared memory:
//   1. (thread = slot) cp.async copies the block's contiguous incidence
//      words and lconn rows into shared memory, the block's geometry is
//      asked into L2, and hop 1 cp.async's each slot's three X values of
//      both clusters into the slot values uc;
//   a. (thread = element lane) hop 2: ue[cl][c][kk*E_c + e], in the
//      lanes that stage c later writes the forces into;
//   b. (thread = element and one or two quadrature points, Tuning) Hhat
//      over the nodes in node order, H, tr, sig and T = W J^-T sig: each
//      point's nine T values go to shared memory (over uc and lconn, dead
//      by then);
//   c. (thread = element and half of its nodes) F[c][kk] = sum over the
//      points in order of sum_j dN[qi, kk, j] T_qi[j][c], from zero, as
//      the one-thread loop summed; written over ue, lanes past k*E_c zero
//      (what the plain version's chunks read there);
//   4. (thread = slot) the incidence sums over the words in shared memory.
// k and q are template parameters: every dN weight is a constant-offset
// parameter read, zero weights are skipped as _pa_planes skips them, and
// the points (stage b) and the node half (stage c) select compile-time
// bodies through warp-uniform branches (E_c = 32: a warp is one point
// group, or one node half, of 32 elements).  No thread holds more than
// ten nodal values of one component, the Hhat of two points, nine J and
// nine of sig or T at once.
//
// On the H100 (ptxas of CUDA 12.9, -fmad=false), c3d10: f32 70 registers,
// f64 79, no spills; at box_tet10(55)'s tables (Wp 7, Rp 384, E_c 32) a
// block holds 25,600 B of shared memory in f32 and 44,032 B in f64.  An
// SM then holds 7 blocks, 28 warps, in f32 (bound by the registers; the
// shared memory allows 8) and 5 blocks, 20 warps, in f64 (bound by the
// shared memory; the registers allow 6).  What bounds it now: of the f32
// sweep's 0.48 ms, hop 1 and the tables alone take 0.18, hop 2 and the
// incidence sums bring it to 0.28, the element action the rest (f64:
// 0.26, 0.40 of 0.78; ablations in PERF.md §6).  Built with -fmad=false:
// the kernel rounds exactly like the plain PyTorch version.  Launched once
// per cluster bucket.

#include "packed_common.cuh"

namespace tpufem {

template <typename T, int K, int Q>
struct PaParams {
  T dN[Q * K * 3];   // reference gradients [q, k, 3]
  T lam, mu;
};

constexpr int kClusters = 2;     // clusters per block
constexpr int kNodeParts = 2;    // stage c: an element's nodes in halves

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// A block's shared memory: incidence words [kClusters][Wp][128]; then
// either lconn [kClusters][Rp] and the slot values uc [kClusters][3][128]
// (step 1 to stage a) or the points' T [q][9][kClusters * E_c] (stage b
// to c); then the element lanes, ue and later the forces fe
// [kClusters][3][n_chunks * 128].  Offsets in bytes, each a multiple of 16.
struct Layout {
  size_t uc, fe, total;
  __host__ __device__ Layout(int Wp, int Rp, int n_chunks, int E_c, int q,
                             size_t item) {
    const size_t cs = static_cast<size_t>(kClusters) * Wp * kSlots * 4;
    const size_t ls = round16(static_cast<size_t>(kClusters) * Rp * 4);
    const size_t slots = ls + static_cast<size_t>(kClusters) * kRow * item;
    const size_t tm = static_cast<size_t>(q) * 9 * kClusters * E_c * item;
    uc = cs + ls;
    fe = cs + round16(slots > tm ? slots : tm);
    total = fe + static_cast<size_t>(kClusters) * 3 * n_chunks * kSlots *
                     item;
  }
};

template <int I>
struct Const {
  static constexpr int value = I;
};

// f(Const<i>()) for the run-time i in [I, N): a compile-time body per i.
template <int I, int N, typename F>
__device__ __forceinline__ void with_const(int i, const F& f) {
  if constexpr (I < N) {
    if (i == I)
      f(Const<I>());
    else
      with_const<I + 1, N>(i, f);
  }
}

// Compile-time choices of an instantiation, measured on the H100 at
// box_tet10(55) (PERF.md §6):
//   kPoints: the quadrature points a stage-b thread takes.  Two share
//   one read of the element's nodal values and overlap their chains:
//   f32 c3d10 0.519 -> 0.481 ms a sweep.  f64 c3d10 takes one: two were
//   slower (0.774 against 0.754 ms) at the 4 blocks their 118 registers
//   allow, and spilled under a cap of 5 blocks; f64 c3d8 takes two: with
//   one, ptxas spilled.
//   kMinBlocks: the minimum of blocks an SM in __launch_bounds__ (0:
//   none).  f32 7 caps the registers at 72: 0.459 ms, against 0.480 at 8
//   blocks (64 registers) and a spill without a minimum; any f64 minimum
//   (3, 4, 5) made ptxas spill or fall to 3 blocks, none gives 79
//   registers and no spill, and shared memory holds f64 to 5 blocks.
template <typename T, int K, int Q>
struct Tuning {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kPoints = Q % 2 ? 1 : (kF32 || K == 8 ? 2 : 1);
  static constexpr int kMinBlocks = kF32 ? 7 : 0;
};

// Stage b for quadrature points Q0 .. Q0 + NQ - 1 of one element: u reads
// the element's lanes (u[c * RS + kk * E_c]), jb and wb its geometry, to
// its T values (to[(qi * 9 + m) * ts], m = 3 j + c).
template <typename T, int K, int Q, int Q0, int NQ>
__device__ __forceinline__ void point_action(
    const PaParams<T, K, Q>& P, const T* u, int RS, int E_c,
    const T* __restrict__ jb, int qJ, const T* __restrict__ wb, T* to,
    int ts) {
  // Hhat[a][c] = sum_kk dN[qi, kk, a] * ue[c][kk]  (zero weights skipped)
  T Hh[NQ][3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T uk[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) uk[kk] = u[c * RS + kk * E_c];
#pragma unroll
    for (int iq = 0; iq < NQ; ++iq)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T acc = T(0);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const T w = P.dN[((Q0 + iq) * K + kk) * 3 + a];
          if (w != T(0)) acc = acc + w * uk[kk];
        }
        Hh[iq][a][c] = acc;
      }
  }
#pragma unroll
  for (int iq = 0; iq < NQ; ++iq) {
    const int qi = Q0 + iq;
    const int qj = qi < qJ ? qi : qJ - 1;
    T J[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) J[i][j] = jb[(qj * 9 + 3 * i + j) * E_c];
    // H[i][c] = sum_j J[i][j] * Hhat[j][c]
    T H[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T h = J[i][0] * Hh[iq][0][c];
        h = h + J[i][1] * Hh[iq][1][c];
        h = h + J[i][2] * Hh[iq][2][c];
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
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T s = J[0][j] * sig[0][c];
        s = s + J[1][j] * sig[1][c];
        s = s + J[2][j] * sig[2][c];
        to[(qi * 9 + 3 * j + c) * ts] = Wq * s;
      }
  }
}

// Stage c for node part NP of one element: ti reads its points' T values
// (ti[(qi * 9 + m) * ts]), fo writes its force lanes (fo[c * RS + kk *
// E_c]).
//   Fe[c][kk] += sum_j dN[qi, kk, j] * T_qi[j][c], qi in order
template <typename T, int K, int Q, int NP>
__device__ __forceinline__ void node_forces(const PaParams<T, K, Q>& P,
                                            const T* ti, int ts, T* fo,
                                            int RS, int E_c) {
  constexpr int kPer = (K + kNodeParts - 1) / kNodeParts;
  constexpr int k0 = NP * kPer;
  constexpr int nk = K - k0 < kPer ? K - k0 : kPer;
  T F[3][nk];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < nk; ++i) F[c][i] = T(0);
#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
    T Tm[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) Tm[m] = ti[(qi * 9 + m) * ts];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < nk; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T w = P.dN[(qi * K + k0 + i) * 3 + j];
          if (w != T(0)) acc = acc + w * Tm[3 * j + c];
        }
        F[c][i] = F[c][i] + acc;
      }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < nk; ++i) fo[c * RS + (k0 + i) * E_c] = F[c][i];
}

template <typename T, int K, int Q>
__global__ void __launch_bounds__(kSlots, (Tuning<T, K, Q>::kMinBlocks))
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
  const Layout lay(Wp, Rp, vw.n, E_c, Q, sizeof(T));
  const int RS = vw.n * kSlots;          // element lanes per component
  int* cs = reinterpret_cast<int*>(smem_raw);          // incidence words
  int* ls = cs + kClusters * Wp * kSlots;              // lconn rows
  T* uc = reinterpret_cast<T*>(smem_raw + lay.uc);     // slot values
  T* tm = reinterpret_cast<T*>(ls);                    // the points' T
  T* fe = reinterpret_cast<T*>(smem_raw + lay.fe);     // ue, then forces
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

  // 1b. hop 1, the clusters' loads issued together: slot t's table
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

  // a. hop 2, one thread an element lane: ue[cl][c][r] = uc[cl][c][slot]
#pragma unroll 1
  for (int p = t; p < nc * KE; p += kSlots) {
    const int cl = p / KE;
    const int r = p - cl * KE;
    T v[3];
    hop2_lane<T>(uc + cl * kRow, ls[cl * Rp + r], v);
    T* u = fe + cl * 3 * RS + r;
    u[0] = v[0];
    u[RS] = v[1];
    u[2 * RS] = v[2];
  }
  __syncthreads();

  // b. one thread an (element, pair of quadrature points): their T
  constexpr int NQ = Tuning<T, K, Q>::kPoints;
  const int ne = nc * E_c;               // elements of the block
  const int ts = kClusters * E_c;        // stride of tm's rows
#pragma unroll 1
  for (int p = t; p < (Q / NQ) * ne; p += kSlots) {
    const int g = p / ne;
    const int el = p - g * ne;
    const int cl = el / E_c;
    const int e = el - cl * E_c;
    const int64_t b = b0 + cl;
    const T* u = fe + cl * 3 * RS + e;
    const T* jb = jinv + b * (qJ * 9) * E_c + e;
    const T* wb = wgt + b * Q * E_c + e;
    with_const<0, Q / NQ>(g, [&](auto gc) {
      point_action<T, K, Q, decltype(gc)::value * NQ, NQ>(
          P, u, RS, E_c, jb, qJ, wb, tm + el, ts);
    });
  }
  __syncthreads();

  // c. one thread an (element, node part): its forces, over ue
#pragma unroll 1
  for (int p = t; p < kNodeParts * ne; p += kSlots) {
    const int np = p / ne;
    const int el = p - np * ne;
    const int cl = el / E_c;
    const int e = el - cl * E_c;
    T* fo = fe + cl * 3 * RS + e;
    with_const<0, kNodeParts>(np, [&](auto pc) {
      node_forces<T, K, Q, decltype(pc)::value>(P, tm + el, ts, fo, RS, E_c);
    });
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
  const size_t smem = Layout(a.Wp, a.Rp, vw.n, a.E_c, Q, sizeof(T)).total;
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
int occupancy(int Wp, int Rp, int n_chunks, int E_c) {
  const size_t smem = Layout(Wp, Rp, n_chunks, E_c, Q, sizeof(T)).total;
  if (smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
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
int dispatch_occupancy(int k, int q, int Wp, int Rp, int n_chunks,
                       int E_c) {
  if (k == 10 && q == 4) return occupancy<T, 10, 4>(Wp, Rp, n_chunks, E_c);
  if (k == 4 && q == 1) return occupancy<T, 4, 1>(Wp, Rp, n_chunks, E_c);
  if (k == 8 && q == 8) return occupancy<T, 8, 8>(Wp, Rp, n_chunks, E_c);
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
// bucket's table widths and elements per cluster (the occupancy the
// register budget and the shared memory allow), or minus a CUDA error code.
extern "C" int tpufem_fused_yc_occupancy(int is_f64, int k, int q, int Wp,
                                         int Rp, int n_chunks, int E_c) {
  if (E_c <= 0 || tpufem::kSlots % E_c)
    return -static_cast<int>(cudaErrorInvalidValue);
  return is_f64
             ? tpufem::dispatch_occupancy<double>(k, q, Wp, Rp, n_chunks, E_c)
             : tpufem::dispatch_occupancy<float>(k, q, Wp, Rp, n_chunks, E_c);
}
