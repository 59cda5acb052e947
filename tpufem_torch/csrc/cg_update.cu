// cg_update: the vector update of one PCG iteration, in three kernels.
//
// Replaces no TPU kernel: tpufem runs the iteration as the body of one
// lax.while_loop (tpufem/solvers/cg.py:165), whose vector work XLA fuses.
// In solvers/cg.py's CGBlock.body that work was about 48 full passes over
// the state and about 80 launches an iteration (torch's elementwise and
// reduce kernels, and one-element kernels for the status).  These three
// kernels, each launched once an iteration inside the captured block graph
// (solvers/cg_fused.py), do all of it but A(p):
//
//   cg_pap       pAp = p.Ap; alpha = rz / (pAp + eps), bad_curv,
//                bad_alpha, keep
//   cg_update_r  u <- (u + alpha p) m_state, r <- (r - alpha Ap) m_res,
//                rz1 = r.(M^-1 r), rr = r.r (z is never stored); beta, the
//                status, rz, hlast, hblock[j], i
//   cg_update_p  p <- (M^-1 r + beta p) m_res
//
// Bound on the H100: bytes.  The least an iteration's update can move is 9
// passes over the state (read u, r, p, Ap, M^-1 and the mask once, write
// u, r and p once).  These kernels make 15: cg_pap reads 2, cg_update_r
// reads 6 and writes 2, cg_update_p reads 4 and writes 1 (16 where the
// state's and the residual's masks are two tensors).
//
// Design.  A grid fixed by n and the constants below (a block takes a tile
// of kThreads x kItems 16-byte vectors), never by the occupancy the card
// reports.  Each thread issues all its loads before it computes.  Products
// and sums are taken in the working dtype with no contraction (built with
// -fmad=false), so u, r and p are bitwise the body's separate multiply and
// add, given the same scalars.  A dot is summed in a fixed order with no
// floating-point atomics, so two solves of one case are bitwise equal:
// each thread keeps one sum per vector lane over its kItems vectors (from
// 0, in item order), adds its lanes by halving, the block adds its threads
// by halving (shared memory, then shuffles) and writes its partial; the
// last block to finish (an integer ticket, which that block resets for the
// next launch) sums the partials, thread t those at t, t + kThreads, ...
// in order, then the threads by halving, and computes the iteration's
// scalars with the body's operations in the body's order.  Past n a thread
// reads zeros.  solvers/cg_fused.py's plain versions follow the same
// order.  The status is read on the device: once it is not RUNNING,
// cg_pap and cg_update_r leave the vectors alone and cg_update_p returns;
// a step that is dropped (NOT_SPD or NAN_INF) leaves them too.

#include <math_constants.h>

#include "common.cuh"

namespace tpufem {
namespace cgu {

constexpr int kThreads = 256;  // threads a block
constexpr int kItems = 2;      // 16-byte vectors a thread

// status codes (solvers/cg.py)
constexpr int kRunning = 0;
constexpr int kConverged = 1;
constexpr int kNotSpd = 3;
constexpr int kNanInf = 4;

// ctl [8] int32: the iteration's flags, written by cg_pap, and the tickets
constexpr int kCtlRunning = 0;
constexpr int kCtlKeep = 1;
constexpr int kCtlBadCurv = 2;
constexpr int kCtlBadAlpha = 3;
constexpr int kCtlTicketPap = 4;
constexpr int kCtlTicketR = 5;
// scal [4] of the working dtype
constexpr int kScalAlpha = 0;
constexpr int kScalBeta = 1;
constexpr int kScalPap = 2;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // the lanes' sums added by halving
  static __device__ __forceinline__ float lanes(const float* a) {
    return (a[0] + a[2]) + (a[1] + a[3]);
  }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};

template <>
struct Vec<double> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void load(const double* p, double* v) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
  static __device__ __forceinline__ double lanes(const double* a) {
    return a[0] + a[1];
  }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
};

template <typename T>
__host__ __device__ constexpr int64_t tile() {
  return static_cast<int64_t>(kThreads) * kItems * Vec<T>::N;
}

// the first index of this thread's k-th vector in the block's tile
template <typename T>
__device__ __forceinline__ int64_t vec_index(int k) {
  return blockIdx.x * tile<T>() +
         (static_cast<int64_t>(k) * kThreads + threadIdx.x) * Vec<T>::N;
}

template <typename T>
__device__ __forceinline__ void load_or_zero(const T* x, int64_t i,
                                             int64_t n, T* v) {
  if (i < n) {
    Vec<T>::load(x + i, v);
  } else {
#pragma unroll
    for (int c = 0; c < Vec<T>::N; ++c) v[c] = T(0);
  }
}

// The block's sum of v, valid in thread 0: s[t] += s[t + h] for h =
// kThreads / 2, ..., 32 in shared memory, then h = 16, ..., 1 by shuffles.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s) {
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) s[t] += s[t + h];
    __syncthreads();
  }
  if (t < 32) {
    v = s[t];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, h);
    }
  }
  __syncthreads();  // s may be written again
  return v;
}

// Thread 0 holds the block's S sums: write them as partials part[s * G +
// block], then take a ticket.  True in every thread of the last block to
// finish, which then reads the partials.
template <int S, typename T>
__device__ __forceinline__ bool arrive(const T (&v)[S], T* part,
                                       int* ticket) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) part[s * gridDim.x + blockIdx.x] = v[s];
    __threadfence();
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  return last;
}

// The sum of the G partials, valid in thread 0 (the last block only: the
// other blocks' partials are read from L2)
template <typename T>
__device__ __forceinline__ T partials_sum(const T* part, int G, T* s) {
  T acc = T(0);
  for (int m = 0; m * kThreads < G; ++m) {
    const int i = m * kThreads + threadIdx.x;
    acc += i < G ? __ldcg(part + i) : T(0);
  }
  return block_sum(acc, s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_pap_kernel(const T* __restrict__ p, const T* __restrict__ Ap, int64_t n,
              T* __restrict__ part, int* __restrict__ ctl,
              const int* __restrict__ status, const T* __restrict__ rz,
              T* __restrict__ scal, T eps) {
  constexpr int N = Vec<T>::N;
  __shared__ T s[kThreads];
  if (*status != kRunning) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[kCtlRunning] = 0;
      ctl[kCtlKeep] = 0;
    }
    return;
  }
  T pv[kItems][N], av[kItems][N];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = vec_index<T>(k);
    load_or_zero(p, i, n, pv[k]);
    load_or_zero(Ap, i, n, av[k]);
  }
  T a[N];
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int c = 0; c < N; ++c) a[c] += pv[k][c] * av[k][c];
  }
  const T v[1] = {block_sum(Vec<T>::lanes(a), s)};
  if (!arrive<1>(v, part, ctl + kCtlTicketPap)) return;
  const T pAp = partials_sum(part, gridDim.x, s);
  if (threadIdx.x == 0) {
    const bool bad_curv = fabs(pAp) < eps || pAp < T(0);
    const T alpha = *rz / (pAp + eps);
    const bool bad_alpha = isnan(alpha) || isinf(alpha);
    scal[kScalPap] = pAp;
    scal[kScalAlpha] = alpha;
    ctl[kCtlRunning] = 1;
    ctl[kCtlBadCurv] = bad_curv;
    ctl[kCtlBadAlpha] = bad_alpha;
    ctl[kCtlKeep] = !bad_curv && !bad_alpha;
    ctl[kCtlTicketPap] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_r_kernel(T* __restrict__ u, T* __restrict__ r,
                   const T* __restrict__ p, const T* __restrict__ Ap,
                   const T* __restrict__ minv, const T* __restrict__ ms,
                   const T* __restrict__ mr, int64_t n, T* __restrict__ part,
                   int* __restrict__ ctl, int* __restrict__ status,
                   T* __restrict__ rz, T* __restrict__ hlast,
                   T* __restrict__ hblock, int j, int* __restrict__ iters,
                   T* __restrict__ scal, T eps, T tol, int record) {
  constexpr int N = Vec<T>::N;
  __shared__ T s[kThreads];
  const bool running = ctl[kCtlRunning] != 0;
  if (!ctl[kCtlKeep]) {
    // the state stays; a running solve ends NOT_SPD or NAN_INF
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (running) {
        *status = ctl[kCtlBadCurv] ? kNotSpd : kNanInf;
        *iters += 1;
      } else if (record) {
        *hlast = Vec<T>::inf();
      }
      if (record) hblock[j] = *hlast;
    }
    return;
  }
  const T alpha = scal[kScalAlpha];
  const bool one_mask = ms == mr;
  T uv[kItems][N], rv[kItems][N], pv[kItems][N], av[kItems][N];
  T mv[kItems][N], sv[kItems][N], qv[kItems][N];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = vec_index<T>(k);
    load_or_zero(u, i, n, uv[k]);
    load_or_zero(r, i, n, rv[k]);
    load_or_zero(p, i, n, pv[k]);
    load_or_zero(Ap, i, n, av[k]);
    load_or_zero(minv, i, n, mv[k]);
    load_or_zero(ms, i, n, sv[k]);
    if (!one_mask) load_or_zero(mr, i, n, qv[k]);
  }
  T a_rz[N], a_rr[N];
#pragma unroll
  for (int c = 0; c < N; ++c) a_rz[c] = a_rr[c] = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T m_res = one_mask ? sv[k][c] : qv[k][c];
      const T u1 = (uv[k][c] + alpha * pv[k][c]) * sv[k][c];
      const T r1 = (rv[k][c] - alpha * av[k][c]) * m_res;
      const T z = r1 * mv[k][c];
      a_rz[c] += r1 * z;
      a_rr[c] += r1 * r1;
      uv[k][c] = u1;
      rv[k][c] = r1;
    }
    const int64_t i = vec_index<T>(k);
    if (i < n) {
      Vec<T>::store(u + i, uv[k]);
      Vec<T>::store(r + i, rv[k]);
    }
  }
  const T v[2] = {block_sum(Vec<T>::lanes(a_rz), s),
                  block_sum(Vec<T>::lanes(a_rr), s)};
  if (!arrive<2>(v, part, ctl + kCtlTicketR)) return;
  const int G = gridDim.x;
  const T rz1 = partials_sum(part, G, s);
  const T rr = partials_sum(part + G, G, s);
  if (threadIdx.x == 0) {
    const T rnorm = sqrt(rr);
    const T beta = rz1 / (*rz + eps);
    const bool bad_beta = isnan(beta) || isinf(beta);
    scal[kScalBeta] = beta;
    *status = bad_beta ? kNanInf : (rnorm < tol ? kConverged : kRunning);
    *rz = rz1;
    if (record) {
      *hlast = rnorm;
      hblock[j] = rnorm;
    }
    *iters += 1;
    ctl[kCtlTicketR] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_p_kernel(const T* __restrict__ r, T* __restrict__ p,
                   const T* __restrict__ minv, const T* __restrict__ mr,
                   int64_t n, const int* __restrict__ ctl,
                   const T* __restrict__ scal) {
  constexpr int N = Vec<T>::N;
  if (!ctl[kCtlKeep]) return;
  const T beta = scal[kScalBeta];
  T rv[kItems][N], pv[kItems][N], mv[kItems][N], qv[kItems][N];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = vec_index<T>(k);
    load_or_zero(r, i, n, rv[k]);
    load_or_zero(p, i, n, pv[k]);
    load_or_zero(minv, i, n, mv[k]);
    load_or_zero(mr, i, n, qv[k]);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T z = rv[k][c] * mv[k][c];
      pv[k][c] = (z + beta * pv[k][c]) * qv[k][c];
    }
    const int64_t i = vec_index<T>(k);
    if (i < n) Vec<T>::store(p + i, pv[k]);
  }
}

template <typename T>
unsigned grid(int64_t n) {
  return static_cast<unsigned>((n + tile<T>() - 1) / tile<T>());
}

template <typename T>
int launch_pap(const void* p, const void* Ap, int64_t n, void* part,
               void* ctl, const void* status, const void* rz, void* scal,
               double eps, cudaStream_t stream) {
  cg_pap_kernel<T><<<grid<T>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(Ap), n,
      static_cast<T*>(part), static_cast<int*>(ctl),
      static_cast<const int*>(status), static_cast<const T*>(rz),
      static_cast<T*>(scal), static_cast<T>(eps));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update_r(void* u, void* r, const void* p, const void* Ap,
                    const void* minv, const void* ms, const void* mr,
                    int64_t n, void* part, void* ctl, void* status, void* rz,
                    void* hlast, void* hblock, int j, void* iters, void* scal,
                    double eps, double tol, int record, cudaStream_t stream) {
  cg_update_r_kernel<T><<<grid<T>(n), kThreads, 0, stream>>>(
      static_cast<T*>(u), static_cast<T*>(r), static_cast<const T*>(p),
      static_cast<const T*>(Ap), static_cast<const T*>(minv),
      static_cast<const T*>(ms), static_cast<const T*>(mr), n,
      static_cast<T*>(part), static_cast<int*>(ctl),
      static_cast<int*>(status), static_cast<T*>(rz),
      static_cast<T*>(hlast), static_cast<T*>(hblock), j,
      static_cast<int*>(iters), static_cast<T*>(scal), static_cast<T>(eps),
      static_cast<T>(tol), record);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update_p(const void* r, void* p, const void* minv,
                    const void* mr, int64_t n, const void* ctl,
                    const void* scal, cudaStream_t stream) {
  cg_update_p_kernel<T><<<grid<T>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<T*>(p),
      static_cast<const T*>(minv), static_cast<const T*>(mr), n,
      static_cast<const int*>(ctl), static_cast<const T*>(scal));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prepare() {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, cg_pap_kernel<T>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, cg_update_r_kernel<T>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, cg_update_p_kernel<T>);
  return e == cudaSuccess ? static_cast<int>(tile<T>())
                          : -static_cast<int>(e);
}

}  // namespace cgu
}  // namespace tpufem

using tpufem::cgu::launch_pap;
using tpufem::cgu::launch_update_p;
using tpufem::cgu::launch_update_r;

// The tile (values a block takes) of the dtype, after loading the three
// kernels (so that none is first loaded inside a graph capture); a CUDA
// error as its negative code.
extern "C" int tpufem_cg_tile(int is_f64) {
  return is_f64 ? tpufem::cgu::prepare<double>()
                : tpufem::cgu::prepare<float>();
}

// p, Ap [n]; part [>= 2 G]; ctl [8] int32; status int32; rz, scal [4].
extern "C" int tpufem_cg_pap(int is_f64, const void* p, const void* Ap,
                             int64_t n, void* part, void* ctl,
                             const void* status, const void* rz, void* scal,
                             double eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_pap<double>(p, Ap, n, part, ctl, status, rz, scal,
                                     eps, s)
                : launch_pap<float>(p, Ap, n, part, ctl, status, rz, scal,
                                    eps, s);
}

// u, r, p, Ap, minv, ms, mr [n]; hblock [> j]; status, iters int32.
extern "C" int tpufem_cg_update_r(int is_f64, void* u, void* r,
                                  const void* p, const void* Ap,
                                  const void* minv, const void* ms,
                                  const void* mr, int64_t n, void* part,
                                  void* ctl, void* status, void* rz,
                                  void* hlast, void* hblock, int j,
                                  void* iters, void* scal, double eps,
                                  double tol, int record, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_update_r<double>(u, r, p, Ap, minv, ms, mr, n, part,
                                          ctl, status, rz, hlast, hblock, j,
                                          iters, scal, eps, tol, record, s)
                : launch_update_r<float>(u, r, p, Ap, minv, ms, mr, n, part,
                                         ctl, status, rz, hlast, hblock, j,
                                         iters, scal, eps, tol, record, s);
}

// r, p, minv, mr [n]; ctl [8] int32; scal [4].
extern "C" int tpufem_cg_update_p(int is_f64, const void* r, void* p,
                                  const void* minv, const void* mr,
                                  int64_t n, const void* ctl,
                                  const void* scal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_update_p<double>(r, p, minv, mr, n, ctl, scal, s)
                : launch_update_p<float>(r, p, minv, mr, n, ctl, scal, s);
}
