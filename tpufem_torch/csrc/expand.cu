// expand and expand_planar: the packed operator's two-hop gather on its
// own, X rows -> cluster slots -> element lanes.
//
// expand replaces tpufem/ops/packed_kernels.py `expand` (_expand_kernel),
// the first kernel of the staged apply (and of parallel/packed_dist.py);
// expand_planar replaces `expand_planar` (_expand_planar_kernel), the
// same gather written in the element-compute layout.  The Pallas kernels
// read window rows Xw [B, Wn, 384] that XLA gathered into HBM first; these
// read rows of X by index (win_nodes), as fused_yc does, so no Xw is
// materialized.  Per cluster b:
//   hop 1: slot s takes X[win_nodes[b, wslot[b,s]], c*128 + jslot[b,s]]
//          (zero for an empty slot, wslot >= wk, or a padded row, == Nb);
//   hop 2: element lane r takes slot lconn[b, r];
//   expand:        ue[b, c, r] for every lane r < Rp (pad lanes read the
//                  slot their lconn entry names, as in tpufem);
//   expand_planar: ue3[c, kk, b, e] for r = kk * E_c + e < k * E_c.  ue3
//                  may be a bucket's rows of a larger planar array:
//                  `plane` is the distance between its (c, kk) planes.
// Both hops are the device functions K1 runs (packed_common.cuh).
//
// Bound on the H100: bytes.  Per cluster they read the slot tables
// (wslot, jslot: 1 KB), lconn, wk window entries and 384 X values (X is
// read about once per sweep), and write 3 * Rp (3 * k * E_c) values: the
// writes dominate, ~120 MB per f32 sweep at 1M c3d10 elements.  No
// arithmetic.
//
// Design: one 128-thread block per cluster.  Thread s fills slot s into
// shared memory (hop 1), then the block writes the element lanes, 128
// consecutive lanes per step (hop 2), so the stores are coalesced.  Pure
// copies: bitwise equal to the plain PyTorch versions.  Launched once per
// cluster bucket.

#include "packed_common.cuh"

namespace tpufem {

template <typename T>
__global__ void __launch_bounds__(kSlots)
expand_kernel(const T* __restrict__ X, int64_t Nb,
              const int* __restrict__ win_nodes, int Wn, int wk,
              const int* __restrict__ wslot, const int* __restrict__ jslot,
              const int* __restrict__ lconn, int Rp, T* __restrict__ out) {
  __shared__ T uc[3 * kSlots];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  hop1_cluster<T>(X, Nb, win_nodes, Wn, wk, wslot, jslot, b, true, t, uc);
  __syncthreads();
  const int* lc = lconn + b * Rp;
  T* o = out + b * 3 * Rp;
  for (int r = t; r < Rp; r += kSlots) {
    T v[3];
    hop2_lane<T>(uc, lc[r], v);
    o[r] = v[0];
    o[Rp + r] = v[1];
    o[2 * Rp + r] = v[2];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSlots)
expand_planar_kernel(const T* __restrict__ X, int64_t Nb,
                     const int* __restrict__ win_nodes, int Wn, int wk,
                     const int* __restrict__ wslot,
                     const int* __restrict__ jslot,
                     const int* __restrict__ lconn, int Rp, int k, int E_c,
                     T* __restrict__ out, int64_t plane) {
  __shared__ T uc[3 * kSlots];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  hop1_cluster<T>(X, Nb, win_nodes, Wn, wk, wslot, jslot, b, true, t, uc);
  __syncthreads();
  const int* lc = lconn + b * Rp;
  T* o = out + b * E_c;
  const int lanes = k * E_c;
  for (int r = t; r < lanes; r += kSlots) {
    const int kk = r / E_c;
    const int e = r - kk * E_c;
    T v[3];
    hop2_lane<T>(uc, lc[r], v);
    o[kk * plane + e] = v[0];
    o[(k + kk) * plane + e] = v[1];
    o[(2 * k + kk) * plane + e] = v[2];
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
  void* out;
  int64_t n;
};

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.n > 0) {
    expand_kernel<T><<<static_cast<unsigned>(a.n), kSlots, 0, stream>>>(
        static_cast<const T*>(a.X), a.Nb,
        static_cast<const int*>(a.win_nodes), a.Wn, a.wk,
        static_cast<const int*>(a.wslot), static_cast<const int*>(a.jslot),
        static_cast<const int*>(a.lconn), a.Rp, static_cast<T*>(a.out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_planar(const Args& a, int k, int E_c, int64_t plane,
                  cudaStream_t stream) {
  if (a.n > 0) {
    expand_planar_kernel<T><<<static_cast<unsigned>(a.n), kSlots, 0,
                              stream>>>(
        static_cast<const T*>(a.X), a.Nb,
        static_cast<const int*>(a.win_nodes), a.Wn, a.wk,
        static_cast<const int*>(a.wslot), static_cast<const int*>(a.jslot),
        static_cast<const int*>(a.lconn), a.Rp, k, E_c,
        static_cast<T*>(a.out), plane);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpufem

// X [Nb, 384]; win_nodes [n, Wn]; wslot, jslot [n, 128]; lconn [n, Rp];
// out [n, 3, Rp].
extern "C" int tpufem_expand(int is_f64, const void* X, int64_t Nb,
                             const void* win_nodes, int Wn, int wk,
                             const void* wslot, const void* jslot,
                             const void* lconn, int Rp, void* out,
                             int64_t n, void* stream) {
  tpufem::Args a{X, Nb, win_nodes, Wn, wk, wslot, jslot, lconn, Rp, out, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::launch<double>(a, s) : tpufem::launch<float>(a, s);
}

// As tpufem_expand, with out: element (c, kk, b, e) at
// out[(c * k + kk) * plane + b * E_c + e] for b < n.
extern "C" int tpufem_expand_planar(int is_f64, const void* X, int64_t Nb,
                                    const void* win_nodes, int Wn, int wk,
                                    const void* wslot, const void* jslot,
                                    const void* lconn, int Rp, int k,
                                    int E_c, void* out, int64_t plane,
                                    int64_t n, void* stream) {
  if (E_c <= 0 || tpufem::kSlots % E_c || k * E_c > Rp)
    return static_cast<int>(cudaErrorInvalidValue);
  tpufem::Args a{X, Nb, win_nodes, Wn, wk, wslot, jslot, lconn, Rp, out, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::launch_planar<double>(a, k, E_c, plane, s)
                : tpufem::launch_planar<float>(a, k, E_c, plane, s);
}
