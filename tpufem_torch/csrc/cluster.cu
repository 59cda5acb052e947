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
// in L1/L2, 1.5 KB per cluster in f32).
// Compress: one warp per cluster, four clusters per 128-thread block, and
// no barrier but the warp's own.  The warp copies lconn[b] and Fe[b] into
// its shared memory with cp.async (lconn first, so that the next step
// starts while Fe is still in flight), then builds each slot's list of
// lanes, r ascending: over 32-lane chunks in r order, __match_any_sync
// groups the lanes of one slot, and a lane's rank is the slot's running
// count plus the number of its group's lanes below it; an exclusive scan
// of the L counts gives each list's start.  Then thread (slot l,
// component c) adds only its own lanes, in list order: the r-ascending
// order of the plain PyTorch version, from 0, so the result is bitwise
// the plain version's.  No atomics.

#include "packed_common.cuh"   // cp.async staging

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
constexpr int kCompressWarps = 4;   // clusters per block, one warp each

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// One warp's shared memory, four 16-byte aligned parts: Fe [R, 3], lconn
// [R] (then each lane's rank << 16 | slot), the lists [R] and the list
// starts [L + 1] (first the counts).
struct CompressLayout {
  size_t ls, list, start, total;
  __host__ __device__ CompressLayout(int R, int L, size_t item)
      : ls(align16(static_cast<size_t>(R) * kNd * item)),
        list(ls + align16(static_cast<size_t>(R) * 4)),
        start(list + align16(static_cast<size_t>(R) * 4)),
        total(start + align16(static_cast<size_t>(L + 1) * 4)) {}
};

template <typename T>
__global__ void __launch_bounds__(32 * kCompressWarps)
cluster_compress_kernel(const int* __restrict__ lconn,
                        const T* __restrict__ fe, int64_t B, int R, int L,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                       // the whole warp
  const CompressLayout lay(R, L, sizeof(T));
  unsigned char* base = smem_raw + (threadIdx.x >> 5) * lay.total;
  T* fs = reinterpret_cast<T*>(base);
  int* ls = reinterpret_cast<int*>(base + lay.ls);
  int* list = reinterpret_cast<int*>(base + lay.list);
  int* start = reinterpret_cast<int*>(base + lay.start);

  // 1. lconn[b] (group 0), then Fe[b] (group 1), into shared memory
  stage_words<32>(ls, lconn + b * R, R, lane);
  cp_async_commit();
  stage_words<32>(fs, fe + b * R * kNd, R * kNd * (sizeof(T) / 4), lane);
  cp_async_commit();
  for (int l = lane; l < L; l += 32) start[l] = 0;
  cp_async_wait<1>();
  __syncwarp();

  // 2. each lane's rank among the earlier lanes of its slot; slot counts
  const unsigned below = (1u << lane) - 1u;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int r = r0 + lane;
    int l = r < R ? ls[r] : -1;
    if (static_cast<unsigned>(l) >= static_cast<unsigned>(L)) l = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    const int rank = l >= 0 ? start[l] + __popc(peers & below) : 0;
    __syncwarp();
    if (l >= 0 && (peers & below) == 0) start[l] += __popc(peers);
    if (r < R) ls[r] = l >= 0 ? (rank << 16) | l : -1;
    __syncwarp();
  }

  // 3. exclusive scan of the counts: lane i takes a run of ceil(L / 32)
  const int per = (L + 31) / 32;
  const int lo = min(lane * per, L), hi = min(lo + per, L);
  int sum = 0;
  for (int l = lo; l < hi; ++l) sum += start[l];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
  for (int l = lo; l < hi; ++l) {
    const int c = start[l];
    start[l] = run;
    run += c;
  }
  if (lane == 31) start[L] = incl;
  __syncwarp();

  // 4. the lists: lane r at its slot's start plus its rank
  for (int r = lane; r < R; r += 32) {
    const int v = ls[r];
    if (v >= 0) list[start[v & 0xFFFF] + (v >> 16)] = r;
  }
  cp_async_wait<0>();
  __syncwarp();

  // 5. thread (slot l, component c) sums its lanes in list order; the
  // stores of a warp are 32 consecutive values
  T* o = out + b * L * kNd;
  for (int p = lane; p < L * kNd; p += 32) {
    const int l = p / kNd;
    const int c = p - l * kNd;
    T acc = T(0);
    for (int i = start[l]; i < start[l + 1]; ++i)
      acc += fs[list[i] * kNd + c];
    o[p] = acc;
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

// Warps (clusters) per block: four, or fewer where four clusters' shared
// memory would exceed the block's; 0 where one cluster's does.
inline int compress_warps(int R, int L, size_t item) {
  const size_t per = CompressLayout(R, L, item).total;
  const size_t w = kMaxSmem / per;
  return static_cast<int>(w < kCompressWarps ? w : kCompressWarps);
}

template <typename T>
int compress(const void* lconn, const void* fe, int64_t B, int R, int L,
             int nd, void* out, cudaStream_t stream) {
  const int warps = compress_warps(R, L, sizeof(T));
  if (nd != kNd || warps == 0 || R > 32767 || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warps * CompressLayout(R, L, sizeof(T)).total;
  auto kern = cluster_compress_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
    kern<<<grid, 32 * warps, smem, stream>>>(
        static_cast<const int*>(lconn), static_cast<const T*>(fe), B, R, L,
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

// lconn [B, R] int32 with entries in [0, L); fe [B, R, 3]; out [B, L, 3];
// nd must be 3, R <= 32767, L <= 65535, and one cluster's shared memory
// (CompressLayout) within the block's.
extern "C" int tpufem_cluster_compress(int is_f64, const void* lconn,
                                       const void* fe, int64_t B, int R,
                                       int L, int nd, void* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? tpufem::compress<double>(lconn, fe, B, R, L, nd, out, s)
                : tpufem::compress<float>(lconn, fe, B, R, L, nd, out, s);
}
