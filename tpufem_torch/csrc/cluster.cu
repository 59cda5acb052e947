// cluster_expand and cluster_compress: the in-cluster gather and sum of the
// clustered operator (ops/clustered.py, ClusteredOperator).
//
// Replace tpufem/ops/pallas_kernels.py `cluster_expand` (_expand_kernel)
// and `cluster_compress` (_compress_kernel).  The Pallas kernels build a
// one-hot [R, L] selection from lconn in VMEM and contract it on the MXU;
// here the same selections are an indexed read and a fixed-order sum:
//   expand:   ue[b, r, c] = Uc[b, lconn[b, r], c]   (0 where lconn is
//             outside [0, L))
//   compress: Yc[b, l, c] = sum over r ascending with lconn[b, r] == l of
//             Fe[b, r, c], starting from 0
// (lconn [B, R] int32 is ClusterPlan.lconn flattened element-major,
// r = e * k + kk; c < nd, the values per node, 1 to 6: 3 for a solid, 6
// for a shell).  nd is a template parameter, so every index split below
// is a multiply and a shift.
//
// Bound on the H100: bytes.  Expand reads lconn (R ints) and Uc (L * nd
// values) and writes R * nd values per cluster; compress reads lconn and
// Fe (R * nd) and writes L * nd values.  Neither does arithmetic beyond
// one add per Fe value.
//
// Expand: four consecutive clusters per 128-thread block.  The block
// copies their Uc rows and lconn rows (each a contiguous span) into shared
// memory with cp.async, turns each lane's slot into the offset of its
// values there (-1 out of range), and writes the four clusters' outputs,
// one contiguous span of 4 R nd values, with 16-byte stores: every value
// is read from shared memory, and the only index arithmetic is 32-bit
// within the block.  Four clusters keep every block's span 16-byte aligned
// (4 R nd values of 4 or 8 bytes).
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

#include <type_traits>

#include "packed_common.cuh"   // cp.async staging

namespace tpufem {

constexpr int kExpandThreads = 128;
constexpr int kExpandClusters = 4;  // clusters per expand block

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// One expand block's shared memory: Uc [C, L, nd], then lconn [C, R]
// (then each lane's value offset).
struct ExpandLayout {
  size_t src, total;
  __host__ __device__ ExpandLayout(int R, int L, int nd, size_t item, int C)
      : src(align16(static_cast<size_t>(C) * L * nd * item)),
        total(src + align16(static_cast<size_t>(C) * R * 4)) {}
};

// One 16-byte store of V = 16 / sizeof(T) values.
__device__ __forceinline__ void store16(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(double* dst, const double (&v)[2]) {
  *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
}

template <typename T, int ND>
__global__ void __launch_bounds__(kExpandThreads)
cluster_expand_kernel(const int* __restrict__ lconn, const T* __restrict__ uc,
                      int64_t B, int R, int L, int C, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * C;
  const int nc = static_cast<int>(B - b0 < C ? B - b0 : C);
  const ExpandLayout lay(R, L, ND, sizeof(T), C);
  T* us = reinterpret_cast<T*>(smem_raw);
  int* src = reinterpret_cast<int*>(smem_raw + lay.src);

  // 1. the clusters' Uc rows and lconn rows, each one contiguous span
  stage_words<kExpandThreads>(us, uc + b0 * L * ND,
                              static_cast<int64_t>(nc) * L * ND *
                                  (sizeof(T) / 4), t);
  stage_words<kExpandThreads>(src, lconn + b0 * R,
                              static_cast<int64_t>(nc) * R, t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. each lane's slot -> the offset of its values in `us` (-1: none)
  for (int c = 0; c < nc; ++c) {
    for (int r = t; r < R; r += kExpandThreads) {
      const int l = src[c * R + r];
      src[c * R + r] = static_cast<unsigned>(l) < static_cast<unsigned>(L)
                           ? (c * L + l) * ND
                           : -1;
    }
  }
  __syncthreads();

  // 3. the block's nc * R * ND output values, value v = (lane v / ND,
  // component v % ND); 16-byte stores where the span is aligned
  const int n = nc * R * ND;
  T* o = out + b0 * R * ND;
  constexpr int V = 16 / sizeof(T);
  const int nv = (reinterpret_cast<uintptr_t>(o) & 15) == 0 ? n / V : 0;
  for (int i = t; i < nv; i += kExpandThreads) {
    int r = (i * V) / ND;
    int c = i * V - r * ND;
    T vals[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int s = src[r];
      vals[k] = s >= 0 ? us[s + c] : T(0);
      if (++c == ND) {
        c = 0;
        ++r;
      }
    }
    store16(o + i * V, vals);
  }
  for (int v = nv * V + t; v < n; v += kExpandThreads) {
    const int r = v / ND;
    const int s = src[r];
    o[v] = s >= 0 ? us[s + (v - r * ND)] : T(0);
  }
}

constexpr int kCompressWarps = 4;   // clusters per block, one warp each

// One warp's shared memory, four 16-byte aligned parts: Fe [R, nd], lconn
// [R] (then each lane's rank << 16 | slot), the lists [R] and the list
// starts [L + 1] (first the counts).
struct CompressLayout {
  size_t ls, list, start, total;
  __host__ __device__ CompressLayout(int R, int L, int nd, size_t item)
      : ls(align16(static_cast<size_t>(R) * nd * item)),
        list(ls + align16(static_cast<size_t>(R) * 4)),
        start(list + align16(static_cast<size_t>(R) * 4)),
        total(start + align16(static_cast<size_t>(L + 1) * 4)) {}
};

template <typename T, int ND>
__global__ void __launch_bounds__(32 * kCompressWarps)
cluster_compress_kernel(const int* __restrict__ lconn,
                        const T* __restrict__ fe, int64_t B, int R, int L,
                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                       // the whole warp
  const CompressLayout lay(R, L, ND, sizeof(T));
  unsigned char* base = smem_raw + (threadIdx.x >> 5) * lay.total;
  T* fs = reinterpret_cast<T*>(base);
  int* ls = reinterpret_cast<int*>(base + lay.ls);
  int* list = reinterpret_cast<int*>(base + lay.list);
  int* start = reinterpret_cast<int*>(base + lay.start);

  // 1. lconn[b] (group 0), then Fe[b] (group 1), into shared memory
  stage_words<32>(ls, lconn + b * R, R, lane);
  cp_async_commit();
  stage_words<32>(fs, fe + b * R * ND, R * ND * (sizeof(T) / 4), lane);
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
  T* o = out + b * L * ND;
  for (int p = lane; p < L * ND; p += 32) {
    const int l = p / ND;
    const int c = p - l * ND;
    T acc = T(0);
    for (int i = start[l]; i < start[l + 1]; ++i)
      acc += fs[list[i] * ND + c];
    o[p] = acc;
  }
}

// Raise a kernel's dynamic shared memory limit where `smem` needs it.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Clusters per expand block: four, or fewer where four clusters' shared
// memory would exceed the block's; 0 where one cluster's does.
inline int expand_clusters(int R, int L, int nd, size_t item) {
  for (int c = kExpandClusters; c > 0; --c)
    if (ExpandLayout(R, L, nd, item, c).total <= kMaxSmem) return c;
  return 0;
}

template <typename T, int ND>
int expand_nd(const void* lconn, const void* uc, int64_t B, int R, int L,
              void* out, cudaStream_t stream) {
  const int C = expand_clusters(R, L, ND, sizeof(T));
  if (C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ExpandLayout(R, L, ND, sizeof(T), C).total;
  auto kern = cluster_expand_kernel<T, ND>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && R > 0) {
    const unsigned grid = static_cast<unsigned>((B + C - 1) / C);
    kern<<<grid, kExpandThreads, smem, stream>>>(
        static_cast<const int*>(lconn), static_cast<const T*>(uc), B, R, L,
        C, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Warps (clusters) per compress block: four, or fewer where four clusters'
// shared memory would exceed the block's; 0 where one cluster's does.
inline int compress_warps(int R, int L, int nd, size_t item) {
  const size_t per = CompressLayout(R, L, nd, item).total;
  const size_t w = kMaxSmem / per;
  return static_cast<int>(w < kCompressWarps ? w : kCompressWarps);
}

template <typename T, int ND>
int compress_nd(const void* lconn, const void* fe, int64_t B, int R, int L,
                void* out, cudaStream_t stream) {
  const int warps = compress_warps(R, L, ND, sizeof(T));
  if (warps == 0 || R > 32767 || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warps * CompressLayout(R, L, ND, sizeof(T)).total;
  auto kern = cluster_compress_kernel<T, ND>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
    kern<<<grid, 32 * warps, smem, stream>>>(
        static_cast<const int*>(lconn), static_cast<const T*>(fe), B, R, L,
        static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, nd>) for nd = 1..6: nd as a template
// argument.
template <typename F>
int with_nd(int nd, F f) {
  switch (nd) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tpufem

// lconn [B, R] int32; uc [B, L, nd]; out [B, R, nd]; 1 <= nd <= 6 and
// one cluster's Uc and lconn rows (ExpandLayout) within a block's shared
// memory.
extern "C" int tpufem_cluster_expand(int is_f64, const void* lconn,
                                     const void* uc, int64_t B, int R, int L,
                                     int nd, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tpufem::with_nd(nd, [&](auto k) {
    constexpr int ND = decltype(k)::value;
    return is_f64 ? tpufem::expand_nd<double, ND>(lconn, uc, B, R, L, out, s)
                  : tpufem::expand_nd<float, ND>(lconn, uc, B, R, L, out, s);
  });
}

// lconn [B, R] int32 with entries in [0, L); fe [B, R, nd]; out [B, L, nd];
// 1 <= nd <= 6, R <= 32767, L <= 65535, and one cluster's shared memory
// (CompressLayout) within the block's.
extern "C" int tpufem_cluster_compress(int is_f64, const void* lconn,
                                       const void* fe, int64_t B, int R,
                                       int L, int nd, void* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tpufem::with_nd(nd, [&](auto k) {
    constexpr int ND = decltype(k)::value;
    return is_f64
               ? tpufem::compress_nd<double, ND>(lconn, fe, B, R, L, out, s)
               : tpufem::compress_nd<float, ND>(lconn, fe, B, R, L, out, s);
  });
}
