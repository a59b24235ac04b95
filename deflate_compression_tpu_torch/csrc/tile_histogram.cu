// Per-tile symbol histogram for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deflate_compression_tpu/ops/histogram_pallas.py
// ::tile_histogram (and its production twin, the one-hot int8 matmul
// core/huffman.py::histogram_rows_matmul). It computes
//     out[r, c] = #{ l : sym[r, l] == c }   for c in [0, C),
// and symbols outside [0, C) drop out (the encoder masks unused positions
// to C). Symbols are int32 or int64 and the counts come out in the same
// type, so the encoder's int64 symbols need no cast kernel before and no
// widening kernel after.
//
// What bounds it on this card: device memory, barely. The encoder's rows
// are 32768 int64 symbols (256 KB), 32 of them per 1 MB shard: 8 MB read
// once, 2.5 us at 3.35 TB/s, and the counts are a few KB. Below that sit
// fixed costs (the launch, the counters' zero-fill, the reductions and the
// cluster's barriers: about 5 us, measured) and shared-memory atomics.
//
// What the design does. A row is split over a thread block cluster of k
// CTAs (k up to 8, chosen from rows and length so that the grid fills the
// SMs: 256 CTAs at 32 rows), each reading its share with 16-byte loads,
// kLoads vectors per thread in flight. Every warp counts into its own copy
// of the C counters in shared memory (8 copies; where C is large, warps
// share fewer copies, chosen from C at launch). The warps' copies are
// summed in shared memory, then each CTA of the cluster sums one slice of
// the classes over the cluster's CTAs through distributed shared memory
// and stores each count once: no global atomics, no zero-fill of `out`.
// Aggregating a warp's equal symbols first (__match_any_sync, one atomic
// per group) was measured on an H100 and ran slower on random rows while
// saving nothing on rows of one symbol, where the hardware already merges
// a warp's atomics on one address; so each symbol is one plain atomicAdd.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                 // 16-byte vectors in flight
constexpr int kSmemBytes = 48 * 1024;     // no opt-in attribute needed
constexpr int kMaxCluster = 8;            // portable cluster size
constexpr int kMinShare = 4096;           // symbols per CTA, at least
constexpr unsigned kDrop = 0xFFFFFFFFu;   // key of a symbol outside [0, C)
constexpr int kMaxDevices = 64;

int g_sms[kMaxDevices];                   // SM count per device, 0: unknown

template <typename T>
struct Vec;
template <>
struct Vec<int32_t> {
  using type = int4;
  static constexpr int n = 4;
  __device__ static void unpack(const int4& v, int32_t (&x)[4]) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <>
struct Vec<int64_t> {
  using type = longlong2;
  static constexpr int n = 2;
  __device__ static void unpack(const longlong2& v, int64_t (&x)[2]) {
    x[0] = v.x; x[1] = v.y;
  }
};

__device__ __forceinline__ unsigned key_of(int64_t v, unsigned C) {
  return static_cast<unsigned long long>(v) < C ? static_cast<unsigned>(v)
                                                : kDrop;
}

// One symbol per lane of a full warp, added to the warp's counters.
__device__ __forceinline__ void count_warp(int* cnt, unsigned key) {
  if (key != kDrop) atomicAdd(cnt + key, 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_histogram_kernel(const T* __restrict__ sym, T* __restrict__ out,
                      int64_t length, int num_classes, int copies) {
  using V = Vec<T>;
  extern __shared__ int counts[];         // [copies][num_classes]
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / k;
  const unsigned C = static_cast<unsigned>(num_classes);
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < copies * num_classes; i += kThreads)
    counts[i] = 0;
  __syncthreads();

  // the row: a scalar head up to a 16-byte boundary, whole vectors, and a
  // scalar tail; the vectors are shared out among the cluster's CTAs
  const T* r = sym + row * length;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(r);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > length) head = length;
  const int64_t n_vec = (length - head) / V::n;
  const int64_t per = (n_vec + k - 1) / k;
  const int64_t v0 = rank * per;
  const int64_t v1 = n_vec < v0 + per ? n_vec : v0 + per;
  const int64_t tail = head + n_vec * V::n;
  if (rank == 0 && threadIdx.x < head) {
    const unsigned key = key_of(r[threadIdx.x], C);
    if (key != kDrop) atomicAdd(counts + key, 1);
  }
  if (rank == k - 1 && tail + threadIdx.x < length) {
    const unsigned key = key_of(r[tail + threadIdx.x], C);
    if (key != kDrop) atomicAdd(counts + key, 1);
  }

  int* mine = counts + (warp % copies) * num_classes;
  const typename V::type* vec =
      reinterpret_cast<const typename V::type*>(r + head);
  // kLoads vectors per thread in flight, then counted; the trip count is
  // uniform over the CTA, and lanes past the end count kDrop
  for (int64_t base = v0; base < v1; base += int64_t{kThreads} * kLoads) {
    typename V::type cur[kLoads] = {};
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      if (i < v1) cur[u] = __ldcs(vec + i);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool live = base + u * kThreads + threadIdx.x < v1;
      T x[V::n];
      V::unpack(cur[u], x);
#pragma unroll
      for (int j = 0; j < V::n; ++j)
        count_warp(mine, live ? key_of(x[j], C) : kDrop);
    }
  }
  __syncthreads();

  // the warps' copies into copy 0 (thread c alone touches column c)
  for (int c = threadIdx.x; c < num_classes; c += kThreads) {
    int s = 0;
    for (int j = 0; j < copies; ++j) s += counts[j * num_classes + c];
    counts[c] = s;
  }
  cluster.sync();

  // each CTA sums its slice of the classes over the cluster's CTAs
  const int per_c = (num_classes + k - 1) / k;
  const int c1 = num_classes < (rank + 1) * per_c ? num_classes
                                                  : (rank + 1) * per_c;
  T* dst = out + row * num_classes;
  for (int c = rank * per_c + threadIdx.x; c < c1; c += kThreads) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < k) s += cluster.map_shared_rank(counts, q)[c];
    dst[c] = static_cast<T>(s);
  }
  cluster.sync();                         // peers may still read our counters
}

// CTAs per row: the largest power of two up to 8 that keeps the grid
// within two CTAs per SM and every CTA at kMinShare symbols or more.
int cluster_for(int rows, int64_t length, int sms) {
  int k = kMaxCluster;
  while (k > 1 && (static_cast<int64_t>(rows) * k > 2 * sms ||
                   length / k < kMinShare))
    k >>= 1;
  return k;
}

template <typename T>
cudaError_t launch(const void* sym, void* out, int rows, int64_t length,
                   int num_classes, int cluster, cudaStream_t stream) {
  const int per_copy = num_classes * static_cast<int>(sizeof(int));
  int copies = kSmemBytes / per_copy;
  if (copies > kWarps) copies = kWarps;
  if (copies < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(copies) * per_copy;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tile_histogram_kernel<T>,
                            static_cast<const T*>(sym), static_cast<T*>(out),
                            length, num_classes, copies);
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `sym` is rows x length
// int32 (elem_bytes 4) or int64 (8), `out` rows x num_classes of the same
// type, both allocated by the caller.
extern "C" int tile_histogram_launch(const void* sym, void* out, int rows,
                                     int64_t length, int num_classes,
                                     int elem_bytes, int device,
                                     void* stream) {
  if (rows < 1 || length < 0 || num_classes < 1 ||
      (elem_bytes != 4 && elem_bytes != 8) ||
      device < 0 || device >= kMaxDevices ||
      static_cast<int64_t>(rows) * kMaxCluster > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess && !g_sms[device])
    e = cudaDeviceGetAttribute(&g_sms[device],
                               cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    const int k = cluster_for(rows, length, g_sms[device]);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = elem_bytes == 4
            ? launch<int32_t>(sym, out, rows, length, num_classes, k, s)
            : launch<int64_t>(sym, out, rows, length, num_classes, k, s);
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
