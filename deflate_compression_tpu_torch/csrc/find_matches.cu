// LZ77 match finder for Hopper (sm_90a), plain C interface.
//
// Stands for deflate_compression_tpu/core/lz77.py::find_matches (:88-313),
// which the JAX package left to XLA: it has no Pallas kernel. Mosaic could
// not lower a dynamic gather, so the TPU code walks no chain: it sorts the
// positions by hash once and scores each position's K sorted predecessors
// with shifted-slice compares over a (S, 9) payload table. Here the chain
// is walked: with b[x] read as 0 for every x >= S,
//   h[i]    = ((b[i] | b[i+1] << 8 | b[i+2] << 16) * 2654435761 mod 2^32)
//             >> 16,
//   prev[i] = the nearest j < i with h[j] == h[i], or -1 (from one stable
//             sort by hash: the sort is glue, as jnp.argsort is glue there);
// the candidates of i are prev[i], prev[prev[i]], ... (K of them at most,
// a hash collision using one up), and the walk stops at the first j with
// i - j > 32768. Each candidate scores nb = min(leading equal bytes, 11);
// the largest nb wins and ties go to the nearest, so the walk ends early
// once a candidate reaches 11. The winner is rescored to min(leading equal
// bytes, 35); length = min(that, 258, S - i), 0 under 3, and dist = i - j
// where length > 0.
//
// Three launches on one stream: `find_matches_hash_kernel` (h), then,
// after the sort, `find_matches_link_kernel` (prev[], links longer than the
// window cut, since such a link is out of every later position's window
// too) and `find_matches_walk_kernel`.
//
// What bounds it on this card: the bytes are S read and 16 written per
// position (two int64 outputs), 17 MB for a 1 MB shard, 5 us at 3.35 TB/s;
// the operations are one compare per byte scored and one load per chain
// hop, far under the int32 rate. What sets its time is the latency of the
// dependent chain loads and of the byte compares. The design keeps every
// compare in shared memory, four bytes at a time (a funnel shift of two
// aligned words): a CTA owns kTile positions and stages the bytes
// [a - 32768, a + kTile + 43) (34.9 KB, so six CTAs fit on an SM), which
// hold every candidate's bytes and every rescore's 35. prev[] stays
// in global memory; a chain walks back at most 128 KB of it, which the
// L1 and L2 caches hold. No payload table, no gathered copy of it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;               // positions per CTA
constexpr int kWindow = 32768;
constexpr int kPreselect = 11;            // bytes scored per candidate
constexpr int kRescore = 35;              // bytes scored for the winner
constexpr int kMaxMatch = 258;
constexpr int kMinMatch = 3;
// bytes staged per CTA: the window, the tile, the rescore's 35 and the
// rest of the last word pair that equal_run reads
constexpr int kStage = kWindow + kTile + kRescore + 8;
constexpr int kStageAlloc = (kStage + 15) / 16 * 16;
constexpr unsigned kHashMul = 2654435761u;

__global__ void __launch_bounds__(kThreads)
find_matches_hash_kernel(const uint8_t* __restrict__ data, int S,
                         int32_t* __restrict__ h) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < S;
       i += gridDim.x * kThreads) {
    const unsigned b0 = data[i];
    const unsigned b1 = i + 1 < S ? data[i + 1] : 0u;
    const unsigned b2 = i + 2 < S ? data[i + 2] : 0u;
    h[i] = static_cast<int32_t>(((b0 | b1 << 8 | b2 << 16) * kHashMul) >> 16);
  }
}

// prev[order[j]] = order[j-1] where both have the same hash and lie within
// the window of each other, else -1. hs = h[order], sorted.
__global__ void __launch_bounds__(kThreads)
find_matches_link_kernel(const int32_t* __restrict__ hs,
                         const int64_t* __restrict__ order, int S,
                         int32_t* __restrict__ prev) {
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < S;
       j += gridDim.x * kThreads) {
    const int i = static_cast<int>(order[j]);
    int p = -1;
    if (j > 0 && hs[j - 1] == hs[j]) {
      const int q = static_cast<int>(order[j - 1]);
      if (i - q <= kWindow) p = q;
    }
    prev[i] = p;
  }
}

// The 4 bytes at byte offset o of the staged buffer, LSB first, from the
// two aligned words that hold them.
__device__ __forceinline__ unsigned bytes4(const unsigned* w, int o) {
  return __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], (o & 3) * 8);
}

// Leading equal bytes at byte offsets a and b of the staged buffer, from
// `from` up to `cap`, four at a time.
__device__ __forceinline__ int equal_run(const unsigned* w, int a, int b,
                                         int from, int cap) {
  for (int n = from; n < cap; n += 4) {
    const unsigned x = bytes4(w, a + n) ^ bytes4(w, b + n);
    if (x) {
      n += (__ffs(x) - 1) >> 3;
      return n < cap ? n : cap;
    }
  }
  return cap;
}

__global__ void __launch_bounds__(kThreads)
find_matches_walk_kernel(const uint8_t* __restrict__ data, int S,
                         const int32_t* __restrict__ prev, int K,
                         int64_t* __restrict__ length,
                         int64_t* __restrict__ dist) {
  __shared__ __align__(16) uint8_t sb[kStageAlloc];
  const int a = blockIdx.x * kTile;
  const int base = a - kWindow;             // sb[x - base] holds b[x]

  // stage the bytes, zero past S (and before 0, where nothing reads);
  // whole 16-byte vectors where the data pointer allows them
  const bool vec = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  for (int c = threadIdx.x; c < kStageAlloc / 16; c += kThreads) {
    const int x = base + 16 * c;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (vec && x >= 0 && x + 16 <= S) {
      v = __ldg(reinterpret_cast<const uint4*>(data + x));
    } else {
      unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (x + k >= 0 && x + k < S)
          w[k >> 2] |= static_cast<unsigned>(data[x + k]) << (8 * (k & 3));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(sb + 16 * c) = v;
  }
  __syncthreads();

  const unsigned* sw = reinterpret_cast<const unsigned*>(sb);
  const int end = a + kTile < S ? a + kTile : S;
  for (int i = a + threadIdx.x; i < end; i += kThreads) {
    const int me = i - base;
    int best = -1;
    int best_nb = -1;
    int cand = __ldg(prev + i);
    for (int k = 0; k < K && cand >= 0 && i - cand <= kWindow; ++k) {
      const int nb = equal_run(sw, me, cand - base, 0, kPreselect);
      if (nb > best_nb) {
        best_nb = nb;
        best = cand;
        if (nb == kPreselect) break;      // no later candidate can beat it
      }
      cand = __ldg(prev + cand);
    }
    int len = 0;
    if (best >= 0) {
      // the first best_nb bytes are equal and, under 11, the next differs
      len = best_nb < kPreselect
                ? best_nb
                : equal_run(sw, me, best - base, kPreselect, kRescore);
      if (len > S - i) len = S - i;       // equality in the padding is fake
      if (len > kMaxMatch) len = kMaxMatch;
      if (len < kMinMatch) len = 0;
    }
    length[i] = len;
    dist[i] = len > 0 ? i - best : 0;
  }
}

}  // namespace

static cudaError_t with_device(int device, cudaError_t (*fn)(void*),
                               void* arg) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = fn(arg);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return e;
}

static unsigned grid_for(int S) {
  const int g = (S + kThreads * 8 - 1) / (kThreads * 8);
  return static_cast<unsigned>(g < 1 ? 1 : g);
}

struct HashArgs {
  const uint8_t* data;
  int S;
  int32_t* h;
  cudaStream_t stream;
};

static cudaError_t run_hash(void* p) {
  const HashArgs& a = *static_cast<HashArgs*>(p);
  find_matches_hash_kernel<<<grid_for(a.S), kThreads, 0, a.stream>>>(
      a.data, a.S, a.h);
  return cudaSuccess;
}

struct WalkArgs {
  const uint8_t* data;
  int S;
  const int32_t* hs;
  const int64_t* order;
  int32_t* prev;
  int K;
  int64_t* length;
  int64_t* dist;
  cudaStream_t stream;
};

static cudaError_t run_walk(void* p) {
  const WalkArgs& a = *static_cast<WalkArgs*>(p);
  find_matches_link_kernel<<<grid_for(a.S), kThreads, 0, a.stream>>>(
      a.hs, a.order, a.S, a.prev);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned tiles = static_cast<unsigned>((a.S + kTile - 1) / kTile);
  find_matches_walk_kernel<<<tiles, kThreads, 0, a.stream>>>(
      a.data, a.S, a.prev, a.K, a.length, a.dist);
  return cudaSuccess;
}

// h[i] (int32) of the S bytes of `data`, on `stream` of `device`. Returns
// the CUDA error (0 on success).
extern "C" int find_matches_hash_launch(const void* data, int64_t S, void* h,
                                        int device, void* stream) {
  if (S < 1 || S > 0x7FFFFFFF - kStage)
    return static_cast<int>(cudaErrorInvalidValue);
  HashArgs a{static_cast<const uint8_t*>(data), static_cast<int>(S),
             static_cast<int32_t*>(h), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(with_device(device, run_hash, &a));
}

// prev[] from the sorted hashes `hs` (int32) and the stable sort's `order`
// (int64) into `prev` (int32 scratch), then the walk into `length` and
// `dist` (int64[S]), K candidates in [1, 255].
extern "C" int find_matches_walk_launch(const void* data, int64_t S,
                                        const void* hs, const void* order,
                                        void* prev, int K, void* length,
                                        void* dist, int device, void* stream) {
  if (S < 1 || S > 0x7FFFFFFF - kStage || K < 1 || K > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{static_cast<const uint8_t*>(data), static_cast<int>(S),
             static_cast<const int32_t*>(hs),
             static_cast<const int64_t*>(order), static_cast<int32_t*>(prev),
             K, static_cast<int64_t*>(length), static_cast<int64_t*>(dist),
             static_cast<cudaStream_t>(stream)};
  return static_cast<int>(with_device(device, run_walk, &a));
}
