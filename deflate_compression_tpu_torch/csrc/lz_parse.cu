// The LZ77 stage after the match finder, for Hopper (sm_90a), plain C
// interface: constant runs, chain extension, clamps, lazy matching and the
// greedy parse of one shard.
//
// Stands for deflate_compression_tpu/core/lz77.py::tokenize after
// find_matches (:497-577) and greedy_parse (:340-464), which the JAX
// package left to XLA: they have no Pallas kernel. With b[x] the shard's
// bytes, (L, D) find_matches' lengths and distances (0 past S), T = 32768:
//   runs     where b[i] == b[i-1], run = min(run_end - i, 258) replaces L
//            (D = 1) if it is strictly longer;
//   chain    for s = 32, 64, 128, each round over the array the last one
//            left: L = max(L, s + L[i+s]) where L >= s+3, D[i+s] == D > 0;
//            then L = min(L, 258);
//   clamps   L = min(L, max(valid_len - i, 0), T - i % T), 0 under 3 (D is
//            left as it is);
//   lazy     where L[i+1] > L or L[i+2] > L + 1 on the clamped lengths, L
//            and D are zeroed;
//   parse    chosen = the orbit of 0 under i + max(L, 1), and i < valid_len.
// The clamps make every multiple of T a token start, so the orbit is the
// union of each tile's own walk from its first position (the JAX parse's
// `reset`).
//
// Grid: one CTA of 512 threads per 32 KB tile, in shared memory (169 KB):
// the bytes [t0 - 1, t0 + 33,295), a bitmap of run breaks, and L and D as
// 16-bit values over the tile and a halo of 224 positions (the three
// rounds reach i + 224). So the CTA recomputes the runs and the chain on
// its halo and waits for no other CTA. A run's end is the next set bit of
// the break bitmap, at most nine words on (the JAX package's reverse cummin
// over the shard). Each round computes its values in registers, then
// stores them after a barrier, so it reads only the last round's array.
// The parse resolves 64-position chunks as the JAX parse's phases A-C do:
// each thread walks its chunk right to left for the exit of every position
// (64 steps), thread 0 threads the 512 chunk entries (512 dependent steps),
// and each thread marks its chunk's walk from its entry (64 steps). The
// chunk arrays are padded by 2 entries per 64 so the 32 threads of a warp,
// each on its own chunk, read 32 banks.
//
// What bounds it on this card: device memory. Per position it reads the
// byte and two int64 values and writes two int64 values and a bool, 34
// bytes; the operations are a few dozen per position, far under the int32
// rate. A 1 MB shard runs 32 CTAs, so each moves 1.1 MB on one SM, and
// thread 0's 512 dependent steps add their latency.
//
// Domain: L in [0, 258] and D in [0, 32768], as find_matches gives them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 32768;
constexpr int kHalo = 32 + 64 + 128;      // the chain rounds' reach
constexpr int kSpan = kTile + kHalo;      // positions with L and D staged
constexpr int kRunLook = 258;             // a run is capped at 258
constexpr int kWords = (kSpan + kRunLook + 31) / 32;    // break bitmap
constexpr int kBits = 32 * kWords;
constexpr int kBytes = (kBits + 1 + 15) / 16 * 16;      // b[t0 - 1 ...]
constexpr int kChunk = 64;
constexpr int kChunks = kTile / kChunk;   // == kThreads
constexpr int kPadded = kTile + 2 * kChunks;
constexpr int kSlots = kPadded > kSpan ? kPadded : kSpan;
constexpr int kPerSpan = (kSpan + kThreads - 1) / kThreads;
constexpr int kPerTile = kTile / kThreads;
constexpr int kMaxMatch = 258;
constexpr int kMinMatch = 3;
constexpr uint16_t kNone = 0xFFFF;
constexpr size_t kSmem = kBytes + 4 * kWords + 2 * 2 * kSlots;
constexpr int kMaxDevices = 64;
static_assert(kChunks == kThreads, "one chunk per thread");
static_assert(kSmem <= 232448, "over the shared memory of a CTA");

bool g_smem_set[kMaxDevices];

__device__ __forceinline__ int pad(int q) { return q + 2 * (q >> 6); }

// First set bit of `bits` in [from, lim), or lim.
__device__ __forceinline__ int next_set(const unsigned* bits, int from,
                                        int lim) {
  for (int r = from; r < lim; r = (r | 31) + 1) {
    const unsigned w = bits[r >> 5] >> (r & 31);
    if (w) {
      const int f = r + __ffs(w) - 1;
      return f < lim ? f : lim;
    }
  }
  return lim;
}

__global__ void __launch_bounds__(kThreads, 1)
lz_parse_kernel(const uint8_t* __restrict__ data,
                const int64_t* __restrict__ len_in,
                const int64_t* __restrict__ dist_in, int64_t S,
                int64_t valid_len, int lazy, uint8_t* __restrict__ chosen,
                int64_t* __restrict__ len_out,
                int64_t* __restrict__ dist_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sb = smem;                                     // b[t0 - 1 + k]
  unsigned* bits = reinterpret_cast<unsigned*>(smem + kBytes);
  uint16_t* sl = reinterpret_cast<uint16_t*>(smem + kBytes + 4 * kWords);
  uint16_t* sd = sl + kSlots;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;

  // ---- stage the bytes and (L, D), zero past S
  for (int k = tid; k < kBytes; k += kThreads) {
    const int64_t x = t0 - 1 + k;
    sb[k] = (x >= 0 && x < S) ? data[x] : 0;
  }
  for (int q = tid; q < kSpan; q += kThreads) {
    const int64_t p = t0 + q;
    sl[q] = p < S ? static_cast<uint16_t>(len_in[p]) : 0;
    sd[q] = p < S ? static_cast<uint16_t>(dist_in[p]) : 0;
  }
  __syncthreads();

  // ---- run breaks: b[p] != b[p-1], at p = 0 and at every p >= S
  for (int w = tid >> 5; w < kWords; w += kThreads / 32) {
    const int q = 32 * w + lane;
    const int64_t p = t0 + q;
    const bool brk = p >= S || p == 0 || sb[q + 1] != sb[q];
    const unsigned m = __ballot_sync(0xFFFFFFFFu, brk);
    if (lane == 0) bits[w] = m;
  }
  __syncthreads();

  // ---- constant runs (each position reads and writes only its own slot)
  for (int q = tid; q < kSpan && t0 + q < S; q += kThreads) {
    if ((bits[q >> 5] >> (q & 31)) & 1) continue;
    const int run = next_set(bits, q + 1, q + kRunLook) - q;
    if (run > sl[q]) {
      sl[q] = static_cast<uint16_t>(run);
      sd[q] = 1;
    }
  }
  __syncthreads();

  // ---- chain extension: three rounds, each on the last round's array
#pragma unroll 1
  for (int s = 32; s <= 128; s <<= 1) {
    uint16_t nv[kPerSpan];
#pragma unroll
    for (int u = 0; u < kPerSpan; ++u) {
      const int q = tid + u * kThreads;
      if (q < kSpan) {
        const int L = sl[q];
        const int D = sd[q];
        const int ls = q + s < kSpan ? sl[q + s] : 0;
        const int ds = q + s < kSpan ? sd[q + s] : 0;
        const bool can = L >= s + kMinMatch && ds == D && D > 0;
        nv[u] = static_cast<uint16_t>(can && s + ls > L ? s + ls : L);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerSpan; ++u) {
      const int q = tid + u * kThreads;
      if (q < kSpan) sl[q] = nv[u];
    }
    __syncthreads();
  }

  // ---- clamps, in place over the tile
  for (int q = tid; q < kTile; q += kThreads) {
    const int64_t p = t0 + q;
    int64_t L = 0;
    if (p < S) {
      L = sl[q] < kMaxMatch ? sl[q] : kMaxMatch;
      const int64_t room = valid_len - p > 0 ? valid_len - p : 0;
      if (L > room) L = room;
      if (L > kTile - q) L = kTile - q;
      if (L < kMinMatch) L = 0;
    }
    sl[q] = static_cast<uint16_t>(L);
  }
  __syncthreads();

  // ---- lazy: demotion bits on the clamped lengths (the bitmap is free);
  // a warp's 32 positions are consecutive
  for (int q = tid; q < kTile; q += kThreads) {
    const int L = sl[q];
    const int l1 = q + 1 < kTile ? sl[q + 1] : 0;
    const int l2 = q + 2 < kTile ? sl[q + 2] : 0;
    const bool dem = lazy && L > 0 && (l1 > L || l2 > L + 1);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, dem);
    if (lane == 0) bits[q >> 5] = m;
  }
  __syncthreads();

  // ---- outputs, and each position's token length kept for the parse
  uint16_t keep[kPerTile];
#pragma unroll
  for (int u = 0; u < kPerTile; ++u) {
    const int q = tid + u * kThreads;
    const int64_t p = t0 + q;
    const bool dem = (bits[q >> 5] >> (q & 31)) & 1;
    const int L = dem ? 0 : sl[q];
    if (p < S) {
      len_out[p] = L;
      dist_out[p] = dem ? 0 : sd[q];
    }
    keep[u] = static_cast<uint16_t>(L >= kMinMatch ? L : 1);
  }
  __syncthreads();
  // token lengths and successors in the padded chunk layout; chosen flags
  // in the byte buffer
  uint16_t* tl = sl;
  uint16_t* ex = sd;
#pragma unroll
  for (int u = 0; u < kPerTile; ++u) {
    const int q = tid + u * kThreads;
    tl[pad(q)] = keep[u];
    ex[pad(q)] = static_cast<uint16_t>(q + keep[u]);
    sb[q] = 0;
  }
  __syncthreads();

  // ---- parse, phase A: each position's first walk position at or past
  // its chunk's end (successors move forward, so right to left resolves)
  {
    const int hi = (tid + 1) * kChunk;
    for (int q = hi - 1; q >= hi - kChunk; --q) {
      const int t = ex[pad(q)];
      if (t < hi) ex[pad(q)] = ex[pad(t)];
    }
  }
  __syncthreads();

  // ---- phase B: thread 0 threads the chunk entries
  uint16_t* entry = reinterpret_cast<uint16_t*>(bits);
  if (tid == 0) {
    int p = 0;
    for (int c = 0; c < kChunks; ++c) {
      if (p < (c + 1) * kChunk) {
        entry[c] = static_cast<uint16_t>(p);
        p = ex[pad(p)];
      } else {
        entry[c] = kNone;
      }
    }
  }
  __syncthreads();

  // ---- phase C: each thread marks its chunk's walk from its entry
  if (entry[tid] != kNone) {
    const int hi = (tid + 1) * kChunk;
    for (int q = entry[tid]; q < hi; q += tl[pad(q)]) sb[q] = 1;
  }
  __syncthreads();

  for (int q = tid; q < kTile; q += kThreads) {
    const int64_t p = t0 + q;
    if (p < S) chosen[p] = sb[q] && p < valid_len;
  }
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `data` is u8[S],
// `len_in`/`dist_in` int64[S] (find_matches' result), `chosen` bool[S] and
// `len_out`/`dist_out` int64[S], all allocated by the caller; the outputs
// must not alias the inputs.
extern "C" int lz_parse_launch(const void* data, const void* len_in,
                               const void* dist_in, int64_t S,
                               int64_t valid_len, int lazy, void* chosen,
                               void* len_out, void* dist_out, int device,
                               void* stream) {
  if (S < 1 || S > 0x7FFFFFFF || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess && !g_smem_set[device]) {
    e = cudaFuncSetAttribute(lz_parse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
    g_smem_set[device] = e == cudaSuccess;
  }
  if (e == cudaSuccess) {
    const unsigned tiles = static_cast<unsigned>((S + kTile - 1) / kTile);
    lz_parse_kernel<<<tiles, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data),
        static_cast<const int64_t*>(len_in),
        static_cast<const int64_t*>(dist_in), S, valid_len, lazy,
        static_cast<uint8_t*>(chosen), static_cast<int64_t*>(len_out),
        static_cast<int64_t*>(dist_out));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
