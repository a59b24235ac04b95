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
//   back[i] = i - j for the nearest j < i with h[j] == h[i] if i - j <=
//             32768, else 0 (from one stable sort by hash: the sort is
//             glue, as jnp.argsort is glue there; a link past the window is
//             past every later position's window too);
// the candidates of i are i - back[i], then that one's link, ... (K of
// them at most, a hash collision using one up), and the walk stops at the
// first j with i - j > 32768. Each candidate scores nb = min(leading equal
// bytes, 11); the largest nb wins and ties go to the nearest, so the walk
// ends early once a candidate reaches 11. The winner is rescored to
// min(leading equal bytes, 35); length = min(that, 258, S - i), 0 under 3,
// and dist = i - j where length > 0.
//
// One C call on one stream: `find_matches_hash_kernel` (h as 16-bit keys
// and the positions 0..S-1), CUB's stable radix sort of the (key,
// position) pairs on the 16 key bits (glue, as jnp.argsort is glue in the
// JAX package: two passes over 6 bytes a position), then
// `find_matches_link_kernel` (back[] as 16-bit values, 0 for none) and
// `find_matches_walk_kernel`.
//
// What bounds it on this card: the bytes are S read and 4 written per
// position (the packed result, length | dist << 16, that tokenize hands to
// lz_parse); the operations are at least one load and one compare per
// candidate, far under the int32 rate. What
// sets the walk's time is latency: each step of a chain is a short run of
// dependent shared-memory loads and branches, so a warp issues one
// instruction every few dozen cycles, and the SMs that hold the busiest
// tiles (chains that run the full K) finish last. The walk's design:
//   * everything a chain touches is in shared memory: a CTA of 1,024
//     threads owns 4,096 positions [a, a + 4096) and stages, with
//     cp.async 16 bytes at a time, the bytes [a - 32768, a + 4139)
//     (36.9 KB) and the 16-bit links of [a - 32768, a + 4096) (73.7 KB),
//     so every hop and every compare is a shared-memory load; 110.7 KB
//     leave two CTAs, 64 warps, per SM;
//   * lanes that refill: each loop iteration moves every lane one
//     candidate along its own chain. A lane whose chain ends (K reached,
//     past the window, an 11-byte candidate, or no link) stores its
//     winner's distance and score in its position's output slot and goes
//     idle; once 8 lanes of a warp are idle they take the warp's next
//     positions, and the warp takes 32 at a time from a shared counter (a
//     refill costs shared-memory loads for the whole warp, so it is not
//     done for one lane), so a warp does not wait for its longest chain
//     once per position;
//   * the rescore of the winners to 35 bytes and the outputs come after
//     the walk, one position a thread in order: in the walk, a lane that
//     rescored would hold up the other 31 in nearly every iteration;
//   * the position's first 12 bytes stay in registers; a candidate is
//     first checked at one byte, the one past the best score so far (it
//     can win only if that byte is equal, so the check turns most of a
//     long chain away with one load), and only then compared as words (a
//     funnel shift of two aligned words), four bytes per compare.
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // hash and link kernels
constexpr int kWalkThreads = 1024;
constexpr int kRefill = 8;                // idle lanes that start a refill
constexpr int kTile = 4096;               // positions per walk CTA
constexpr int kWindow = 32768;
constexpr int kPreselect = 11;            // bytes scored per candidate
constexpr int kRescore = 35;              // bytes scored for the winner
constexpr int kMaxMatch = 258;
constexpr int kMinMatch = 3;
// bytes staged per CTA: the window, the tile, the rescore's 35 and the
// rest of the last word pair that a compare reads
constexpr int kStage = kWindow + kTile + kRescore + 8;
constexpr int kStageAlloc = (kStage + 15) / 16 * 16;
constexpr int kLinks = kWindow + kTile;   // 16-bit links staged per CTA
constexpr size_t kSmem = kStageAlloc + 2 * kLinks + 16;
constexpr unsigned kHashMul = 2654435761u;
constexpr int kMaxDevices = 64;
static_assert(kLinks % 8 == 0 && kTile % 8 == 0, "16-byte link chunks");
static_assert(2 * (kSmem + 1024) <= 233472, "two walk CTAs per SM");

bool g_smem_set[kMaxDevices];

__global__ void __launch_bounds__(kThreads)
find_matches_hash_kernel(const uint8_t* __restrict__ data, int S,
                         uint16_t* __restrict__ h, int32_t* __restrict__ pos) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < S;
       i += gridDim.x * kThreads) {
    const unsigned b0 = data[i];
    const unsigned b1 = i + 1 < S ? data[i + 1] : 0u;
    const unsigned b2 = i + 2 < S ? data[i + 2] : 0u;
    h[i] = static_cast<uint16_t>(((b0 | b1 << 8 | b2 << 16) * kHashMul) >> 16);
    pos[i] = i;
  }
}

// back[order[j]] = order[j] - order[j-1] where both have the same hash and
// lie within the window of each other, else 0. hs = h[order], sorted.
__global__ void __launch_bounds__(kThreads)
find_matches_link_kernel(const uint16_t* __restrict__ hs,
                         const int32_t* __restrict__ order, int S,
                         uint16_t* __restrict__ back) {
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < S;
       j += gridDim.x * kThreads) {
    const int i = order[j];
    int d = 0;
    if (j > 0 && hs[j - 1] == hs[j]) {
      d = i - order[j - 1];
      if (d > kWindow) d = 0;
    }
    back[i] = static_cast<uint16_t>(d);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
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

// min(leading equal bytes, 11) of the position whose first 12 bytes are
// m0..m2 and the candidate at byte offset c.
__device__ __forceinline__ int preselect(const unsigned* w, unsigned m0,
                                         unsigned m1, unsigned m2, int c) {
  unsigned x = m0 ^ bytes4(w, c);
  if (x) return (__ffs(x) - 1) >> 3;
  x = m1 ^ bytes4(w, c + 4);
  if (x) return 4 + ((__ffs(x) - 1) >> 3);
  x = m2 ^ bytes4(w, c + 8);
  const int n = x ? 8 + ((__ffs(x) - 1) >> 3) : 12;
  return n < kPreselect ? n : kPreselect;
}

// out32[i] = length | dist << 16.
__global__ void __launch_bounds__(kWalkThreads, 2)
find_matches_walk_kernel(const uint8_t* __restrict__ data, int S,
                         const uint16_t* __restrict__ back, int K,
                         uint32_t* __restrict__ out32) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sb = smem;                       // sb[x - base] holds b[x]
  uint16_t* sl = reinterpret_cast<uint16_t*>(smem + kStageAlloc);
  int* next = reinterpret_cast<int*>(smem + kStageAlloc + 2 * kLinks);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int a = blockIdx.x * kTile;
  const int base = a - kWindow;             // sl[x - base] holds back[x]

  // ---- stage the bytes (zero past S; nothing reads before 0) and the
  // links (the caller pads back[] to a multiple of 8 entries; nothing
  // reads a link past S or before 0)
  const bool vec = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  for (int c = tid; c < kStageAlloc / 16; c += kWalkThreads) {
    const int x = base + 16 * c;
    if (x + 16 <= 0) continue;
    if (vec && x >= 0 && x + 16 <= S) {
      cp_async16(sb + 16 * c, data + x);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        sb[16 * c + k] = x + k >= 0 && x + k < S ? data[x + k] : 0;
    }
  }
  for (int c = tid; c < kLinks / 8; c += kWalkThreads) {
    const int x = base + 8 * c;
    if (x >= 0 && x < S) cp_async16(sl + 8 * c, back + x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid == 0) *next = 0;  // the CTA's next position, 32 a warp
  __syncthreads();

  // ---- the walk: one chain per lane, a lane refilled when its ends
  const unsigned* sw = reinterpret_cast<const unsigned*>(sb);
  const int n = S - a < kTile ? S - a : kTile;
  const unsigned below = (1u << lane) - 1;
  int i = -1, me = 0, cand = -1, k = 0, best = -1, best_nb = -1;
  unsigned m0 = 0, m1 = 0, m2 = 0, mbyte = 0;
  int wnext = 0, wend = 0;                  // the warp's run of positions
  for (;;) {
    const unsigned idle = __ballot_sync(0xFFFFFFFFu, i < 0);
    // refill once kRefill lanes are idle (or all are): the idle lanes take
    // the warp's next positions in lane order, and the warp takes 32 more
    // from the CTA's counter when its run is used up
    unsigned want = __popc(idle) >= kRefill || idle == 0xFFFFFFFFu ? idle
                                                                    : 0u;
    while (want) {
      if (wnext >= wend) {
        int q = 0;
        if (lane == 0) q = atomicAdd(next, 32);
        q = __shfl_sync(0xFFFFFFFFu, q, 0);
        if (q >= n) break;
        wnext = q;
        wend = q + 32 < n ? q + 32 : n;
      }
      const int r = __popc(want & below);
      const bool mine = (want >> lane) & 1 && r < wend - wnext;
      const unsigned took = __ballot_sync(0xFFFFFFFFu, mine);
      wnext += __popc(took);
      want &= ~took;
      if (mine) {
        i = a + wnext - __popc(took) + r;
        me = i - base;
        {
          const unsigned* w = sw + (me >> 2);
          const unsigned sh = (me & 3) * 8, w1 = w[1], w2 = w[2];
          m0 = __funnelshift_r(w[0], w1, sh);
          m1 = __funnelshift_r(w1, w2, sh);
          m2 = __funnelshift_r(w2, w[3], sh);
        }
        const int d = sl[i - base];
        cand = d ? i - d : -1;
        k = 0;
        best = -1;
        best_nb = -1;
      }
    }
    if (!__any_sync(0xFFFFFFFFu, i >= 0)) break;
    if (i < 0) continue;
    bool open = cand >= 0 && k < K && i - cand <= kWindow;
    if (open) {
      // a candidate beats best_nb only if its byte at best_nb is equal: one
      // byte load turns most of a long chain's candidates away
      int nb = 0;
      if (best_nb < 0 || sb[cand - base + best_nb] == mbyte) {
        nb = preselect(sw, m0, m1, m2, cand - base);
        if (nb > best_nb) {                 // strict: the nearest wins
          best_nb = nb;
          best = cand;
          if (nb < kPreselect)
            mbyte = ((nb < 4 ? m0 : nb < 8 ? m1 : m2) >> (8 * (nb & 3))) &
                    0xFF;
        }
      }
      const int d = sl[cand - base];
      cand = d ? cand - d : -1;
      ++k;
      // no later candidate can beat 11 bytes
      open = nb < kPreselect && cand >= 0 && k < K && i - cand <= kWindow;
    }
    if (!open) {
      // the chain is over: the winner's distance and score for the rescore
      // below, in the output's own slot
      const unsigned t = best >= 0 ? static_cast<unsigned>(i - best) |
                                         static_cast<unsigned>(best_nb) << 16
                                   : 0u;
      out32[i] = t;
      i = -1;
    }
  }
  __syncthreads();

  // ---- the rescore and the outputs, one position a thread, in order
  for (int q = tid; q < n; q += kWalkThreads) {
    const int i = a + q;
    const unsigned t = out32[i];
    const int d = t & 0xFFFF;
    const int nb = t >> 16;
    int len = 0;
    if (d > 0) {
      // the first nb bytes are equal and, under 11, the next differs
      len = nb < kPreselect
                ? nb
                : equal_run(sw, q + kWindow, q + kWindow - d, kPreselect,
                            kRescore);
      if (len > S - i) len = S - i;         // equality in the padding is fake
      if (len > kMaxMatch) len = kMaxMatch;
      if (len < kMinMatch) len = 0;
    }
    out32[i] = static_cast<unsigned>(len) |
               static_cast<unsigned>(len > 0 ? d : 0) << 16;
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

struct Args {
  const uint8_t* data;
  int S;
  uint16_t* h;
  uint16_t* hs;
  int32_t* pos;
  int32_t* order;
  void* temp;
  size_t temp_bytes;
  uint16_t* back;
  int K;
  uint32_t* out32;
  int device;
  cudaStream_t stream;
};

static cudaError_t run(void* p) {
  const Args& a = *static_cast<Args*>(p);
  if (!g_smem_set[a.device]) {
    cudaError_t e = cudaFuncSetAttribute(
        find_matches_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(find_matches_walk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (e != cudaSuccess) return e;
    g_smem_set[a.device] = true;
  }
  find_matches_hash_kernel<<<grid_for(a.S), kThreads, 0, a.stream>>>(
      a.data, a.S, a.h, a.pos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  size_t bytes = a.temp_bytes;
  e = cub::DeviceRadixSort::SortPairs(a.temp, bytes, a.h, a.hs, a.pos,
                                      a.order, a.S, 0, 16, a.stream);
  if (e != cudaSuccess) return e;
  find_matches_link_kernel<<<grid_for(a.S), kThreads, 0, a.stream>>>(
      a.hs, a.order, a.S, a.back);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned tiles = static_cast<unsigned>((a.S + kTile - 1) / kTile);
  find_matches_walk_kernel<<<tiles, kWalkThreads, kSmem, a.stream>>>(
      a.data, a.S, a.back, a.K, a.out32);
  return cudaSuccess;
}

// The bytes of scratch the sort needs for S positions, into *bytes.
// Returns the CUDA error (0 on success); launches nothing.
extern "C" int find_matches_temp_bytes(int64_t S, int64_t* bytes) {
  if (S < 1 || S > 0x7FFFFFFF - kStage)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t n = 0;
  const cudaError_t e = cub::DeviceRadixSort::SortPairs(
      nullptr, n, static_cast<const uint16_t*>(nullptr),
      static_cast<uint16_t*>(nullptr), static_cast<const int32_t*>(nullptr),
      static_cast<int32_t*>(nullptr), static_cast<int>(S), 0, 16);
  *bytes = static_cast<int64_t>(n);
  return static_cast<int>(e);
}

// The match finder on the S bytes of `data`, on `stream` of `device` (made
// current for the call only if it is not), K candidates in [1, 255], into
// `out32` (uint32[S], length | dist << 16). Scratch, allocated by the
// caller: `h`, `hs` (16-bit, S each), `pos`, `order` (int32, S each),
// `temp` (the sort's `temp_bytes`, from find_matches_temp_bytes) and
// `back` (16-bit, S rounded up to 8 entries). Returns the CUDA error (0 on success).
extern "C" int find_matches_launch(const void* data, int64_t S, void* h,
                                   void* hs, void* pos, void* order,
                                   void* temp, int64_t temp_bytes,
                                   void* back, int K, void* out32,
                                   int device, void* stream) {
  if (S < 1 || S > 0x7FFFFFFF - kStage || K < 1 || K > 255 || device < 0 ||
      device >= kMaxDevices || temp_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(data), static_cast<int>(S),
         static_cast<uint16_t*>(h), static_cast<uint16_t*>(hs),
         static_cast<int32_t*>(pos), static_cast<int32_t*>(order), temp,
         static_cast<size_t>(temp_bytes), static_cast<uint16_t*>(back), K,
         static_cast<uint32_t*>(out32), device,
         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(with_device(device, run, &a));
}
