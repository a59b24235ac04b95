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
// `reset`); and they leave a tile's last two positions without a match, so
// lazy never looks across a tile either.
//
// Two launches on one stream:
//   * `lz_parse_match_kernel`: one CTA of 256 threads per 4 KB sub-tile
//     (256 CTAs for a 1 MB shard, so every SM works). Runs, the chain
//     rounds, the clamps and lazy reach at most 226 positions past a
//     position (the rounds reach i + 224 and lazy i + 2), and a run 258
//     bytes past those; so a CTA stages the bytes [q0 - 16, q0 + 4,640)
//     and (L, D) over the sub-tile and a halo of 256 positions, 16 bytes a
//     load with every load of a thread in flight, recomputes the halo and
//     waits for no other CTA. It writes the outputs as 16-byte vectors and
//     each position's token length max(L, 1) (16 bits) into a scratch
//     array in the parse's padded chunk layout. It reads (L, D) as
//     find_matches hands them over, packed in 4 bytes a position.
//   * `lz_parse_parse_kernel`: one CTA of 512 threads per 32 KB tile. One
//     bulk asynchronous copy (cp.async.bulk, completed on an mbarrier)
//     brings the tile's 66 KB of token lengths into shared memory; the
//     parse resolves 64-position chunks as the JAX parse's phases A-C do:
//     each thread walks its chunk right to left for the exit of every
//     position (64 steps), thread 0 threads the 512 chunk entries (512
//     dependent steps; a warp-wide form, each lane guessing its 16
//     chunks' entries and the lanes then correcting their guesses in
//     turn, was slower), and each thread marks its chunk's walk from its
//     entry; the flags go out as 16-byte vectors. The chunk arrays are
//     padded by 2 entries per 64 so the 32 threads of a warp, each on its
//     own chunk, read 32 banks.
//
// What bounds it on this card: device memory. Per position it reads the
// byte and the packed (L, D) (4 bytes), writes two int64 values and a
// bool, and the token length goes out and back (4 bytes): 26 bytes. The
// operations are a few dozen per position, far under the int32 rate.
//
// Domain: L in [0, 258] and D in [0, 32768], as find_matches gives them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32768;
constexpr int kSub = 4096;                // positions per match CTA
constexpr int kSubs = kTile / kSub;
constexpr int kMatchThreads = 256;
constexpr int kHalo = 256;                // >= 224 + 2: rounds and lazy
constexpr int kSpan = kSub + kHalo;       // positions with L and D staged
constexpr int kRunLook = 258;             // a run is capped at 258
constexpr int kWords = (kSpan + kRunLook + 31) / 32;    // break bitmap
constexpr int kBits = 32 * kWords;
constexpr int kLead = 16;                 // bytes staged before q0
constexpr int kBytes = kLead + kBits;     // b[q0 - 16 ...]
constexpr int kPerSpan = kSpan / kMatchThreads;
constexpr int kParseThreads = 512;
constexpr int kChunk = 64;
constexpr int kChunks = kTile / kChunk;   // == kParseThreads
constexpr int kPadded = kTile + 2 * kChunks;
constexpr unsigned kPaddedBytes = 2 * kPadded;
constexpr int kMaxMatch = 258;
constexpr int kMinMatch = 3;
constexpr uint16_t kNone = 0xFFFF;
constexpr size_t kParseSmem = 2 * kPaddedBytes + 2 * kChunks + 16;
constexpr int kMaxDevices = 64;
static_assert(kChunks == kParseThreads, "one chunk per thread");
static_assert(kSpan % kMatchThreads == 0 && kBytes % 16 == 0, "layout");
static_assert(kPaddedBytes % 16 == 0, "bulk copies move 16-byte units");
static_assert(kParseSmem <= 232448, "over the shared memory of a CTA");

bool g_smem_set[kMaxDevices];

__device__ __forceinline__ int pad(int q) { return q + 2 * (q >> 6); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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

// (L, D) from `packed`, uint32 L | D << 16.
__global__ void __launch_bounds__(kMatchThreads)
lz_parse_match_kernel(const uint8_t* __restrict__ data,
                      const uint32_t* __restrict__ packed, int64_t S,
                      int64_t valid_len, int lazy,
                      int64_t* __restrict__ len_out,
                      int64_t* __restrict__ dist_out,
                      uint16_t* __restrict__ tok_len) {
  __shared__ __align__(16) uint8_t sb[kBytes];          // b[q0 - 16 + k]
  __shared__ unsigned bits[kWords];
  __shared__ __align__(16) uint16_t sl[kSpan];
  __shared__ __align__(16) uint16_t sd[kSpan];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kSub;

  // ---- stage the bytes and (L, D), zero past S; all of a thread's loads
  // issued before its stores
  {
    constexpr int kN = kBytes / 16;
    constexpr int kPer = (kN + kMatchThreads - 1) / kMatchThreads;
    const bool vec = aligned16(data);
    uint4 v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kMatchThreads;
      const int64_t x = q0 - kLead + 16 * c;
      v[u] = make_uint4(0, 0, 0, 0);
      if (c < kN && vec && x >= 0 && x + 16 <= S)
        v[u] = __ldg(reinterpret_cast<const uint4*>(data + x));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kMatchThreads;
      if (c >= kN) break;
      const int64_t x = q0 - kLead + 16 * c;
      if (!(vec && x >= 0 && x + 16 <= S)) {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (x + k >= 0 && x + k < S)
            w[k >> 2] |= static_cast<unsigned>(data[x + k]) << (8 * (k & 3));
        v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(sb + 16 * c) = v[u];
    }
  }
  {
    constexpr int kN = kSpan / 4;                         // 4 a load
    constexpr int kPer = (kN + kMatchThreads - 1) / kMatchThreads;
    const bool vec = aligned16(packed);
    uint4 v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kMatchThreads;
      const int64_t p = q0 + 4 * c;
      v[u] = make_uint4(0, 0, 0, 0);
      if (c < kN && vec && p + 4 <= S)
        v[u] = __ldg(reinterpret_cast<const uint4*>(packed + p));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kMatchThreads;
      if (c >= kN) break;
      const int q = 4 * c;
      const int64_t p = q0 + q;
      unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (!(vec && p + 4 <= S)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = p + k < S ? packed[p + k] : 0u;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sl[q + k] = static_cast<uint16_t>(w[k] & 0xFFFF);
        sd[q + k] = static_cast<uint16_t>(w[k] >> 16);
      }
    }
  }
  __syncthreads();

  // ---- run breaks: b[p] != b[p-1], at p = 0 and at every p >= S
  for (int w = tid >> 5; w < kWords; w += kMatchThreads / 32) {
    const int q = 32 * w + lane;
    const int64_t p = q0 + q;
    const bool brk = p >= S || p == 0 || sb[kLead + q] != sb[kLead + q - 1];
    const unsigned m = __ballot_sync(0xFFFFFFFFu, brk);
    if (lane == 0) bits[w] = m;
  }
  __syncthreads();

  // ---- constant runs (each position reads and writes only its own slot)
  for (int q = tid; q < kSpan && q0 + q < S; q += kMatchThreads) {
    if ((bits[q >> 5] >> (q & 31)) & 1) continue;
    const int run = next_set(bits, q + 1, q + kRunLook) - q;
    if (run > sl[q]) {
      sl[q] = static_cast<uint16_t>(run);
      sd[q] = 1;
    }
  }
  __syncthreads();

  // ---- chain extension: three rounds, each on the last round's array
  // (the values of the halo's far end come out short, and nothing below
  // reads them)
#pragma unroll 1
  for (int s = 32; s <= 128; s <<= 1) {
    uint16_t nv[kPerSpan];
#pragma unroll
    for (int u = 0; u < kPerSpan; ++u) {
      const int q = tid + u * kMatchThreads;
      const int L = sl[q];
      const int D = sd[q];
      const int ls = q + s < kSpan ? sl[q + s] : 0;
      const int ds = q + s < kSpan ? sd[q + s] : 0;
      const bool can = L >= s + kMinMatch && ds == D && D > 0;
      nv[u] = static_cast<uint16_t>(can && s + ls > L ? s + ls : L);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerSpan; ++u) sl[tid + u * kMatchThreads] = nv[u];
    __syncthreads();
  }

  // ---- clamps, in place over the sub-tile and the halo
#pragma unroll
  for (int u = 0; u < kPerSpan; ++u) {
    const int q = tid + u * kMatchThreads;
    const int64_t p = q0 + q;
    int64_t L = 0;
    if (p < S) {
      L = sl[q] < kMaxMatch ? sl[q] : kMaxMatch;
      const int64_t room = valid_len - p > 0 ? valid_len - p : 0;
      if (L > room) L = room;
      const int edge = kTile - static_cast<int>(p % kTile);
      if (L > edge) L = edge;
      if (L < kMinMatch) L = 0;
    }
    sl[q] = static_cast<uint16_t>(L);
  }
  __syncthreads();

  // ---- lazy and the outputs, two positions a thread per step: int64
  // pairs as 16-byte stores, token lengths as one 32-bit store into the
  // tile's padded chunk layout (past S: 0, and token length 1)
  const bool vout = aligned16(len_out) && aligned16(dist_out);
  const int64_t tile = q0 / kTile;
  uint16_t* tl = tok_len + tile * kPadded;
  const int qt = static_cast<int>(q0 % kTile);
  for (int c = tid; c < kSub / 2; c += kMatchThreads) {
    const int q = 2 * c;
    int L[2], D[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int l = sl[q + k];
      const bool dem =
          lazy && l > 0 && (sl[q + k + 1] > l || sl[q + k + 2] > l + 1);
      L[k] = dem ? 0 : l;
      D[k] = dem ? 0 : sd[q + k];
    }
    const int64_t p = q0 + q;
    if (vout && p + 2 <= S) {
      *reinterpret_cast<longlong2*>(len_out + p) = make_longlong2(L[0], L[1]);
      *reinterpret_cast<longlong2*>(dist_out + p) = make_longlong2(D[0], D[1]);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (p + k < S) {
          len_out[p + k] = L[k];
          dist_out[p + k] = D[k];
        }
      }
    }
    const unsigned t0 = L[0] >= kMinMatch ? L[0] : 1;
    const unsigned t1 = L[1] >= kMinMatch ? L[1] : 1;
    *reinterpret_cast<unsigned*>(tl + pad(qt + q)) = t0 | t1 << 16;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kParseThreads, 1)
lz_parse_parse_kernel(const uint16_t* __restrict__ tok_len, int64_t S,
                      int64_t valid_len, uint8_t* __restrict__ chosen) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* tl = reinterpret_cast<uint16_t*>(smem);       // padded
  uint16_t* ex = reinterpret_cast<uint16_t*>(smem + kPaddedBytes);
  uint8_t* flag = smem + kPaddedBytes;      // over ex, after phase B
  uint16_t* entry = reinterpret_cast<uint16_t*>(smem + 2 * kPaddedBytes);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + 2 * kPaddedBytes + 2 * kChunks);
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;

  // ---- stage the tile's token lengths: one bulk copy on an mbarrier
  const unsigned b = smem_addr(bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(kPaddedBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(tl)), "l"(tok_len + blockIdx.x * kPadded),
           "r"(kPaddedBytes), "r"(b) : "memory");
  }
  __syncthreads();                          // the barrier is initialised
  for (unsigned done = 0; !done;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
  }

  // ---- phase A: each position's first walk position at or past its
  // chunk's end (successors move forward, so right to left resolves)
  {
    const int hi = (tid + 1) * kChunk;
    for (int q = hi - 1; q >= hi - kChunk; --q) {
      const int t = q + tl[pad(q)];
      ex[pad(q)] = static_cast<uint16_t>(t < hi ? ex[pad(t)] : t);
    }
  }
  __syncthreads();

  // ---- phase B: thread 0 threads the chunk entries
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
  {
    const int lo = tid * kChunk;
    for (int k = 0; k < kChunk; k += 2)
      *reinterpret_cast<uint16_t*>(flag + pad(lo) + k) = 0;
    if (entry[tid] != kNone)
      for (int q = entry[tid]; q < lo + kChunk; q += tl[pad(q)])
        flag[pad(q)] = 1;
  }
  __syncthreads();

  // ---- chosen: 16 positions a store
  const bool vec = aligned16(chosen);
  for (int c = tid; c < kTile / 16; c += kParseThreads) {
    const int q = 16 * c;
    const int64_t p = t0 + q;
    if (p >= S) break;
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (flag[pad(q + k)] && p + k < valid_len)
        w[k >> 2] |= 1u << (8 * (k & 3));
    if (vec && p + 16 <= S) {
      *reinterpret_cast<uint4*>(chosen + p) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
    } else {
      for (int k = 0; k < 16 && p + k < S; ++k)
        chosen[p + k] = (w[k >> 2] >> (8 * (k & 3))) & 1;
    }
  }
}

}  // namespace

// Launches both kernels on `stream` of `device` (made current for the call
// only if it is not) and returns the CUDA error (0 on success). `data` is
// u8[S]; (L, D) come from `packed` (uint32[S], L | D << 16); `chosen` is
// bool[S],
// `len_out`/`dist_out` int64[S] and `tok_len` 16-bit scratch of
// ceil(S / 32768) * 33,792 entries, all allocated by the caller; the
// outputs must not alias the inputs.
extern "C" int lz_parse_launch(const void* data, const void* packed,
                               int64_t S, int64_t valid_len, int lazy,
                               void* chosen, void* len_out, void* dist_out,
                               void* tok_len, int device, void* stream) {
  if (S < 1 || S > 0x7FFFFFFF || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess && !g_smem_set[device]) {
    e = cudaFuncSetAttribute(lz_parse_parse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kParseSmem));
    g_smem_set[device] = e == cudaSuccess;
  }
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned tiles = static_cast<unsigned>((S + kTile - 1) / kTile);
    const auto* d = static_cast<const uint8_t*>(data);
    auto* tl = static_cast<uint16_t*>(tok_len);
    auto* lo = static_cast<int64_t*>(len_out);
    auto* dd = static_cast<int64_t*>(dist_out);
    lz_parse_match_kernel<<<tiles * kSubs, kMatchThreads, 0, st>>>(
        d, static_cast<const uint32_t*>(packed), S, valid_len, lazy, lo, dd,
        tl);
    e = cudaGetLastError();
    if (e == cudaSuccess) {
      lz_parse_parse_kernel<<<tiles, kParseThreads, kParseSmem, st>>>(
          tl, S, valid_len, static_cast<uint8_t*>(chosen));
      e = cudaGetLastError();
    }
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
