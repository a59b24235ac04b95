// Phase C's bytes of the indexed DEFLATE decoder, from the tokens to the
// resolved output, for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX decoder left this stage to XLA
// (deflate_compression_tpu/decode/tpu_inflate.py:600-841: scatters,
// cumulative maxima over the output and gather rounds). In plain PyTorch it
// is four torch.cummax calls over int64[S], each of which also writes an
// int64 index nobody reads, and a host loop over the stored blocks.
//
// What it computes (exactly ops/copy_sources.py::resolve_bytes_ref: the
// bytes, bad_dist and unconverged; the pointers in between need not be
// equal). Per output position j < S:
//  * its literal value: the token's literal, else the prefix byte below
//    prefix_len, else 0;
//  * whether a live block covers it and whether the covering block (the
//    highest block index among the blocks that start at or before j) is
//    stored;
//  * the stored blocks' bytes, copied from the stream, later blocks winning;
//  * its covering token, the last valid token at or before j, however far
//    back, and that token's distance d (0 for a literal);
//  * for a match position its source g = r - d + (j - r) % d, r the start
//    of the run of positions with the same distance, so a run of any
//    length costs one step; bad_dist if g < 0;
//  * v[j] = TAG | g or the literal value, then pointer doubling until no
//    TAG is left, at most `rounds` times (unconverged otherwise).
//
// What bounds it on this card. It must read the tokens (4 bytes per
// position) and write the bytes (1 per position): 168 MB for 33.5 M
// positions, 50 us at 3.35 TB/s. The passes here move about 25 bytes per
// position before the rounds, and each round reads 4 bytes per position
// plus a 4-byte gather and a 4-byte store per pointer still open.
//
// What the design does about it:
//  * The two block-coverage scans forward-fill NB marks, not S values: one
//    kernel ranks the blocks by start (NB^2 compares, NB is a few thousand
//    at most) with the prefix maxima of their ends and indices, and every
//    position finds its block by a search that its tile's bracket narrows
//    to a step or none.
//  * The covering token and the run start are the two unbounded look-backs
//    (a stored or dead region has no tokens, a 4 MB zero run is one run).
//    Each is a real scan written here in three kernels: per-tile last
//    flagged position, a one-CTA scan of the tile totals, and the tile's
//    own scan seeded with its carry. Tiles are 2,048 positions, 8 per
//    thread, staged through shared memory so that device memory is read and
//    written coalesced.
//  * v holds 32 bits per position, TAG in bit 31, so S < 2^31.
//  * The stored copies take 16 CTAs per stored block; a CTA whose block no
//    later stored block overlaps copies without a check (every block of a
//    valid stream), else it skips the bytes a later block covers.
//  * The rounds update v in place (a source read in its newer state only
//    jumps further) with 16-byte loads; each round raises a device flag if
//    it left a pointer, and the next round's CTAs return at once when the
//    flag is down, so all `rounds` launches are queued and nothing waits for
//    the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // positions per thread
constexpr int kTile = kThreads * kPer;     // 2048 (ops/copy_sources.py TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr uint32_t kTag = 0x80000000u;
constexpr int64_t kWsto = 1 << 16;         // a stored block's byte cap
constexpr int kStoredChunks = 16;          // CTAs per stored block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

int g_sms[kMaxDevices];                    // SM count per device, 0: unknown

struct Params {
  const int64_t* words;        // u32 values
  int64_t n_words;
  const int32_t* tok;
  int64_t S;
  const int64_t* blk_bit;
  const int64_t* blk_out;
  const int64_t* blk_end;
  const uint8_t* blive;
  const uint8_t* is_sto;
  int32_t nb;
  const uint8_t* prefix;       // or null
  int64_t prefix_n;            // prefix bytes that lie inside the output
  const int64_t* plen_ptr;     // on the device, or null: plen_val
  int64_t plen_val;
  uint32_t* v;
  int32_t* tile_last;          // per tile: last valid token, -1 if none
  int32_t* carry1;             // ... before the tile
  int32_t* tile_chg;           // per tile: last run start
  int32_t* carry2;
  int32_t* prev_rd;            // per tile: rd of the position before it
  int32_t* st_start;           // blocks by start: start, prefix max of the
  int32_t* st_end;             //   ends, prefix max of the indices << 1 |
  int32_t* st_mark;            //   stored
  int32_t* flags;              // [0] bad_dist [1] unconverged [2 + r] open
  uint8_t* out;
};

__device__ __forceinline__ int64_t prefix_len(const Params& p) {
  if (!p.prefix) return 0;
  return p.plen_ptr ? *p.plen_ptr : p.plen_val;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// The maximum of x over the CTA, in every thread; s_w holds kWarps ints.
__device__ int cta_max(int x, int* s_w) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = x;
  __syncthreads();
  int m = s_w[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = max(m, s_w[w]);
  __syncthreads();
  return m;
}

// In: last[e] is position e of this thread's kPer consecutive positions if
// it is flagged, else -1. Out: the last flagged position at or before each,
// `carry` standing for everything before the tile.
__device__ void scan_last(int (&last)[kPer], int carry, int* s_w) {
#pragma unroll
  for (int e = 1; e < kPer; ++e) last[e] = max(last[e], last[e - 1]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = last[kPer - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  int pre = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) pre = -1;
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  pre = max(pre, carry);
  for (int w = 0; w < warp; ++w) pre = max(pre, s_w[w]);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPer; ++e) last[e] = max(last[e], pre);
}

// The number of blocks that start at or before j, searched in [lo, hi].
__device__ __forceinline__ int starts_upto(const Params& p, int64_t j, int lo,
                                           int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.st_start[mid] <= j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Cover {
  bool live;                   // a live block covers the position
  bool sto;                    // the covering block is stored
};

__device__ __forceinline__ Cover cover_at(const Params& p, int64_t j, int lo,
                                          int hi) {
  const int k = starts_upto(p, j, lo, hi) - 1;
  Cover c = {false, false};
  if (k >= 0) {
    c.live = j < p.st_end[k];
    c.sto = p.st_mark[k] & 1;
  }
  return c;
}

__device__ __forceinline__ uint32_t base_lit(const Params& p, int64_t j,
                                             int32_t t, int64_t plen) {
  if (((t >> 25) & 1) && !((t >> 26) & 1)) return t & 0x1FF;
  return j < plen && j < p.prefix_n ? p.prefix[j] : 0;
}

// The run distance of position j whose covering token is at sj (-1: none):
// the token's distance where j is a match position, else 0.
__device__ __forceinline__ int run_dist(const Params& p, int64_t j,
                                        int32_t tcov, int64_t plen, int lo,
                                        int hi) {
  const int d = ((tcov >> 26) & 1) ? (tcov >> 9) & 0xFFFF : 0;
  if (d == 0 || j < plen) return 0;
  const Cover c = cover_at(p, j, lo, hi);
  return c.live && !c.sto ? d : 0;
}

// ------------------------------------------------------- blocks by start

// One thread per block slot: its rank among the slots by (start, index),
// and the maxima of the ends and of the indices over the slots at or before
// it in that order. A slot that is dead or starts outside the output sorts
// last (start S) and is never found.
__global__ void __launch_bounds__(kThreads)
copy_sources_order_kernel(Params p) {
  __shared__ int32_t s_start[kThreads], s_end[kThreads];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  auto start_of = [&](int i) -> int32_t {
    const int64_t o = p.blk_out[i];
    return p.blive[i] && o >= 0 && o < p.S ? static_cast<int32_t>(o)
                                           : static_cast<int32_t>(p.S);
  };
  const int32_t start = b < p.nb ? start_of(b) : 0;
  int rank = 0, pm_end = 0, pm_b = -1;
  for (int c0 = 0; c0 < p.nb; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    if (i < p.nb) {
      s_start[threadIdx.x] = start_of(i);
      const int64_t e = p.blk_end[i];
      s_end[threadIdx.x] =
          static_cast<int32_t>(e < 0 ? 0 : e > p.S ? p.S : e);
    }
    __syncthreads();
    const int n = min(kThreads, p.nb - c0);
    if (b < p.nb) {
      for (int k = 0; k < n; ++k) {
        const int32_t sk = s_start[k];
        const int bi = c0 + k;
        const bool less = sk < start || (sk == start && bi < b);
        rank += less;
        if ((less || bi == b) && sk < p.S) {
          pm_end = max(pm_end, s_end[k]);
          pm_b = max(pm_b, bi);
        }
      }
    }
    __syncthreads();
  }
  if (b < p.nb) {
    p.st_start[rank] = start;
    p.st_end[rank] = pm_end;
    p.st_mark[rank] = pm_b < 0 ? 0 : (pm_b << 1) | (p.is_sto[pm_b] ? 1 : 0);
  }
}

// ------------------------------------------------------------ the scans

// Per tile, the last position that holds a valid token (-1: none).
__global__ void __launch_bounds__(kThreads)
copy_sources_last_token_kernel(Params p) {
  __shared__ int s_w[kWarps];
  const int64_t base = int64_t{blockIdx.x} * kTile;
  int m = -1;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t j = base + e * kThreads + threadIdx.x;
    if (j < p.S && ((p.tok[j] >> 25) & 1)) m = static_cast<int>(j);
  }
  m = cta_max(m, s_w);
  if (threadIdx.x == 0) p.tile_last[blockIdx.x] = m;
}

// out[i] = max(in[0..i)), -1 for i = 0: one CTA walks the tiles' totals.
__global__ void __launch_bounds__(kScanThreads)
copy_sources_scan_kernel(const int32_t* in, int32_t* out, int64_t n) {
  __shared__ int s_w[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = -1;
  for (int64_t c0 = 0; c0 < n; c0 += kScanThreads) {
    const int64_t i = c0 + threadIdx.x;
    int x = i < n ? in[i] : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    int pre = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) pre = -1;
    if (lane == 31) s_w[warp] = x;
    __syncthreads();
    pre = max(pre, carry);
    for (int w = 0; w < warp; ++w) pre = max(pre, s_w[w]);
    if (i < n) out[i] = pre;
    int total = carry;
    for (int w = 0; w < 32; ++w) total = max(total, s_w[w]);
    carry = total;
    __syncthreads();
  }
}

// Per tile: every position's covering token and run distance rd; v[j] =
// TAG | rd at a match position, else the literal value; the tile's last
// run start (a position whose rd differs from the one before it), and the
// rd of the position before the tile.
__global__ void __launch_bounds__(kThreads)
copy_sources_mark_kernel(Params p) {
  __shared__ int32_t s_tok[kTile];
  __shared__ int s_w[kWarps];
  __shared__ int s_rd_last[kThreads];
  __shared__ int s_lo, s_hi, s_prev;
  const int tid = threadIdx.x;
  const int64_t base = int64_t{blockIdx.x} * kTile;
  const int64_t plen = prefix_len(p);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = e * kThreads + tid;
    s_tok[i] = base + i < p.S ? p.tok[base + i] : 0;
  }
  const int carry = p.carry1[blockIdx.x];
  if (tid == 0) s_lo = starts_upto(p, base, 0, p.nb);
  if (tid == 32) {
    const int64_t end = base + kTile - 1;
    s_hi = starts_upto(p, end < p.S - 1 ? end : p.S - 1, 0, p.nb);
  }
  if (tid == 64) {
    // rd of the position before the tile, whose covering token is `carry`
    s_prev = blockIdx.x == 0 ? -1
             : run_dist(p, base - 1, carry < 0 ? 0 : p.tok[carry], plen, 0,
                        p.nb);
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;

  int last[kPer];
  int32_t t[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    t[e] = s_tok[tid * kPer + e];
    last[e] = ((t[e] >> 25) & 1) ? static_cast<int>(base + tid * kPer + e)
                                 : -1;
  }
  scan_last(last, carry, s_w);
  int rd[kPer];
  uint32_t val[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t j = base + tid * kPer + e;
    const int sj = last[e];
    const int32_t tcov = sj < 0 ? 0 : sj >= base ? s_tok[sj - base] : p.tok[sj];
    rd[e] = j < p.S ? run_dist(p, j, tcov, plen, lo, hi) : 0;
    val[e] = rd[e] ? kTag | rd[e] : base_lit(p, j, t[e], plen);
  }
  s_rd_last[tid] = rd[kPer - 1];
  __syncthreads();                          // all reads of s_tok are done
  int prev = tid ? s_rd_last[tid - 1] : s_prev;
  int chg = -1;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t j = base + tid * kPer + e;
    if (j < p.S && rd[e] != prev) chg = static_cast<int>(j);
    prev = rd[e];
    s_tok[tid * kPer + e] = static_cast<int32_t>(val[e]);
  }
  chg = cta_max(chg, s_w);                  // syncs: s_tok holds the values
  if (tid == 0) {
    p.tile_chg[blockIdx.x] = chg;
    p.prev_rd[blockIdx.x] = s_prev;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = e * kThreads + tid;
    if (base + i < p.S) p.v[base + i] = static_cast<uint32_t>(s_tok[i]);
  }
}

// Per tile: the run start r of every match position and its source
// g = r - rd + (j - r) % rd; v[j] = TAG | g, or the literal value and
// bad_dist where g lies before the output.
__global__ void __launch_bounds__(kThreads)
copy_sources_point_kernel(Params p) {
  __shared__ uint32_t s_v[kTile];
  __shared__ int s_w[kWarps];
  __shared__ int s_rd_last[kThreads];
  const int tid = threadIdx.x;
  const int64_t base = int64_t{blockIdx.x} * kTile;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = e * kThreads + tid;
    s_v[i] = base + i < p.S ? p.v[base + i] : 0;
  }
  __syncthreads();
  int rd[kPer], last[kPer];
  uint32_t val[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    val[e] = s_v[tid * kPer + e];
    rd[e] = (val[e] & kTag) ? static_cast<int>(val[e] & 0xFFFF) : 0;
  }
  s_rd_last[tid] = rd[kPer - 1];
  __syncthreads();
  int prev = tid ? s_rd_last[tid - 1] : p.prev_rd[blockIdx.x];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int64_t j = base + tid * kPer + e;
    last[e] = j < p.S && rd[e] != prev ? static_cast<int>(j) : -1;
    prev = rd[e];
  }
  scan_last(last, p.carry2[blockIdx.x], s_w);
  int bad = 0, open = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (rd[e] == 0) continue;
    const int64_t j = base + tid * kPer + e;
    const int64_t from = int64_t{last[e]} - rd[e];
    const int64_t g =
        from + static_cast<uint32_t>(j - from) % static_cast<uint32_t>(rd[e]);
    if (g < 0) {
      bad = 1;
      val[e] = base_lit(p, j, p.tok[j], prefix_len(p));
    } else {
      open = 1;
      val[e] = kTag | static_cast<uint32_t>(g);
    }
    s_v[tid * kPer + e] = val[e];
  }
  bad = __syncthreads_or(bad);
  open = __syncthreads_or(open);
  if (tid == 0) {
    if (bad) p.flags[0] = 1;
    if (open) p.flags[2] = 1;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = e * kThreads + tid;
    if (base + i < p.S) p.v[base + i] = s_v[i];
  }
}

// ------------------------------------------------------- stored blocks

// kStoredChunks CTAs per block slot, each with its share of a stored
// block's bytes (a copy is a chain of dependent loads, so one CTA per block
// is bound by their latency); the bytes go from the stream to
// v[dst, dst + n) wherever v holds no pointer, unless a later stored block
// covers the position.
__global__ void __launch_bounds__(kThreads)
copy_sources_stored_kernel(Params p) {
  const int b = blockIdx.x;
  if (!p.is_sto[b]) return;
  const int64_t bytes = 4 * p.n_words;
  auto range = [&](int i, int64_t* dst, int64_t* n) {
    const int64_t o = p.blk_out[i];
    const int64_t len = p.blk_end[i] - o;
    *dst = o < 0 ? 0 : o > p.S ? p.S : o;
    *n = len < 0 ? 0 : len > kWsto ? kWsto : len;
  };
  int64_t dst, n;
  range(b, &dst, &n);
  int64_t src = ((p.blk_bit[b] + 3 + 7) >> 3) + 4;
  src = src < 0 ? 0 : src > bytes ? bytes : src;
  int later = 0;
  for (int i = b + 1 + threadIdx.x; i < p.nb; i += kThreads) {
    if (!p.is_sto[i]) continue;
    int64_t d2, n2;
    range(i, &d2, &n2);
    if (d2 < dst + n && dst < d2 + n2) later = 1;
  }
  later = __syncthreads_or(later);
  const int64_t chunk = kWsto / kStoredChunks;
  const int64_t k1 =
      n < (blockIdx.y + 1) * chunk ? n : (blockIdx.y + 1) * chunk;
  for (int64_t k = blockIdx.y * chunk + threadIdx.x; k < k1; k += kThreads) {
    const int64_t pos = dst + k;
    if (pos >= p.S) break;
    if (later) {
      bool covered = false;
      for (int i = b + 1; i < p.nb && !covered; ++i) {
        if (!p.is_sto[i]) continue;
        int64_t d2, n2;
        range(i, &d2, &n2);
        covered = pos >= d2 && pos < d2 + n2;
      }
      if (covered) continue;
    }
    const int64_t sb = src + k;
    const uint32_t byte =
        sb < bytes ? (static_cast<uint32_t>(p.words[sb >> 2]) >> (8 * (sb & 3)))
                         & 0xFF
                   : 0;
    if (!(p.v[pos] & kTag)) p.v[pos] = byte;
  }
}

// ------------------------------------------------------------ the rounds

// One pointer-doubling round in place: v[j] = v[source] where v[j] is a
// pointer. Returns at once if the round before left no pointer; raises
// flags[2 + round] if this one leaves any.
__global__ void __launch_bounds__(kThreads)
copy_sources_round_kernel(Params p, int round) {
  if (p.flags[2 + round - 1] == 0) return;
  const int64_t stride = int64_t{gridDim.x} * kThreads;
  const int64_t tid = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  const int64_t n4 = p.S / 4;
  uint4* v4 = reinterpret_cast<uint4*>(p.v);
  int open = 0;
  auto step = [&](uint32_t x) -> uint32_t {
    if (!(x & kTag)) return x;
    const uint32_t y = __ldcg(p.v + (x & ~kTag));
    open |= (y & kTag) != 0;
    return y;
  };
  for (int64_t i = tid; i < n4; i += stride) {
    uint4 x = v4[i];
    if (!((x.x | x.y | x.z | x.w) & kTag)) continue;
    x.x = step(x.x);
    x.y = step(x.y);
    x.z = step(x.z);
    x.w = step(x.w);
    v4[i] = x;
  }
  for (int64_t j = 4 * n4 + tid; j < p.S; j += stride) {
    const uint32_t x = p.v[j];
    if (x & kTag) p.v[j] = step(x);
  }
  open = __syncthreads_or(open);
  if (open && threadIdx.x == 0) p.flags[2 + round] = 1;
}

// out[j] = v[j] & 0xFF; unconverged if a pointer is left.
__global__ void __launch_bounds__(kThreads)
copy_sources_bytes_kernel(Params p) {
  const int64_t stride = int64_t{gridDim.x} * kThreads;
  const int64_t tid = int64_t{blockIdx.x} * kThreads + threadIdx.x;
  const int64_t n4 = p.S / 4;
  const uint4* v4 = reinterpret_cast<const uint4*>(p.v);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(p.out);
  int open = 0;
  for (int64_t i = tid; i < n4; i += stride) {
    const uint4 x = v4[i];
    open |= ((x.x | x.y | x.z | x.w) & kTag) != 0;
    out4[i] = (x.x & 0xFF) | ((x.y & 0xFF) << 8) | ((x.z & 0xFF) << 16) |
              ((x.w & 0xFF) << 24);
  }
  for (int64_t j = 4 * n4 + tid; j < p.S; j += stride) {
    const uint32_t x = p.v[j];
    open |= (x & kTag) != 0;
    p.out[j] = static_cast<uint8_t>(x & 0xFF);
  }
  open = __syncthreads_or(open);
  if (open && threadIdx.x == 0) p.flags[1] = 1;
}

cudaError_t sm_count(int dev, int* sms) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_sms[dev]) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = g_sms[dev];
  return cudaSuccess;
}

cudaError_t launch_all(const Params& p, int rounds, int device,
                       cudaStream_t st) {
  int sms = 0;
  const cudaError_t e = sm_count(device, &sms);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (p.S + kTile - 1) / kTile;
  const unsigned nt = static_cast<unsigned>(tiles);
  const int64_t want = (p.S / 4 + kThreads - 1) / kThreads + 1;
  const int64_t cap = int64_t{sms} * 8;
  const unsigned flat = static_cast<unsigned>(want < cap ? want : cap);
  if (p.nb > 0)
    copy_sources_order_kernel<<<(p.nb + kThreads - 1) / kThreads, kThreads, 0,
                                st>>>(p);
  copy_sources_last_token_kernel<<<nt, kThreads, 0, st>>>(p);
  copy_sources_scan_kernel<<<1, kScanThreads, 0, st>>>(p.tile_last, p.carry1,
                                                      tiles);
  copy_sources_mark_kernel<<<nt, kThreads, 0, st>>>(p);
  copy_sources_scan_kernel<<<1, kScanThreads, 0, st>>>(p.tile_chg, p.carry2,
                                                      tiles);
  copy_sources_point_kernel<<<nt, kThreads, 0, st>>>(p);
  if (p.nb > 0)
    copy_sources_stored_kernel<<<dim3(p.nb, kStoredChunks), kThreads, 0,
                                 st>>>(p);
  for (int r = 1; r <= rounds; ++r)
    copy_sources_round_kernel<<<flat, kThreads, 0, st>>>(p, r);
  copy_sources_bytes_kernel<<<flat, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Queues every kernel of one call on `stream` of `device` (made current for
// the call only if it is not); returns the CUDA error (0 on success). Every
// pointer is a device pointer except that `prefix` and `plen_ptr` may be
// null (no prefix; prefix length `plen_val`). The caller allocates v
// (uint32[S]), out (uint8[S]), scratch (int32[5 * tiles + 3 * nb]) and
// flags (int32[3 + rounds], zeroed); v and out are 16-byte aligned.
extern "C" int copy_sources_launch(
    const void* words, int64_t n_words, const void* tok, int64_t S,
    const void* blk_bit, const void* blk_out, const void* blk_end,
    const void* blive, const void* is_sto, int64_t nb, const void* prefix,
    int64_t prefix_n, const void* plen_ptr, int64_t plen_val, int64_t rounds,
    void* v, void* scratch, void* flags, void* out, int device,
    void* stream) {
  if (S <= 0) return 0;
  if (S > 0x7FFFFFFF - kTile || nb < 0 || nb > 0x3FFFFFFF || rounds < 0 ||
      rounds > 64 || (reinterpret_cast<uintptr_t>(v) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (S + kTile - 1) / kTile;
  int32_t* s = static_cast<int32_t*>(scratch);
  Params p;
  p.words = static_cast<const int64_t*>(words);
  p.n_words = n_words;
  p.tok = static_cast<const int32_t*>(tok);
  p.S = S;
  p.blk_bit = static_cast<const int64_t*>(blk_bit);
  p.blk_out = static_cast<const int64_t*>(blk_out);
  p.blk_end = static_cast<const int64_t*>(blk_end);
  p.blive = static_cast<const uint8_t*>(blive);
  p.is_sto = static_cast<const uint8_t*>(is_sto);
  p.nb = static_cast<int32_t>(nb);
  p.prefix = static_cast<const uint8_t*>(prefix);
  p.prefix_n = prefix_n;
  p.plen_ptr = static_cast<const int64_t*>(plen_ptr);
  p.plen_val = plen_val;
  p.v = static_cast<uint32_t*>(v);
  p.tile_last = s;
  p.carry1 = s + tiles;
  p.tile_chg = s + 2 * tiles;
  p.carry2 = s + 3 * tiles;
  p.prev_rd = s + 4 * tiles;
  p.st_start = s + 5 * tiles;
  p.st_end = p.st_start + nb;
  p.st_mark = p.st_end + nb;
  p.flags = static_cast<int32_t*>(flags);
  p.out = static_cast<uint8_t*>(out);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = launch_all(p, static_cast<int>(rounds), device,
                   static_cast<cudaStream_t>(stream));
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
