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
//    TAG is left, at most `rounds` times (unconverged otherwise);
//  * out[j] = v[j] & 0xFF below valid_out, else 0.
//
// What bounds it on this card. It must read the tokens (4 bytes per
// position) and write the bytes (1 per position): 168 MB for 33.5 M
// positions, 50 us at 3.35 TB/s. Besides, the pointer rounds gather 4 bytes
// per pointer still open in each round. Every extra pass over the output
// costs its bytes in full, and every queued launch its slot on the device.
//
// What the design does about it:
//  * One pass over the tokens (a CTA per 2,048-position tile, tiles taken in
//    order from a counter) reads them once and writes v (4 bytes) and the
//    bytes it already knows (1 byte) once per position. The two unbounded
//    look-backs (a stored or dead region has no tokens, a 4 MB zero run is
//    one run) are single-pass decoupled look-backs over per-tile status
//    words, read 32 tiles at a time by one warp: first the last valid token
//    (a tile's aggregate needs no other tile), then the last run start (a
//    tile's aggregate, the last change of distance after its first
//    position, is known once it has its covering tokens; it carries the
//    distance of its last position, which decides whether the next tile's
//    first position starts a run).
//  * The blocks are ranked by start once (NB^2 compares split over a CTA's
//    warps, NB is a few thousand at most) with the prefix maxima of their
//    ends and indices; a tile finds the few blocks that can cover it by
//    32-way searches of whole warps, keeps them in shared memory, and each
//    thread walks them along its 8 consecutive positions. The stored
//    blocks are ranked by output start too, with the prefix maxima of their
//    ends, so a tile finds the few stored blocks that reach it by two more
//    searches and copies their bytes itself (later blocks winning, never
//    over a pointer). The pass is held to 64 registers, so 4 CTAs share an
//    SM and hide each other's waits.
//  * Pointers whose source lies in the same tile jump in shared memory
//    until they resolve or leave the tile. A tile that keeps a pointer is
//    listed.
//  * The rounds run in one persistent kernel (a cooperative launch of
//    resident CTAs, a grid barrier between rounds): a round reads only the
//    listed tiles, starts all of a thread's gathers before it uses one,
//    writes the bytes that resolve and lists the tiles still open; it stops
//    when the list is empty, or after `rounds` rounds (unconverged).
//  * v holds 32 bits per position, TAG in bit 31, so S < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // positions per thread
constexpr int kTile = kThreads * kPer;     // 2048 (ops/copy_sources.py TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kTileBlocks = 64;            // block starts kept per tile
constexpr int kPassCtasPerSm = 4;          // the pass held to 64 registers
constexpr int kMaxRoundCtasPerSm = 8;
constexpr uint32_t kTag = 0x80000000u;
constexpr int64_t kWsto = 1 << 16;         // a stored block's byte cap
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
constexpr int kHead = 16;                  // int32 counters before the tiles
// a tile's status word: flag in bits 62-63 (0 not yet, 1 aggregate, 2
// inclusive prefix), a run distance in bits 32-48, a position in bits 0-31
constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;

int g_sms[kMaxDevices];                    // SM count per device, 0: unknown
int g_round_ctas[kMaxDevices];             // rounds kernel CTAs per SM

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
  const int64_t* vout_ptr;     // on the device, or null: vout_val
  int64_t vout_val;
  uint32_t* v;
  uint8_t* out;
  int64_t n_tiles;
  // scratch: the zeroed head
  int32_t* flags;              // [0] bad_dist [1] unconverged
  int32_t* tile_ctr;           // tiles taken by the pass
  uint32_t* bar_count;         // grid barrier
  uint32_t* bar_gen;
  int32_t* counts;             // [3] tiles listed per round list
  int32_t* n_sto;              // stored blocks
  int32_t* rounds_run;         // gather rounds the rounds kernel ran
  uint64_t* st_token;          // per tile: last valid token
  uint64_t* st_run;            // per tile: last run start, last distance
  // scratch: the rest
  int32_t* st_start;           // blocks by start: start, prefix max of the
  int32_t* st_end;             //   ends, prefix max of the indices << 1 |
  int32_t* st_mark;            //   stored
  int32_t* sto_dst;            // stored blocks by (output start, index):
  int32_t* sto_end;            //   start, end, prefix max of the ends,
  int32_t* sto_pmend;          //   block index, first stream byte
  int32_t* sto_idx;
  int64_t* sto_src;
  int32_t* lists;              // [3][n_tiles] tile lists of the rounds
};

__device__ __forceinline__ int64_t prefix_len(const Params& p) {
  if (!p.prefix) return 0;
  return p.plen_ptr ? *p.plen_ptr : p.plen_val;
}

__device__ __forceinline__ int64_t valid_out(const Params& p) {
  return p.vout_ptr ? *p.vout_ptr : p.vout_val;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* st, int k) {
  uint64_t s;
  do {
    s = *reinterpret_cast<const volatile uint64_t*>(st + k);
  } while ((s >> 62) == 0);
  return s;
}

__device__ __forceinline__ void store_status(uint64_t* st, int k,
                                             uint64_t s) {
  atomicExch(reinterpret_cast<unsigned long long*>(st + k),
             static_cast<unsigned long long>(s));
}

__device__ __forceinline__ int status_pos(uint64_t s) {
  return static_cast<int>(static_cast<uint32_t>(s));
}

__device__ __forceinline__ int status_rd(uint64_t s) {
  return static_cast<int>((s >> 32) & 0x1FFFF);
}

__device__ __forceinline__ uint64_t status(uint64_t flag, int rd, int pos) {
  return flag | (static_cast<uint64_t>(rd) << 32) | static_cast<uint32_t>(pos);
}

// In: last[e] is position e of this thread's kPer consecutive positions if
// it is flagged, else -1. Out: the last flagged position at or before each,
// `carry` standing for everything before the tile. Returns the tile's last
// flagged position (-1: none; the carry not included).
__device__ int scan_last(int (&last)[kPer], int carry, int* s_w) {
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
  int total = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre = max(pre, s_w[w]);
    total = max(total, s_w[w]);
  }
  __syncthreads();
  pre = max(pre, carry);
#pragma unroll
  for (int e = 0; e < kPer; ++e) last[e] = max(last[e], pre);
  return total;
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

// The number of a[0..n) at or below x (a nondecreasing), by a whole warp:
// a 32-way search, one load a lane a step.
__device__ int warp_count_le(const int32_t* a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int at = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, at < hi && a[at] <= x));
    if (c == 0) break;                     // a[lo] is above x
    const int top = lo + (c - 1) * step;   // a[top] <= x < a[top + step]
    hi = min(top + step, hi);
    lo = top + 1;
  }
  return lo;
}

// x clipped to [0, S].
__device__ __forceinline__ int64_t clamp_pos(int64_t x, int64_t S) {
  return x < 0 ? 0 : x > S ? S : x;
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

__device__ __forceinline__ uint32_t base_lit(const Params& p, int j,
                                             int32_t t, int plen) {
  if (((t >> 25) & 1) && !((t >> 26) & 1)) return t & 0x1FF;
  return j < plen && j < p.prefix_n ? p.prefix[j] : 0;
}

// ------------------------------------------------------- blocks by start

// 32 block slots per CTA, one per lane; the CTA's warps split the slots they
// compare with. Per slot: its rank among the slots by (start, index), and
// the maxima of the ends and of the indices over the slots at or before it
// in that order. A slot that is dead or starts outside the output sorts
// last (start S) and is never found. A stored slot also gets its rank among
// the stored slots by (output start, index), with the prefix maximum of
// their ends, and the stored slots are counted.
__global__ void __launch_bounds__(kThreads)
copy_sources_order_kernel(Params p) {
  __shared__ int32_t s_start[kThreads], s_end[kThreads];
  __shared__ int32_t s_sdst[kThreads], s_send[kThreads];
  __shared__ int32_t s_red[6][kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  auto start_of = [&](int i) -> int32_t {
    const int64_t o = p.blk_out[i];
    return p.blive[i] && o >= 0 && o < p.S ? static_cast<int32_t>(o)
                                           : static_cast<int32_t>(p.S);
  };
  // a stored block's bytes go to [dst, dst + n); -1: not stored
  auto sto_range = [&](int i, int32_t* dst) -> int32_t {
    if (!p.is_sto[i]) {
      *dst = -1;
      return -1;
    }
    const int64_t o = p.blk_out[i];
    const int64_t len = p.blk_end[i] - o;
    const int64_t d = o < 0 ? 0 : o > p.S ? p.S : o;
    *dst = static_cast<int32_t>(d);
    return static_cast<int32_t>(d + (len < 0 ? 0 : len > kWsto ? kWsto : len));
  };
  const bool mine = b < p.nb;
  const int32_t start = mine ? start_of(b) : 0;
  int32_t my_dst = -1, my_end = -1;
  if (mine) my_end = sto_range(b, &my_dst);
  int rank = 0, pm_end = 0, pm_b = -1, srank = 0, spm_end = 0, n_sto = 0;
  for (int c0 = 0; c0 < p.nb; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    if (i < p.nb) {
      s_start[threadIdx.x] = start_of(i);
      const int64_t e = p.blk_end[i];
      s_end[threadIdx.x] =
          static_cast<int32_t>(e < 0 ? 0 : e > p.S ? p.S : e);
      int32_t d;
      s_send[threadIdx.x] = sto_range(i, &d);
      s_sdst[threadIdx.x] = d;
    }
    __syncthreads();
    const int n = min(kThreads, p.nb - c0);
    for (int k = warp; k < n; k += kWarps) {
      const int32_t sk = s_start[k];
      const int bi = c0 + k;
      const bool less = sk < start || (sk == start && bi < b);
      rank += less;
      if ((less || bi == b) && sk < p.S) {
        pm_end = max(pm_end, s_end[k]);
        pm_b = max(pm_b, bi);
      }
      const int32_t dk = s_sdst[k];
      if (dk >= 0) {
        ++n_sto;
        if (my_dst >= 0 && (dk < my_dst || (dk == my_dst && bi <= b))) {
          srank += bi != b;
          spm_end = max(spm_end, s_send[k]);
        }
      }
    }
    __syncthreads();
  }
  const int part[6] = {rank, pm_end, pm_b, srank, spm_end, n_sto};
#pragma unroll
  for (int f = 0; f < 6; ++f) s_red[f][warp][lane] = part[f];
  __syncthreads();
  if (warp != 0 || !mine) return;
  rank = srank = n_sto = 0;
  pm_end = spm_end = 0;
  pm_b = -1;
  for (int w = 0; w < kWarps; ++w) {
    rank += s_red[0][w][lane];
    pm_end = max(pm_end, s_red[1][w][lane]);
    pm_b = max(pm_b, s_red[2][w][lane]);
    srank += s_red[3][w][lane];
    spm_end = max(spm_end, s_red[4][w][lane]);
    n_sto += s_red[5][w][lane];
  }
  p.st_start[rank] = start;
  p.st_end[rank] = pm_end;
  p.st_mark[rank] = pm_b < 0 ? 0 : (pm_b << 1) | (p.is_sto[pm_b] ? 1 : 0);
  if (my_dst >= 0) {
    p.sto_dst[srank] = my_dst;
    p.sto_end[srank] = my_end;
    p.sto_pmend[srank] = spm_end;
    p.sto_idx[srank] = b;
    const int64_t bytes = 4 * p.n_words;
    const int64_t src = ((p.blk_bit[b] + 3 + 7) >> 3) + 4;
    p.sto_src[srank] = src < 0 ? 0 : src > bytes ? bytes : src;
  }
  if (b == 0) *p.n_sto = n_sto;
}

// ----------------------------------------------------------- the one pass

// The nearest tile before `tile` whose status decides the look-back, read
// 32 tiles at a time by one warp; returns the decided value, and in *prev
// the status of the tile just before `tile`.
//  * tokens (runs = false): a tile decides if it holds a valid token or has
//    its inclusive prefix; the value is the last valid token (-1: none).
//  * runs (runs = true): a tile decides if it has its inclusive prefix, a
//    change of distance after its first position, or a first position
//    whose distance differs from the last of the tile before it (then the
//    run starts at that first position).
__device__ int look_back(const uint64_t* st, int tile, bool runs,
                         uint64_t* prev) {
  const int lane = threadIdx.x & 31;
  for (int k0 = tile - 1;; k0 -= 32) {
    const int k = k0 - lane;
    uint64_t s = kInclusive | 0xFFFFFFFFull;   // before tile 0: none
    if (k >= 0) s = load_status(st, k);
    if (k0 == tile - 1) *prev = __shfl_sync(kFull, s, 0);
    int val = status_pos(s);
    bool decided = (s >> 62) == 2 || val >= 0;
    if (runs) {
      // the tile before k: lane + 1's, or one more load for lane 31
      uint64_t before = __shfl_down_sync(kFull, s, 1);
      if (lane == 31 && k >= 1) before = load_status(st, k - 1);
      if (!decided && k >= 1 && status_rd(s) != status_rd(before)) {
        decided = true;
        val = k * kTile;
      }
    }
    const unsigned hit = __ballot_sync(kFull, decided);
    if (hit) return __shfl_sync(kFull, val, __ffs(hit) - 1);
  }
}

// Per tile: the covering token and run distance of every position, its run
// start and source, the literal and stored bytes, the pointers resolved
// inside the tile; v and the known bytes written once; the tile listed for
// round 1 if it keeps a pointer. Positions are 32-bit (S < 2^31 - kTile).
__global__ void __launch_bounds__(kThreads, kPassCtasPerSm)
copy_sources_pass_kernel(Params p) {
  __shared__ __align__(16) uint32_t s_buf[kTile];   // tokens, then values
  __shared__ int s_w[kWarps];
  __shared__ int s_rd_last[kThreads];
  // the blocks that can cover the tile (ranks lo - 1 .. hi - 1 by start):
  // start, prefix max of the ends, mark
  __shared__ int32_t s_bs[kTileBlocks], s_be[kTileBlocks], s_bm[kTileBlocks];
  __shared__ int s_tile, s_find[4], s_carry, s_prev_rd;
  __shared__ int32_t s_tcov;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(p.tile_ctr, 1);
  __syncthreads();
  const int tile = s_tile;
  const int S = static_cast<int>(p.S);
  const int base = tile * kTile;
  const int plen = static_cast<int>(clamp_pos(prefix_len(p), S));
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = e * kThreads + tid;
    s_buf[i] = base + i < S ? static_cast<uint32_t>(p.tok[base + i]) : 0;
  }
  // four warps search at once: the blocks that start at or before the
  // tile's first and last position, the stored blocks that start at or
  // before its last, and those whose prefix max of the ends is at or
  // before its first
  const int end = min(base + kTile, S) - 1;
  if (warp < 4) {
    const int n_sto = *p.n_sto;
    const int32_t* a[4] = {p.st_start, p.st_start, p.sto_dst, p.sto_pmend};
    const int n[4] = {p.nb, p.nb, n_sto, n_sto};
    const int x[4] = {base, end, end, base};
    const int c = warp_count_le(a[warp], n[warp], x[warp]);
    if (lane == 0) s_find[warp] = c;
  }
  __syncthreads();
  const int lo = s_find[0], hi = s_find[1];
  const int n_bt = hi - lo + 1;
  const bool local = n_bt <= kTileBlocks;
  if (local && tid < n_bt) {
    const int k = lo - 1 + tid;
    s_bs[tid] = k >= 0 ? p.st_start[k] : -1;       // [0]: never compared
    s_be[tid] = k >= 0 ? p.st_end[k] : 0;
    s_bm[tid] = k >= 0 ? p.st_mark[k] : 0;
  }
  const int j0 = base + tid * kPer;

  // 1. the last valid token at or before every position
  int32_t t[kPer];
  int last[kPer];
  {
    const uint4* b4 = reinterpret_cast<const uint4*>(s_buf) + tid * 2;
    const uint4 q0 = b4[0], q1 = b4[1];
    const uint32_t q[kPer] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      t[e] = static_cast<int32_t>(q[e]);
      last[e] = ((t[e] >> 25) & 1) ? j0 + e : -1;
    }
  }
  const int agg_tok = scan_last(last, -1, s_w);
  if (warp == 0) {
    if (lane == 0 && (agg_tok >= 0 || tile == 0))
      store_status(p.st_token, tile, status(kInclusive, 0, agg_tok));
    else if (lane == 0)
      store_status(p.st_token, tile, status(kAggregate, 0, -1));
    int carry = -1;
    uint64_t prev;
    if (tile > 0) carry = look_back(p.st_token, tile, false, &prev);
    if (lane == 0) {
      if (agg_tok < 0 && tile > 0)
        store_status(p.st_token, tile, status(kInclusive, 0, carry));
      s_carry = carry;
      s_tcov = carry >= 0 ? p.tok[carry] : 0;
    }
  }
  __syncthreads();
  const int carry_tok = s_carry;

  // 2. every position's run distance; the changes of distance after the
  //    tile's first position
  int rd[kPer];
  {
    int bi = 0;                    // the thread's entry of the tile's blocks
    if (local) {
      int a = 1, z = n_bt;         // s_bs[0] lies at or before the tile
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (s_bs[mid] <= j0) a = mid + 1; else z = mid;
      }
      bi = a - 1;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = j0 + e;
      const int sj = max(last[e], carry_tok);
      const int32_t tcov =
          sj < 0 ? 0 : sj >= base ? static_cast<int32_t>(s_buf[sj - base])
                                  : s_tcov;
      const int d = ((tcov >> 26) & 1) ? (tcov >> 9) & 0xFFFF : 0;
      rd[e] = 0;
      if (d == 0 || j < plen || j >= S) continue;
      bool live, sto;
      if (local) {
        while (bi + 1 < n_bt && s_bs[bi + 1] <= j) ++bi;
        live = j < s_be[bi];
        sto = s_bm[bi] & 1;
      } else {
        const Cover c = cover_at(p, j, lo, hi);
        live = c.live;
        sto = c.sto;
      }
      rd[e] = live && !sto ? d : 0;
    }
  }
  s_rd_last[tid] = rd[kPer - 1];
  __syncthreads();
  int chg[kPer];
  {
    int prev = tid ? s_rd_last[tid - 1] : -1;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      chg[e] = j0 + e < S && (tid || e) && rd[e] != prev ? j0 + e : -1;
      prev = rd[e];
    }
  }
  int chg_last[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) chg_last[e] = chg[e];
  const int agg_run = scan_last(chg_last, -1, s_w);
  const int rd_last = s_rd_last[kThreads - 1];
  if (warp == 0) {
    // tile 0's first position starts a run (the distance before it is -1)
    const int incl0 = agg_run >= 0 ? agg_run : 0;
    if (lane == 0 && (agg_run >= 0 || tile == 0))
      store_status(p.st_run, tile,
                   status(kInclusive, rd_last, tile ? agg_run : incl0));
    else if (lane == 0)
      store_status(p.st_run, tile, status(kAggregate, rd_last, -1));
    int carry = -1, prev_rd = -1;
    if (tile > 0) {
      uint64_t prev;
      carry = look_back(p.st_run, tile, true, &prev);
      prev_rd = status_rd(prev);
    }
    if (lane == 0) {
      s_carry = carry;
      s_prev_rd = prev_rd;
      if (agg_run < 0 && tile > 0) {
        const int incl = rd[0] != prev_rd ? base : carry;
        store_status(p.st_run, tile, status(kInclusive, rd_last, incl));
      }
    }
  }
  __syncthreads();
  if (tid == 0 && rd[0] != s_prev_rd) chg[0] = base;
  scan_last(chg, s_carry, s_w);            // chg[e]: the run start r

  // 3. sources, literals, stored bytes
  int32_t win_idx[kPer], win_k[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) win_idx[e] = -1;
  for (int k = s_find[3]; k < s_find[2]; ++k) {
    const int32_t d = p.sto_dst[k], en = p.sto_end[k], idx = p.sto_idx[k];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (j0 + e >= d && j0 + e < en && idx > win_idx[e]) {
        win_idx[e] = idx;
        win_k[e] = k;
      }
    }
  }
  uint32_t val[kPer];
  int bad = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = j0 + e;
    val[e] = base_lit(p, j, t[e], plen);
    if (rd[e]) {
      const int from = chg[e] - rd[e];
      const int g = from + static_cast<int>(static_cast<uint32_t>(j - from) %
                                            static_cast<uint32_t>(rd[e]));
      if (g < 0) bad = 1; else val[e] = kTag | static_cast<uint32_t>(g);
    }
    if (!(val[e] & kTag) && win_idx[e] >= 0) {
      const int k = win_k[e];
      const int64_t sb = p.sto_src[k] + (j - p.sto_dst[k]);
      val[e] = sb < 4 * p.n_words
                   ? (static_cast<uint32_t>(p.words[sb >> 2]) >> (8 * (sb & 3))) &
                         0xFF
                   : 0;
    }
  }
  bad = __syncthreads_or(bad);             // every read of the tokens done
  if (bad && tid == 0) p.flags[0] = 1;
  uint4* own = reinterpret_cast<uint4*>(s_buf) + tid * 2;
  own[0] = make_uint4(val[0], val[1], val[2], val[3]);
  own[1] = make_uint4(val[4], val[5], val[6], val[7]);
  __syncthreads();

  // 4. pointers into the tile jump in shared memory until they resolve or
  //    leave it (a source lies before its position, so in the tile or
  //    before it)
  for (;;) {
    int again = 0, moved = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int g = static_cast<int>(val[e] & ~kTag);
      if ((val[e] & kTag) && g >= base) {
        const uint32_t y = s_buf[g - base];
        val[e] = y;
        moved = 1;
        again |= (y & kTag) && static_cast<int>(y & ~kTag) >= base;
      }
    }
    if (moved) {
      own[0] = make_uint4(val[0], val[1], val[2], val[3]);
      own[1] = make_uint4(val[4], val[5], val[6], val[7]);
    }
    if (!__syncthreads_or(again)) break;
  }

  // 5. v, the bytes known; the tile listed if a pointer is left
  const int vout = static_cast<int>(clamp_pos(valid_out(p), S));
  int open = 0;
  uint32_t byte[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    open |= (val[e] & kTag) != 0;
    byte[e] = !(val[e] & kTag) && j0 + e < vout ? val[e] & 0xFF : 0;
  }
  if (j0 + kPer <= S) {
    uint4* v4 = reinterpret_cast<uint4*>(p.v + j0);
    v4[0] = make_uint4(val[0], val[1], val[2], val[3]);
    v4[1] = make_uint4(val[4], val[5], val[6], val[7]);
    *reinterpret_cast<uint2*>(p.out + j0) = make_uint2(
        byte[0] | byte[1] << 8 | byte[2] << 16 | byte[3] << 24,
        byte[4] | byte[5] << 8 | byte[6] << 16 | byte[7] << 24);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (j0 + e < S) {
        p.v[j0 + e] = val[e];
        p.out[j0 + e] = static_cast<uint8_t>(byte[e]);
      }
    }
  }
  if (__syncthreads_or(open) && tid == 0)
    p.lists[p.n_tiles + atomicAdd(&p.counts[1], 1)] = tile;
}

// ------------------------------------------------------------ the rounds

__device__ __forceinline__ void grid_barrier(const Params& p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile uint32_t* gen = p.bar_gen;
    const uint32_t g = *gen;
    __threadfence();
    if (atomicAdd(p.bar_count, 1) == gridDim.x - 1) {
      *p.bar_count = 0;
      __threadfence();
      atomicAdd(p.bar_gen, 1);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The pointer-doubling rounds in place over the listed tiles (round r
// reads list r % 3, lists the tiles still open in list (r + 1) % 3 and
// clears list (r + 2) % 3, read in round r - 1); each resolved position's
// byte is written. Stops when a list is empty; after `rounds` rounds it
// raises unconverged and writes the low byte of every pointer left.
__global__ void __launch_bounds__(kThreads)
copy_sources_rounds_kernel(Params p, int rounds) {
  const int64_t vout = valid_out(p);
  for (int r = 1;; ++r) {
    const int cur = r % 3, nxt = (r + 1) % 3;
    const int n = *reinterpret_cast<volatile int32_t*>(&p.counts[cur]);
    const bool last = r > rounds;
    if ((n == 0 || last) && blockIdx.x == 0 && threadIdx.x == 0)
      *p.rounds_run = r - 1;
    if (n == 0) return;
    if (last && blockIdx.x == 0 && threadIdx.x == 0) p.flags[1] = 1;
    for (int it = blockIdx.x; it < n; it += gridDim.x) {
      // thread t takes positions t, t + 256, ...: neighbouring threads
      // gather neighbouring sources wherever a run continues
      const int tile = p.lists[cur * p.n_tiles + it];
      const int64_t j0 = int64_t{tile} * kTile + threadIdx.x;
      uint32_t x[kPer], y[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int64_t j = j0 + e * kThreads;
        x[e] = j < p.S ? __ldcg(p.v + j) : 0;
      }
      // every gather started before any is used
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        y[e] = (x[e] & kTag) && !last ? __ldcg(p.v + (x[e] & ~kTag)) : x[e];
      int open = 0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (!(x[e] & kTag)) continue;
        const int64_t j = j0 + e * kThreads;
        if (!last) __stcg(p.v + j, y[e]);
        open |= (y[e] & kTag) != 0;
        if (!(y[e] & kTag) || last)
          p.out[j] = j < vout ? static_cast<uint8_t>(y[e] & 0xFF) : 0;
      }
      open = __syncthreads_or(open);
      if (open && !last && threadIdx.x == 0)
        p.lists[nxt * p.n_tiles + atomicAdd(&p.counts[nxt], 1)] = tile;
    }
    if (last) return;
    if (blockIdx.x == 0 && threadIdx.x == 0) p.counts[(r + 2) % 3] = 0;
    grid_barrier(p);
  }
}

cudaError_t device_limits(int dev, int* sms, int* round_ctas) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_sms[dev]) {
    int n = 0, occ = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, copy_sources_rounds_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    g_round_ctas[dev] = occ < kMaxRoundCtasPerSm ? occ : kMaxRoundCtasPerSm;
    g_sms[dev] = n;
  }
  *sms = g_sms[dev];
  *round_ctas = g_round_ctas[dev];
  return cudaSuccess;
}

// Bytes of scratch before the tiles' status words, the status words, the
// block tables and the lists; the first `zeroed` of them must be zero.
struct Layout {
  int64_t tiles, zeroed, total;
  int64_t st_token, st_run, tables, sto_src, lists;
};

Layout layout(int64_t S, int64_t nb) {
  Layout l;
  l.tiles = (S + kTile - 1) / kTile;
  l.st_token = kHead * 4;
  l.st_run = l.st_token + 8 * l.tiles;
  l.zeroed = l.st_run + 8 * l.tiles;
  l.tables = l.zeroed;                              // 7 int32 per block
  l.sto_src = (l.tables + 4 * 7 * nb + 7) / 8 * 8;  // 1 int64 per block
  l.lists = l.sto_src + 8 * nb;
  l.total = l.lists + 4 * 3 * l.tiles;
  return l;
}

cudaError_t launch_all(Params& p, int rounds, int device, cudaStream_t st,
                       uint8_t* scratch) {
  int sms = 0, per_sm = 0;
  cudaError_t e = device_limits(device, &sms, &per_sm);
  if (e != cudaSuccess) return e;
  const Layout l = layout(p.S, p.nb);
  e = cudaMemsetAsync(scratch, 0, l.zeroed, st);
  if (e != cudaSuccess) return e;
  if (p.nb > 0)
    copy_sources_order_kernel<<<(p.nb + 31) / 32, kThreads, 0, st>>>(p);
  copy_sources_pass_kernel<<<static_cast<unsigned>(l.tiles), kThreads, 0,
                             st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int64_t grid = int64_t{sms} * per_sm;
  if (grid > p.n_tiles) grid = p.n_tiles;
  void* args[] = {&p, &rounds};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(copy_sources_rounds_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, st);
}

}  // namespace

// The scratch bytes one call of S positions over nb block slots needs.
extern "C" int copy_sources_scratch_bytes(int64_t S, int64_t nb,
                                          int64_t* bytes) {
  if (S < 0 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = layout(S, nb).total;
  return 0;
}

// Queues every kernel of one call on `stream` of `device` (made current for
// the call only if it is not); returns the CUDA error (0 on success). Every
// pointer is a device pointer except that `prefix`, `plen_ptr` and
// `vout_ptr` may be null (no prefix; prefix length `plen_val`; valid output
// `vout_val`). The caller allocates out (uint8[S]), v (uint32[S]) and
// scratch (copy_sources_scratch_bytes); out, v and scratch are 16-byte
// aligned. Scratch's first ints are the flags bad_dist and unconverged
// and, at index 9, the gather rounds run.
extern "C" int copy_sources_launch(
    const void* words, int64_t n_words, const void* tok, int64_t S,
    const void* blk_bit, const void* blk_out, const void* blk_end,
    const void* blive, const void* is_sto, int64_t nb, const void* prefix,
    int64_t prefix_n, const void* plen_ptr, int64_t plen_val,
    const void* vout_ptr, int64_t vout_val, int64_t rounds, void* v,
    void* scratch, void* out, int device, void* stream) {
  if (S <= 0) return 0;
  if (S > 0x7FFFFFFF - kTile || nb < 0 || nb > 0x3FFFFFFF || rounds < 0 ||
      rounds > 64 || (reinterpret_cast<uintptr_t>(v) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(S, nb);
  uint8_t* s8 = static_cast<uint8_t*>(scratch);
  int32_t* head = reinterpret_cast<int32_t*>(s8);
  int32_t* tables = reinterpret_cast<int32_t*>(s8 + l.tables);
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
  p.vout_ptr = static_cast<const int64_t*>(vout_ptr);
  p.vout_val = vout_val;
  p.v = static_cast<uint32_t*>(v);
  p.out = static_cast<uint8_t*>(out);
  p.n_tiles = l.tiles;
  p.flags = head;
  p.tile_ctr = head + 2;
  p.bar_count = reinterpret_cast<uint32_t*>(head + 3);
  p.bar_gen = reinterpret_cast<uint32_t*>(head + 4);
  p.counts = head + 5;                      // [5, 8)
  p.n_sto = head + 8;
  p.rounds_run = head + 9;
  p.st_token = reinterpret_cast<uint64_t*>(s8 + l.st_token);
  p.st_run = reinterpret_cast<uint64_t*>(s8 + l.st_run);
  p.st_start = tables;
  p.st_end = tables + nb;
  p.st_mark = tables + 2 * nb;
  p.sto_dst = tables + 3 * nb;
  p.sto_end = tables + 4 * nb;
  p.sto_pmend = tables + 5 * nb;
  p.sto_idx = tables + 6 * nb;
  p.sto_src = reinterpret_cast<int64_t*>(s8 + l.sto_src);
  p.lists = reinterpret_cast<int32_t*>(s8 + l.lists);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = launch_all(p, static_cast<int>(rounds), device,
                   static_cast<cudaStream_t>(stream), s8);
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
