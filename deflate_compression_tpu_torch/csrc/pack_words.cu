// The shard encoder's bit-pack for Hopper (sm_90a), plain C interface.
//
// Stands for deflate_compression_tpu/format/deflate.py:421-640, which the
// JAX package left to XLA (it has no Pallas kernel): the token items
// (:421-470, the table lookups by rows_matvec_onehot at :425-429), the
// block layout (:520-534), the item offsets (:546-564), the two sorted
// packs (:566-603, through core/bits.py::pack_items64_to_words :95 and
// pack_items96_to_words :182) and the stored payloads' fori_loop
// (:612-640). What it computes, for a shard of S positions in NB = S /
// 32768 tiles:
//   * each position's token item: for a chosen position, its litlen
//     symbol (the byte, or the length code of a match of length >= 3) and
//     for a match its distance code, both in closed form (RFC 1951
//     §3.2.5), looked up in its coding block's table words (reversed code
//     | length << 16); the item is the litlen code, its extra bits, the
//     distance code and its extra bits, LSB first, at most 48 bits, and 0
//     bits where the block is not emitted with Huffman codes;
//   * T_b, each block's token bits; the layout (layout_scan.cuh) of the
//     blocks' rest = header bits + T_b + 8 * stored bytes; each block's
//     token base = base + header bits without the EOB + pad; p_end and
//     total_bits (a non-final shard ends with an empty stored block);
//   * the words: each block's header row (slots 0-338 in order from its
//     base, slot 337 the pad), its tokens from its token base, its EOB
//     after them, a stored block's bytes from the byte edge after LEN and
//     NLEN, and a non-final shard's LEN/NLEN of the empty block, ORed into
//     num_words u32 words (int64, zero-extended); words past total_bits
//     are 0, bits past num_words are dropped;
//   * off_pos, each position's absolute bit offset.
// The items occupy disjoint bits, so the words equal the plain version's
// (ops/pack_words.py::pack_words_ref) sums of the items' contributions.
//
// What bounds it on this card: bytes. Each position is read once per pass
// (its chosen flag, byte, length and distance: 18 bytes), off_pos written
// once (8); the words are written once, after the count pass zeroes them.
//
// Two launches on the stream:
//   1. the count pass, a CTA of 256 threads per unit of 4,096 positions (8
//      a tile, so a 1 MB shard has 256 CTAs where one a tile would leave
//      most SMs idle) stages the unit's lengths and distances in shared
//      memory (one word a position) with coalesced 16-byte loads; a thread
//      takes its 16 consecutive positions from there and their flags and
//      bytes by 16-byte loads, looks their symbols up in the block's
//      tables staged in shared memory and sums the item widths; the CTA writes its total
//      and, for unit u < NB, the sum of header row u's widths. Every CTA
//      zeroes a share of the words. The CTA that takes the last ticket
//      (on the per-stream counter that ops/block_plan.py also uses, left
//      at 0) scans the tiles' totals, forms each block's T_b and rest as
//      the layout scan reads them, and writes the layout, total_bits and
//      each tile's first bit offset;
//   2. the write pass. A unit's CTA takes its first bit from its tile's
//      and the units before it in the tile, builds its items again, scans the
//      widths across the CTA, writes off_pos, and packs each thread's run
//      of items into a shared-memory window of the unit's words through a
//      64-bit register: the words a run fills alone are stored, its first
//      and last (which a neighbour may share) go in by shared atomicOr;
//      the window goes out with coalesced stores, its first and last word
//      by a global atomicOr. A block's CTA packs its header row (a warp:
//      11 slots a lane, offsets by a warp scan, the pad slot filled in)
//      the same way straight to the words, its EOB, a stored block's
//      bytes (four to a word, the run's two end words by atomicOr) and,
//      in block 0's CTA, the tail. OR is order-free, so the words do not
//      depend on the order in which CTAs run.
//
// Domain: S a positive multiple of 32,768 below 2^30; a match's length in
// [3, 258] and distance in [1, 32768]; code lengths at most 15 (items of
// at most 48 bits); header widths >= 0; inputs 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

#include "layout_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                         // positions a thread
constexpr int kUnit = kThreads * kPer;           // 4,096 positions a CTA
constexpr int kTile = 32768;
constexpr int kUnitsPerTile = kTile / kUnit;
constexpr int kNumLL = 286, kNumD = 30;          // symbols looked up
constexpr int kLLStride = 287, kDStride = 31;    // table rows as given
constexpr int kH = 340, kSlotPad = 337, kSlotEob = 339;
constexpr int kHPerLane = (kSlotEob + 31) / 32;  // header slots a lane
constexpr int kMaxItemBits = 48;
constexpr int kWin = kUnit * kMaxItemBits / 32 + 2;  // a unit's words
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Args {
  const uint8_t* data;
  const bool* chosen;
  const int64_t* length;
  const int64_t* dist;
  const int64_t* blk;        // coding block of each tile
  const int64_t* start;      // first tile of each coding block
  const bool* huff;          // block emitted with Huffman codes
  const bool* sto;           // block emitted stored
  const int64_t* blen;       // its bytes
  const int64_t* ll_tab;     // NB x 287 table words
  const int64_t* d_tab;      // NB x 31
  const int64_t* hdr_lo;     // NB x 340 header items
  const int64_t* hdr_nbs;
  int nb, nu, is_final;
  int64_t nw;
  unsigned long long* words;
  int64_t* off_pos;
  int64_t* out;              // base | pad | T_b (NB each) | total | p_end
  int64_t* scratch;          // unit bits | header bits | tiles' prefix |
                             // token base | tile base
  unsigned* ticket;
};

struct Scratch {
  int64_t *unit_bits, *hdr_bits, *P, *tok, *tile_base;
  __device__ explicit Scratch(const Args& a)
      : unit_bits(a.scratch), hdr_bits(unit_bits + a.nu),
        P(hdr_bits + a.nb), tok(P + a.nb + 1), tile_base(tok + a.nb) {}
};

__device__ __forceinline__ int64_t ldg(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// a load past L1: what other CTAs of the launch wrote
__device__ __forceinline__ int64_t ldcg(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

// ------------------------------------------------------------ the items

struct Tok {
  uint64_t v;    // below 2^w
  int w;
};

// length and dist clamped to [0, 259] and [0, 32769] (stage_tokens),
// which keeps what the test length >= 3 and a match's fields in the domain
// see; a distance code past the table's 30 reads its last entry
__device__ __forceinline__ Tok token(bool chosen, int byte, int length,
                                     int dist, const uint32_t* s_ll,
                                     const uint32_t* s_d) {
  if (!chosen) return {0, 0};
  const bool match = length >= 3;
  int sym = byte, lev = 0, leb = 0;
  if (match) {                              // RFC 1951 Table 1
    const int m = length > 258 ? 255 : length - 3;
    if (m < 8) {
      sym = 257 + m;
    } else if (m >= 255) {
      sym = 285;                            // length 258 is exact
    } else {
      const int k = 31 - __clz(m);
      leb = k - 2;
      sym = 257 + 4 * (k - 1) + ((m - (1 << k)) >> leb);
      lev = m & ((1 << leb) - 1);
    }
  }
  const uint32_t t = s_ll[sym];
  const int lb = static_cast<int>(t >> 16);
  uint64_t v = (t & 0xFFFFu) | (static_cast<uint64_t>(lev) << lb);
  int w = lb + leb;
  if (match) {                              // RFC 1951 Table 2
    const int x = dist < 1 ? 0 : dist - 1;
    int dc = x, dev = 0, deb = 0;
    if (x >= 4) {
      const int k = 31 - __clz(x);
      deb = k - 1;
      dc = 2 * k + (x >> deb) - 2;
      dev = x & ((1 << deb) - 1);
    }
    const uint32_t u = s_d[dc < kNumD ? dc : kNumD - 1];
    const int db = static_cast<int>(u >> 16);
    v |= ((u & 0xFFFFu) | (static_cast<uint64_t>(dev) << db)) << w;
    w += db + deb;
  }
  return {w >= 64 ? v : v & ((uint64_t{1} << w) - 1), w};
}

// The unit's lengths and distances, staged in shared memory as one word a
// position (dist << 9 | length) by coalesced 16-byte loads: each thread
// then reads its own kPer consecutive positions from there.
__device__ __forceinline__ uint32_t pack_ld(long long length,
                                            long long dist) {
  const uint32_t l = length < 0 ? 0 : length > 259 ? 259 : length;
  const uint32_t d = dist < 0 ? 0 : dist > 32769 ? 32769 : dist;
  return d << 9 | l;
}

__device__ __forceinline__ void stage_tokens(const Args& a, int64_t u0,
                                             uint32_t* s_ld) {
  const auto* l = reinterpret_cast<const longlong2*>(a.length + u0);
  const auto* d = reinterpret_cast<const longlong2*>(a.dist + u0);
#pragma unroll
  for (int k = 0; k < kPer / 2; ++k) {
    const int i = k * kThreads + threadIdx.x;      // a pair of positions
    const longlong2 x = __ldg(l + i), y = __ldg(d + i);
    reinterpret_cast<uint2*>(s_ld)[i] =
        make_uint2(pack_ld(x.x, y.x), pack_ld(x.y, y.y));
  }
}

// a thread's kPer consecutive positions: the flags and bytes by 16-byte
// loads, the lengths and distances from the staged words
struct Span {
  uint4 chosen, bytes;
  uint32_t ld[kPer];

  __device__ void load(const Args& a, int64_t q0, const uint32_t* s_ld) {
    chosen = *reinterpret_cast<const uint4*>(a.chosen + q0);
    bytes = __ldg(reinterpret_cast<const uint4*>(a.data + q0));
    const auto* w = reinterpret_cast<const uint4*>(s_ld + threadIdx.x * kPer);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const uint4 v = w[j];
      ld[4 * j] = v.x;
      ld[4 * j + 1] = v.y;
      ld[4 * j + 2] = v.z;
      ld[4 * j + 3] = v.w;
    }
  }

  __device__ __forceinline__ static int byte_of(const uint4& v, int i) {
    const unsigned w = (i >> 2) == 0 ? v.x : (i >> 2) == 1 ? v.y
                       : (i >> 2) == 2 ? v.z : v.w;
    return static_cast<int>((w >> (8 * (i & 3))) & 0xFF);
  }

  __device__ __forceinline__ Tok item(int i, const uint32_t* s_ll,
                                      const uint32_t* s_d) const {
    return token(byte_of(chosen, i) != 0, byte_of(bytes, i),
                 static_cast<int>(ld[i] & 511), static_cast<int>(ld[i] >> 9),
                 s_ll, s_d);
  }
};

__device__ __forceinline__ void stage_tables(const Args& a, int64_t b,
                                             uint32_t* s_ll, uint32_t* s_d) {
  for (int i = threadIdx.x; i < kNumLL; i += kThreads)
    s_ll[i] = static_cast<uint32_t>(ldg(a.ll_tab + b * kLLStride + i));
  for (int i = threadIdx.x; i < kNumD; i += kThreads)
    s_d[i] = static_cast<uint32_t>(ldg(a.d_tab + b * kDStride + i));
}

// ------------------------------------------------------------- the runs

// A run of bits from bit `start` of a word array, packed through a 64-bit
// register: emit(word, value, edge) gets each word the run touches once,
// edge = true for its first and last word (a neighbour's bits may share
// them: they go in by atomicOr) and false for the words between (only this
// run writes them: a store).
struct Run {
  uint64_t acc = 0;
  int cur;
  int64_t word;
  bool first = true;

  __device__ explicit Run(int64_t start)
      : cur(static_cast<int>(start & 31)), word(start >> 5) {}

  // v below 2^w, w <= 32
  template <class Emit>
  __device__ __forceinline__ void put(uint32_t v, int w, Emit& emit) {
    acc |= static_cast<uint64_t>(v) << cur;
    cur += w;
    if (cur >= 32) {
      emit(word, static_cast<uint32_t>(acc), first);
      first = false;
      acc >>= 32;
      cur -= 32;
      ++word;
    }
  }

  // an item of up to 64 bits
  template <class Emit>
  __device__ __forceinline__ void put64(uint64_t v, int w, Emit& emit) {
    if (w > 32) {
      put(static_cast<uint32_t>(v), 32, emit);
      put(static_cast<uint32_t>(v >> 32), w - 32, emit);
    } else if (w > 0) {
      put(static_cast<uint32_t>(v), w, emit);
    }
  }

  // a header item: its low min(w, 32) bits, then zeros up to w
  template <class Emit>
  __device__ __forceinline__ void put_item(int64_t lo, int64_t w,
                                           Emit& emit) {
    if (w <= 0) return;
    const int w1 = w >= 32 ? 32 : static_cast<int>(w);
    const uint32_t x = static_cast<uint32_t>(lo);
    put(w1 == 32 ? x : x & ((1u << w1) - 1), w1, emit);
    for (int64_t z = w - 32; z > 0; z -= 32)
      put(0, z >= 32 ? 32 : static_cast<int>(z), emit);
  }

  template <class Emit>
  __device__ __forceinline__ void finish(Emit& emit) {
    if (cur > 0) emit(word, static_cast<uint32_t>(acc), true);
  }
};

// ---------------------------------------------------------------- scans

// the exclusive prefix of x over the CTA's threads in order; the total
__device__ __forceinline__ int cta_scan(int x, int& total, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(kAll, wi, o);
      if (lane >= o) wi += u;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  total = s_warp[kWarps];
  const int r = s_warp[warp] + incl - x;
  __syncthreads();                          // s_warp is free again
  return r;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(kAll, static_cast<long long>(x), o);
  return x;
}

// ------------------------------------------------------- the count pass

// the last CTA: the tiles' prefix of the units' bits; each block's T_b and
// rest, read by the layout scan; the layout; each tile's first bit
__device__ void lay_out(const Args& a, int* s_warp, layout::Shared& s_lay) {
  const Scratch sc(a);
  int64_t* base = a.out;
  int64_t* pad = base + a.nb;
  int64_t* tbits = pad + a.nb;
  int64_t carry = 0;
  for (int c0 = 0; c0 < a.nb; c0 += kThreads) {
    const int t = c0 + threadIdx.x;
    int x = 0;
    if (t < a.nb) {
#pragma unroll
      for (int v = 0; v < kUnitsPerTile; ++v)
        x += static_cast<int>(ldcg(sc.unit_bits + t * kUnitsPerTile + v));
    }
    int total;
    const int ex = cta_scan(x, total, s_warp);
    if (t < a.nb) sc.P[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) sc.P[a.nb] = carry;
  __syncthreads();
  const int64_t n_blocks = a.blk[a.nb - 1] + 1;
  const int64_t p_end = layout::scan(
      a.nb,
      [&](int64_t b, int64_t& r, bool& s) {
        int64_t t = 0;                      // unused buckets carry nothing
        if (b < n_blocks) {
          const int64_t end = b + 1 < n_blocks ? a.start[b + 1] : a.nb;
          t = sc.P[end] - sc.P[a.start[b]];
        }
        tbits[b] = t;
        s = a.sto[b];
        r = ldcg(sc.hdr_bits + b) + t + (s ? 8 * a.blen[b] : 0);
      },
      [&](int64_t b, int64_t bs, int pd) {
        base[b] = bs;
        pad[b] = pd;
        sc.tok[b] = bs + ldcg(sc.hdr_bits + b) -
                    a.hdr_nbs[b * kH + kSlotEob] + pd;
      },
      s_lay);
  for (int t = threadIdx.x; t < a.nb; t += kThreads) {
    const int64_t b = a.blk[t];
    sc.tile_base[t] = sc.tok[b] + sc.P[t] - sc.P[a.start[b]];
  }
  if (threadIdx.x == 0) {
    const int64_t sf_pad = (5 - p_end) & 7;
    a.out[3 * a.nb] = a.is_final ? p_end : p_end + 3 + sf_pad + 32;
    a.out[3 * a.nb + 1] = p_end;
  }
}

__global__ void __launch_bounds__(kThreads) pack_count_kernel(Args a) {
  __shared__ __align__(16) uint32_t s_ld[kUnit];
  __shared__ uint32_t s_ll[kNumLL], s_d[kNumD];
  __shared__ int s_warp[kWarps + 1];
  __shared__ int64_t s_red[2][kWarps];
  __shared__ int s_last;
  __shared__ layout::Shared s_lay;
  const Scratch sc(a);
  const int u = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = int64_t{u} * kThreads + threadIdx.x; i < a.nw;
       i += int64_t{gridDim.x} * kThreads)
    a.words[i] = 0;
  const int64_t b = a.blk[u / kUnitsPerTile];
  int64_t bits = 0, hbits = 0;
  if (a.huff[b]) {
    stage_tables(a, b, s_ll, s_d);
    stage_tokens(a, int64_t{u} * kUnit, s_ld);
    __syncthreads();
    Span sp;
    sp.load(a, int64_t{u} * kUnit + threadIdx.x * kPer, s_ld);
#pragma unroll
    for (int i = 0; i < kPer; ++i) bits += sp.item(i, s_ll, s_d).w;
  }
  if (u < a.nb)
    for (int i = threadIdx.x; i < kH; i += kThreads)
      hbits += a.hdr_nbs[int64_t{u} * kH + i];
  bits = warp_sum(bits);
  hbits = warp_sum(hbits);
  if (lane == 0) {
    s_red[0][warp] = bits;
    s_red[1][warp] = hbits;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t t0 = 0, t1 = 0;
    for (int w = 0; w < kWarps; ++w) {
      t0 += s_red[0][w];
      t1 += s_red[1][w];
    }
    sc.unit_bits[u] = t0;
    if (u < a.nb) sc.hdr_bits[u] = t1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  lay_out(a, s_warp, s_lay);
}

// ------------------------------------------------------- the write pass

// block b's header row, EOB, stored bytes and (block 0) the tail
__device__ void block_items(const Args& a, int b) {
  const Scratch sc(a);
  const int64_t* base = a.out;
  const int64_t* pad = base + a.nb;
  const int64_t* tbits = pad + a.nb;
  const int lane = threadIdx.x & 31;
  auto to_words = [&](int64_t w, uint32_t x, bool edge) {
    if (x == 0 || w >= a.nw) return;        // the words start at 0
    if (edge)
      atomicOr(a.words + w, static_cast<unsigned long long>(x));
    else
      a.words[w] = x;
  };
  const int64_t* lo = a.hdr_lo + int64_t{b} * kH;
  const int64_t* nbs = a.hdr_nbs + int64_t{b} * kH;
  if (threadIdx.x < 32) {                   // slots 0-338, in order
    const int64_t pd = pad[b];
    const int i0 = lane * kHPerLane;
    const int i1 = min(i0 + kHPerLane, kSlotEob);
    int64_t sum = 0;
    for (int i = i0; i < i1; ++i) sum += i == kSlotPad ? pd : nbs[i];
    int64_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(kAll, static_cast<long long>(incl), o);
      if (lane >= o) incl += y;
    }
    Run run(base[b] + incl - sum);
    for (int i = i0; i < i1; ++i)
      run.put_item(lo[i], i == kSlotPad ? pd : nbs[i], to_words);
    run.finish(to_words);
  } else if (threadIdx.x == 32) {           // the EOB after the tokens
    Run run(sc.tok[b] + tbits[b]);
    run.put_item(lo[kSlotEob], nbs[kSlotEob], to_words);
    run.finish(to_words);
  } else if (threadIdx.x == 33 && b == 0 && !a.is_final) {
    // the empty stored block's LEN = 0, NLEN = 0xFFFF on its byte edge
    const int64_t p_end = a.out[3 * a.nb + 1];
    Run run(p_end + 3 + ((5 - p_end) & 7));
    run.put(0xFFFF0000u, 32, to_words);
    run.finish(to_words);
  }
  if (!a.sto[b] || a.blen[b] <= 0) return;
  const int64_t n = a.blen[b] < kTile ? a.blen[b] : kTile;
  const int64_t byte0 = (base[b] + 3 + pad[b] + 32) >> 3;
  const uint8_t* src = a.data + a.start[b] * kTile;
  const int64_t g0 = byte0 >> 2, g1 = (byte0 + n - 1) >> 2;
  for (int64_t g = g0 + threadIdx.x; g <= g1; g += kThreads) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t k = 4 * g + j - byte0;
      if (k >= 0 && k < n) x |= static_cast<uint32_t>(src[k]) << (8 * j);
    }
    to_words(g, x, g == g0 || g == g1);
  }
}

__global__ void __launch_bounds__(kThreads) pack_write_kernel(Args a) {
  __shared__ __align__(16) uint32_t s_ld[kUnit];
  __shared__ uint32_t s_win[kWin];
  __shared__ uint32_t s_ll[kNumLL], s_d[kNumD];
  __shared__ int s_warp[kWarps + 1];
  if (static_cast<int>(blockIdx.x) >= a.nu) {
    block_items(a, blockIdx.x - a.nu);
    return;
  }
  const Scratch sc(a);
  const int u = blockIdx.x;
  const int tile = u / kUnitsPerTile;
  const int64_t b = a.blk[tile];
  int64_t ub = sc.tile_base[tile];          // the unit's first bit
  for (int v = tile * kUnitsPerTile; v < u; ++v) ub += sc.unit_bits[v];
  const int64_t q0 = int64_t{u} * kUnit + threadIdx.x * kPer;
  auto* op = reinterpret_cast<longlong2*>(a.off_pos + q0);
  if (!a.huff[b]) {                         // no token bits here
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) op[j] = make_longlong2(ub, ub);
    return;
  }
  stage_tables(a, b, s_ll, s_d);
  stage_tokens(a, int64_t{u} * kUnit, s_ld);
  __syncthreads();
  Span sp;
  sp.load(a, q0, s_ld);
  Tok t[kPer];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    t[i] = sp.item(i, s_ll, s_d);
    sum += t[i].w;
  }
  int total;
  const int ex = cta_scan(sum, total, s_warp);
  int64_t o = ub + ex;
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    const int64_t o0 = o;
    o += t[2 * j].w;
    op[j] = make_longlong2(o0, o);
    o += t[2 * j + 1].w;
  }
  if (total == 0) return;
  const int64_t w0 = ub >> 5;
  const int nwin = static_cast<int>(((ub + total - 1) >> 5) - w0 + 1);
  for (int i = threadIdx.x; i < nwin; i += kThreads) s_win[i] = 0;
  __syncthreads();
  auto to_window = [&](int64_t w, uint32_t x, bool edge) {
    if (edge) {
      if (x) atomicOr(s_win + w, x);
    } else {
      s_win[w] = x;
    }
  };
  Run run((ub & 31) + ex);
#pragma unroll
  for (int i = 0; i < kPer; ++i) run.put64(t[i].v, t[i].w, to_window);
  run.finish(to_window);
  __syncthreads();
  for (int i = threadIdx.x; i < nwin; i += kThreads) {
    const int64_t g = w0 + i;
    if (g >= a.nw) break;
    const uint32_t x = s_win[i];
    if (i == 0 || i == nwin - 1) {
      if (x) atomicOr(a.words + g, static_cast<unsigned long long>(x));
    } else {
      a.words[g] = x;
    }
  }
}

}  // namespace

// Launches one pass (0: count, 1: write) on `stream` of `device` (made
// current for the call only if it is not) and returns the CUDA error (0 on
// success). Positions: `data` u8[S], `chosen` bool[S], `length` and
// `dist` int64[S]; per tile (NB = S / 32768): `blk`; per coding block
// (NB buckets): `start`, `huff`, `sto`, `blen`, the tables `ll_tab` (NB x
// 287) and `d_tab` (NB x 31) and the header items `hdr_lo`, `hdr_nbs` (NB
// x 340), all int64 but the bool flags. Out: `words` int64[num_words],
// `off_pos` int64[S], `out` int64[3 NB + 2] (base, pad, T_b, total_bits,
// p_end). `scratch` is int64[NU + 4 NB + 1] (NU = S / 4096), `ticket` a
// uint32 that is 0 when no launch on it is running and is left at 0. The
// write pass reads what the count pass left in `out` and `scratch`. All
// allocated by the caller; data, chosen, length, dist and off_pos 16-byte
// aligned.
extern "C" int pack_words_launch(
    const void* data, const void* chosen, const void* length,
    const void* dist, const void* blk, const void* start, const void* huff,
    const void* sto, const void* blen, const void* ll_tab, const void* d_tab,
    const void* hdr_lo, const void* hdr_nbs, int64_t S, int is_final,
    int64_t num_words, void* words, void* off_pos, void* out, void* scratch,
    void* ticket, int pass, int device, void* stream) {
  if (S < kTile || S % kTile || S / kTile > 32767 || num_words < 1 ||
      (pass != 0 && pass != 1) || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.data = static_cast<const uint8_t*>(data);
  a.chosen = static_cast<const bool*>(chosen);
  a.length = static_cast<const int64_t*>(length);
  a.dist = static_cast<const int64_t*>(dist);
  a.blk = static_cast<const int64_t*>(blk);
  a.start = static_cast<const int64_t*>(start);
  a.huff = static_cast<const bool*>(huff);
  a.sto = static_cast<const bool*>(sto);
  a.blen = static_cast<const int64_t*>(blen);
  a.ll_tab = static_cast<const int64_t*>(ll_tab);
  a.d_tab = static_cast<const int64_t*>(d_tab);
  a.hdr_lo = static_cast<const int64_t*>(hdr_lo);
  a.hdr_nbs = static_cast<const int64_t*>(hdr_nbs);
  a.nb = static_cast<int>(S / kTile);
  a.nu = static_cast<int>(S / kUnit);
  a.is_final = is_final != 0;
  a.nw = num_words;
  a.words = static_cast<unsigned long long*>(words);
  a.off_pos = static_cast<int64_t*>(off_pos);
  a.out = static_cast<int64_t*>(out);
  a.scratch = static_cast<int64_t*>(scratch);
  a.ticket = static_cast<unsigned*>(ticket);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (pass == 0)
      pack_count_kernel<<<a.nu, kThreads, 0, st>>>(a);
    else
      pack_write_kernel<<<a.nu + a.nb, kThreads, 0, st>>>(a);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
