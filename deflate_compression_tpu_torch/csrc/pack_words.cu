// The shard encoder's bit-pack for Hopper (sm_90a), plain C interface.
//
// Stands for deflate_compression_tpu/format/deflate.py:421-676, which the
// JAX package left to XLA (it has no Pallas kernel): the token items
// (:421-470, the table lookups by rows_matvec_onehot at :425-429), the
// block layout (:520-534), the item offsets (:546-564), the two sorted
// packs (:566-603, through core/bits.py::pack_items64_to_words :95 and
// pack_items96_to_words :182), the stored payloads' fori_loop (:612-640)
// and the sub-block decode entries (:643-676). What it computes, for a
// shard of S positions in NB = S / 32768 tiles:
//   * each position's token item: for a chosen position, its litlen
//     symbol (the byte, or the length code of a match of length >= 3) and
//     for a match its distance code, both in closed form (RFC 1951
//     §3.2.5), looked up in its coding block's table words (reversed code
//     | length << 16); the item is the litlen code, its extra bits, the
//     distance code and its extra bits, LSB first, at most 48 bits, and 0
//     bits where the block is not emitted with Huffman codes;
//   * T_b, each block's token bits; the layout (layout_scan.cuh) of the
//     blocks: header bits, T_b, EOB and 8 * stored bytes, a stored block's
//     pad before its LEN; each block's token base = base + header bits
//     without the EOB + pad; p_end and total_bits (a non-final shard ends
//     with an empty stored block);
//   * the words: each block's header row (slots 0-338 in order from its
//     base, slot 337 the pad), its tokens from its token base, its EOB
//     after them, a stored block's bytes from the byte edge after LEN and
//     NLEN, and a non-final shard's LEN/NLEN of the empty block, ORed into
//     num_words u32 words (int64, zero-extended); words past total_bits
//     are 0, bits past num_words are dropped;
//   * the decode entries: a Huffman token (chosen, in a block with
//     Huffman codes) whose rank cs among them is a multiple of `stride`,
//     or which is its block's first, is selected; the one of rank r among
//     the selected goes to slot r < NSUB = S / 64 as (its item's bit
//     offset, its position, its block); the other slots hold (-1, 2^30,
//     -1); the overflow flag says whether a selected token ranked >= NSUB.
// The items occupy disjoint bits, so the words equal the plain version's
// (ops/pack_words.py::pack_words_ref) sums of the items' contributions.
//
// What bounds it on this card: bytes. Each position is read once (its
// chosen flag, byte, length and distance: 18 bytes), the words zeroed once
// (one cudaMemsetAsync before the launch, with the look-back's status
// words and the per-block sums) and written once, the NSUB entries
// written once.
//
// One launch, a CTA of 256 threads per unit of 4,096 positions (8 a tile),
// in a single pass with a decoupled look-back (the CUB single-pass scan):
//   1. a CTA takes its unit from a counter (zeroed by the memset), not
//      from blockIdx.x: units start in order, so a CTA only ever waits on
//      units that are running, however few are resident at once;
//   2. it stages the unit's lengths and distances in shared memory (one
//      word a position) with coalesced 16-byte loads; a thread takes its 16
//      consecutive positions from there and their flags and bytes by
//      16-byte loads and builds their items from its block's tables
//      (staged); a CTA scan gives each thread its items' first bit and
//      Huffman tokens within the unit;
//   3. the unit's aggregate is a map of the stream's bit position p mod 8
//      (layout_scan.cuh: C + s ((k - r) mod 8)): the unit that starts a
//      block puts in the previous block's EOB, this block's header bits
//      and, if stored, its pad rule and payload bits; every unit its token
//      bits; the last unit the last block's EOB. Beside it the unit's
//      Huffman tokens and whether it starts a block. It goes out at once,
//      in one 64-bit status word;
//   4. while its predecessors' prefixes arrive, the CTA packs its items as
//      if the unit began on a word: each thread's run through a 64-bit
//      register into a shared-memory window, the words a run fills alone
//      stored, its two end words (which a neighbour may share) by shared
//      atomicOr; each position's bit within the unit is kept for the
//      entries;
//   5. warp 0 looks back: 128 predecessors' status words a round trip
//      (polled with relaxed loads), back to the nearest inclusive prefix
//      (bit position p, Huffman tokens c, selected entries e, whether the
//      open block has had a Huffman token t), then forward over the
//      aggregates between, 128 a fold: each lane composes its four units,
//      a warp scan composes the lanes, each lane counts its units' entries
//      (the multiples of the stride in [c, c + h) telescope; a block's
//      first Huffman token adds one where its rank is not a multiple). The
//      unit publishes its own inclusive prefix: its second word, a fence,
//      then its status word, which a reader fences after before reading
//      the second word;
//   6. the window goes out from the unit's first bit, each word shifted by
//      that bit's place in its word, by coalesced stores, its first and
//      last word by a global atomicOr. The unit that starts a block
//      writes the previous block's EOB, the block's header row (a warp:
//      11 slots a lane, offsets by a warp scan, the pad filled in), its
//      base and pad, and a stored block's bytes (four to a word, the run's
//      two end words by atomicOr); every unit adds its token bits to its
//      block's T_b by atomicAdd; the selected tokens' entries go to their
//      slots; the last unit writes the last EOB, p_end, total_bits, the
//      unused buckets' bases, the tail, the unused slots and the overflow
//      flag. OR is order-free, and the memset is ordered before the launch
//      on the stream, so the words do not depend on the order of CTAs.
//
// Domain: S a positive multiple of 32,768 below 2^30; a match's length in
// [3, 258] and distance in [1, 32768]; code lengths at most 15 (items of
// at most 48 bits); header widths >= 0, zero in buckets past the last
// block; no block both Huffman and stored; a stored block's bytes at most
// 32,768 (they come from its tile); the stride >= 1; inputs 16-byte
// aligned.
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
constexpr int kHBits = 13;                       // a unit's Huffman tokens
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr uint32_t kMaxStride = 1u << 30;        // above every rank cs
constexpr int64_t kNoPos = int64_t{1} << 30;     // an unused slot's position
constexpr int kStats = 7;                        // stats words a unit

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
  const int64_t* stride;     // one scalar
  int nb, nu, is_final;
  int64_t nw, nsub;
  unsigned long long* words;
  int64_t* base;             // NB each: base, pad, T_b; then total_bits,
  int64_t* pad;              // p_end, overflow
  unsigned long long* tbits;
  int64_t* tail;
  unsigned* counter;         // the units' tickets
  unsigned long long* status;  // NU status words
  unsigned long long* incl;    // NU second words of the inclusive prefixes
  int64_t* entries;          // NSUB bit offsets | positions | blocks
  int64_t* stats;            // NU x kStats or null: look-back cycles,
                             // start, aggregate published, end, cycles
                             // to the nearest inclusive prefix, clock64
                             // at the start and at the end
};

__device__ __forceinline__ int64_t ldg(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
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

  __device__ void load_flags(const Args& a, int64_t q0) {
    chosen = __ldg(reinterpret_cast<const uint4*>(a.chosen + q0));
    bytes = __ldg(reinterpret_cast<const uint4*>(a.data + q0));
  }

  __device__ void load_staged(const uint32_t* s_ld) {
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

  __device__ __forceinline__ bool is_chosen(int i) const {
    return byte_of(chosen, i) != 0;
  }

  __device__ __forceinline__ Tok item(int i, const uint32_t* s_ll,
                                      const uint32_t* s_d) const {
    return token(is_chosen(i), byte_of(bytes, i),
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
__device__ __forceinline__ uint32_t cta_scan(uint32_t x, uint32_t& total,
                                             uint32_t* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? s_warp[lane] : 0;
    uint32_t wi = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t u = __shfl_up_sync(kAll, wi, o);
      if (lane >= o) wi += u;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  total = s_warp[kWarps];
  const uint32_t r = s_warp[warp] + incl - x;
  __syncthreads();                          // s_warp is free again
  return r;
}

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(kAll, static_cast<long long>(x), o);
  return x;
}

// ----------------------------------------------------------- look-back

// Status word of a unit: the flag in bits 62-63 (0 not yet, 1 aggregate,
// 2 inclusive prefix). An aggregate holds the unit's map (C in bits 0-39,
// s << 3 | k in 40-43), whether it starts a block (44) and its Huffman
// tokens (45-57); an inclusive prefix the bit position after the unit (bits
// 0-43) and whether its block has had a Huffman token (44), with the
// tokens and entries up to it in the unit's second word (c | e << 32).
constexpr int kFlagShift = 62;
constexpr uint64_t kAggregate = uint64_t{1} << kFlagShift;
constexpr uint64_t kInclusive = uint64_t{2} << kFlagShift;
constexpr uint64_t kMask40 = (uint64_t{1} << 40) - 1;
constexpr uint64_t kMask44 = (uint64_t{1} << 44) - 1;
constexpr int kLook = 4;                 // batches of 32 words a round trip

__device__ __forceinline__ uint64_t ld_relaxed(
    const unsigned long long* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           uint64_t v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// the prefix of the units up to some point
struct State {
  int64_t p;     // bit position
  uint32_t c;    // Huffman tokens before it
  uint32_t e;    // entries selected before it
  bool t;        // the open block has had a Huffman token
};

// ceil(x / s): the multiples of s in [0, x) (x < 2^30, s <= 2^30)
__device__ __forceinline__ uint32_t mult_below(uint32_t x, uint32_t s) {
  return (x + s - 1) / s;
}

// the state after a unit of map m, h Huffman tokens, starting a block or
// not: its entries are the multiples of the stride among its tokens'
// ranks [c, c + h), and its first token if that is its block's first and
// not a multiple
__device__ __forceinline__ State advance(State s, layout::Map m, uint32_t h,
                                         bool starts, uint32_t stride) {
  const bool t0 = starts ? false : s.t;
  const bool extra = h > 0 && !t0 && s.c % stride != 0;
  s.e += mult_below(s.c + h, stride) - mult_below(s.c, stride) +
         (extra ? 1 : 0);
  s.p += layout::apply(m, s.p);
  s.c += h;
  s.t = t0 || h > 0;
  return s;
}

__device__ __forceinline__ State decode_inclusive(uint64_t w, uint64_t w2) {
  return {static_cast<int64_t>(w & kMask44),
          static_cast<uint32_t>(w2 & 0xFFFFFFFFu),
          static_cast<uint32_t>(w2 >> 32), ((w >> 44) & 1) != 0};
}

__device__ __forceinline__ void publish_inclusive(const Args& a, int u,
                                                  State s) {
  st_relaxed(a.incl + u, uint64_t{s.c} | uint64_t{s.e} << 32);
  __threadfence();             // the second word before the flag
  st_relaxed(a.status + u, kInclusive |
                               (static_cast<uint64_t>(s.p) & kMask44) |
                               uint64_t{s.t} << 44);
}

// Units as one element of a warp scan: their map, their Huffman tokens,
// whether a block starts among them (r) and whether a Huffman token lies
// after the last such start, or among them if none (v).
struct Seg {
  layout::Map m;
  uint32_t h;
  bool r, v;
};

// f, then g
__device__ __forceinline__ Seg compose(const Seg& f, const Seg& g) {
  return {layout::compose(f.m, g.m), f.h + g.h, f.r || g.r,
          g.r ? g.v : f.v || g.v};
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int o) {
  const int rv = __shfl_up_sync(kAll, int{x.r} | int{x.v} << 1, o);
  return {layout::shfl_up(x.m, o), __shfl_up_sync(kAll, x.h, o),
          (rv & 1) != 0, (rv & 2) != 0};
}

__device__ __forceinline__ uint64_t pick(const uint64_t (&w)[kLook],
                                         int k) {
  uint64_t x = w[0];
#pragma unroll
  for (int i = 1; i < kLook; ++i) x = k == i ? w[i] : x;
  return x;
}

// a unit's element from its aggregate
__device__ __forceinline__ Seg seg_of(uint64_t w) {
  const uint32_t h = static_cast<uint32_t>((w >> 45) & 8191);
  return {{static_cast<int64_t>(w & kMask40),
           static_cast<int>((w >> 40) & 15)},
          h, ((w >> 44) & 1) != 0, h > 0};
}

// Warp 0: the state after the units in (lo, u) among units [j0, j0 +
// 32 kLook), from the state s before them: lane l holds units j0 + kLook
// l + k in x[k]. A unit that has published its inclusive prefix restarts
// the fold after the last such. Each lane composes its units in order,
// the lanes' elements are scanned in a few shuffle levels, then each lane
// walks its units again from its exclusive prefix for their block-first
// entries (the block's first Huffman token, where its rank is not a
// multiple of the stride); the multiples of the stride telescope.
__device__ State fold(const Args& a, State s, const uint64_t (&x)[kLook],
                      int64_t j0, int64_t lo, int64_t u, uint32_t stride) {
  const int lane = threadIdx.x & 31;
  const int64_t j1 = j0 + kLook * lane;
  int kin = -1;
#pragma unroll
  for (int k = 0; k < kLook; ++k)
    if (j1 + k > lo && j1 + k < u && (x[k] >> kFlagShift) == 2) kin = k;
  const unsigned inc = __ballot_sync(kAll, kin >= 0);
  if (inc) {
    const int l = 31 - __clz(inc);
    const int k = __shfl_sync(kAll, kin, l);
    uint64_t w2 = 0;
    if (lane == l) {           // the second word, written before the flag
      __threadfence();
      w2 = ld_relaxed(a.incl + j1 + k);
    }
    s = decode_inclusive(__shfl_sync(kAll, pick(x, k), l),
                         __shfl_sync(kAll, w2, l));
    lo = j0 + kLook * l + k;
  }
  Seg e = {{0, 0}, 0, false, false};
#pragma unroll
  for (int k = 0; k < kLook; ++k)
    if (j1 + k > lo && j1 + k < u) e = compose(e, seg_of(x[k]));
  Seg in = e;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg y = shfl_up(in, o);
    if (lane >= o) in = compose(y, in);
  }
  Seg ex = shfl_up(in, 1);
  if (lane == 0) ex = {{0, 0}, 0, false, false};
  uint32_t c = s.c + ex.h;                  // the lane's first unit's
  bool t = ex.r ? ex.v : s.t || ex.v;
  uint32_t n_extra = 0;
#pragma unroll
  for (int k = 0; k < kLook; ++k) {
    if (j1 + k > lo && j1 + k < u) {
      const Seg g = seg_of(x[k]);
      const bool t0 = g.r ? false : t;
      n_extra += g.h > 0 && !t0 && c % stride != 0;
      c += g.h;
      t = t0 || g.h > 0;
    }
  }
  n_extra = __reduce_add_sync(kAll, n_extra);
  const Seg tot = {{__shfl_sync(kAll, static_cast<long long>(in.m.c), 31),
                    __shfl_sync(kAll, in.m.sk, 31)},
                   __shfl_sync(kAll, in.h, 31),
                   __shfl_sync(kAll, int{in.r}, 31) != 0,
                   __shfl_sync(kAll, int{in.v}, 31) != 0};
  State r;
  r.p = s.p + layout::apply(tot.m, s.p);
  r.c = s.c + tot.h;
  r.e = s.e + mult_below(r.c, stride) - mult_below(s.c, stride) + n_extra;
  r.t = tot.r ? tot.v : s.t || tot.v;
  return r;
}

// Warp 0: the prefix of units [0, u) from their status words. Back,
// 32 kLook words a round trip (lane l the kLook units below hi - kLook l),
// to the nearest inclusive prefix (waiting on any word not yet written:
// its unit is running), then forward from it over the aggregates between,
// read again, 32 kLook units a fold.
__device__ State look_back(const Args& a, int u, uint32_t stride,
                           uint64_t& found_at) {
  const int lane = threadIdx.x & 31;
  int64_t hi = u - 1, v0;
  uint64_t w[kLook];
  State s;
  for (;;) {
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int64_t j = hi - kLook * lane - k;
      w[k] = j >= 0 ? ld_relaxed(a.status + j) : 0;
    }
    int kin = kLook;
#pragma unroll
    for (int k = kLook - 1; k >= 0; --k) {
      const int64_t j = hi - kLook * lane - k;
      if (j >= 0) {
        while ((w[k] >> kFlagShift) == 0) {
          __nanosleep(32);
          w[k] = ld_relaxed(a.status + j);
        }
      }
      if ((w[k] >> kFlagShift) == 2) kin = k;
    }
    const unsigned inc = __ballot_sync(kAll, kin < kLook);
    if (inc) {                 // unit 0 always publishes an inclusive prefix
      const int l = __ffs(inc) - 1;
      const int k = __shfl_sync(kAll, kin, l);
      v0 = hi - kLook * l - k;
      uint64_t w2 = 0;
      if (lane == l) {         // the second word, written before the flag
        __threadfence();
        w2 = ld_relaxed(a.incl + v0);
      }
      s = decode_inclusive(__shfl_sync(kAll, pick(w, k), l),
                           __shfl_sync(kAll, w2, l));
      found_at = clock64();
      break;
    }
    hi -= 32 * kLook;
  }
  uint64_t x[kLook];
  for (int64_t j0 = v0 + 1; j0 < u; j0 += 32 * kLook) {
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int64_t j = j0 + kLook * lane + k;
      x[k] = j < u ? ld_relaxed(a.status + j) : 0;
    }
    s = fold(a, s, x, j0, j0 - 1, u, stride);
  }
  return s;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}

// ------------------------------------------------------------ the kernel

struct Shared {
  union {
    struct {
      uint32_t ld[kUnit];              // the unit's lengths and distances,
                                       // then its items' bits before them
      uint32_t win[kWin];              // its words from its first bit
    };
    uint4 tile[kTile / 16];            // or a stored block's bytes
  };
  int64_t hw[kH];                      // a block's header widths
  uint32_t hl[kH];                     // and values' low words
  uint32_t ll[kNumLL], d[kNumD];
  uint32_t warp[kWarps + 1];
  int64_t hsum[kWarps];
  State s;                             // the prefix before the unit
  int64_t p_end, n_sel;                // after the unit
  int u;
};

__global__ void __launch_bounds__(kThreads) pack_words_kernel(Args a) {
  __shared__ __align__(16) Shared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t t_start = 0, c_start = 0;
  if (threadIdx.x == 0) {
    if (a.stats) {
      t_start = globaltimer();
      c_start = clock64();
    }
    sh.u = static_cast<int>(atomicAdd(a.counter, 1u));
  }
  __syncthreads();
  const int u = sh.u;
  const int tile = u / kUnitsPerTile;
  const int64_t b = a.blk[tile];
  const bool starts = u % kUnitsPerTile == 0 && a.start[b] == tile;
  const bool last = u == a.nu - 1;
  const bool huff = a.huff[b];
  const bool sto = a.sto[b];
  const int64_t stride_in = ldg(a.stride);
  const uint32_t stride = stride_in < 1 ? 1u
                          : stride_in > kMaxStride
                              ? kMaxStride
                              : static_cast<uint32_t>(stride_in);
  const int64_t q0 = int64_t{u} * kUnit + threadIdx.x * kPer;
  const int64_t* nbs = a.hdr_nbs + b * kH;

  // a block's header row, staged, and its bits without the EOB (slots
  // 0-338 as given); a stored block's bytes, staged
  int64_t hdr_part = 0;
  if (starts) {
    const int64_t* lo = a.hdr_lo + b * kH;
    for (int i = threadIdx.x; i < kH; i += kThreads) {
      const int64_t x = nbs[i];
      sh.hw[i] = x;
      sh.hl[i] = static_cast<uint32_t>(lo[i]);
      if (i < kSlotEob) hdr_part += x;
    }
    if (sto && a.blen[b] > 0) {
      const auto* src = reinterpret_cast<const uint4*>(
          a.data + int64_t{tile} * kTile);
      for (int i = threadIdx.x; i < kTile / 16; i += kThreads)
        sh.tile[i] = __ldg(src + i);
    }
  }

  // the items, in registers until they are packed
  Tok t[kPer];
  uint32_t hmask = 0, wsum = 0;
  if (huff) {
    Span sp;
    sp.load_flags(a, q0);
    stage_tables(a, b, sh.ll, sh.d);
    stage_tokens(a, int64_t{u} * kUnit, sh.ld);
    __syncthreads();
    sp.load_staged(sh.ld);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      t[i] = sp.item(i, sh.ll, sh.d);
      wsum += t[i].w;
      hmask |= sp.is_chosen(i) ? 1u << i : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) t[i] = {0, 0};
  }
  if (starts) {
    hdr_part = warp_sum(hdr_part);
    if (lane == 0) sh.hsum[warp] = hdr_part;
  }
  uint32_t tot;
  const uint32_t ex = cta_scan(wsum << kHBits | __popc(hmask), tot,
                               sh.warp);
  const int64_t W = tot >> kHBits;          // the unit's token bits
  const uint32_t h = tot & ((1u << kHBits) - 1);
  const int64_t wx = ex >> kHBits;          // the thread's first, in it
  const uint32_t hx = ex & ((1u << kHBits) - 1);
  int64_t hs = 0, eprev = 0;
  if (starts) {
    for (int w = 0; w < kWarps; ++w) hs += sh.hsum[w];
    if (b > 0) eprev = nbs[kSlotEob - kH];
  }

  auto to_window = [&](int64_t w, uint32_t x, bool edge) {
    if (edge) {
      if (x) atomicOr(sh.win + w, x);
    } else {
      sh.win[w] = x;
    }
  };

  // the unit's map: the block's start (the previous EOB, the header, a
  // stored block's pad rule and bytes), its tokens, the last EOB
  layout::Map m = {W, 0};
  if (starts) {
    m.c += eprev + hs + (sto ? 8 * a.blen[b] : 0);
    if (sto) m.sk = 8 | static_cast<int>((5 - eprev) & 7);
  }
  if (last) m.c += nbs[kSlotEob];

  // the aggregate, the items into the window from bit 0 while others look
  // back, the look-back, the inclusive prefix
  if (warp == 0 && u > 0 && lane == 0) {
    st_relaxed(a.status + u,
               kAggregate | (static_cast<uint64_t>(m.c) & kMask40) |
                   uint64_t(m.sk & 15) << 40 | uint64_t{starts} << 44 |
                   uint64_t{h} << 45);
    if (a.stats)
      a.stats[kStats * u + 2] = static_cast<int64_t>(globaltimer());
  }
  const int nwin = static_cast<int>((W + 31) >> 5);
  if (W > 0 || h > 0) {
    for (int i = threadIdx.x; i <= nwin; i += kThreads) sh.win[i] = 0;
    __syncthreads();
    Run run(wx);
    uint32_t o = static_cast<uint32_t>(wx);
    uint32_t* rel = sh.ld + threadIdx.x * kPer;   // the thread's own words
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      rel[i] = o;
      o += t[i].w;
      run.put64(t[i].v, t[i].w, to_window);
    }
    run.finish(to_window);
  }
  if (warp == 0) {                 // the other warps may still be packing
    uint64_t c0 = 0, found_at = 0;
    State s = {0, 0, 0, false};
    if (u > 0) {
      if (a.stats && lane == 0) c0 = clock64();
      s = look_back(a, u, stride, found_at);
    }
    if (lane == 0) {
      const State incl = advance(s, m, h, starts, stride);
      publish_inclusive(a, u, incl);
      if (a.stats) {
        a.stats[kStats * u] = u > 0 ? clock64() - c0 : 0;
        a.stats[kStats * u + 4] = u > 0 ? found_at - c0 : 0;
        if (u == 0) a.stats[2] = static_cast<int64_t>(globaltimer());
      }
      sh.s = s;
      sh.p_end = incl.p;
      sh.n_sel = incl.e;
    }
  }
  __syncthreads();
  const State s = sh.s;

  auto to_words = [&](int64_t w, uint32_t x, bool edge) {
    if (x == 0 || w >= a.nw) return;        // the words start at 0
    if (edge)
      atomicOr(a.words + w, static_cast<unsigned long long>(x));
    else
      a.words[w] = x;
  };

  // the block's start: the previous EOB, the header row, base, pad, bytes
  int64_t ub = s.p;                         // the unit's first token bit
  if (starts) {
    const int64_t base = s.p + eprev;
    const int64_t pd = sto ? (5 - base) & 7 : 0;
    ub = base + hs + pd;
    if (warp == 0) {                        // slots 0-338, in order
      const int i0 = lane * kHPerLane;
      const int i1 = min(i0 + kHPerLane, kSlotEob);
      int64_t sum = 0;
      for (int i = i0; i < i1; ++i) sum += i == kSlotPad ? pd : sh.hw[i];
      int64_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t y =
            __shfl_up_sync(kAll, static_cast<long long>(incl), o);
        if (lane >= o) incl += y;
      }
      Run run(base + incl - sum);
      for (int i = i0; i < i1; ++i)
        run.put_item(sh.hl[i], i == kSlotPad ? pd : sh.hw[i], to_words);
      run.finish(to_words);
      if (lane == 0) {
        a.base[b] = base;
        a.pad[b] = pd;
      }
    } else if (threadIdx.x == 32 && b > 0) {  // the previous block's EOB
      Run run(s.p);
      run.put_item(a.hdr_lo[b * kH - 1], eprev, to_words);
      run.finish(to_words);
    }
    if (sto && a.blen[b] > 0) {
      const int64_t n = a.blen[b] < kTile ? a.blen[b] : kTile;
      const int64_t byte0 = (base + 3 + pd + 32) >> 3;
      const auto* src = reinterpret_cast<const uint8_t*>(sh.tile);
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
  }

  // the window out from the unit's first bit, its words shifted by that
  // bit's place in its word; the decode entries among the thread's Huffman
  // tokens at their bits in the window
  if (W > 0 || h > 0) {
    if (threadIdx.x == 0)
      atomicAdd(a.tbits + b, static_cast<unsigned long long>(W));
    const int64_t w0 = ub >> 5;
    const int sft = static_cast<int>(ub & 31);
    const int nout = static_cast<int>((sft + W + 31) >> 5);
    for (int i = threadIdx.x; i < nout; i += kThreads) {
      const int64_t g = w0 + i;
      if (g >= a.nw) break;
      uint32_t x = sh.win[i] << sft;
      if (sft && i > 0) x |= sh.win[i - 1] >> (32 - sft);
      if (i == 0 || i == nout - 1) {
        if (x) atomicOr(a.words + g, static_cast<unsigned long long>(x));
      } else {
        a.words[g] = x;
      }
    }
    if (hmask) {
      const bool t0 = starts ? false : s.t;
      const bool extra = !t0 && s.c % stride != 0;  // the block's first token
      uint32_t cs = s.c + hx;
      uint32_t next = mult_below(cs, stride);
      int64_t r = s.e + (next - mult_below(s.c, stride)) +
                  (extra && hx > 0 ? 1 : 0);
      next *= stride;                       // the next multiple from cs
      const uint32_t* rel = sh.ld + threadIdx.x * kPer;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (hmask >> i & 1) {
          const bool mult = cs == next;
          if (mult) next += stride;
          if (mult || (extra && cs == s.c)) {
            if (r < a.nsub) {
              a.entries[r] = ub + rel[i];
              a.entries[a.nsub + r] = q0 + i;
              a.entries[2 * a.nsub + r] = b;
            }
            ++r;
          }
          ++cs;
        }
      }
    }
  }

  // the last unit: the last EOB, the end, the tail, the unused slots
  if (last) {
    const int64_t p_end = sh.p_end;
    const int64_t n_sel = sh.n_sel;         // the entries selected
    if (threadIdx.x == 0) {
      Run run(ub + W);
      run.put_item(a.hdr_lo[b * kH + kSlotEob], nbs[kSlotEob], to_words);
      run.finish(to_words);
      const int64_t sf_pad = (5 - p_end) & 7;
      a.tail[0] = a.is_final ? p_end : p_end + 3 + sf_pad + 32;
      a.tail[1] = p_end;
    } else if (threadIdx.x == 32 && !a.is_final) {
      // the empty stored block's LEN = 0, NLEN = 0xFFFF on its byte edge
      Run run(p_end + 3 + ((5 - p_end) & 7));
      run.put(0xFFFF0000u, 32, to_words);
      run.finish(to_words);
    }
    for (int64_t k = b + 1 + threadIdx.x; k < a.nb; k += kThreads)
      a.base[k] = p_end;                    // unused buckets
    if (threadIdx.x == 0) a.tail[2] = n_sel > a.nsub;
    for (int64_t k = (n_sel < a.nsub ? n_sel : a.nsub) + threadIdx.x;
         k < a.nsub; k += kThreads) {
      a.entries[k] = -1;
      a.entries[a.nsub + k] = kNoPos;
      a.entries[2 * a.nsub + k] = -1;
    }
  }
  if (a.stats && threadIdx.x == 0) {
    a.stats[kStats * u + 1] = static_cast<int64_t>(t_start);
    a.stats[kStats * u + 3] = static_cast<int64_t>(globaltimer());
    a.stats[kStats * u + 5] = static_cast<int64_t>(c_start);
    a.stats[kStats * u + 6] = static_cast<int64_t>(clock64());
  }
}

}  // namespace

// Zeroes `buf` and launches the kernel on `stream` of `device` (made
// current for the call only if it is not); returns the CUDA error (0 on
// success). Positions: `data` u8[S], `chosen` bool[S], `length` and
// `dist` int64[S]; per tile (NB = S / 32768): `blk`; per coding block
// (NB buckets): `start`, `huff`, `sto`, `blen`, the tables `ll_tab` (NB x
// 287) and `d_tab` (NB x 31) and the header items `hdr_lo`, `hdr_nbs` (NB
// x 340), all int64 but the bool flags; `stride` an int64 scalar. `buf`
// is int64[num_words + 3 NB + 4 + 2 NU] (NU = S / 4096): the words, then
// base, pad, T_b (NB each), total_bits, p_end, the overflow flag, the
// units' counter, the status words and the second words (NU each).
// `entries` is int64[3 NSUB] (NSUB = S / 64): bit offsets, positions,
// blocks. `stats` is null or int64[7 NU]: each unit's look-back in clock64
// cycles; its start, its aggregate's publication and its end on the
// globaltimer (ns); the look-back's cycles to the nearest inclusive
// prefix; its SM's clock64 at its start and at its end. All allocated by
// the caller; data, chosen, length and dist 16-byte aligned.
extern "C" int pack_words_launch(
    const void* data, const void* chosen, const void* length,
    const void* dist, const void* blk, const void* start, const void* huff,
    const void* sto, const void* blen, const void* ll_tab, const void* d_tab,
    const void* hdr_lo, const void* hdr_nbs, const void* stride, int64_t S,
    int is_final, int64_t num_words, void* buf, void* entries, void* stats,
    int device, void* stream) {
  if (S < kTile || S % kTile || S / kTile > 32767 || num_words < 1 ||
      device < 0 || device >= kMaxDevices)
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
  a.stride = static_cast<const int64_t*>(stride);
  a.nb = static_cast<int>(S / kTile);
  a.nu = static_cast<int>(S / kUnit);
  a.is_final = is_final != 0;
  a.nw = num_words;
  a.nsub = S / 64;
  int64_t* p = static_cast<int64_t*>(buf);
  a.words = reinterpret_cast<unsigned long long*>(p);
  a.base = p + num_words;
  a.pad = a.base + a.nb;
  a.tbits = reinterpret_cast<unsigned long long*>(a.pad + a.nb);
  a.tail = a.pad + 2 * a.nb;
  a.counter = reinterpret_cast<unsigned*>(a.tail + 3);
  a.status = reinterpret_cast<unsigned long long*>(a.tail + 4);
  a.incl = a.status + a.nu;
  a.entries = static_cast<int64_t*>(entries);
  a.stats = static_cast<int64_t*>(stats);
  const size_t n_buf = sizeof(int64_t) *
                       (num_words + 3 * int64_t{a.nb} + 4 + 2 * int64_t{a.nu});
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    e = cudaMemsetAsync(buf, 0, n_buf, st);
    if (e == cudaSuccess) {
      pack_words_kernel<<<a.nu, kThreads, 0, st>>>(a);
      e = cudaGetLastError();
    }
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}

// The kernel's CTAs that fit on `device` at once (blocks a multiple-
// processor can hold, by its registers and shared memory, times the
// multiprocessors) into *n; returns the CUDA error.
extern "C" int pack_words_resident(int device, int* n) {
  int per = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, pack_words_kernel, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *n = per * sms;
  return static_cast<int>(e);
}
