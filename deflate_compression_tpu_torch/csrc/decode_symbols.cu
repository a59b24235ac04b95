// Phase-B symbol decode of the indexed DEFLATE decoder, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU's LUT gather probed in tools/probe_pallas_r5.py::try_lower
// (kernels k_take / k_intidx / k_tala / k_onehot: out[i] = tbl[idx[i]] with
// tbl i32[2048], idx i32[4096]), which Mosaic could not lower, so the JAX
// decoder (decode/tpu_inflate.py dec_body) resolved each Huffman code by a
// dense compare over the symbol axis instead. Here the gather is what it
// wanted to be: each CTA holds its coding block's 2^11-entry litlen and
// dist LUTs in shared memory and every lookup is one shared-memory load.
//
// What it computes (exactly ops/decode_symbols.py::decode_symbols_ref): each
// sub-entry lane decodes tokens from the lane's start bit until its output
// cursor reaches lane_end, writing each token packed as
//     value | dist << 9 | 1 << 25 | is_match << 26
// at tok[cursor]. A lane goes bad, and stops without emitting, on an invalid
// prefix, a litlen symbol >= 286, EOB before lane_end, a dist symbol >= 30,
// a distance over max_dist, a token past lane_end or a read past the bit
// budget; after max_steps symbols it stops neither done nor bad.
//
// Codes longer than the 11-bit LUT (zlib streams use up to 15 bits; the
// encoder of this repository caps at 11) hit a LUT entry marked long and
// resolve by the RFC 1951 §3.2.2 count/first-code walk over the block's
// canonical tables, also in shared memory; the symbols' payloads come from
// the RFC tables in constant memory.
//
// What bounds it on this card. The function writes the whole token array
// (4 bytes per output position, zeroed by the wrapper, nearly every 32-byte
// sector of it taking a token), so its bytes are those 38 MB for an 8.5 MB
// corpus plus the stream, one 17.8 KB table set per block and the lanes'
// state: about 48 MB, 14 us at 3.35 TB/s. The kernel itself writes the
// tokens' sectors sparsely (a token every few positions), and every token
// is a dependent chain: stream bits -> litlen LUT -> extra bits -> dist
// LUT -> store.
//
// What the design does about it:
//  * One thread per lane, kThreads (256) lanes per CTA in the lanes' own
//    order, so the grid is fixed by the lane count and the wrapper builds no
//    plan: it launches the kernel and waits for nothing. The index lists a
//    block's lanes together, so a CTA's lanes belong to one or two blocks;
//    each round stages the tables of the kSets (2) smallest blocks still
//    pending among the CTA's lanes and decodes their lanes, until none is
//    left (any lane order is decoded exactly, in more rounds).
//  * Thread 0 stages a round's tables with cp.async.bulk on an mbarrier
//    while the other threads load their lane's state and first word.
//  * Each thread keeps a 64-bit bit buffer in registers and refills it with
//    one aligned 32-bit word when fewer than 32 bits remain: at most once
//    before the litlen code and once before the dist code.
//  * Tokens are stored a 16-byte group at a time: a lane holds the tokens
//    of its current 4-position group in registers and stores the group when
//    it moves past it, so a run of literals costs one store per 4 tokens.
//  * The symbols' payloads come from constant memory; every lane's done,
//    bad and cursor are written by the kernel, so nothing is copied from
//    the host or filled before the launch but the zeroed tokens.
// A CTA per 1024 lanes of one block, staging each block's tables once
// and handing out lanes from a shared counter, was measured on an H100
// and ran slower: 200 large CTAs do not spread evenly over 132 SMs, and
// the lanes are even (12-14 tokens each), so handing them out gains
// nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLutBits = 11;
constexpr int kLutSize = 1 << kLutBits;
constexpr uint32_t kLutMask = kLutSize - 1;
constexpr int32_t kLongCode = 1 << 30;
constexpr int kNumLitlen = 288;
constexpr int kNumDist = 32;
constexpr int kMaxBits = 15;
constexpr int kCntLen = kMaxBits + 1;
constexpr int kThreads = 256;            // threads, and so lanes, per CTA
constexpr int kSets = 2;                  // table sets staged per round
constexpr int kNone = 0x7FFFFFFF;         // no block pending
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
constexpr long long kWaitCycles = 1ll << 34;   // about 9 s: a lost copy traps

// RFC 1951 §3.2.5: base and extra bits of length codes 257..285 and of
// distance codes 0..29.
__constant__ int16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
    12289, 16385, 24577};
__constant__ int8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// A block's tables, as the wrapper lays them out per row (16-byte aligned
// rows, so each field is one bulk copy).
struct Tables {
  int32_t ll_lut[kLutSize];
  int32_t d_lut[kLutSize];
  int32_t ll_sym[kNumLitlen];
  int32_t d_sym[kNumDist];
  int32_t ll_cnt[kCntLen];
  int32_t d_cnt[kCntLen];
};
constexpr uint32_t kTableBytes = sizeof(Tables);

struct Params {
  const uint32_t* words;
  int64_t n_words;
  const int64_t* bp0;
  const int64_t* ocur0;
  const int64_t* lane_end;
  const int32_t* lblk;
  const uint8_t* lbad;
  int64_t n_lanes;
  int64_t n_blocks;
  const int32_t* ll_lut;
  const int32_t* d_lut;
  const int32_t* ll_cnt;
  const int32_t* d_cnt;
  const int32_t* ll_sym;
  const int32_t* d_sym;
  int64_t max_dist;
  int64_t bit_budget;
  int64_t out_size;
  int64_t max_steps;
  int32_t* tok;
  uint8_t* done;
  uint8_t* bad;
  int64_t* ocur;
};

enum Step { kMore = 0, kDone = 1, kBad = 2 };

// Static payloads (ops/decode_symbols.py LL_PAY / D_PAY). litlen: value(9)
// | extra bits(3) << 9 | kind(2) << 12 (0 lit, 1 EOB, 2 length, 3 bad);
// dist: base(15) | extra bits(4) << 15 | bad(1) << 19.
__device__ __forceinline__ int32_t ll_pay(int s) {
  if (s < 256) return s;
  if (s == 256) return 1 << 12;
  if (s < 286) return kLenBase[s - 257] | (kLenExtra[s - 257] << 9) | (2 << 12);
  return 3 << 12;
}

__device__ __forceinline__ int32_t d_pay(int s) {
  return s < 30 ? kDistBase[s] | (kDistExtra[s] << 15) : 1 << 19;
}

// RFC 1951 §3.2.2 canonical decode, one bit at a time in stream order:
// cnt[len] codes of each length, sym[] the symbols in canonical order.
// Returns pay(symbol) | len << shift, or 0 when no code matches.
template <bool kLitlen>
__device__ int32_t slow_decode(const int32_t* cnt, const int32_t* sym,
                               uint64_t bits) {
  constexpr int nsym = kLitlen ? kNumLitlen : kNumDist;
  constexpr int shift = kLitlen ? 14 : 20;
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= kMaxBits; ++len) {
    code |= static_cast<int>(bits & 1u);
    bits >>= 1;
    const int count = cnt[len];
    if (code - count < first) {
      const int k = index + (code - first);
      if (k < 0 || k >= nsym) return 0;
      const int s = sym[k];
      if (s < 0 || s >= nsym) return 0;
      return (kLitlen ? ll_pay(s) : d_pay(s)) | (len << shift);
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Wait for the mbarrier's phase of this parity to complete; trap rather
// than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One lane's decode state. The bit buffer holds the next nb stream bits,
// LSB first, and wi is the next word to load (words outside [0, n_words)
// read 0); bleft is the bits the budget still allows (bit_budget - bit
// position).
struct Lane {
  uint64_t buf;
  int nb;
  int64_t wi;
  int64_t ocur;
  int64_t start;              // the lane's first output position
  int64_t end;
  int64_t bleft;
  int64_t group;              // the 4-aligned position of `pend`, -1: none
  int4 pend;                  // tokens of that group not yet stored
};

__device__ __forceinline__ uint32_t word_at(const Params& p, int64_t k) {
  return static_cast<uint64_t>(k) < static_cast<uint64_t>(p.n_words)
             ? __ldg(p.words + k) : 0u;
}

__device__ __forceinline__ void refill(const Params& p, Lane& L) {
  if (L.nb < 32) {
    L.buf |= static_cast<uint64_t>(word_at(p, L.wi)) << L.nb;
    L.nb += 32;
    ++L.wi;
  }
}

// Store the lane's pending group of 4 tokens: one 16-byte store where the
// group lies inside the lane's own positions [start, end), else its tokens
// one by one. A lane's positions are its alone: a lane ends at most where
// the next sub-entry starts, and the index lists its sub-entries in output
// order (DecodeIndex rejects one that does not). tok is zero wherever no
// token lands.
__device__ __forceinline__ void flush(const Params& p, Lane& L) {
  const int64_t g = L.group;
  if (g < 0) return;
  if (g >= L.start && g + 4 <= L.end && g + 4 <= p.out_size) {
    *reinterpret_cast<int4*>(p.tok + g) = L.pend;
  } else {
    if (L.pend.x) p.tok[g] = L.pend.x;
    if (L.pend.y && g + 1 < p.out_size) p.tok[g + 1] = L.pend.y;
    if (L.pend.z && g + 2 < p.out_size) p.tok[g + 2] = L.pend.z;
    if (L.pend.w && g + 3 < p.out_size) p.tok[g + 3] = L.pend.w;
  }
  L.group = -1;
}

// tok[pos] = pack (packs are never 0), through the pending group.
__device__ __forceinline__ void emit(const Params& p, Lane& L, int64_t pos,
                                     int32_t pack) {
  if (pos < 0 || pos >= p.out_size) return;
  const int64_t g = pos & ~int64_t{3};
  if (g != L.group) {
    flush(p, L);
    L.group = g;
    L.pend = make_int4(0, 0, 0, 0);
  }
  const int k = static_cast<int>(pos & 3);
  L.pend.x = k == 0 ? pack : L.pend.x;
  L.pend.y = k == 1 ? pack : L.pend.y;
  L.pend.z = k == 2 ? pack : L.pend.z;
  L.pend.w = k == 3 ? pack : L.pend.w;
}

// Decode one token of lane L.
__device__ __forceinline__ Step decode_token(const Params& p, const Tables& t,
                                             Lane& L) {
  refill(p, L);
  int32_t e = t.ll_lut[L.buf & kLutMask];
  if (e == kLongCode) e = slow_decode<true>(t.ll_cnt, t.ll_sym, L.buf);
  const int cl = (e >> 14) & 0xF;
  const int kind = (e >> 12) & 3;         // 0 lit, 1 EOB, 2 length, 3 bad
  if (cl == 0 || (kind & 1)) return kBad;
  L.buf >>= cl;
  L.nb -= cl;
  int64_t adv = 1;
  int nbits = cl;
  int32_t pack = (e & 0x1FF) | (1 << 25);
  if (kind == 2) {
    const int leb = (e >> 9) & 7;
    const int mlen = (e & 0x1FF) + static_cast<int>(L.buf & ((1u << leb) - 1u));
    L.buf >>= leb;
    L.nb -= leb;
    refill(p, L);
    int32_t de = t.d_lut[L.buf & kLutMask];
    if (de == kLongCode) de = slow_decode<false>(t.d_cnt, t.d_sym, L.buf);
    const int dcl = (de >> 20) & 0xF;
    if (dcl == 0 || ((de >> 19) & 1)) return kBad;
    const int deb = (de >> 15) & 0xF;
    L.buf >>= dcl;
    const int mdist =
        (de & 0x7FFF) + static_cast<int>(L.buf & ((1u << deb) - 1u));
    L.buf >>= deb;
    L.nb -= dcl + deb;
    if (mdist > p.max_dist) return kBad;
    adv = mlen;
    nbits = cl + leb + dcl + deb;
    pack = mlen | (mdist << 9) | (1 << 25) | (1 << 26);
  }
  const int64_t ocur2 = L.ocur + adv;
  if (ocur2 > L.end || nbits > L.bleft) return kBad;
  emit(p, L, L.ocur, pack);
  L.ocur = ocur2;
  L.bleft -= nbits;
  return L.ocur >= L.end ? kDone : kMore;
}

// Decode a lane from bit bp (whose word is `word`) and cursor ocur to its
// end, at most max_steps tokens; returns the outcome and sets *cur to the
// final cursor.
__device__ Step run_lane(const Params& p, const Tables& t, int64_t bp,
                         uint32_t word, int64_t ocur, int64_t end,
                         int64_t* cur) {
  Lane L;
  const int sh = static_cast<int>(bp & 31);
  L.buf = word >> sh;
  L.nb = 32 - sh;
  L.wi = (bp >> 5) + 1;
  L.ocur = ocur;
  L.start = ocur;
  L.end = end;
  L.bleft = p.bit_budget - bp;
  L.group = -1;
  Step r = kMore;
  for (int64_t n = p.max_steps; n > 0 && r == kMore; --n)
    r = decode_token(p, t, L);
  flush(p, L);
  *cur = L.ocur;
  return r;
}

// Stage block b's tables into t, counted on the mbarrier.
__device__ __forceinline__ void stage(Tables& t, const Params& p, int64_t b,
                                      uint32_t bar) {
  bulk_load(t.ll_lut, p.ll_lut + b * kLutSize, sizeof(t.ll_lut), bar);
  bulk_load(t.d_lut, p.d_lut + b * kLutSize, sizeof(t.d_lut), bar);
  bulk_load(t.ll_sym, p.ll_sym + b * kNumLitlen, sizeof(t.ll_sym), bar);
  bulk_load(t.d_sym, p.d_sym + b * kNumDist, sizeof(t.d_sym), bar);
  bulk_load(t.ll_cnt, p.ll_cnt + b * kCntLen, sizeof(t.ll_cnt), bar);
  bulk_load(t.d_cnt, p.d_cnt + b * kCntLen, sizeof(t.d_cnt), bar);
}

// The smallest of the CTA's values `v` (one per thread), to every thread.
__device__ __forceinline__ int cta_min(int v, int* scratch) {
  v = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = kNone;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = min(m, scratch[w]);
  __syncthreads();                        // scratch is reused
  return m;
}

__global__ void __launch_bounds__(kThreads)
decode_symbols_kernel(const Params p) {
  __shared__ __align__(16) Tables t[kSets];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_scratch[kThreads / 32];

  // this thread's lane; a lane that is dead, finished or bad from the
  // start gets its results now, the others wait for their block's round
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  int pending = kNone;
  int64_t bp = 0, ocur = 0, end = 0;
  uint32_t word = 0;
  if (lane < p.n_lanes) {
    const int32_t b = p.lblk[lane];
    ocur = p.ocur0[lane];
    end = p.lane_end[lane];
    const bool bad = p.lbad[lane] != 0;
    if (b >= 0 && b < p.n_blocks && ocur < end && !bad) {
      pending = b;
      bp = p.bp0[lane];
      word = word_at(p, bp >> 5);
    } else {
      p.done[lane] = b < 0 || ocur >= end;
      p.bad[lane] = bad;
      p.ocur[lane] = ocur;
    }
  }

  const uint32_t bar = smem_u32(&s_bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (uint32_t round = 0;; ++round) {
    // the kSets smallest blocks still pending among the CTA's lanes
    int blk[kSets];
    int rest = pending;
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      blk[s] = cta_min(rest, s_scratch);
      if (rest == blk[s]) rest = kNone;
    }
    if (blk[0] == kNone) break;           // uniform over the CTA
    if (threadIdx.x == 0) {
      const int sets = blk[1] == kNone ? 1 : 2;
      // the last round's reads of the tables are ordered before the copies
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(sets * kTableBytes) : "memory");
      stage(t[0], p, blk[0], bar);
      if (sets == 2) stage(t[1], p, blk[1], bar);
    }
    mbar_wait(bar, round & 1);
    if (pending != kNone && (pending == blk[0] || pending == blk[1])) {
      int64_t cur;
      const Step r = run_lane(p, t[pending == blk[0] ? 0 : 1], bp, word,
                              ocur, end, &cur);
      p.done[lane] = r == kDone;
      p.bad[lane] = r == kBad;
      p.ocur[lane] = cur;
      pending = kNone;
    }
    __syncthreads();                      // the tables are free again
  }
}

}  // namespace

// Launches one thread per lane on `stream` of `device` (made current for
// the call only if it is not); returns the CUDA error (0 on success). Every
// pointer is a device pointer; the tables' rows are 16-byte aligned. The
// caller allocates the outputs and zeroes `tok`; the kernel writes done,
// bad and ocur of every lane.
extern "C" int decode_symbols_launch(
    const void* words, int64_t n_words, const void* bp0, const void* ocur0,
    const void* lane_end, const void* lblk, const void* lbad, int64_t n_lanes,
    int64_t n_blocks, const void* ll_lut, const void* d_lut,
    const void* ll_cnt, const void* d_cnt, const void* ll_sym,
    const void* d_sym, int64_t max_dist, int64_t bit_budget, int64_t out_size,
    int64_t max_steps, void* tok, void* done, void* bad, void* ocur,
    int device, void* stream) {
  if (n_lanes <= 0) return 0;
  const int64_t grid = (n_lanes + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFF || n_blocks < 0 || n_blocks > 0x7FFFFFFF ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.words = static_cast<const uint32_t*>(words);
  p.n_words = n_words;
  p.bp0 = static_cast<const int64_t*>(bp0);
  p.ocur0 = static_cast<const int64_t*>(ocur0);
  p.lane_end = static_cast<const int64_t*>(lane_end);
  p.lblk = static_cast<const int32_t*>(lblk);
  p.lbad = static_cast<const uint8_t*>(lbad);
  p.n_lanes = n_lanes;
  p.n_blocks = n_blocks;
  p.ll_lut = static_cast<const int32_t*>(ll_lut);
  p.d_lut = static_cast<const int32_t*>(d_lut);
  p.ll_cnt = static_cast<const int32_t*>(ll_cnt);
  p.d_cnt = static_cast<const int32_t*>(d_cnt);
  p.ll_sym = static_cast<const int32_t*>(ll_sym);
  p.d_sym = static_cast<const int32_t*>(d_sym);
  p.max_dist = max_dist;
  p.bit_budget = bit_budget;
  p.out_size = out_size;
  p.max_steps = max_steps;
  p.tok = static_cast<int32_t*>(tok);
  p.done = static_cast<uint8_t*>(done);
  p.bad = static_cast<uint8_t*>(bad);
  p.ocur = static_cast<int64_t*>(ocur);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    decode_symbols_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
