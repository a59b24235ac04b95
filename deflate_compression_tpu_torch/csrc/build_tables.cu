// Phase A of the indexed DEFLATE decoder, block headers and decode tables,
// for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX decoder left this stage to XLA
// (deflate_compression_tpu/decode/tpu_inflate.py:352-455: the header
// fields, rle_body / rle_body4, _canon_first and _sym_tables), as masked
// vector steps over all blocks at once. In plain PyTorch that shape costs
// up to 320 RLE steps of some 65 small operations each, every one a launch.
//
// What it computes (exactly ops/build_tables.py::build_tables_ref, for
// every block slot: live, dead, stored, fixed, reserved BTYPE, and blocks
// that go bad): the BTYPE classes; for a dynamic block HLIT/HDIST/HCLEN, the
// 19 code-length lengths, the code-length code's 7-bit LUT and the RLE walk
// over at most 316 lengths (a block's state freezes in the step in which it
// goes bad, after that step's writes); for a fixed block the RFC lengths;
// then for the litlen and the dist alphabet the Kraft flag, the count of
// codes per length, the symbols in canonical order and the 2^11-entry
// primary LUT (payload | length << shift, the sum of the payloads where an
// oversubscribed tree's codes collide, LONG_CODE where only codes over 11
// bits share the prefix). Bits are read with word indices clipped to the
// array, so a corrupt header near the end of the words reads the same bits.
//
// What bounds it on this card. Per block slot it reads at most 600 bytes of
// stream and writes 17.8 KB of tables: 1,024 slots are 18 MB, 5.5 us at
// 3.35 TB/s. All slots run at once, so the latency of one CTA sets the time,
// and in that CTA the code-length walk is a chain of up to 316 dependent
// steps (bits -> code-length LUT -> extra bits -> next bit position). Walked
// by one thread with its decode in every step (the first design), that chain
// was most of the kernel.
//
// What the design does about it:
//  * One CTA per block slot, 320 threads: one per symbol of the two
//    alphabets (288 litlen, 32 dist). Nothing waits for the host (the plain
//    version asks the device every 8 steps whether any block is still
//    active).
//  * The header's words are staged in shared memory by the whole CTA; bit
//    positions are 32-bit offsets from the first staged word (word indices
//    still clipped to the array; a word past the window is read from device
//    memory).
//  * The 19 code-length lengths are read by 19 threads, the code-length
//    code's canonical codes by 19 and its 128-entry LUT by 128 threads.
//  * Every thread decodes the code-length symbol at 7 of the 2,240 bit
//    offsets a walk can reach (a step takes at most 7 bits per length it
//    adds): its next offset, repeat count and symbol, one word in shared
//    memory. The chain left, the path of offsets from the first RLE bit, is
//    found by pointer doubling over the next offsets: 9 rounds of the whole
//    CTA (thread 0 following the chain, one shared-memory load a step, took
//    up to 1.4x the time of the kernel).
//  * Then one thread per step: a CTA scan of the repeat counts places each
//    step, a scan of the last fill that is not a repeat (16) gives each
//    step's previous length, a min-reduce finds the last step (the one that
//    completes the lengths or reads no code) and another the first step that
//    goes bad; the state freezes after it, and every thread writes one of
//    the 316 lengths from the step that covers it (a binary search over
//    the steps' ends).
//  * Ranks within a length come from __match_any_sync and per-warp counts,
//    canonical codes and the canonical order from those ranks; every warp
//    fills the LUT in shared memory for its own 32 symbols (a code of
//    length L adds its payload to 2^(11-L) strided entries, the lanes
//    striding over them); the tables leave shared memory in 16-byte stores.
//    The LUT shares its shared memory with the walk's decode, which is done
//    by then.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLutBits = 11;
constexpr int kLutSize = 1 << kLutBits;
constexpr int32_t kLongCode = 1 << 30;
constexpr int kNumLitlen = 288;           // decode-side alphabets
constexpr int kNumDist = 32;
constexpr int kMaxBits = 15;
constexpr int kCntLen = kMaxBits + 1;
constexpr int kRleW = 316;                // 286 + 30 code lengths at most
constexpr int kRleSteps = kRleW + 4;
constexpr int kNumClen = 19;
constexpr int kClenBits = 7;
constexpr int kThreads = kNumLitlen + kNumDist;   // 320: one per symbol
constexpr int kWarps = kThreads / 32;             // 9 litlen warps + 1 dist
constexpr int kStage = 152;               // words staged: the longest header
// A step takes at most 7 bits per length it adds (a 7-bit code and 1
// length, or 7 + 7 bits and 11 or more), so a step that starts before the
// lengths are complete starts at most 7 x 315 bits after the first RLE bit.
constexpr int kBitsPerLength = 7;
constexpr int kSpan = kRleSteps * kBitsPerLength;   // 2,240 offsets
constexpr int kPerThread = kSpan / kThreads;        // 7
constexpr int kNextMask = (1 << 13) - 1;  // s_dec: next offset, bits 0-12
constexpr int kRelLimit = 1 << 24;        // |first bit offset| kept below it
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kSpan % kThreads == 0, "every thread decodes as many offsets");
static_assert(kSpan + 14 <= kNextMask, "next offsets fit 13 bits");
static_assert((31 + 74 + kSpan + 31) / 32 < kStage,
              "the window holds every bit the walk reads");
constexpr int kRoom = kSpan > 2 * kLutSize ? kSpan : 2 * kLutSize;

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
__constant__ int8_t kClenOrder[kNumClen] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Params {
  const int64_t* words;        // u32 values
  int64_t n_words;
  const int64_t* blk_bit;
  const int64_t* blk_btype;
  const int64_t* n_blocks;     // one value, on the device
  int32_t* ll_lut;
  int32_t* d_lut;
  int32_t* ll_cnt;
  int32_t* d_cnt;
  int32_t* ll_sym;
  int32_t* d_sym;
  int64_t* hdr_end;
  uint8_t* bbad;
  uint8_t* blive;
  uint8_t* huff;
  uint8_t* is_sto;
};

// Static payloads (ops/decode_symbols.py LL_PAY / D_PAY).
__device__ __forceinline__ int32_t ll_pay(int s) {
  if (s < 256) return s;
  if (s == 256) return 1 << 12;
  if (s < 286) return kLenBase[s - 257] | (kLenExtra[s - 257] << 9) | (2 << 12);
  return 3 << 12;
}

__device__ __forceinline__ int32_t d_pay(int s) {
  return s < 30 ? kDistBase[s] | (kDistExtra[s] << 15) : 1 << 19;
}

__device__ __forceinline__ int fixed_ll_len(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

// The header's words: s[k] holds word min(first + k, n_words - 1). Bit
// positions are relative to bit 0 of word `first`; word indices relative
// to it clip to [kmin, kmax] = [-first, n_words - 1 - first].
struct Staged {
  const uint32_t* s;
  const int64_t* words;
  int64_t first;
  int kmin, kmax;

  __device__ __forceinline__ uint32_t word(int k) const {
    return k >= 0 && k < kStage ? s[k]
                                : static_cast<uint32_t>(words[first + k]);
  }
  // 32 bits from relative bit position rel, LSB first, word indices clipped
  // to the array (ops/build_tables.py::peek32).
  __device__ __forceinline__ uint32_t peek(int rel) const {
    int k = rel >> 5;
    k = k < kmin ? kmin : k > kmax ? kmax : k;
    const int kj = k + 1 > kmax ? kmax : k + 1;
    const int sh = rel & 31;
    const uint32_t lo = word(k);
    return sh ? (lo >> sh) | (word(kj) << (32 - sh)) : lo;
  }
};

// Over the CTA's threads in order: the inclusive sum of a and the
// exclusive maximum of m (-1 for thread 0). s_w holds 2 x kWarps ints.
__device__ __forceinline__ void cta_scan(int& a, int& m, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = a, x = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ys = __shfl_up_sync(kFull, s, d);
    const int yx = __shfl_up_sync(kFull, x, d);
    if (lane >= d) {
      s += ys;
      x = max(x, yx);
    }
  }
  int ex = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) ex = -1;
  if (lane == 31) {
    s_w[warp] = s;
    s_w[kWarps + warp] = x;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    s += s_w[w];
    ex = max(ex, s_w[kWarps + w]);
  }
  __syncthreads();
  a = s;
  m = ex;
}

// The minimum of x over the CTA, in every thread; s_w holds kWarps ints.
__device__ __forceinline__ int cta_min(int x, int* s_w) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = min(x, __shfl_xor_sync(kFull, x, d));
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = x;
  __syncthreads();
  int m = s_w[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, s_w[w]);
  __syncthreads();
  return m;
}

struct Header {
  int hlit, hdist;
  int end;                     // the bit after the header, from bp0
  bool bad;
};

// A dynamic block's header, by the whole CTA (every thread calls it and
// gets the same result): writes the code lengths it decodes into
// s_lens[kRleW] (zeroed by the caller; zeros are not written again). `r0`
// is the header's first bit after BTYPE, relative to the staged window;
// `budget` the bits from there to the end of the words (clipped).
__device__ Header parse_dynamic(const Staged& in, int r0, int budget,
                                uint8_t* s_lens, uint32_t* s_dec) {
  __shared__ int32_t s_cl_lut[1 << kClenBits];
  __shared__ uint8_t s_clen[kNumClen], s_cl_rc[kNumClen];
  __shared__ uint16_t s_path[kRleSteps];
  __shared__ int32_t s_iend[kRleSteps];
  __shared__ int8_t s_fill[kRleSteps];
  __shared__ int32_t s_w[2 * kWarps];
  const int t = threadIdx.x;

  Header h;
  const uint32_t hw = in.peek(r0);
  h.hlit = static_cast<int>(hw & 31) + 257;
  h.hdist = static_cast<int>((hw >> 5) & 31) + 1;
  const int hclen = static_cast<int>((hw >> 10) & 15) + 4;
  const int rle = 14 + 3 * hclen;          // the first RLE bit, from r0
  if (t < kNumClen)
    s_clen[kClenOrder[t]] =
        t < hclen ? static_cast<uint8_t>(in.peek(r0 + 14 + 3 * t) & 7) : 0;
  __syncthreads();

  // the code-length code: counts, Kraft, canonical codes, then the LUT
  int count[kClenBits + 1] = {0};
  for (int j = 0; j < kNumClen; ++j) ++count[s_clen[j]];
  int kraft = 0, code = 0, next_code = 0;
  const int my_len = t < kNumClen ? s_clen[t] : 0;
  for (int l = 1; l <= kClenBits; ++l) {
    code = (code + (l > 1 ? count[l - 1] : 0)) << 1;
    if (l == my_len) next_code = code;
    kraft += count[l] << (kClenBits - l);
  }
  h.bad = h.hlit > 286 || h.hdist > 30 || kraft > (1 << kClenBits);
  if (my_len > 0) {
    for (int j = 0; j < t; ++j) next_code += s_clen[j] == my_len;
    s_cl_rc[t] = static_cast<uint8_t>(
        __brev(static_cast<uint32_t>(next_code)) >> (32 - my_len));
  }
  __syncthreads();
  if (t < (1 << kClenBits)) {
    int32_t e = 0;
    for (int j = 0; j < kNumClen; ++j) {
      const int len = s_clen[j];
      if (len > 0 && (t & ((1 << len) - 1)) == s_cl_rc[j]) e += j | (len << 5);
    }
    s_cl_lut[t] = e;
  }
  if (h.bad) {                             // no RLE step runs
    h.end = rle;
    return h;
  }
  __syncthreads();

  // the code-length symbol at every bit offset the walk can reach
  for (int m = 0; m < kPerThread; ++m) {
    const int o = m * kThreads + t;
    const uint32_t lo = in.peek(r0 + rle + o);
    const int32_t e = s_cl_lut[lo & 127];
    const int cl = e >> 5;
    const int sym = e & 0x1F;
    const int eb = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
    const int ev = static_cast<int>((lo >> cl) & ((1u << eb) - 1));
    const int rep = sym < 16 ? 1 : sym <= 17 ? 3 + ev : 11 + ev;
    s_dec[o] = static_cast<uint32_t>(o + cl + eb) | (rep << 13) | (sym << 21);
  }
  __syncthreads();

  // the path: thread 0 follows the next offsets from the first RLE bit
  // until the lengths are complete or a step reads no code (cl 0)
  // the path: the offset of every step from the first RLE bit, by pointer
  // doubling over the next offsets (after round r, s_jump[cur] jumps 2^r
  // steps and the first 2^r steps are placed); an offset past the span is
  // one no step before the lengths are complete reaches
  {
    __shared__ uint16_t s_jump[2][kSpan];
    for (int m = 0; m < kPerThread; ++m) {
      const int o = m * kThreads + t;
      const int nx = static_cast<int>(s_dec[o] & kNextMask);
      s_jump[0][o] = static_cast<uint16_t>(nx < kSpan ? nx : kSpan - 1);
    }
    if (t == 0) s_path[0] = 0;
    __syncthreads();
    int cur = 0;
    for (int r = 0; (1 << r) < kRleSteps; ++r) {
      const int k = (1 << r) + t;
      if (t < (1 << r) && k < kRleSteps)
        s_path[k] = s_jump[cur][s_path[k - (1 << r)]];
      uint16_t j2[kPerThread];
      for (int m = 0; m < kPerThread; ++m)
        j2[m] = s_jump[cur][s_jump[cur][m * kThreads + t]];
      for (int m = 0; m < kPerThread; ++m)
        s_jump[cur ^ 1][m * kThreads + t] = j2[m];
      cur ^= 1;
      __syncthreads();
    }
  }

  // one thread per step: its place, its previous length, whether it is
  // bad; the steps run up to the one that completes the lengths or reads
  // no code (cl 0)
  const int total = h.hlit + h.hdist;
  const int at = s_path[t];
  const uint32_t x = s_dec[at];
  const int nxt = static_cast<int>(x & kNextMask);
  const int rep = static_cast<int>((x >> 13) & 0xFF);
  const int sym = static_cast<int>(x >> 21);
  int key = sym == 16 ? -1 : (t << 5) | (sym < 16 ? sym : 0);
  int i_end = rep;
  cta_scan(i_end, key, s_w);
  const int n_steps =
      cta_min(i_end >= total || nxt == at ? t + 1 : kRleSteps, s_w);
  const bool on = t < n_steps;
  const int prev = key < 0 ? -1 : key & 31;
  const int fill = sym < 16 ? sym : sym == 16 ? prev : 0;
  const bool bad = on && (nxt == at || (sym == 16 && prev < 0) ||
                          i_end > total || rle + nxt > budget);
  if (on) {
    s_iend[t] = i_end;
    s_fill[t] = static_cast<int8_t>(fill);
  }
  const int first_bad = cta_min(bad ? t : kRleSteps, s_w);   // syncs
  const int last = first_bad < n_steps ? first_bad : n_steps - 1;
  h.bad = first_bad < n_steps;
  h.end = rle + static_cast<int>(s_dec[s_path[last]] & kNextMask);
  if (t < kRleW) {                         // the step that covers length t
    int lo = 0, hi = last + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_iend[mid] > t) hi = mid; else lo = mid + 1;
    }
    if (lo <= last && s_fill[lo] > 0) s_lens[t] = s_fill[lo];
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
build_tables_kernel(Params p) {
  // the LUTs (litlen, dist); before them, the walk's decode per bit offset
  __shared__ __align__(16) uint32_t s_room[kRoom];
  int32_t (*s_lut)[kLutSize] =
      reinterpret_cast<int32_t (*)[kLutSize]>(s_room);
  __shared__ int32_t s_sym[kThreads];
  __shared__ int32_t s_wcnt[kWarps][kCntLen];
  __shared__ int32_t s_tot[2][kCntLen], s_next[2][kCntLen], s_offs[2][kCntLen];
  __shared__ int32_t s_present[2], s_over[2];
  __shared__ uint32_t s_words[kStage];
  __shared__ uint8_t s_lens[kRleW + 4];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int64_t n_blocks = *p.n_blocks;
  const int64_t btype = p.blk_btype[b];
  const bool blive = b < n_blocks && btype >= 0;
  const bool is_dyn = blive && btype == 2;
  const bool is_fix = blive && btype == 1;
  const bool is_sto = blive && btype == 0;
  const int64_t bp0 = p.blk_bit[b] + 3;           // skip BFINAL/BTYPE

  if (t < kRleW + 4) s_lens[t] = 0;
  if (t < kWarps * kCntLen) (&s_wcnt[0][0])[t] = 0;
  int64_t first = bp0 >> 5;
  first = first < 0 ? 0 : first > p.n_words - 1 ? p.n_words - 1 : first;
  if (is_dyn && t < kStage) {
    const int64_t i = first + t > p.n_words - 1 ? p.n_words - 1 : first + t;
    s_words[t] = static_cast<uint32_t>(p.words[i]);
  }
  __syncthreads();
  Header hdr = {257, 1, 0, blive && btype == 3};  // reserved BTYPE: bad
  if (is_dyn) {                                   // the same in every thread
    Staged in;
    in.s = s_words;
    in.words = p.words;
    in.first = first;
    in.kmin = static_cast<int>(-first);
    in.kmax = static_cast<int>(p.n_words - 1 - first);
    // the header's first bit relative to the window, kept in 32 bits (far
    // outside the words every read clips to the same word either way)
    int64_t r0 = bp0 - 32 * first;
    if (r0 > kRelLimit) r0 = kRelLimit + (r0 & 31);
    if (r0 < -kRelLimit) r0 = -kRelLimit + (r0 & 31);
    int64_t budget = 32 * p.n_words - bp0;
    budget = budget < -1 ? -1 : budget > (1 << 30) ? (1 << 30) : budget;
    hdr = parse_dynamic(in, static_cast<int>(r0), static_cast<int>(budget),
                        s_lens, s_room);
  }
  __syncthreads();                          // the walk is done with s_lut
  for (int i = t; i < 2 * kLutSize; i += kThreads) (&s_lut[0][0])[i] = 0;
  __syncthreads();
  const int hlit = hdr.hlit, hdist = hdr.hdist;

  // this thread's symbol: its alphabet, index and code length
  const int a = t < kNumLitlen ? 0 : 1;
  const int s = a ? t - kNumLitlen : t;
  int len;
  if (a == 0) {
    len = is_fix ? fixed_ll_len(s)
                 : (s < hlit && s < 286 ? s_lens[s] : 0);
  } else {
    const int k = hlit + s < kRleW - 1 ? hlit + s : kRleW - 1;
    len = is_fix ? 5 : (s < hdist ? s_lens[k] : 0);
  }

  // rank among the symbols of the same length, in symbol order
  const unsigned same = __match_any_sync(kFull, len);
  const int rank_w = __popc(same & ((1u << lane) - 1));
  if (lane == __ffs(same) - 1) s_wcnt[warp][len] = __popc(same);
  __syncthreads();
  if (t < 2 * kCntLen) {
    const int aa = t >> 4, l = t & 15;
    const int w0 = aa ? kWarps - 1 : 0, w1 = aa ? kWarps : kWarps - 1;
    int run = 0;
    for (int w = w0; w < w1; ++w) {
      const int c = s_wcnt[w][l];
      s_wcnt[w][l] = run;
      run += c;
    }
    s_tot[aa][l] = run;
  }
  __syncthreads();
  if (t == 0 || t == kCntLen) {
    const int aa = t >> 4;
    int code = 0, off = 0, kraft = 0;
    s_next[aa][0] = 0;
    s_offs[aa][0] = 0;
    for (int l = 1; l <= kMaxBits; ++l) {
      code = (code + (l > 1 ? s_tot[aa][l - 1] : 0)) << 1;
      s_next[aa][l] = code;
      s_offs[aa][l] = off;
      off += s_tot[aa][l];
      kraft += s_tot[aa][l] << (kMaxBits - l);
    }
    s_present[aa] = off;
    s_over[aa] = kraft > (1 << kMaxBits);
  }
  __syncthreads();
  const int rank = s_wcnt[warp][len] + rank_w;
  uint32_t rcode = 0;
  int32_t pay = 0;
  if (len > 0) {
    const uint32_t code = static_cast<uint32_t>(s_next[a][len] + rank);
    rcode = __brev(code) >> (32 - len);
    pay = (a ? d_pay(s) | (len << 20) : ll_pay(s) | (len << 14));
    s_sym[a * kNumLitlen + s_offs[a][len] + rank] = s;
  } else {
    s_sym[a * kNumLitlen + s_present[a] + rank] = s;
  }

  // primary LUT: each warp adds its 32 symbols' payloads
  int32_t* lut = s_lut[a];
  for (int i = 0; i < 32; ++i) {
    const int li = __shfl_sync(kFull, len, i);
    const uint32_t rc = __shfl_sync(kFull, rcode, i);
    const int32_t pi = __shfl_sync(kFull, pay, i);
    if (li >= 1 && li <= kLutBits)
      for (uint32_t k = lane; k < (1u << (kLutBits - li)); k += 32)
        atomicAdd(&lut[rc | (k << li)], pi);
  }
  __syncthreads();
  if (len > kLutBits) atomicCAS(&lut[rcode & (kLutSize - 1)], 0, kLongCode);
  __syncthreads();

  const int4* src = reinterpret_cast<const int4*>(&s_lut[0][0]);
  int4* dst_ll = reinterpret_cast<int4*>(p.ll_lut + int64_t{b} * kLutSize);
  int4* dst_d = reinterpret_cast<int4*>(p.d_lut + int64_t{b} * kLutSize);
  for (int i = t; i < kLutSize / 4; i += kThreads) {
    dst_ll[i] = src[i];
    dst_d[i] = src[kLutSize / 4 + i];
  }
  if (t < kCntLen) {
    p.ll_cnt[int64_t{b} * kCntLen + t] = t ? s_tot[0][t] : 0;
  } else if (t < 2 * kCntLen) {
    p.d_cnt[int64_t{b} * kCntLen + t - kCntLen] =
        t > kCntLen ? s_tot[1][t - kCntLen] : 0;
  }
  if (a == 0) {
    p.ll_sym[int64_t{b} * kNumLitlen + s] = s_sym[t];
  } else {
    p.d_sym[int64_t{b} * kNumDist + s] = s_sym[t];
  }
  if (t == 0) {
    const bool huff = is_dyn || is_fix;
    p.hdr_end[b] = bp0 + hdr.end;
    p.bbad[b] = hdr.bad || (huff && (s_over[0] || s_over[1]));
    p.blive[b] = blive;
    p.huff[b] = huff;
    p.is_sto[b] = is_sto;
  }
}

}  // namespace

// Launches one CTA per block slot on `stream` of `device` (made current for
// the call only if it is not); returns the CUDA error (0 on success). Every
// pointer is a device pointer (`n_blocks` to the one live block count). The
// LUT rows are 16-byte aligned.
// The caller allocates the outputs; the kernel writes every entry of them.
extern "C" int build_tables_launch(
    const void* words, int64_t n_words, const void* blk_bit,
    const void* blk_btype, const void* n_blocks, int64_t nb, void* ll_lut,
    void* d_lut, void* ll_cnt, void* d_cnt, void* ll_sym, void* d_sym,
    void* hdr_end, void* bbad, void* blive, void* huff, void* is_sto,
    int device, void* stream) {
  if (nb <= 0) return 0;
  if (nb > 0x7FFFFFFF || n_words < 1 || n_words > 0x7FFFFFFF ||
      (reinterpret_cast<uintptr_t>(ll_lut) & 15) ||
      (reinterpret_cast<uintptr_t>(d_lut) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.words = static_cast<const int64_t*>(words);
  p.n_words = n_words;
  p.blk_bit = static_cast<const int64_t*>(blk_bit);
  p.blk_btype = static_cast<const int64_t*>(blk_btype);
  p.n_blocks = static_cast<const int64_t*>(n_blocks);
  p.ll_lut = static_cast<int32_t*>(ll_lut);
  p.d_lut = static_cast<int32_t*>(d_lut);
  p.ll_cnt = static_cast<int32_t*>(ll_cnt);
  p.d_cnt = static_cast<int32_t*>(d_cnt);
  p.ll_sym = static_cast<int32_t*>(ll_sym);
  p.d_sym = static_cast<int32_t*>(d_sym);
  p.hdr_end = static_cast<int64_t*>(hdr_end);
  p.bbad = static_cast<uint8_t*>(bbad);
  p.blive = static_cast<uint8_t*>(blive);
  p.huff = static_cast<uint8_t*>(huff);
  p.is_sto = static_cast<uint8_t*>(is_sto);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    build_tables_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
