// Phase-B symbol decode of the indexed DEFLATE decoder, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU's LUT gather probed in tools/probe_pallas_r5.py::try_lower
// (kernels k_take / k_intidx / k_tala / k_onehot: out[i] = tbl[idx[i]] with
// tbl i32[2048], idx i32[4096]), which Mosaic could not lower, so the JAX
// decoder (decode/tpu_inflate.py dec_body) resolved each Huffman code by a
// dense compare over the symbol axis instead. Here the gather is what it
// wanted to be: each CTA stages its coding block's 2^11-entry litlen and
// dist LUTs in shared memory and every lookup is one shared-memory load.
//
// What it computes (exactly ops/decode_symbols.py::decode_symbols_ref): one
// thread per sub-entry lane decodes tokens from the lane's start bit until
// its output cursor reaches lane_end, writing each token packed as
//     value | dist << 9 | 1 << 25 | is_match << 26
// at tok[cursor]. A lane goes bad, and stops without emitting, on an invalid
// prefix, a litlen symbol >= 286, EOB before lane_end, a dist symbol >= 30,
// a distance over max_dist, a token past lane_end or a read past the bit
// budget; after max_steps symbols it stops neither done nor bad.
//
// Codes longer than the 11-bit LUT (zlib streams use up to 15 bits; the
// encoder of this repository caps at 11) hit a LUT entry marked long and
// resolve by the RFC 1951 §3.2.2 count/first-code walk over the block's
// canonical tables, also staged in shared memory.
//
// What bounds it on this card: latency, not bandwidth. Every step is a
// dependent chain (word loads -> LUT load -> extra bits -> dist LUT load ->
// token store) and lanes of a warp finish after different token counts, so
// the warp diverges. The design keeps the chain short: the next 64 stream
// bits come from three 32-bit words in one funnel, both LUTs sit in shared
// memory, and there is no synchronisation after the staging. Warp-level
// lane packing and multi-symbol LUT entries are later work.
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
constexpr int kThreads = 128;

struct Params {
  const uint32_t* words;
  int64_t n_words;
  const int64_t* bp0;
  const int64_t* ocur0;
  const int64_t* lane_end;
  const int32_t* order;
  const int32_t* cta_blk;
  const int32_t* cta_first;
  const int32_t* cta_cnt;
  const int32_t* ll_lut;
  const int32_t* d_lut;
  const int32_t* ll_cnt;
  const int32_t* d_cnt;
  const int32_t* ll_sym;
  const int32_t* d_sym;
  const int32_t* ll_pay;
  const int32_t* d_pay;
  int64_t max_dist;
  int64_t bit_budget;
  int64_t out_size;
  int64_t max_steps;
  int32_t* tok;
  uint8_t* done;
  uint8_t* bad;
  int64_t* ocur;
};

// The LUT entry of the low bits of `bits`.
__device__ __forceinline__ int32_t lut_at(const int32_t* table, uint32_t bits,
                                          uint32_t mask) {
  return table[bits & mask];
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int64_t n,
                                            int64_t k) {
  return (k >= 0 && k < n) ? __ldg(w + k) : 0u;
}

// 64 stream bits from bit position bp, LSB first; bits past the words read 0.
__device__ __forceinline__ uint64_t peek64(const uint32_t* w, int64_t n,
                                           int64_t bp) {
  const int64_t k = bp >> 5;
  const uint32_t sh = static_cast<uint32_t>(bp & 31);
  uint64_t v = (static_cast<uint64_t>(word_at(w, n, k)) |
                (static_cast<uint64_t>(word_at(w, n, k + 1)) << 32)) >> sh;
  if (sh) v |= static_cast<uint64_t>(word_at(w, n, k + 2)) << (64 - sh);
  return v;
}

// RFC 1951 §3.2.2 canonical decode, one bit at a time in stream order:
// cnt[len] codes of each length, sym[] the symbols in canonical order.
// Returns pay[symbol] | len << shift, or 0 when no code matches.
__device__ int32_t slow_decode(const int32_t* cnt, const int32_t* sym,
                               const int32_t* pay, int nsym, uint64_t bits,
                               int shift) {
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
      return pay[s] | (len << shift);
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
decode_symbols_kernel(const Params p) {
  __shared__ int32_t s_ll_lut[kLutSize];
  __shared__ int32_t s_d_lut[kLutSize];
  __shared__ int32_t s_ll_cnt[kCntLen];
  __shared__ int32_t s_d_cnt[kCntLen];
  __shared__ int32_t s_ll_sym[kNumLitlen];
  __shared__ int32_t s_d_sym[kNumDist];
  __shared__ int32_t s_ll_pay[kNumLitlen];
  __shared__ int32_t s_d_pay[kNumDist];

  const int cta = blockIdx.x;
  const int32_t b = p.cta_blk[cta];
  if (b < 0) return;                      // uniform over the CTA
  const int64_t bb = b;
  for (int i = threadIdx.x; i < kLutSize; i += kThreads) {
    s_ll_lut[i] = __ldg(p.ll_lut + bb * kLutSize + i);
    s_d_lut[i] = __ldg(p.d_lut + bb * kLutSize + i);
  }
  for (int i = threadIdx.x; i < kNumLitlen; i += kThreads) {
    s_ll_sym[i] = __ldg(p.ll_sym + bb * kNumLitlen + i);
    s_ll_pay[i] = __ldg(p.ll_pay + i);
  }
  if (threadIdx.x < kNumDist) {
    s_d_sym[threadIdx.x] = __ldg(p.d_sym + bb * kNumDist + threadIdx.x);
    s_d_pay[threadIdx.x] = __ldg(p.d_pay + threadIdx.x);
  }
  if (threadIdx.x < kCntLen) {
    s_ll_cnt[threadIdx.x] = __ldg(p.ll_cnt + bb * kCntLen + threadIdx.x);
    s_d_cnt[threadIdx.x] = __ldg(p.d_cnt + bb * kCntLen + threadIdx.x);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= p.cta_cnt[cta]) return;

  const int32_t lane = p.order[p.cta_first[cta] + threadIdx.x];
  int64_t bp = p.bp0[lane];
  int64_t ocur = p.ocur0[lane];
  const int64_t end = p.lane_end[lane];
  bool done = false, bad = false;
  for (int64_t step = 0; step < p.max_steps; ++step) {
    const uint64_t win = peek64(p.words, p.n_words, bp);
    int32_t e = lut_at(s_ll_lut, static_cast<uint32_t>(win), kLutMask);
    if (e == kLongCode)
      e = slow_decode(s_ll_cnt, s_ll_sym, s_ll_pay, kNumLitlen, win, 14);
    const int cl = (e >> 14) & 0xF;
    const int kind = (e >> 12) & 3;       // 0 lit, 1 EOB, 2 length, 3 bad
    if (cl == 0 || (kind != 0 && kind != 2)) {
      bad = true;
      break;
    }
    int64_t adv = 1;
    int nbits = cl;
    int32_t pack = (e & 0x1FF) | (1 << 25);
    if (kind == 2) {
      const int leb = (e >> 9) & 7;
      const int mlen = (e & 0x1FF) +
                       static_cast<int>((win >> cl) & ((1u << leb) - 1u));
      const uint64_t w2 = win >> (cl + leb);
      int32_t de = lut_at(s_d_lut, static_cast<uint32_t>(w2), kLutMask);
      if (de == kLongCode)
        de = slow_decode(s_d_cnt, s_d_sym, s_d_pay, kNumDist, w2, 20);
      const int dcl = (de >> 20) & 0xF;
      if (dcl == 0 || ((de >> 19) & 1)) {
        bad = true;
        break;
      }
      const int deb = (de >> 15) & 0xF;
      const int mdist = (de & 0x7FFF) +
                        static_cast<int>((w2 >> dcl) & ((1u << deb) - 1u));
      if (mdist > p.max_dist) {
        bad = true;
        break;
      }
      adv = mlen;
      nbits = cl + leb + dcl + deb;
      pack = mlen | (mdist << 9) | (1 << 25) | (1 << 26);
    }
    const int64_t ocur2 = ocur + adv;
    const int64_t bp2 = bp + nbits;
    if (ocur2 > end || bp2 > p.bit_budget) {
      bad = true;
      break;
    }
    if (ocur >= 0 && ocur < p.out_size) p.tok[ocur] = pack;
    ocur = ocur2;
    bp = bp2;
    if (ocur >= end) {
      done = true;
      break;
    }
  }
  p.done[lane] = done;
  p.bad[lane] = bad;
  p.ocur[lane] = ocur;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). Every
// pointer is a device pointer; the caller allocates the outputs and fills
// done / bad / ocur for the lanes the grid does not visit.
extern "C" int decode_symbols_launch(
    const void* words, int64_t n_words, const void* bp0, const void* ocur0,
    const void* lane_end, const void* order, const void* cta_blk,
    const void* cta_first, const void* cta_cnt, int64_t n_cta,
    const void* ll_lut, const void* d_lut, const void* ll_cnt,
    const void* d_cnt, const void* ll_sym, const void* d_sym,
    const void* ll_pay, const void* d_pay, int64_t max_dist,
    int64_t bit_budget, int64_t out_size, int64_t max_steps, void* tok,
    void* done, void* bad, void* ocur, void* stream) {
  if (n_cta <= 0) return 0;
  if (n_cta > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.words = static_cast<const uint32_t*>(words);
  p.n_words = n_words;
  p.bp0 = static_cast<const int64_t*>(bp0);
  p.ocur0 = static_cast<const int64_t*>(ocur0);
  p.lane_end = static_cast<const int64_t*>(lane_end);
  p.order = static_cast<const int32_t*>(order);
  p.cta_blk = static_cast<const int32_t*>(cta_blk);
  p.cta_first = static_cast<const int32_t*>(cta_first);
  p.cta_cnt = static_cast<const int32_t*>(cta_cnt);
  p.ll_lut = static_cast<const int32_t*>(ll_lut);
  p.d_lut = static_cast<const int32_t*>(d_lut);
  p.ll_cnt = static_cast<const int32_t*>(ll_cnt);
  p.d_cnt = static_cast<const int32_t*>(d_cnt);
  p.ll_sym = static_cast<const int32_t*>(ll_sym);
  p.d_sym = static_cast<const int32_t*>(d_sym);
  p.ll_pay = static_cast<const int32_t*>(ll_pay);
  p.d_pay = static_cast<const int32_t*>(d_pay);
  p.max_dist = max_dist;
  p.bit_budget = bit_budget;
  p.out_size = out_size;
  p.max_steps = max_steps;
  p.tok = static_cast<int32_t*>(tok);
  p.done = static_cast<uint8_t*>(done);
  p.bad = static_cast<uint8_t*>(bad);
  p.ocur = static_cast<int64_t*>(ocur);
  decode_symbols_kernel<<<static_cast<unsigned>(n_cta), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
