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
// 3.35 TB/s. The RLE walk is a serial chain (bits -> code-length LUT ->
// extra bits -> next bit position) of up to 316 steps per block, so the
// latency of one step, not the bytes, sets the time of a CTA.
//
// What the design does about it:
//  * One CTA per block slot, 320 threads: one per symbol of the two
//    alphabets (288 litlen, 32 dist). All slots run at once; nothing waits
//    for the host (the plain version asks the device every 8 steps whether
//    any block is still active).
//  * The header's words are staged in shared memory by the whole CTA, then
//    thread 0 walks the RLE stream out of shared memory, so a step costs
//    shared-memory latency and not a trip to L2.
//  * Ranks within a length come from __match_any_sync and per-warp counts,
//    canonical codes and the canonical order from those ranks; every warp
//    fills the LUT in shared memory for its own 32 symbols (a code of
//    length L adds its payload to 2^(11-L) strided entries, the lanes
//    striding over them); the tables leave shared memory in 16-byte stores.
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
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// The header's words: s[k] holds word min(first + k, n_words - 1).
struct Staged {
  const uint32_t* s;
  const int64_t* words;
  int64_t n_words;
  int64_t first;

  __device__ __forceinline__ uint32_t word(int64_t i) const {
    const int64_t k = i - first;
    return k >= 0 && k < kStage ? s[k] : static_cast<uint32_t>(words[i]);
  }
  // 32 bits from bit position bp, LSB first, word indices clipped to the
  // array (ops/build_tables.py::peek32).
  __device__ __forceinline__ uint32_t peek(int64_t bp) const {
    int64_t wi = bp >> 5;
    wi = wi < 0 ? 0 : wi > n_words - 1 ? n_words - 1 : wi;
    const int64_t wj = wi + 1 > n_words - 1 ? n_words - 1 : wi + 1;
    const int sh = static_cast<int>(bp & 31);
    const uint32_t lo = word(wi);
    return sh ? (lo >> sh) | (word(wj) << (32 - sh)) : lo;
  }
};

struct Header {
  int64_t bp;                  // the bit after the header
  int hlit, hdist;
  bool bad;
};

// A dynamic block's header, walked by one thread: writes the code lengths
// it decodes into lens[kRleW] (zeroed by the caller; zeros are not written
// again) and uses cl_lut[128] as its code-length LUT.
__device__ Header parse_dynamic(const Staged& in, int64_t bp,
                                int64_t bit_budget, uint8_t* lens,
                                int32_t* cl_lut) {
  Header h;
  const uint32_t hw = in.peek(bp);
  h.hlit = static_cast<int>(hw & 31) + 257;
  h.hdist = static_cast<int>((hw >> 5) & 31) + 1;
  const int hclen = static_cast<int>((hw >> 10) & 15) + 4;
  h.bad = h.hlit > 286 || h.hdist > 30;
  bp += 14;

  int clen[kNumClen];
#pragma unroll
  for (int j = 0; j < kNumClen; ++j) clen[j] = 0;
  int count[kClenBits + 1] = {0};
  for (int j = 0; j < hclen; ++j) {
    const int v = static_cast<int>(in.peek(bp + 3 * j) & 7);
    clen[kClenOrder[j]] = v;
  }
  bp += 3 * hclen;
  for (int j = 0; j < kNumClen; ++j)
    if (clen[j] > 0) ++count[clen[j]];
  int kraft = 0, next[kClenBits + 1], code = 0;
  next[0] = 0;
  for (int l = 1; l <= kClenBits; ++l) {
    code = (code + count[l - 1]) << 1;     // count[0] is 0
    next[l] = code;
    kraft += count[l] << (kClenBits - l);
  }
  h.bad = h.bad || kraft > (1 << kClenBits);
  for (int p = 0; p < (1 << kClenBits); ++p) cl_lut[p] = 0;
  for (int j = 0; j < kNumClen; ++j) {
    const int len = clen[j];
    if (len == 0) continue;
    const uint32_t c = static_cast<uint32_t>(next[len]++);
    const uint32_t rc = __brev(c) >> (32 - len);
    const int32_t pay = j | (len << 5);
    for (uint32_t k = 0; k < (1u << (kClenBits - len)); ++k)
      cl_lut[rc | (k << len)] += pay;
  }

  const int total = h.hlit + h.hdist;
  int i = 0, prev = -1;
  for (int step = 0; step < kRleSteps && i < total && !h.bad; ++step) {
    const uint32_t lo = in.peek(bp);
    const int32_t e = cl_lut[lo & 127];
    const int cl = e >> 5;
    const int sym = e & 0x1F;
    if (cl == 0) h.bad = true;
    const bool is_lit = sym < 16, is16 = sym == 16;
    const int eb = is16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
    const int ev = static_cast<int>((lo >> cl) & ((1u << eb) - 1));
    const int rep = is_lit ? 1 : sym <= 17 ? 3 + ev : 11 + ev;
    const int fill = is_lit ? sym : is16 ? prev : 0;
    if (is16 && prev < 0) h.bad = true;
    if (fill > 0) {
      const int end = i + rep < kRleW ? i + rep : kRleW;
      for (int k = i; k < end; ++k) lens[k] = static_cast<uint8_t>(fill);
    }
    i += rep;
    if (i > total) h.bad = true;
    prev = fill;
    bp += cl + eb;
    if (bp > bit_budget) h.bad = true;
  }
  h.bp = bp;
  return h;
}

__global__ void __launch_bounds__(kThreads)
build_tables_kernel(Params p) {
  __shared__ __align__(16) int32_t s_lut[2][kLutSize];   // litlen, dist
  __shared__ int32_t s_sym[kThreads];
  __shared__ int32_t s_wcnt[kWarps][kCntLen];
  __shared__ int32_t s_tot[2][kCntLen], s_next[2][kCntLen], s_offs[2][kCntLen];
  __shared__ int32_t s_present[2], s_over[2];
  __shared__ int32_t s_cl_lut[1 << kClenBits];
  __shared__ uint32_t s_words[kStage];
  __shared__ uint8_t s_lens[kRleW + 4];
  __shared__ Header s_hdr;

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

  for (int i = t; i < 2 * kLutSize; i += kThreads) (&s_lut[0][0])[i] = 0;
  if (t < kRleW + 4) s_lens[t] = 0;
  if (t < kWarps * kCntLen) (&s_wcnt[0][0])[t] = 0;
  Staged in;
  in.s = s_words;
  in.words = p.words;
  in.n_words = p.n_words;
  int64_t first = bp0 >> 5;
  first = first < 0 ? 0 : first > p.n_words - 1 ? p.n_words - 1 : first;
  in.first = first;
  if (is_dyn && t < kStage) {
    const int64_t i = first + t > p.n_words - 1 ? p.n_words - 1 : first + t;
    s_words[t] = static_cast<uint32_t>(p.words[i]);
  }
  __syncthreads();
  if (t == 0) {
    if (is_dyn) {
      s_hdr = parse_dynamic(in, bp0, 32 * p.n_words, s_lens, s_cl_lut);
    } else {
      s_hdr.bp = bp0;
      s_hdr.hlit = 257;
      s_hdr.hdist = 1;
      s_hdr.bad = blive && btype == 3;            // reserved BTYPE
    }
  }
  __syncthreads();
  const int hlit = s_hdr.hlit, hdist = s_hdr.hdist;

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
    p.hdr_end[b] = s_hdr.bp;
    p.bbad[b] = s_hdr.bad || (huff && (s_over[0] || s_over[1]));
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
  if (nb > 0x7FFFFFFF || n_words < 1 ||
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
