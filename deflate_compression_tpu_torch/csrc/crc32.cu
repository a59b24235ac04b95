// CRC-32 (gzip's: reflected, polynomial 0xEDB88320, zlib.crc32) of the first
// n bytes of a byte array, continued from a given CRC, for Hopper (sm_90a),
// plain C interface.
//
// Replaces no Pallas kernel: the JAX package has no CRC-32 on the device
// (deflate_compression_tpu/core/checksum.py::crc32_np is host numpy). It was
// added so that the indexed decode can check a gzip member's footer on the
// card, one call a decoded group, chained through `init`, with the value
// read once after the last group (decode/index.py::decompress_indexed).
//
// What it computes. With r = init ^ 0xFFFFFFFF, the CRC is R(r, d) ^
// 0xFFFFFFFF, where R is zlib's byte-table recurrence on the raw register.
// R is linear over GF(2) in the register and in the bytes, which gives:
//   * feeding r in is xoring it into the first four bytes: R(r, d) =
//     R(0, d ^ r[0..3]) ^ (n < 4 ? r >> 8n : 0);
//   * zeros in front change nothing: R(0, 0...0 d) = R(0, d);
//   * a register followed by k more bytes is multiplied by x^(8k) mod p(x):
//     R(0, u v) = R(0, u) x^(8 |v|) ^ R(0, v).
// So the bytes are laid out back-aligned, ending at the span's end, with
// zeros in front: 2^a 16-byte vectors a thread (a run), THREADS runs a CTA
// (a segment). A thread folds its run with slice-by-8 tables, multiplies
// the result by x^(2^(a+7) (THREADS - 1 - t)) (the runs after it in the
// segment), the CTA xors its threads' results, and the CTA that finishes
// last (a ticket after __threadfence()) multiplies each segment's by
// x^(2^(a+15) (CTAs - 1 - c)) and xors them. The powers come from a table
// (ops/crc32.py::pow_table, row m, column k: x^(2^m k)), one multiply a
// thread at each level; no length enters an exponent, so no power is
// computed on the card.
//
// What bounds it on this card: bytes, the n bytes read once (a 4 MiB group
// in 1.25 us at 3.35 TB/s, likely still in the 50 MB L2 from the decode
// that wrote it), and shared memory: one table lookup a byte, from eight
// tables of 256 words that a warp's lanes hit at random banks. At these
// sizes a launch's own latency (about 2 us) weighs as much. What the design
// does:
//   * one launch a call and nothing else: no memset (the ticket is left at
//     0 by every launch), no copy from the host (n and init come as
//     arguments or are read on the card; the power table is on the card
//     from the first call), no host sync;
//   * about two CTAs an SM (ops/crc32.py::grid), so a 1 MiB and a 4 MiB
//     group each cover the card in one wave; each CTA builds its tables
//     from the polynomial (8 steps and 7 lookups a thread) instead of
//     reading them;
//   * 16-byte aligned loads; the bytes of a back-aligned vector are cut
//     from two neighbouring aligned vectors by funnel shifts, the byte
//     offset uniform over the launch (a switch outside the loop);
//   * a multiply by a power is zlib's multmodp, 32 steps, once a thread in
//     its CTA and once a segment in the last CTA.
// An aligned vector is read only where it holds a byte of [0, n): it then
// lies inside the same page of the same allocation, so the bytes it reads
// outside the array are masked, never out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLog2Vec = 12;
constexpr int kPowRows = 28;
constexpr unsigned kPoly = 0xEDB88320u;
constexpr int kMaxDevices = 64;

// a(x) b(x) mod p(x), both reflected (bit 31 is x^0): zlib's multmodp.
__device__ __forceinline__ unsigned mulmod(unsigned a, unsigned b) {
  unsigned p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// R(r, 8 bytes): the low word w0 holds the first four, w1 the next four.
__device__ __forceinline__ unsigned step8(const unsigned (*t)[256],
                                          unsigned r, unsigned w0,
                                          unsigned w1) {
  const unsigned x = r ^ w0;
  return t[7][x & 0xFFu] ^ t[6][(x >> 8) & 0xFFu] ^ t[5][(x >> 16) & 0xFFu] ^
         t[4][x >> 24] ^ t[3][w1 & 0xFFu] ^ t[2][(w1 >> 8) & 0xFFu] ^
         t[1][(w1 >> 16) & 0xFFu] ^ t[0][w1 >> 24];
}

// v's bytes k at data index q + k: zeroed below 0, xored with byte q + k of
// r0 (the raw starting register) in [0, 4).
__device__ __forceinline__ uint4 front(uint4 v, long long q, unsigned r0) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long i = q + k;
    const unsigned sh = 8 * (k & 3);
    if (i < 0)
      w[k >> 2] &= ~(0xFFu << sh);
    else if (i < 4)
      w[k >> 2] ^= ((r0 >> (8 * i)) & 0xFFu) << sh;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes [4 * WS + bs / 8, + 16) of the 32 bytes lo, hi.
template <int WS>
__device__ __forceinline__ uint4 cut(uint4 lo, uint4 hi, unsigned bs) {
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(w[WS], w[WS + 1], bs),
                    __funnelshift_r(w[WS + 1], w[WS + 2], bs),
                    __funnelshift_r(w[WS + 2], w[WS + 3], bs),
                    __funnelshift_r(w[WS + 3], w[WS + 4], bs));
}

// R(0, a thread's run): `vec` back-aligned vectors, the first at data index
// q0. Aligned vector g (from `al`, the 16-byte boundary at or before the
// data) holds data bytes [16 g - head, 16 g - head + 16); the run's first
// vector starts in aligned vector g0, at the launch's byte offset; those
// outside [0, gmax] hold no byte of the data and are not read.
template <int WS>
__device__ unsigned run(const unsigned (*t)[256], const uint4* __restrict__ al,
                        long long g0, long long gmax, long long q0, int vec,
                        unsigned bs, unsigned r0) {
  unsigned r = 0;
  uint4 lo = (g0 >= 0 && g0 <= gmax) ? __ldg(al + g0)
                                      : make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < vec; ++j) {
    const long long q = q0 + 16LL * j;
    const long long g = g0 + 1 + j;
    const uint4 hi = (g >= 0 && g <= gmax) ? __ldg(al + g)
                                           : make_uint4(0u, 0u, 0u, 0u);
    if (q + 16 > 0) {           // before that the run is all zeros: r is 0
      uint4 v = cut<WS>(lo, hi, bs);
      if (q < 4) v = front(v, q, r0);
      r = step8(t, r, v.x, v.y);
      r = step8(t, r, v.z, v.w);
    }
    lo = hi;
  }
  return r;
}

__device__ __forceinline__ unsigned xor_cta(unsigned v, unsigned* s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v ^= __shfl_xor_sync(0xFFFFFFFFu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                     // s may hold an earlier round's
  if (lane == 0) s[warp] = v;
  __syncthreads();
  unsigned x = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) x ^= s[w];
  return x;
}

// One CTA a segment of kThreads runs of 2^a back-aligned vectors; out[1 + c]
// takes segment c's register shifted to the segment's end, out[0] the CRC.
__global__ void __launch_bounds__(kThreads)
crc32_kernel(const uint4* __restrict__ al, int head, long long n_arg,
             const long long* __restrict__ n_dev, long long size,
             unsigned init_arg, const long long* __restrict__ init_dev,
             int a, const unsigned* __restrict__ pows,
             unsigned long long* __restrict__ out,
             unsigned* __restrict__ ticket) {
  __shared__ unsigned t[8][256];
  __shared__ unsigned s_x[kWarps];
  __shared__ int s_last;
  long long n = n_arg;
  if (n_dev != nullptr) {              // read on the card, clamped to [0, size]
    n = *n_dev;
    n = n < 0 ? 0 : (n > size ? size : n);
  }
  const unsigned r0 =
      ~(init_dev != nullptr ? static_cast<unsigned>(*init_dev) : init_arg);
  {                                    // slice-by-8 tables from the polynomial
    unsigned c = threadIdx.x;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    t[0][threadIdx.x] = c;
    __syncthreads();
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      c = (c >> 8) ^ t[0][c & 0xFFu];
      t[k][threadIdx.x] = c;
    }
    __syncthreads();
  }
  const int vec = 1 << a;
  const long long total = static_cast<long long>(gridDim.x) * kThreads * vec;
  // the thread's first vector, counted from the span's start, and its data
  // index: the span ends at data index n
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * vec;
  const long long q0 = n - 16 * (total - s0);
  const long long e = head + n;        // the end, from the aligned base
  const unsigned off = static_cast<unsigned>(e & 15);   // every vector's
  // the aligned vector the first vector starts in (q0 + head - off is a
  // multiple of 16), and the last one that holds a byte of [0, n)
  const long long g0 = (q0 + head - off) / 16;
  const long long gmax = n > 0 ? (e - 1) / 16 : -1;
  const unsigned bs = 8 * (off & 3);
  unsigned r;
  switch (off >> 2) {
    case 0: r = run<0>(t, al, g0, gmax, q0, vec, bs, r0); break;
    case 1: r = run<1>(t, al, g0, gmax, q0, vec, bs, r0); break;
    case 2: r = run<2>(t, al, g0, gmax, q0, vec, bs, r0); break;
    default: r = run<3>(t, al, g0, gmax, q0, vec, bs, r0); break;
  }
  if (r != 0)
    r = mulmod(r, pows[(a + 7) * 256 + (kThreads - 1 - threadIdx.x)]);
  const unsigned seg = xor_cta(r, s_x);
  if (threadIdx.x == 0) {
    out[1 + blockIdx.x] = seg;
    __threadfence();
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned v = 0;
  if (threadIdx.x < gridDim.x) {
    v = static_cast<unsigned>(__ldcg(out + 1 + threadIdx.x));
    if (v != 0)
      v = mulmod(v, pows[(a + 15) * 256 + (gridDim.x - 1 - threadIdx.x)]);
  }
  v = xor_cta(v, s_x);
  if (threadIdx.x == 0) {
    if (n < 4) v ^= r0 >> (8 * n);
    out[0] = v ^ 0xFFFFFFFFu;
  }
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it is
// not) and returns the CUDA error (0 on success). `data` holds `size`
// bytes; the CRC covers its first n: `n` itself, or where `n_dev` is not
// null the int64 there, clamped to [0, size], read by the kernel. It starts
// from `init`, or where `init_dev` is not null from the low 32 bits of the
// int64 there. Runs of 2^a vectors (a <= 12) and `grid` CTAs
// (ops/crc32.py::grid, at most 256) must cover the bytes; `pows` is
// ops/crc32.py::pow_table on the card (u32[28][256]); `out` is
// int64[1 + grid]: the CRC comes back in out[0]; `ticket` is a uint32 that
// is 0 when no launch on it is running and is left at 0: one per stream.
// All allocated by the caller.
extern "C" int crc32_launch(const void* data, long long n, const void* n_dev,
                            long long size, unsigned init,
                            const void* init_dev, int a, int grid,
                            const void* pows, void* out, void* ticket,
                            int device, void* stream) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  const long long bound = n_dev != nullptr ? size : n;
  if (size < 0 || bound < 0 || bound > size || a < 0 || a > kMaxLog2Vec ||
      grid < 1 || grid > kThreads || a + 15 >= kPowRows ||
      static_cast<long long>(grid) * kThreads * (16LL << a) < bound ||
      pows == nullptr || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const auto* al = reinterpret_cast<const uint4*>(
        static_cast<const char*>(data) - head);
    crc32_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        al, head, n, static_cast<const long long*>(n_dev), size, init,
        static_cast<const long long*>(init_dev), a,
        static_cast<const unsigned*>(pows),
        static_cast<unsigned long long*>(out),
        static_cast<unsigned*>(ticket));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
