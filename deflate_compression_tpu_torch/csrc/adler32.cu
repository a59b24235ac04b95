// Adler-32 of the first n bytes of a byte array for Hopper (sm_90a), plain C
// interface.
//
// Replaces no Pallas kernel: the JAX package computes the zlib footer's
// checksum in plain jnp (deflate_compression_tpu/core/checksum.py::
// adler32_jax), and the port's plain version (core/checksum.py::
// adler32_torch_ref) in some fifteen torch operations over an int64 copy of
// the bytes. The verified decode checksums every shard it decodes, so the
// checksum runs once per decoded MiB group or 4 MiB shard.
//
// What it computes (exactly zlib.adler32 and adler32_torch_ref): with d[i]
// the bytes, 0 <= i < n, and p = 65521,
//   a = 1 + sum d[i],   b = n + sum (n - i) * d[i],   both mod p,
// returned as the int64 (b << 16) | a. Both sums are linear in the bytes,
// so the bytes split into segments whose shares add up: segment c, starting
// at byte s_c, holds A_c = sum d[s_c + j] and J_c = sum j * d[s_c + j], and
// its share of b is t_c = (n - s_c) * A_c - J_c. The plain version's fold
// over its 5,552-byte chunks, b = sum_c (L_c * a_before_c + w_c), is the
// same sum with a_before_c = 1 + the bytes before chunk c written out:
// sum_c L_c * a_before_c = n + sum_c (n - e_c) * A_c, e_c the chunk's end.
// So no segment waits for the ones before it, and
// a = 1 + sum A_c, b = n + sum t_c, mod p.
//
// What bounds it on this card: bytes, the n bytes read once (a 4 MiB shard
// in 1.25 us at 3.35 TB/s, and it was written by the decode just before, so
// it is likely still in the 50 MB L2). At these sizes a launch's own
// latency (about 2 us) weighs as much as the reads. What the design does:
//   * one launch a call and nothing else: no memset (the ticket counter is
//     left at 0 by every launch), no second pass, no copy from the host (n
//     comes as an argument or is read from the card) and no host sync; the
//     wrapper allocates one buffer, the result and the partials, from
//     torch's cache;
//   * the grid is sized from n (ops/adler32.py::grid): about two CTAs an SM,
//     each over one segment of 4 KiB to 1 MiB, so a 1 MiB group and a 4 MiB
//     shard both cover the card in one wave;
//   * each thread issues its 16-byte loads a few at a time before it uses
//     them, and takes a vector's byte sum and its sum k * d[k] with eight
//     __dp4a; only the vector holding byte 0 (where the array does not
//     start on 16 bytes) and the one holding byte n - 1 mask bytes;
//   * the CTA's sums are exact in 64 bits (a segment is at most 1 MiB:
//     A_c < 2^28, J_c < 2^48) and taken mod p only for its one partial;
//     the CTA that finishes last (a ticket after __threadfence()) adds the
//     partials and writes the result.
// A vector is read whole only where it holds a byte of [0, n): a 16-byte
// aligned load that holds a valid byte lies inside the same page of the
// same allocation, so the bytes it reads outside the array are masked, never
// out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // loads in flight a thread
constexpr int kMaxVec = 256;             // vectors a thread: segments <= 1 MiB
constexpr unsigned kMod = 65521;
constexpr int kMaxDevices = 64;

// The byte sum of a 16-byte vector and sum k * x[k] over its bytes k =
// 0..15 (byte k of word w is byte 4w + k % 4: little endian).
__device__ __forceinline__ void vec_sums(uint4 x, unsigned& s, unsigned& k) {
  const unsigned one = 0x01010101u;
  s = __dp4a(x.x, one, __dp4a(x.y, one, __dp4a(x.z, one,
             __dp4a(x.w, one, 0u))));
  k = __dp4a(x.x, 0x03020100u, __dp4a(x.y, 0x07060504u,
             __dp4a(x.z, 0x0B0A0908u, __dp4a(x.w, 0x0F0E0D0Cu, 0u))));
}

// x with the bytes whose index q + k lies outside [0, n) zeroed.
__device__ __forceinline__ uint4 keep(uint4 x, long long q, long long n) {
  unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (q + k < 0 || q + k >= n) w[k >> 2] &= ~(0xFFu << (8 * (k & 3)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One CTA a segment of kThreads * vec vectors of the 16-byte aligned span
// that starts `head` bytes before the array; out[1 + c] takes segment c's
// (t_c mod p) << 32 | (A_c mod p), out[0] the checksum.
__global__ void __launch_bounds__(kThreads)
adler32_kernel(const uint4* __restrict__ base, int head, long long n_arg,
               const long long* __restrict__ n_dev, long long size, int vec,
               unsigned long long* __restrict__ out,
               unsigned* __restrict__ ticket) {
  __shared__ unsigned long long s_a[kWarps], s_j[kWarps];
  __shared__ int s_last;
  long long n = n_arg;
  if (n_dev != nullptr) {              // read on the card, clamped to [0, size]
    n = *n_dev;
    n = n < 0 ? 0 : (n > size ? size : n);
  }
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads * vec;
  const long long nvec = (n + head + 15) >> 4;   // vectors holding a byte
  unsigned a_t = 0;
  unsigned long long j_t = 0;
  for (int v = 0; v < vec; v += kUnroll) {
    if (v0 + static_cast<long long>(v) * kThreads >= nvec) break;
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g =
          v0 + static_cast<long long>(v + u) * kThreads + threadIdx.x;
      x[u] = (v + u < vec && g < nvec) ? __ldg(base + g)
                                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int o = (v + u) * kThreads + threadIdx.x;  // vector in segment
      const long long q = (v0 + o) * 16 - head;        // its first byte's i
      if (v0 + o < nvec && (q < 0 || q + 16 > n)) x[u] = keep(x[u], q, n);
      unsigned s, k;
      vec_sums(x[u], s, k);
      a_t += s;
      j_t += static_cast<unsigned long long>(o) * 16u * s + k;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a_t += __shfl_down_sync(0xFFFFFFFFu, a_t, off);
    j_t += __shfl_down_sync(0xFFFFFFFFu, j_t, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_a[warp] = a_t;
    s_j[warp] = j_t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long A = 0, J = 0;
    for (int w = 0; w < kWarps; ++w) {
      A += s_a[w];
      J += s_j[w];
    }
    const long long s0 = v0 * 16 - head;             // the segment's byte 0
    const unsigned long long nm =
        static_cast<unsigned long long>(((n - s0) % kMod + kMod) % kMod);
    const unsigned long long am = A % kMod;
    const unsigned long long t = (nm * am + kMod - J % kMod) % kMod;
    out[1 + blockIdx.x] = (t << 32) | am;
    __threadfence();
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned long long sa = 0, st = 0;
  for (unsigned c = threadIdx.x; c < gridDim.x; c += kThreads) {
    const unsigned long long p = __ldcg(out + 1 + c);
    sa += p & 0xFFFFFFFFu;
    st += p >> 32;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_down_sync(0xFFFFFFFFu, sa, off);
    st += __shfl_down_sync(0xFFFFFFFFu, st, off);
  }
  if (lane == 0) {                   // thread 0 read them before s_last
    s_a[warp] = sa;
    s_j[warp] = st;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sa = st = 0;
    for (int w = 0; w < kWarps; ++w) {
      sa += s_a[w];
      st += s_j[w];
    }
    const unsigned long long a = (1 + sa) % kMod;
    const unsigned long long b =
        (static_cast<unsigned long long>(n) % kMod + st) % kMod;
    out[0] = (b << 16) | a;
  }
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it is
// not) and returns the CUDA error (0 on success). `data` holds `size`
// bytes; the checksum covers its first n: `n` itself, or where `n_dev` is
// not null the int64 there, clamped to [0, size], read by the kernel.
// `vec` and `grid` (ops/adler32.py::grid) must cover the bytes from the
// 16-byte boundary at or before `data`; `out` is int64[1 + grid]: the
// checksum comes back in out[0]; `ticket` is a uint32 that is 0 when no
// launch on it is running and is left at 0: one per stream. All allocated
// by the caller.
extern "C" int adler32_launch(const void* data, long long n,
                              const void* n_dev, long long size, int vec,
                              int grid, void* out, void* ticket, int device,
                              void* stream) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  const long long bound = n_dev != nullptr ? size : n;
  if (size < 0 || bound < 0 || bound > size || vec < 1 || vec > kMaxVec ||
      grid < 1 ||
      static_cast<long long>(grid) * kThreads * vec * 16 < bound + head ||
      device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const auto* base = reinterpret_cast<const uint4*>(
        static_cast<const char*>(data) - head);
    adler32_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        base, head, n, static_cast<const long long*>(n_dev), size, vec,
        static_cast<unsigned long long*>(out),
        static_cast<unsigned*>(ticket));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
