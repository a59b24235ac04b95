// The shard encoder's block layout scan for Hopper (sm_90a), plain C
// interface.
//
// Stands for the NB-step loop of deflate_compression_tpu/format/deflate.py
// (:520-534, a lax.scan), which the JAX package left to XLA: it has no
// Pallas kernel. With p = 0 and, for each coding block b in turn, rest[b]
// its bits without the stored pad:
//   pad[b]  = stored[b] ? (8 - (p + 3) % 8) % 8 : 0   (LEN on a byte edge)
//   base[b] = p
//   p      += rest[b] + pad[b]
// and p_end = p after the last block.
//
// What bounds it on this card: the chain of NB dependent steps. The bytes
// are 9 NB in and 16 NB + 8 out (2.1 KB at NB = 128).
//
// One CTA of 256 threads: the threads stage a chunk of up to 2,048 blocks'
// rest and stored flags in shared memory with coalesced loads, thread 0
// walks the chunk (an add and a mask a step, p in a register), and the
// threads store the chunk's bases and pads; chunks follow in turn.
//
// Domain: 1 <= NB <= 2^31 - 1; the sums fit int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
    block_layout_kernel(const int64_t* __restrict__ rest,
                        const bool* __restrict__ stored, int64_t nb,
                        int64_t* __restrict__ base, int64_t* __restrict__ pad,
                        int64_t* __restrict__ p_end) {
  __shared__ int64_t s_rest[kChunk];      // rest, then the bases
  __shared__ int8_t s_pad[kChunk];        // stored flags, then the pads
  int64_t p = 0;                          // thread 0's running offset
  for (int64_t c0 = 0; c0 < nb; c0 += kChunk) {
    const int len = static_cast<int>(nb - c0 < kChunk ? nb - c0 : kChunk);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      s_rest[i] = rest[c0 + i];
      s_pad[i] = stored[c0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) {
        const int pd = s_pad[i] ? static_cast<int>((8 - ((p + 3) & 7)) & 7)
                                : 0;
        const int64_t r = s_rest[i];
        s_rest[i] = p;
        s_pad[i] = static_cast<int8_t>(pd);
        p += r + pd;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      base[c0 + i] = s_rest[i];
      pad[c0 + i] = s_pad[i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *p_end = p;
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `rest` is int64[nb],
// `stored` bool[nb]; `base` and `pad` int64[nb] and `p_end` one int64, all
// allocated by the caller.
extern "C" int block_layout_launch(const void* rest, const void* stored,
                                   int64_t nb, void* base, void* pad,
                                   void* p_end, int device, void* stream) {
  if (nb < 1 || nb > 0x7FFFFFFF || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    block_layout_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(rest), static_cast<const bool*>(stored),
        nb, static_cast<int64_t*>(base), static_cast<int64_t*>(pad),
        static_cast<int64_t*>(p_end));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
