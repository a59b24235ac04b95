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
// What bounds it on this card: the launch and the chain of dependent
// steps. The bytes are 9 NB in and 16 NB + 8 out (2.1 KB at NB = 128).
//
// The encoder carries the same maps through csrc/pack_words.cu's
// look-back; this standalone launch is the op
// `ops/block_layout.py::block_layout`.
// One CTA of min(256, NB rounded up to 32) threads runs the log-depth
// scan of layout_scan.cuh: a block's pad depends on p only through p mod
// 8, so each block is a map of p mod 8 and the maps compose; the chain is
// ceil(log2(NB)) shuffle levels a chunk of 256 blocks instead of a walk
// of NB dependent steps by one thread.
//
// Domain: 1 <= NB <= 2^31 - 1; the sums fit int64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "layout_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
    block_layout_kernel(const int64_t* __restrict__ rest,
                        const bool* __restrict__ stored, int64_t nb,
                        int64_t* __restrict__ base, int64_t* __restrict__ pad,
                        int64_t* __restrict__ p_end) {
  __shared__ layout::Shared sh;
  const int64_t p = layout::scan(
      nb,
      [&](int64_t b, int64_t& r, bool& s) {
        r = rest[b];
        s = stored[b];
      },
      [&](int64_t b, int64_t bs, int pd) {
        base[b] = bs;
        pad[b] = pd;
      },
      sh);
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
    const int threads = static_cast<int>(
        nb >= kThreads ? kThreads : (nb + 31) / 32 * 32);
    block_layout_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(rest), static_cast<const bool*>(stored),
        nb, static_cast<int64_t*>(base), static_cast<int64_t*>(pad),
        static_cast<int64_t*>(p_end));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
