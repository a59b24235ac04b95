// Table gather out[i] = tbl[idx[i]] for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel probed in tools/probe_pallas_r5.py:35 (try_lower
// with k_take / k_intidx / k_tala / k_onehot: out[i] = tbl[idx[i]] with
// tbl i32[2048], idx i32[4096]), which Mosaic could not lower. The indexed
// decoder gathers each lane's block flags with it
// (decode/device_inflate.py::lanes): one table entry per coding block slot,
// padded to a power of two, and one block id per lane.
//
// What it computes (exactly ops/lut_gather.py::lut_gather_ref for idx in
// [0, n_tbl)): out[i] = tbl[idx[i] & (n_tbl - 1)], n_tbl a power of two up
// to 2^30.
//
// What bounds it on this card. Each element reads 4 index bytes and writes
// 4 output bytes once, so a large gather is bound by device memory: 2^24
// indices move 128 MB, 40 us at 3.35 TB/s. At the decoder's shapes (a few
// KB of table, 4 K - 150 K indices) the whole gather is 2-3 us, so any
// fixed cost per CTA or per launch weighs as much as the gather itself.
// The table reads are random, but a table of a few KB stays in L1 and a
// larger one in the 50 MB L2, and L1 serves them about as fast as shared
// memory would.
//
// What the design does: every CTA reads the table through the read-only
// path (__ldg) with no staging and no barrier, so no CTA waits before its
// first lookup and no table size is too large (the first design staged the
// whole table in every CTA's shared memory, which capped it at 32768
// entries). A grid of at most SMs x resident CTAs walks the indices
// grid-stride with 16-byte index loads and output stores (streaming hints,
// so they do not evict the table), one index vector prefetched ahead, a
// scalar head and tail where idx is not 16-byte aligned (a view such as
// idx[1:]), and a scalar loop where idx and out differ in alignment. The SM
// count and the occupancy are queried once per device, not per launch.
// A staged variant (the table copied once per CTA into shared memory by
// cp.async.bulk on an mbarrier, overlapped with the first index loads) was
// measured against this on an H100 at 40 shapes: faster at 3 by at most
// 0.18 us, slower at the others by up to 6 us at 4 K - 1 M indices and by
// 2-35 us at 2^24 (PERF.md, Findings).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // indices in one int4
constexpr int kMaxDevices = 64;
constexpr int kMaxLog2Table = 30;

// Resident CTAs the grid may fill, per device; 0: not queried yet.
int g_max_grid[kMaxDevices];

// Elements [0, head) and [head + 4 * n_vec, n_idx) one by one, the rest as
// int4 vectors from idx + head (16-byte aligned, and so is out + head).
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                  uint32_t mask, int64_t n_idx, int64_t head) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t n_vec = (n_idx - head) / kPerThread;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  int4* out4 = reinterpret_cast<int4*>(out + head);

  int64_t v = tid;
  int4 cur = make_int4(0, 0, 0, 0);
  if (v < n_vec) cur = __ldcs(idx4 + v);
  for (; v < n_vec; v += stride) {
    const int64_t nv = v + stride;
    int4 nxt = cur;
    if (nv < n_vec) nxt = __ldcs(idx4 + nv);
    int4 o;
    o.x = __ldg(tbl + (static_cast<uint32_t>(cur.x) & mask));
    o.y = __ldg(tbl + (static_cast<uint32_t>(cur.y) & mask));
    o.z = __ldg(tbl + (static_cast<uint32_t>(cur.z) & mask));
    o.w = __ldg(tbl + (static_cast<uint32_t>(cur.w) & mask));
    __stcs(out4 + v, o);
    cur = nxt;
  }
  for (int64_t i = tid; i < head; i += stride)
    out[i] = __ldg(tbl + (static_cast<uint32_t>(__ldg(idx + i)) & mask));
  for (int64_t i = head + n_vec * kPerThread + tid; i < n_idx; i += stride)
    out[i] = __ldg(tbl + (static_cast<uint32_t>(__ldg(idx + i)) & mask));
}

// SMs x resident CTAs of the current device `dev`, queried once.
cudaError_t max_grid(int dev, int64_t* grid) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!g_max_grid[dev]) {
    int sms = 0, occ = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, lut_gather_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    g_max_grid[dev] = sms * (occ > 0 ? occ : 1);
  }
  *grid = g_max_grid[dev];
  return cudaSuccess;
}

cudaError_t launch(const void* tbl, const void* idx, void* out, int64_t n_tbl,
                   int64_t n_idx, int device, cudaStream_t stream) {
  int64_t cap = 0;
  const cudaError_t e = max_grid(device, &cap);
  if (e != cudaSuccess) return e;
  const int64_t per_cta = int64_t{kThreads} * kPerThread;
  const int64_t need = (n_idx + per_cta - 1) / per_cta;
  const uintptr_t ip = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  int64_t head = static_cast<int64_t>(((16 - (ip & 15)) & 15) / 4);
  if (((ip ^ op) & 15) || head > n_idx) head = n_idx;
  lut_gather_kernel<<<static_cast<unsigned>(need < cap ? need : cap),
                      kThreads, 0, stream>>>(
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), static_cast<uint32_t>(n_tbl - 1), n_idx,
      head);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not); returns the CUDA error (0 on success). Every pointer is a device
// pointer; the caller allocates `out`.
extern "C" int lut_gather_launch(const void* tbl, const void* idx, void* out,
                                 int64_t n_tbl, int64_t n_idx, int device,
                                 void* stream) {
  if (n_idx < 0 || n_tbl <= 0 || n_tbl > (int64_t{1} << kMaxLog2Table) ||
      (n_tbl & (n_tbl - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx == 0) return 0;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch(tbl, idx, out, n_tbl, n_idx, device,
             static_cast<cudaStream_t>(stream));
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
