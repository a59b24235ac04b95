// Length-limited canonical Huffman codes for Hopper (sm_90a), plain C
// interface: code lengths by package-merge, canonical codes and their
// bit-reversed form, for B independent alphabets at once.
//
// Stands for deflate_compression_tpu/core/huffman.py::huffman_code_lengths
// with _package_merge_lengths (:75-192) and canonical_codes, and
// core/bits.py::reverse_bits (:30-44), which the JAX package left to XLA:
// they have no Pallas kernel. Per alphabet (row) of n frequencies f, with
// INF = 2^28 and k = #{f > 0}:
//   leaves  the keys (f > 0 ? f : INF) in stable ascending order (the
//           plain version's argsort(stable=True)): lv[0..n), order[0..n);
//   levels  P_1 = the leaves and n INF pads; P_l (l = 2..max_bits) is the
//           merge of the leaves with the n packages min(P_{l-1}[2p] +
//           P_{l-1}[2p+1], INF), a leaf before a package of equal weight;
//   lengths from m = max(2k - 2, 0) at the deepest level down: nleaf_l =
//           the leaves of weight < INF among P_l's first clamp(m, 0, 2n)
//           items, m = 2 (m - nleaf_l); the j-th sorted leaf's length is
//           #{l : j < nleaf_l} for j < k (k = 1: length 1 for j = 0),
//           scattered back to symbol order and zeroed where f <= 0;
//   codes   RFC 1951 §3.2.2: next_code from the length counts, plus each
//           symbol's rank among the symbols of its length in symbol order;
//   rev     each code reversed within its length.
// The arithmetic is the plain version's, in int64 with the same INF clamp,
// so every output equals it for any int64 frequencies.
//
// What bounds it on this card: the latency of its dependent steps. A row
// moves 8 n bytes in and 24 n bytes out (9 KB at n = 286) and does O(n^2)
// compares; the work is a chain of about 3 max_bits barriers.
//
// One CTA per alphabet, one thread per symbol (n rounded up to a warp):
//   * the sort: the key (weight, symbol) is unique, so each thread counts
//     the keys below its own in shared memory (n compares, the same key
//     read by every lane at once) and writes itself to that rank: a
//     stable order with no sort network;
//   * each of the max_bits - 1 levels: thread p forms package p, then
//     thread j places leaf j and package j in the merged list by a binary
//     search of the other sorted list (searchsorted left for a leaf, right
//     for a package: the tie rule), and keeps the leaf's position for the
//     top-down pass (max_bits x n 16-bit ranks in shared memory);
//   * the top-down pass: every thread carries the same m; one
//     __syncthreads_count per level counts the leaves placed before m;
//   * the length counts by shared atomics, next_code by each thread from
//     them (max_bits steps), its rank among equal lengths by a scan of the
//     lower symbols, and __brev for the reversed code.
//
// Domain: 1 <= n <= 512, 1 <= max_bits <= 15.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSyms = 512;
constexpr int kMaxBits = 15;
constexpr int kMaxDevices = 64;
constexpr int64_t kInf = int64_t{1} << 28;

// #{i < n : a[i] < x} for ascending a
__device__ __forceinline__ int count_below(const int64_t* a, int n,
                                           int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// #{i < n : a[i] <= x} for ascending a
__device__ __forceinline__ int count_at_most(const int64_t* a, int n,
                                             int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxSyms)
    huffman_codes_kernel(const int64_t* __restrict__ freqs, int n, int max_bits,
                         int64_t* __restrict__ lengths,
                         int64_t* __restrict__ codes,
                         int64_t* __restrict__ rev) {
  __shared__ int64_t lv[kMaxSyms];          // sorted leaf weights
  __shared__ int64_t pw[kMaxSyms];          // this level's packages
  __shared__ int64_t w[2 * kMaxSyms];       // the level list (keys first)
  __shared__ int16_t rank_l[kMaxBits][kMaxSyms];
  __shared__ int16_t order[kMaxSyms];       // symbol of sorted leaf j
  __shared__ uint8_t len_of[kMaxSyms];      // length by symbol
  __shared__ int bl_count[kMaxBits + 1];

  const int t = threadIdx.x;
  const bool sym = t < n;
  const int64_t row = int64_t{blockIdx.x} * n;
  const int64_t f = sym ? freqs[row + t] : 0;
  const bool active = sym && f > 0;
  const int64_t key = active ? f : kInf;
  if (sym) w[t] = key;
  if (t <= kMaxBits) bl_count[t] = 0;
  const int k = __syncthreads_count(active);

  // stable order by (key, symbol)
  if (sym) {
    int pos = 0;
    for (int u = 0; u < n; ++u) {
      const int64_t ku = w[u];
      pos += ku < key || (ku == key && u < t);
    }
    lv[pos] = key;
    order[pos] = static_cast<int16_t>(t);
  }
  __syncthreads();
  if (sym) {
    w[t] = lv[t];
    w[n + t] = kInf;
  }
  __syncthreads();

  for (int l = 1; l < max_bits; ++l) {
    if (sym) {
      const int64_t s = w[2 * t] + w[2 * t + 1];
      pw[t] = s < kInf ? s : kInf;
    }
    __syncthreads();
    if (sym) {
      const int rl = t + count_below(pw, n, lv[t]);
      const int rp = t + count_at_most(lv, n, pw[t]);
      w[rl] = lv[t];
      w[rp] = pw[t];
      rank_l[l][t] = static_cast<int16_t>(rl);
    }
    __syncthreads();
  }

  // top-down: the leaves among the first m items, deepest level first
  int len = 0;
  long long m = 2LL * k - 2;
  if (m < 0) m = 0;
  const bool finite = sym && lv[t] < kInf;
  for (int l = max_bits - 1; l >= 0; --l) {
    const long long idx = m < 0 ? 0 : (m > 2LL * n ? 2LL * n : m);
    const int at = l == 0 ? t : rank_l[l][t];
    const int nleaf = __syncthreads_count(finite && at < idx);
    len += t < nleaf;
    m = 2 * (m - nleaf);
  }
  if (sym) {
    int lj = t < k ? len : 0;
    if (k == 1) lj = t == 0;
    len_of[order[t]] = static_cast<uint8_t>(lj);
  }
  __syncthreads();

  const int my_len = active ? len_of[t] : 0;
  if (my_len > 0) atomicAdd(&bl_count[my_len], 1);
  if (sym) len_of[t] = static_cast<uint8_t>(my_len);
  __syncthreads();
  if (!sym) return;
  int64_t code = 0, r = 0;
  if (my_len > 0) {
    int64_t next = 0;
    for (int b = 1; b <= my_len; ++b)      // bl_count[0] stays 0
      next = (next + bl_count[b - 1]) << 1;
    int rank = 0;
    for (int u = 0; u < t; ++u) rank += len_of[u] == my_len;
    code = next + rank;
    r = __brev(static_cast<unsigned>(code)) >> (32 - my_len);
  }
  lengths[row + t] = my_len;
  codes[row + t] = code;
  rev[row + t] = r;
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `freqs`, `lengths`,
// `codes` and `rev` are rows x n int64, all allocated by the caller.
extern "C" int huffman_codes_launch(const void* freqs, int rows, int n,
                                    int max_bits,
                                    void* lengths, void* codes, void* rev,
                                    int device, void* stream) {
  if (rows < 1 || n < 1 || n > kMaxSyms || max_bits < 1 ||
      max_bits > kMaxBits || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned threads = static_cast<unsigned>((n + 31) / 32 * 32);
    auto* lo = static_cast<int64_t*>(lengths);
    auto* co = static_cast<int64_t*>(codes);
    auto* ro = static_cast<int64_t*>(rev);
    huffman_codes_kernel<<<rows, threads, 0, st>>>(
        static_cast<const int64_t*>(freqs), n, max_bits, lo, co, ro);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
