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
//
// Only the finite items matter. With k' the symbols of 0 < f < INF, every
// P_l holds at most 2k' - 1 items below INF, first, in order (k' leaves
// and at most k' - 1 packages, since a package of an item >= INF is INF);
// nleaf_l counts nothing past them and no package below INF is made from
// anything else. So the kernel keeps each level's finite prefix only,
// 2k' - 1 items at most whatever n is, in int32 (below 2^29), and gives
// the plain version's outputs for any frequencies below 2^62 (where no sum
// of two weights overflows int64); a symbol of f >= INF gets length 0, and
// length 1 only where it is the one used symbol and sorts first, as in
// the plain version.
//
// What bounds it on this card: the latency of its dependent steps. A row
// moves 8 n bytes in and 24 n bytes out (9 KB at n = 286) and does
// O(k' log k') compares per level; the work is a chain of about 3
// max_bits barriers, each level one binary search deep.
//
// One CTA per alphabet, a thread per symbol (a warp per 32), thread t the
// item t of every list:
//   * the used symbols below INF are compacted (a ballot per warp and the
//     counts of the warps before it) as unique keys f << 16 | symbol, and
//     each key's rank is the count of the keys below it, read by every
//     thread at once, eight in flight (k' keys, not n);
//   * each package-merge level: the packages below INF (a prefix: the pair
//     sums ascend; __syncthreads_count gives their number), then leaf t
//     placed at t + #(packages < it) and package t at t + #(leaves <= it)
//     (a leaf first on equal weight), both searches in lockstep; leaf t's
//     position is kept per level; two barriers a level (with one, each
//     package summed from the level below where a search reads it, the
//     searches' longer probes cost more than the barrier);
//   * the top-down counts: one __syncthreads_count per level of the leaves
//     placed before m, each thread adding its own leaf's length as it
//     goes;
//   * the codes: each symbol's rank among those of its length in its
//     warp is a __match_any_sync and a __popc of the lower lanes; one table
//     of each warp's counts, summed over the warps by 16 threads, gives
//     the ranks' offsets and bl_count.
// The levels set the time of an encoder's 286-symbol rows, the sort's
// count over the used keys next (block_stage_probe.py gives the cycles of
// each stage; PERF.md §6). A warp per alphabet was slower than one thread
// per symbol: one lane's share of a level is a chain of dependent
// shared-memory loads, where here each thread places one item.
//
// Domain: 1 <= n <= 512, 1 <= max_bits <= 15, frequencies below 2^62.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSyms = 512;
constexpr int kMaxBits = 15;
constexpr int kMaxThreads = kMaxSyms;      // a thread per symbol
constexpr int kGroups = kMaxSyms / 32;     // warps of 32 symbols
constexpr int kMaxDevices = 64;
constexpr int kInf = 1 << 28;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int top_step(int len) {  // the largest 2^i <= len
  return len > 0 ? 1 << (31 - __clz(len)) : 0;
}

__global__ void __launch_bounds__(kMaxThreads)
    huffman_codes_kernel(const int64_t* __restrict__ freqs, int n,
                         int max_bits, int64_t* __restrict__ lengths,
                         int64_t* __restrict__ codes,
                         int64_t* __restrict__ rev) {
  __shared__ uint64_t key[kMaxSyms];        // compacted, unsorted
  __shared__ int lv[kMaxSyms];              // sorted leaf weights
  __shared__ int pk[kMaxSyms];              // this level's packages
  __shared__ int wl[2][2 * kMaxSyms];       // the level lists' weights
  __shared__ int16_t at_level[kMaxBits][kMaxSyms];  // leaf t's position
  __shared__ int16_t order[kMaxSyms];       // symbol of sorted leaf j
  __shared__ uint8_t len_of[kMaxSyms];
  __shared__ int tab[kGroups][16];          // counts, then offsets
  __shared__ int bl[16];
  __shared__ int w_act[kGroups], w_fin[kGroups], s_act_sym;
  __shared__ long long s_act_f;

  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1;
  const int64_t at = int64_t{blockIdx.x} * n;
  for (int i = t; i < kGroups * 16; i += T) tab[i / 16][i % 16] = 0;

  // ---- load; compact the used symbols below INF (warp counts, then each
  // warp's place from the counts before it)
  const int64_t f = t < n ? freqs[at + t] : 0;
  const bool active = f > 0, fin = active && f < kInf;
  const unsigned ba = __ballot_sync(kAll, active);
  const unsigned bf = __ballot_sync(kAll, fin);
  if (lane == 0) {
    w_act[warp] = __popc(ba);
    w_fin[warp] = __popc(bf);
  }
  if (active) {
    s_act_sym = t;                          // read only when k == 1
    s_act_f = f;
  }
  if (t < n) len_of[t] = 0;
  __syncthreads();
  int k = 0, kf = 0, base = 0;
  for (int w = 0; w < T / 32; ++w) {
    k += w_act[w];
    base += w < warp ? w_fin[w] : 0;
    kf += w_fin[w];
  }
  if (fin)
    key[base + __popc(bf & below)] =
        static_cast<uint64_t>(f) << 16 | static_cast<uint64_t>(t);
  __syncthreads();

  // ---- rank sort: each key's place is the count of the keys below it
  if (t < kf) {
    const uint64_t mine = key[t];
    int rank = 0, u = 0;
    for (; u + 8 <= kf; u += 8) {
      uint64_t v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) v[x] = key[u + x];
#pragma unroll
      for (int x = 0; x < 8; ++x) rank += v[x] < mine;
    }
    for (; u < kf; ++u) rank += key[u] < mine;
    lv[rank] = static_cast<int>(mine >> 16);
    order[rank] = static_cast<int16_t>(mine & 0xFFFF);
  }
  __syncthreads();

  // ---- package-merge levels 2..max_bits over the finite prefixes
  int fc = kf;
  const int top_l = top_step(kf);
  for (int l = 1; l < max_bits; ++l) {
    const int* w = l == 1 ? lv : wl[l & 1];  // the level below
    int* nxt = wl[(l & 1) ^ 1];
    // the packages below INF: a prefix, the pair sums ascending
    bool fin = false;
    if (t < fc / 2) {
      const int s = w[2 * t] + w[2 * t + 1];
      fin = s < kInf;
      if (fin) pk[t] = s;
    }
    const int np = __syncthreads_count(fin);
    // leaf t: t + #(packages < it); package t: t + #(leaves <= it)
    const int top_p = top_step(np);
    const int key_l = t < kf ? lv[t] : 0, key_p = t < np ? pk[t] : 0;
    int pos_l = 0, pos_p = 0;
    for (int step = top_p > top_l ? top_p : top_l; step >= 1; step >>= 1) {
      const int pl = pos_l + step, pp = pos_p + step;
      if (step <= top_p && pl <= np && pk[pl - 1] < key_l) pos_l = pl;
      if (step <= top_l && pp <= kf && lv[pp - 1] <= key_p) pos_p = pp;
    }
    if (t < kf) {
      nxt[t + pos_l] = key_l;
      at_level[l][t] = static_cast<int16_t>(t + pos_l);
    }
    if (t < np) nxt[t + pos_p] = key_p;
    fc = kf + np;
    __syncthreads();
  }
  // ---- top-down: the finite leaves among each level's first m items
  // (a barrier's count of the leaves placed before m), and the length of
  // sorted leaf t as the levels where it is one of them
  int depth = 0;
  long long m = 2LL * k - 2;
  if (m < 0) m = 0;
  for (int l = max_bits - 1; l >= 0; --l) {
    const long long idx = m > 2LL * n ? 2LL * n : m;
    const int at = l == 0 ? t : at_level[l][t];
    const int c = __syncthreads_count(t < kf && at < idx);
    depth += t < c;
    m = 2 * (m - c);
  }
  if (t < kf)
    len_of[order[t]] = static_cast<uint8_t>(k == 1 ? t == 0 : depth);
  if (t == 0 && k == 1 && kf == 0) {
    // the one used symbol lies at or above INF: length 1 if it sorts first
    // among all n keys (the unused symbols' keys are INF)
    if (n == 1 || (s_act_sym == 0 && s_act_f == kInf)) len_of[s_act_sym] = 1;
  }
  __syncthreads();

  // ---- canonical codes: ranks among equal lengths in symbol order
  const int len = t < n ? len_of[t] : 0;
  const unsigned same = __match_any_sync(kAll, len);
  const int within = __popc(same & below);
  if (__ffs(same) - 1 == lane) tab[warp][len] = __popc(same);
  __syncthreads();
  if (t < 16) {                             // counts -> offsets, bl_count
    int run = 0;
    for (int g = 0; g < T / 32; ++g) {
      const int v = tab[g][t];
      tab[g][t] = run;
      run += v;
    }
    bl[t] = run;
  }
  __syncthreads();
  if (t < n) {
    long long code = 0, rv = 0;
    if (len > 0) {
      long long next = 0;                   // RFC 1951 next_code[len]
      for (int b = 1; b < len; ++b)
        next += static_cast<long long>(bl[b]) << (len - b);
      code = next + tab[warp][len] + within;
      rv = __brev(static_cast<unsigned>(code)) >> (32 - len);
    }
    lengths[at + t] = len;
    codes[at + t] = code;
    rev[at + t] = rv;
  }
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
    const int threads = (n + 31) / 32 * 32;
    huffman_codes_kernel<<<rows, threads, 0, st>>>(
        static_cast<const int64_t*>(freqs), n, max_bits,
        static_cast<int64_t*>(lengths), static_cast<int64_t*>(codes),
        static_cast<int64_t*>(rev));
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
