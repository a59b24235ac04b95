// The shard encoder's block-split DP for Hopper (sm_90a), plain C interface.
//
// Stands for deflate_compression_tpu/core/cost.py::block_plan (:34-160),
// which the JAX package left to XLA: it has no Pallas kernel. With ll[t, s]
// and d[t, s] the tile histograms (M tiles, 286 and 30 symbols), f the
// counts of tiles [max(j-k, 0), j) and mm the merge bound:
//   cost[j-1, k-1] = h_ll + h_d + extra + 62 + 5.5 * active + log2(n_ll)
//     h_ll = sum over f > 0 of f * (log2(n_ll) - log2(max(f, 1e-9))),
//     n_ll = sum f + 1 (the EOB), h_d the same with n_d = max(sum f, 1),
//     extra = the length and distance codes' extra bits, active = #{f > 0};
//   column 0 takes min(cost, 42 + 8 * tile_bytes) (a stored tile);
//   opt[0] = 0, opt[j] = min over k of opt[j-k] + cost[j-1, k-1] (k <= j),
//     back[j-1] = the first k that reaches it (torch.argmin's ties);
//   the backtrack from n_valid marks each block's first tile in split.
// Every term is the same float32 expression in the same order as the plain
// version (ops/block_plan.py, through core/cost.py::segment_costs), each
// product and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction
// into fused multiply-adds) and log2f the accurate one (no fast math).
// Only the sums over the 316 symbols differ: the counts are integers and
// their sums exact (below 2^24); the h terms are summed in float64 and
// rounded once to float32, so h is within half an ulp of the exact sum of
// the float32 terms, where the plain version's own reduction order leaves
// it within a few ulps. A DP step whose best and second-best candidates
// lie closer than those few ulps could choose otherwise; the wrapper
// reports the smallest such margin of each call.
//
// What bounds it on this card: the serial DP, M dependent steps. The costs
// are M * mm segments of 316 terms (one log2f each where f > 0), spread
// over the card; the bytes (the histograms, read once) are under 0.4 MB at
// M = 128.
//
// One launch. Each CTA of 8 warps computes the costs of one end tile j,
// each warp an eighth of the k = 1..mm segments ending at j:
//   * the CTA stages the tile rows its segments cover (at most mm) in
//     shared memory as int32, with coalesced loads;
//   * a warp sums the rows j-1, j-2, ... into its running counts (lane l
//     holds the symbols l + 32 r, r < 10), and after each row k of its
//     share evaluates cost[j-1, k-1]: the lanes' terms summed in symbol
//     order, then a butterfly of 5 shuffles: a fixed order of float64
//     adds, so the costs' bits do not depend on which warp computes them;
//     the counts and the extra bits travel packed two to a 64-bit word;
//   * the CTA that finishes last (a ticket taken after __threadfence(), on
//     a counter the wrapper keeps per stream and the last CTA leaves at 0)
//     runs the DP: it stages the costs in shared memory, 3,840 at a time
//     (the columns k > mm padded with +inf), and thread 0 runs the chain
//     with opt[j-mm..j-1] in registers, a ring indexed j mod MM, MM = 8 or
//     32 (templated; mm <= MM): each step is MM independent __fadd_rn
//     candidates and a tree of fminf taken newest last, so the chain from
//     opt[j-1] to opt[j] is one add and one minimum; each row's costs are
//     loaded two steps ahead. opt[j] goes to the scratch; then the CTA
//     recomputes each step's candidates from opt in parallel (bit for bit
//     the chain's), takes the first k that reaches opt[j] as back[j-1]
//     and the margin to the runner-up; thread 0 walks the back links from
//     n_valid, marking block starts in shared memory, and the CTA writes
//     split. The DP loop's clock64 cycles come back beside the margin.
// A step takes a fifth of the cycles of a step of warp 0 with a candidate
// per lane and a shuffle, a reduction and a ballot on the chain
// (block_stage_probe.py; PERF.md §6).
//
// Domain: counts >= 0 with every segment's totals below 2^24 (exact in
// float32, as the plain version's cumulative sums are while M * 32768 <
// 2^24); 1 <= M <= 32767, 1 <= mm <= 32, 0 <= n_valid <= M.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLitlen = 286;
constexpr int kDist = 30;
constexpr int kSyms = kLitlen + kDist;
constexpr int kPerLane = (kSyms + 31) / 32;
constexpr int kFirstLen = 257;            // first length code
constexpr int kMaxM = 32767;
constexpr int kMaxMerge = 32;
constexpr int kStage = 3840;              // costs staged per DP round
constexpr int kRowBytes = kMaxMerge * kSyms * 4;
constexpr int kDpBytes = kStage * 4 + kMaxM;
constexpr int kSmem = kRowBytes > kDpBytes ? kRowBytes : kDpBytes;
constexpr int kMaxDevices = 64;
constexpr float kBig = 3.4e38f;
constexpr float kTreeFixed = 17.0f + 3 * 15;
constexpr float kTreePerSym = 5.5f;
constexpr unsigned kAll = 0xFFFFFFFFu;
static_assert(kSmem + 8 <= 48 * 1024, "static shared memory");

__constant__ int8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                     1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                     4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                      4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                      9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

__device__ __forceinline__ uint64_t warp_sum(uint64_t x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1)
    x = __dadd_rn(x, __shfl_xor_sync(kAll, x, o));
  return x;
}

// f * (log2(n) - log2(max(f, 1e-9))), the plain version's term
__device__ __forceinline__ float entropy_term(float f, float log2_n) {
  return __fmul_rn(f, __fsub_rn(log2_n, log2f(fmaxf(f, 1e-9f))));
}

// The cost of the segment whose counts the warp holds (lane l: symbols
// l + 32 r); lane 0's result is the one to keep.
__device__ __forceinline__ float segment_cost(const int (&f)[kPerLane],
                                              const int (&eb)[kPerLane],
                                              int lane, int k, float stored) {
  uint64_t n = 0;                           // n_ll << 32 | n_d
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int s = lane + 32 * r;
    if (s < kLitlen) n += static_cast<uint64_t>(f[r]) << 32;
    else if (s < kSyms) n += static_cast<uint64_t>(f[r]);
  }
  n = warp_sum(n);
  const float nll =
      __fadd_rn(static_cast<float>(static_cast<int>(n >> 32)), 1.0f);
  const float nd =
      fmaxf(static_cast<float>(static_cast<int>(n & 0xFFFFFFFFu)), 1.0f);
  const float lg_ll = log2f(nll), lg_d = log2f(nd);
  double h_ll = 0.0, h_d = 0.0;
  uint64_t ea = 0;                          // extra << 32 | active
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int s = lane + 32 * r;
    if (s >= kSyms || f[r] <= 0) continue;
    const float x = static_cast<float>(f[r]);
    ea += 1 + (static_cast<uint64_t>(f[r] * eb[r]) << 32);
    if (s < kLitlen) h_ll = __dadd_rn(h_ll, entropy_term(x, lg_ll));
    else h_d = __dadd_rn(h_d, entropy_term(x, lg_d));
  }
  h_ll = warp_sum(h_ll);
  h_d = warp_sum(h_d);
  ea = warp_sum(ea);
  float c = __fadd_rn(__double2float_rn(h_ll), __double2float_rn(h_d));
  c = __fadd_rn(c, static_cast<float>(static_cast<int>(ea >> 32)));
  c = __fadd_rn(c, kTreeFixed);
  c = __fadd_rn(c, __fmul_rn(kTreePerSym, static_cast<float>(
                                              static_cast<uint32_t>(ea))));
  c = __fadd_rn(c, lg_ll);
  return k == 1 ? fminf(c, stored) : c;
}

// DP steps r0 + 1 .. r0 + nrow over the staged rows (MM costs each, row
// j - 1 - r0 for step j); ring[x % MM] holds opt[x]. r0 is a multiple of
// MM, so every ring index below is a constant. Step j's row is loaded two
// steps ahead into one of two buffers (by the step's parity), and the
// minimum is taken newest last: the candidates k >= 3 wait on opt[j-3]
// and older, k = 2 on opt[j-2], so the chain from opt[j-1] to opt[j] is
// one add and one minimum.
template <int MM>
__device__ __forceinline__ void dp_chain(const float* __restrict__ s_cost,
                                         int r0, int nrow, float (&ring)[MM],
                                         float* __restrict__ opt) {
  static_assert((MM & (MM - 1)) == 0 && MM >= 4, "MM is a power of two");
  constexpr int V = MM / 4;
  const float4* src = reinterpret_cast<const float4*>(s_cost);
  const int jend = r0 + nrow;
  float4 buf[2][V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    buf[0][i] = src[i];
    buf[1][i] = nrow > 1 ? src[V + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int jb = r0; jb < jend; jb += MM) {
#pragma unroll
    for (int u = 0; u < MM; ++u) {
      const int j = jb + 1 + u;
      if (j > jend) break;
      const float4* row = buf[u & 1];
      float c[MM];
#pragma unroll
      for (int k = 3; k <= MM; ++k) {
        const float4 v = row[(k - 1) / 4];
        const float x = (k - 1) % 4 == 0 ? v.x : (k - 1) % 4 == 1 ? v.y
                        : (k - 1) % 4 == 2 ? v.z : v.w;
        c[k - 1] = __fadd_rn(ring[(1 + u - k) & (MM - 1)], x);
      }
      // the minimum of c[2..MM-1], a tree over MM - 2 values
#pragma unroll
      for (int w = 1; w < MM - 2; w <<= 1) {
#pragma unroll
        for (int i = 2; i + w < MM; i += 2 * w) c[i] = fminf(c[i], c[i + w]);
      }
      const float m2 =
          fminf(__fadd_rn(ring[(u - 1) & (MM - 1)], row[0].y), c[2]);
      const float o = fminf(__fadd_rn(ring[u & (MM - 1)], row[0].x), m2);
      if (j + 2 <= jend) {                  // step j + 2's row, in place
#pragma unroll
        for (int i = 0; i < V; ++i) buf[u & 1][i] = src[(j + 1 - r0) * V + i];
      }
      ring[(1 + u) & (MM - 1)] = o;
      opt[j] = o;
    }
  }
}

template <int MM>
__global__ void __launch_bounds__(kThreads)
    block_plan_kernel(const int64_t* __restrict__ ll,
                      const int64_t* __restrict__ dd,
                      const int64_t* __restrict__ tile_bytes, int M, int mm,
                      int n_valid, float* __restrict__ cost,
                      float* __restrict__ opt, float* __restrict__ gap_out,
                      unsigned* __restrict__ dp_cycles,
                      bool* __restrict__ split,
                      int64_t* __restrict__ n_blocks,
                      unsigned* __restrict__ ticket) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ int s_last;
  __shared__ unsigned s_gap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // ---- the segment costs ending at tile j = blockIdx.x + 1
  {
    int* rows = reinterpret_cast<int*>(smem);
    const int j = blockIdx.x + 1;
    const int r_lo = max(j - mm, 0);       // rows r_lo..j-1
    const int n_rows = j - r_lo;
    for (int i = threadIdx.x; i < n_rows * kLitlen; i += kThreads)
      rows[(i / kLitlen) * kSyms + i % kLitlen] =
          static_cast<int>(__ldg(&ll[int64_t{r_lo} * kLitlen + i]));
    for (int i = threadIdx.x; i < n_rows * kDist; i += kThreads)
      rows[(i / kDist) * kSyms + kLitlen + i % kDist] =
          static_cast<int>(__ldg(&dd[int64_t{r_lo} * kDist + i]));
    __syncthreads();
    const int kc = (mm + kWarps - 1) / kWarps;   // segments a warp takes
    const int k_lo = warp * kc + 1;
    const int k_hi = min(k_lo + kc - 1, mm);
    if (k_lo <= k_hi) {
      int f[kPerLane], eb[kPerLane];
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int s = lane + 32 * r;
        f[r] = 0;
        eb[r] = s < kFirstLen ? 0
                : s < kLitlen ? kLenExtra[s - kFirstLen]
                : s < kSyms   ? kDistExtra[s - kLitlen]
                              : 0;
      }
      auto add_row = [&](int t) {
        if (t < 0) return;                  // the segment starts at tile 0
        const int* src = rows + (t - r_lo) * kSyms;
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
          const int s = lane + 32 * r;
          if (s < kSyms) f[r] += src[s];
        }
      };
      for (int k = 1; k < k_lo; ++k) add_row(j - k);
      const float stored = __fadd_rn(
          42.0f, __fmul_rn(8.0f, static_cast<float>(tile_bytes[j - 1])));
      for (int k = k_lo; k <= k_hi; ++k) {
        add_row(j - k);
        const float c = segment_cost(f, eb, lane, k, stored);
        if (lane == 0) cost[int64_t{j - 1} * mm + k - 1] = c;
      }
    }
  }

  // ---- the CTA that finishes last runs the DP
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  float* s_cost = reinterpret_cast<float*>(smem);
  uint8_t* back = smem + kStage * 4;
  if (threadIdx.x == 0) {
    s_gap = __float_as_uint(INFINITY);
    opt[0] = 0.0f;
  }
  const int rows = kStage / MM / MM * MM;   // rows a stage holds
  float ring[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) ring[i] = i == 0 ? 0.0f : kBig;
  long long t0 = 0, t_dp = 0;
  int r_last = 0;
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int nrow = min(rows, M - r0);
    r_last = r0;
    __syncthreads();                        // the last stage is read
    for (int i = threadIdx.x; i < nrow * MM; i += kThreads) {
      const int k = i % MM;
      s_cost[i] = k < mm ? __ldcg(&cost[int64_t{r0 + i / MM} * mm + k])
                         : INFINITY;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      t0 = clock64();
      dp_chain<MM>(s_cost, r0, nrow, ring, opt);
      t_dp += clock64() - t0;
    }
  }
  __syncthreads();                          // opt[] is written

  // each step's candidates again, in parallel: the back link and the
  // margin to the runner-up
  float gap = INFINITY;
  for (int j = threadIdx.x + 1; j <= M; j += kThreads) {
    const bool staged = j - 1 >= r_last;
    float best = INFINITY, second = INFINITY;
    int bk = 1;
    for (int k = 1; k <= mm && k <= j; ++k) {
      const float ck = staged ? s_cost[(j - 1 - r_last) * MM + k - 1]
                              : __ldcg(&cost[int64_t{j - 1} * mm + k - 1]);
      const float c = __fadd_rn(opt[j - k], ck);
      if (c < best) {
        second = best;
        best = c;
        bk = k;
      } else if (c < second) {
        second = c;
      }
    }
    back[j - 1] = static_cast<uint8_t>(bk);
    if (j >= 2 && j <= n_valid) gap = fminf(gap, __fsub_rn(second, best));
  }
  atomicMin(&s_gap, __float_as_uint(gap));
  __syncthreads();
  if (threadIdx.x == 0) {
    *gap_out = __uint_as_float(s_gap);
    *dp_cycles = static_cast<unsigned>(t_dp);
    // the walk marks each block's first tile by a 0 in back[] (a link is
    // 1..mm): it reads back[jcur - 1] below every start marked so far
    int64_t blocks = 0;
    for (int jcur = n_valid; jcur > 0;) {
      const int start = max(jcur - static_cast<int>(back[jcur - 1]), 0);
      back[start] = 0;
      ++blocks;
      jcur = start;
    }
    *n_blocks = blocks;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads)
    split[m] = m == 0 || back[m] == 0;
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `ll` is M x 286, `dd`
// M x 30 and `tile_bytes` M counts, all int64; `scratch` is float32[M * mm
// + M + 3]: the segment costs (M x mm), the smallest margin, the DP loop's
// clock64 cycles (uint32) and opt[0..M] come back in it; `split` is
// bool[M] and `n_blocks` one int64; `ticket` is a uint32 that is 0 when no
// launch on it is running and is left at 0: one per stream. All allocated
// by the caller.
extern "C" int block_plan_launch(const void* ll, const void* dd,
                                 const void* tile_bytes, int M, int mm,
                                 int n_valid, void* scratch,
                                 void* split, void* n_blocks, void* ticket,
                                 int device, void* stream) {
  if (M < 1 || M > kMaxM || mm < 1 || mm > kMaxMerge || n_valid < 0 ||
      n_valid > M || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* c = static_cast<float*>(scratch);
    float* g = c + int64_t{M} * mm;
    auto* cyc = reinterpret_cast<unsigned*>(g + 1);
    const auto* l = static_cast<const int64_t*>(ll);
    const auto* d = static_cast<const int64_t*>(dd);
    const auto* tb = static_cast<const int64_t*>(tile_bytes);
    auto* sp = static_cast<bool*>(split);
    auto* nb = static_cast<int64_t*>(n_blocks);
    auto* tk = static_cast<unsigned*>(ticket);
    const unsigned grid = static_cast<unsigned>(M);  // a CTA per end tile
    if (mm <= 8)
      block_plan_kernel<8><<<grid, kThreads, 0, st>>>(
          l, d, tb, M, mm, n_valid, c, g + 2, g, cyc, sp, nb, tk);
    else
      block_plan_kernel<32><<<grid, kThreads, 0, st>>>(
          l, d, tb, M, mm, n_valid, c, g + 2, g, cyc, sp, nb, tk);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
