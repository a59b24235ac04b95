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
// What bounds it on this card: the serial DP. The costs are M * mm
// segments of 316 terms (323,584 at M = 128, one log2f each where f > 0);
// the DP is M dependent steps of one warp, each a shared-memory load, an
// add and two warp reductions. The bytes (the histograms, read once) are
// under 0.4 MB at M = 128.
//
// Two launches on one stream:
//   * `block_plan_cost_kernel`: one warp per segment (j, k), 8 a CTA (128
//     CTAs at M = 128, so the log2f work is spread over the card): each
//     lane sums the k tiles' counts of its ten symbols (s = lane + 32 r)
//     and its terms in that order, the lanes' sums meet in a butterfly,
//     and lane 0 writes cost[j-1, k-1] into the device scratch the
//     wrapper allocates;
//   * `block_plan_dp_kernel`: one CTA of 256 threads stages the costs in
//     shared memory, 4,064 at a time, and warp 0 runs the DP with
//     candidate k in lane k - 1: opt[j-1-lane] rides in a register and
//     moves one lane up a step (__shfl_up_sync); the minimum is a warp
//     reduction over the candidates' bits (positive floats order as their
//     bit patterns) and the first lane holding it (a ballot) is
//     torch.argmin's first minimum, its back link stored two steps later
//     (a warp issues in order: what waits on the ballot would stall the
//     next step); each step's opt goes to the scratch, from which the CTA
//     then recomputes the candidates of steps 2..n_valid in parallel for
//     the margin to the runner-up; thread 0 walks the back links from
//     n_valid.
// Both in one CTA of 1,024 threads took 0.137 ms at 128 tiles on an H100
// (one SM's shuffles and log2f; each DP step a load from device memory);
// with the back link and the margin inside each step, a step took 190 ns
// against 166 now.
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
constexpr int kStage = 4064;              // costs staged per DP round:
                                          // with back[], under 48 KB
constexpr int kMaxDevices = 64;
constexpr float kBig = 3.4e38f;
constexpr float kTreeFixed = 17.0f + 3 * 15;
constexpr float kTreePerSym = 5.5f;
constexpr unsigned kAll = 0xFFFFFFFFu;

__constant__ int8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                     1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                     4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                      4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                      9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

__device__ __forceinline__ int64_t warp_sum(int64_t x) {
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

// cost[j-1, k-1]: the segment of tiles [max(j-k, 0), j), by one warp.
__global__ void __launch_bounds__(kThreads)
    block_plan_cost_kernel(const int64_t* __restrict__ ll,
                           const int64_t* __restrict__ dd,
                           const int64_t* __restrict__ tile_bytes, int M,
                           int mm, float* __restrict__ cost) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = int64_t{blockIdx.x} * kWarps + (threadIdx.x >> 5);
  if (seg >= int64_t{M} * mm) return;       // whole warps leave together
  const int j = static_cast<int>(seg / mm) + 1;
  const int k = static_cast<int>(seg % mm) + 1;
  const int t0 = j - k > 0 ? j - k : 0;
  int64_t f[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int s = lane + 32 * r;
    int64_t sum = 0;
    for (int t = t0; t < j; ++t) {
      if (s < kLitlen)
        sum += __ldg(&ll[int64_t{t} * kLitlen + s]);
      else if (s < kSyms)
        sum += __ldg(&dd[int64_t{t} * kDist + s - kLitlen]);
    }
    f[r] = sum;
  }
  int64_t n_ll = 0, n_d = 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int s = lane + 32 * r;
    if (s < kLitlen) n_ll += f[r];
    else if (s < kSyms) n_d += f[r];
  }
  n_ll = warp_sum(n_ll);
  n_d = warp_sum(n_d);
  const float nll = __fadd_rn(static_cast<float>(n_ll), 1.0f);
  const float nd = fmaxf(static_cast<float>(n_d), 1.0f);
  const float lg_ll = log2f(nll), lg_d = log2f(nd);
  double h_ll = 0.0, h_d = 0.0;
  int64_t extra = 0;
  int active = 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int s = lane + 32 * r;
    if (s >= kSyms || f[r] <= 0) continue;
    const float x = static_cast<float>(f[r]);
    ++active;
    if (s < kLitlen) {
      h_ll = __dadd_rn(h_ll, entropy_term(x, lg_ll));
      if (s >= kFirstLen) extra += f[r] * kLenExtra[s - kFirstLen];
    } else {
      h_d = __dadd_rn(h_d, entropy_term(x, lg_d));
      extra += f[r] * kDistExtra[s - kLitlen];
    }
  }
  h_ll = warp_sum(h_ll);
  h_d = warp_sum(h_d);
  extra = warp_sum(extra);
  active = static_cast<int>(warp_sum(static_cast<int64_t>(active)));
  if (lane == 0) {
    float c = __fadd_rn(__double2float_rn(h_ll), __double2float_rn(h_d));
    c = __fadd_rn(c, static_cast<float>(extra));
    c = __fadd_rn(c, kTreeFixed);
    c = __fadd_rn(c, __fmul_rn(kTreePerSym, static_cast<float>(active)));
    c = __fadd_rn(c, lg_ll);
    if (k == 1) {
      const float stored = __fadd_rn(
          42.0f, __fmul_rn(8.0f, static_cast<float>(tile_bytes[j - 1])));
      c = fminf(c, stored);
    }
    cost[seg] = c;
  }
}

// The DP over the costs, the margins, the back links and the backtrack;
// one CTA.
__global__ void __launch_bounds__(kThreads)
    block_plan_dp_kernel(const float* __restrict__ cost, int M, int mm,
                         int n_valid, float* __restrict__ opt,
                         float* __restrict__ gap_out,
                         bool* __restrict__ split,
                         int64_t* __restrict__ n_blocks) {
  __shared__ float s_cost[kStage];
  __shared__ uint8_t back[kMaxM];
  __shared__ unsigned s_gap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m = threadIdx.x; m < M; m += kThreads) split[m] = false;
  if (threadIdx.x == 0) {
    s_gap = __float_as_uint(INFINITY);
    opt[0] = 0.0f;
  }
  const int rows = kStage / mm;               // cost rows a stage holds
  float tail = lane == 0 ? 0.0f : kBig;       // opt[j-1-lane], warp 0
  unsigned m1 = 0, m2 = 0;                    // the last two steps' ballots
  for (int r0 = 0; r0 < M; r0 += rows) {
    const int nrow = M - r0 < rows ? M - r0 : rows;
    __syncthreads();                          // the last stage is read
    for (int i = threadIdx.x; i < nrow * mm; i += kThreads)
      s_cost[i] = cost[int64_t{r0} * mm + i];
    __syncthreads();
    if (warp != 0) continue;
    // Each step's chain is the add, the reduction and the shuffle; what
    // waits on the ballot (the back link) is stored two steps later, so
    // the warp, which issues in order, does not stall on it.
    for (int j = r0 + 1; j <= r0 + nrow; ++j) {
      const float up = __shfl_up_sync(kAll, tail, 1);
      const bool valid = lane < mm && j - 1 - lane >= 0;
      const float c = lane < mm ? s_cost[(j - 1 - r0) * mm + lane] : 0.0f;
      const unsigned bits =
          __float_as_uint(valid ? __fadd_rn(tail, c) : kBig);
      const unsigned lo = __reduce_min_sync(kAll, bits);
      if (lane == 0 && j > 2) back[j - 3] = static_cast<uint8_t>(__ffs(m2));
      m2 = m1;
      m1 = __ballot_sync(kAll, bits == lo);
      const float opt_j = __uint_as_float(lo);
      if (lane == 0) opt[j] = opt_j;
      tail = lane == 0 ? opt_j : up;
    }
  }
  if (threadIdx.x == 0) {
    if (M >= 2) back[M - 2] = static_cast<uint8_t>(__ffs(m2));
    back[M - 1] = static_cast<uint8_t>(__ffs(m1));
  }
  __syncthreads();

  // the margin of each step 2..n_valid, its candidates recomputed from opt
  float gap = INFINITY;
  for (int j = threadIdx.x + 2; j <= n_valid; j += kThreads) {
    float best = INFINITY, second = INFINITY;
    for (int k = 1; k <= mm && k <= j; ++k) {
      const float c =
          __fadd_rn(opt[j - k], cost[int64_t{j - 1} * mm + k - 1]);
      if (c < best) {
        second = best;
        best = c;
      } else if (c < second) {
        second = c;
      }
    }
    gap = fminf(gap, __fsub_rn(second, best));
  }
  atomicMin(&s_gap, __float_as_uint(gap));
  __syncthreads();
  if (threadIdx.x == 0) {
    *gap_out = __uint_as_float(s_gap);
    split[0] = true;
    int64_t blocks = 0;
    for (int jcur = n_valid; jcur > 0;) {
      const int start = max(jcur - static_cast<int>(back[jcur - 1]), 0);
      split[start] = true;
      ++blocks;
      jcur = start;
    }
    *n_blocks = blocks;
  }
}

}  // namespace

// Launches on `stream` of `device` (made current for the call only if it
// is not) and returns the CUDA error (0 on success). `ll` is M x 286, `dd`
// M x 30 and `tile_bytes` M counts, all int64; `scratch` is float32[M * mm + M + 2]: the segment costs (M x mm),
// the smallest margin and opt[0..M] come back in it; `split` is bool[M]
// and `n_blocks` one int64, all allocated by the caller.
extern "C" int block_plan_launch(const void* ll, const void* dd,
                                 const void* tile_bytes, int M, int mm,
                                 int n_valid, void* scratch,
                                 void* split, void* n_blocks, int device,
                                 void* stream) {
  if (M < 1 || M > kMaxM || mm < 1 || mm > kMaxMerge || n_valid < 0 ||
      n_valid > M || device < 0 ||
      device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* c = static_cast<float*>(scratch);
    float* g = c + int64_t{M} * mm;
    auto* sp = static_cast<bool*>(split);
    auto* nb = static_cast<int64_t*>(n_blocks);
    const unsigned grid = static_cast<unsigned>(
        (int64_t{M} * mm + kWarps - 1) / kWarps);
    block_plan_cost_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int64_t*>(ll), static_cast<const int64_t*>(dd),
        static_cast<const int64_t*>(tile_bytes), M, mm, c);
    e = cudaGetLastError();
    if (e == cudaSuccess) {
      block_plan_dp_kernel<<<1, kThreads, 0, st>>>(c, M, mm, n_valid, g + 1,
                                                   g, sp, nb);
      e = cudaGetLastError();
    }
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return static_cast<int>(e);
}
