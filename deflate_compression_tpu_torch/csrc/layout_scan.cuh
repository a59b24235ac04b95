// The shard encoder's block layout as a log-depth CTA scan, for Hopper
// (sm_90a): csrc/block_layout.cu's launch. On the encoder's path
// csrc/pack_words.cu carries the same maps (`Map`, `apply`) through its
// decoupled look-back, a unit of positions at a time.
//
// Block b, laid out from bit offset p, takes rest[b] bits and, if
// stored[b], the pad (8 - (p + 3) % 8) % 8 = (5 - p) mod 8 that puts its
// LEN on a byte edge. So block b is a map from p mod 8 to an increment,
// the 8-entry table D_b(r) = rest[b] + stored[b] * ((5 - r) mod 8). A run
// of blocks composes to a table of the same form,
//   D(r) = C + s * ((k - r) mod 8),
// because after a run's first stored block the residue no longer depends
// on r. So an element of the scan is (C int64, s, k), and "f, then g" is
//   s_g = 0:            (C_f + C_g,                          s_f, k_f)
//   s_g = 1, s_f = 0:   (C_f + C_g,                          1, (k_g - C_f) mod 8)
//   s_g = 1, s_f = 1:   (C_f + C_g + (k_g - C_f - k_f) mod 8, 1, k_f)
// which is associative, with (0, 0, 0) its identity. A block's base is
// its exclusive prefix's D evaluated at r = 0 (at the chunk's start p, for
// later chunks), and its pad (5 - base) mod 8 where it is stored.
//
// The CTA takes blockDim.x blocks a chunk, one a thread: an inclusive
// warp scan (one shuffle level per doubling: the int64 C and s, k packed
// in one int), the warps' totals scanned by warp 0 over as many levels as
// the chunk has warps, then each thread's exclusive prefix composed and
// evaluated. A chunk of n <= blockDim.x blocks is ceil(log2(n)) dependent
// levels; chunks follow in turn, the running p carried.
#pragma once

#include <stdint.h>

namespace layout {

constexpr unsigned kAll = 0xFFFFFFFFu;

struct Map {
  int64_t c;   // C
  int sk;      // s << 3 | k
};

// f, then g
__device__ __forceinline__ Map compose(Map f, Map g) {
  if (!(g.sk & 8)) return {f.c + g.c, f.sk};
  if (!(f.sk & 8))
    return {f.c + g.c, 8 | static_cast<int>((g.sk - f.c) & 7)};
  return {f.c + g.c + ((g.sk - f.c - f.sk) & 7), f.sk};
}

// D(p mod 8): the bits a run of blocks takes when it starts at p
__device__ __forceinline__ int64_t apply(Map m, int64_t p) {
  return m.c + ((m.sk & 8) ? ((m.sk - p) & 7) : 0);
}

__device__ __forceinline__ Map shfl_up(Map m, int o) {
  return {__shfl_up_sync(kAll, static_cast<long long>(m.c), o),
          __shfl_up_sync(kAll, m.sk, o)};
}

struct Shared {
  int64_t c[32];
  int sk[32];
  int64_t p;     // the running offset after the chunk
};

// Lays out blocks [0, nb) with every thread of the CTA (blockDim.x a
// multiple of 32). in(b, rest, stored) reads block b; out(b, base, pad)
// takes its offset and pad, once per block. Returns p_end, the end of the
// last block, to every thread. Ends with a __syncthreads().
template <class In, class Out>
__device__ int64_t scan(int64_t nb, In in, Out out, Shared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t p = 0;
  for (int64_t c0 = 0; c0 < nb; c0 += blockDim.x) {
    const int64_t b = c0 + threadIdx.x;
    const int64_t left = nb - c0;
    const int nwarps = static_cast<int>(
        left >= blockDim.x ? blockDim.x >> 5 : (left + 31) >> 5);
    Map m = {0, 0};
    bool stored = false;
    if (b < nb) {
      int64_t rest = 0;
      in(b, rest, stored);
      m = {rest, stored ? 8 | 5 : 0};
    }
    Map incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Map u = shfl_up(incl, o);
      if (lane >= o) incl = compose(u, incl);
    }
    if (lane == 31) {
      sh.c[warp] = incl.c;
      sh.sk[warp] = incl.sk;
    }
    __syncthreads();
    if (warp == 0) {
      Map w = lane < nwarps ? Map{sh.c[lane], sh.sk[lane]} : Map{0, 0};
      for (int o = 1; o < nwarps; o <<= 1) {
        const Map u = shfl_up(w, o);
        if (lane >= o) w = compose(u, w);
      }
      Map e = shfl_up(w, 1);
      if (lane == 0) e = {0, 0};
      if (lane < nwarps) {
        sh.c[lane] = e.c;
        sh.sk[lane] = e.sk;
      }
      if (lane == nwarps - 1) sh.p = p + apply(w, p);
    }
    Map ex = shfl_up(incl, 1);
    if (lane == 0) ex = {0, 0};
    __syncthreads();
    if (b < nb) {
      const Map pre = compose(Map{sh.c[warp], sh.sk[warp]}, ex);
      const int64_t base = p + apply(pre, p);
      out(b, base, stored ? static_cast<int>((5 - base) & 7) : 0);
    }
    p = sh.p;
    __syncthreads();                    // sh is read before the next chunk
  }
  return p;
}

}  // namespace layout
