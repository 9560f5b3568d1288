// Sorted-segment exact <ovf,msb,lsb> FDP GEMM (the MoE expert forward) for
// Hopper (sm_90a), CUDA C++ with a plain C entry point (loaded with ctypes;
// no PyTorch headers).
//
//   O[t, n] = round_f32( sum_k  q(X[t, k] * W[g(t), k, n]) )   t <  sum(gs)
//   O[t, n] = 0.0                                              t >= sum(gs)
//
// where the rows of X are sorted by group and g(t) is the group whose
// prefix-sum window [gs[0] + ... + gs[g-1], ... + gs[g]) holds t; windows
// are clipped at T. It replaces the Pallas body
// repro/kernels/fdp_gemm.py:fdp_ragged_kernel (reached through
// fdp_ragged_gemm_pallas), with the same bits.
//
// What bounds it: int32 CUDA-core operations per exact product, as the
// dense kernel (fdp_gemm.cu's note). With few rows a group (a decode step
// routes 16 rows into ~14 groups) every weight element serves one or two
// products, so decoding the weights costs about as much as the products,
// and the weight stream (one expert's d x f f32 is 264 MB at dbrx's
// widths) is the next limit.
//
// The design is the dense kernel's, through its tile body (fdp::fdp_tile,
// csrc/fdp_tile.cuh): a block decodes its X tile (BM x BK) and W[g] tile
// (BK x BN) once a chunk into shared memory, each thread owns TM x TN
// outputs in the word register (two shifts a word and one add-with-carry
// chain a product, no carry pending), K may be split over thread groups
// summed exactly in a tree, and a narrow spec takes a narrow capacity.
// What is its own:
//
// - Group-aligned row tiles found on the device. Row tile i of segment e
//   holds rows [s_e + i BM, min(s_e + (i+1) BM, s_e + n_e)) of one group,
//   so one decoded W[e] tile serves all of them, no product is formed for
//   another group's row and no two blocks write one row. Segment E is the
//   rows past sum(gs), up to T: its blocks write 0.0. A block finds its
//   segment and tile by scanning the E group sizes (a device int32 array,
//   so the host never reads them and routing adds no host sync). E + 1
//   segments of T rows need at most ceil(T / BM) + E tiles, the grid's row
//   axis; blocks past the real tiles return.
// - Row tiles are the fastest grid axis (blockIdx.x), so the blocks in
//   flight are the row tiles of every group against one column tile, and
//   a group's row tiles share its weight tile through L2.
// - The launcher (kernels/fdp_gemm.py, ragged_launch) knows only T and E,
//   not the routing: it picks the dense layout for E groups of ceil(T / E)
//   rows. At a decode step (T = E) that is one-row tiles with K split over
//   the block; at a training step (1024 rows, 16 groups) 4 x 2 outputs a
//   thread and 32-row tiles. A group's last partial tile masks the rows
//   it lacks (they decode to zero).
// - The weight stream's latency. Loading and decoding one element after
//   another, as the dense kernel does, left a decode step waiting on
//   memory, no faster than the one-thread-an-output kernel before it. A
//   one-row block therefore streams its weights through registers, 8
//   elements a column in flight into the next chunk, and skips shared
//   memory for them: each serves one thread (fdp::row_chunks). Larger tiles (a training step's) load as the
//   dense kernel does: each X and W[g] element once a block, into shared
//   memory.
//
// Offsets are int64 (W[g] starts g*d*f elements in, past 2^31 bytes at
// dbrx's widths). The dX call of the backward passes w.transpose(-1, -2),
// a view: tiles load along its unit-stride dimension, so it reads coalesced.

#include "fdp_tile.cuh"

namespace {

using fdp::Layout;
using fdp::THREADS;
using fdp::Tile;

// Row tile blockIdx.x (of every segment, in order), column tile blockIdx.y.
template <int LC, int TM, bool RNE, bool MASKED>
__global__ void __launch_bounds__(THREADS, Tile<LC>::BLOCKS)
fdp_ragged_gemm_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ W,
                       const int32_t* __restrict__ group_sizes, float* __restrict__ O,
                       int T, int E, int D, int F, long long sxt, long long sxk,
                       long long swe, long long swk, long long swn,
                       fdp::Spec spec, fdp::Fmt fmt, Layout lay) {
  const int BM = lay.ty * TM, BN = lay.tx * Tile<LC>::TN;
  const int n0 = blockIdx.y * BN;

  // This block's segment g (E: the rows past the total) and its rows
  // [row0, row1); the same for every thread, so a return is the block's.
  long long tile = blockIdx.x, end = 0, row0 = 0, row1 = -1;
  int g = 0;
  for (; g <= E; ++g) {
    const long long lo = end < T ? end : T;
    if (g < E) end += group_sizes[g];
    const long long hi = g == E ? T : end < T ? end : T;
    const long long tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    if (tile < tiles) {
      row0 = lo + tile * BM;
      row1 = row0 + BM < hi ? row0 + BM : hi;
      break;
    }
    tile -= tiles;
  }
  if (row1 < 0) return;                               // past the real tiles
  if (g == E) {                                       // rows past the total
    for (int e = threadIdx.x; e < (row1 - row0) * BN; e += THREADS) {
      const int n = n0 + e % BN;
      if (n < F) O[(row0 + e / BN) * F + n] = 0.0f;
    }
    return;
  }
  // one-row blocks (a decode step's) stream their weights through registers
  fdp::fdp_tile<LC, TM, RNE, MASKED, TM == 1 ? 8 : 0>(
      X, sxt, sxk, (int)row0, (int)row1, W + (long long)g * swe, swk, swn, n0, F, D, O, 0, spec,
      fmt, lay);
}

template <int LC, int TM, bool RNE, bool MASKED>
struct Launch {
  static cudaError_t run(const uint32_t* x, const uint32_t* w, const int32_t* gs, float* o,
                         int T, int E, int D, int F, long long sxt, long long sxk,
                         long long swe, long long swk, long long swn, fdp::Spec spec,
                         fdp::Fmt fmt, Layout lay, cudaStream_t stream) {
    const long long smem = fdp::tile_smem<LC, TM>(spec, lay);
    const long long BM = (long long)lay.ty * TM, BN = (long long)lay.tx * Tile<LC>::TN;
    const long long gx = (T + BM - 1) / BM + E, gy = (F + BN - 1) / BN;
    if (smem < 0 || gx > 2147483647LL || gy > 65535) return cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy);
    fdp_ragged_gemm_kernel<LC, TM, RNE, MASKED><<<grid, THREADS, (size_t)smem, stream>>>(
        x, w, gs, o, T, E, D, F, sxt, sxk, swe, swk, swn, spec, fmt, lay);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x: (T, D) rows sorted by group, w: (E, D, F), both with element strides;
// group_sizes: (E,) contiguous int32 on the device (non-negative); o: (T,
// F) contiguous f32. lc, tm, tx, ty, ks and bks are a layout of the dense
// kernel's (kernels/fdp_gemm.py:ragged_launch picks it). Launches on
// `stream`, allocates nothing, and returns the launch's cudaGetLastError(),
// or cudaErrorInvalidValue for arguments it refuses (0 = success).
int fdp_ragged_gemm_launch(const void* x, const void* w, const void* group_sizes,
                           void* o, int T, int E, int D, int F, long long sxt,
                           long long sxk, long long swe, long long swk,
                           long long swn, int lsb, int width, int num_limbs,
                           int rne, int saturate, int posit, int nbits, int es, int lc,
                           int tm, int tx, int ty, int ks, int bks, void* stream) {
  if (num_limbs < 1 || T < 1 || E < 0 || D < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const fdp::Spec spec{lsb, width, num_limbs, rne, saturate};
  return (int)fdp::dispatch_tile<Launch>(
      lc, tm, spec, static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(o), T, E, D, F, sxt, sxk,
      swe, swk, swn, spec, fdp::Fmt{posit, nbits, es}, Layout{tx, ty, ks, bks},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
