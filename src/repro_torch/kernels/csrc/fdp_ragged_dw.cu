// Sorted-segment exact <ovf,msb,lsb> FDP weight gradient (the MoE expert
// backward dW) for Hopper (sm_90a), CUDA C++ with a plain C entry point
// (loaded with ctypes; no PyTorch headers).
//
//   dW[e, i, j] = round_f32( sum_{t in [s_e, s_e + n_e)}  q(X[t, i] * G[t, j]) )
//
// where the rows of X (T, D) and G (T, F) are sorted by group, n_e =
// group_sizes[e] and s_e = n_0 + ... + n_{e-1}; the window is clipped at T,
// so rows past sum(group_sizes) belong to no group and add nothing. A
// zero-size group contracts over nothing: its register stays zero and reads
// out +0.0. It replaces the Pallas body
// repro/kernels/fdp_gemm.py:fdp_ragged_dw_kernel (reached through
// fdp_ragged_dw_pallas), with the same bits.
//
// What bounds it: int32 CUDA-core operations per exact product, as the
// dense kernel (fdp_gemm.cu's note). Here K is a group's rows, a few dozen
// at a training step (1024 rows in 16 groups), while the outputs number
// E*D*F (1.057 G at dbrx's widths): each output's read-out (the register's
// magnitude, 24-bit RNE, the f32 cast and its store) weighs against only
// ~64 products, so it is a real share of the work. The bound counts the
// products and decodes only.
//
// The design is the dense kernel's, through its tile body (fdp::fdp_tile,
// csrc/fdp_tile.cuh): for group e, dW[e] = X_e^T G_e is a dense (D x n_e) @
// (n_e x F) product, A = X + s_e sxt with strides (sxd, sxt), B = G + s_e
// sgt with strides (sgt, sgf), K = n_e. A block decodes its X_e tile (BM x
// BK) and G_e tile (BK x BN) once a chunk into shared memory, each thread
// owns TM x TN outputs in the word register (two shifts a word and one
// add-with-carry chain a product, no carry pending, so a group of any length
// stays exact), and a narrow spec takes a narrow capacity. Loads go along
// the unit-stride dimension: contiguous X along d, G along f, transposed
// views along t. What is its own:
//
// - One group's window a block, found on the device. Grid (ceil(F / BN),
//   ceil(D / BM), E): column tiles fastest and the group slowest, so the
//   blocks in flight belong to one or two groups, whose X_e and G_e (~1.6
//   and ~2.8 MB at dbrx's widths) stay in L2 while every tile reads them.
//   Each block scans the E group sizes (a device int32 array: the host
//   never reads them) for its window. Every (e, i, j) has its block, empty
//   groups included, so no tile table is built as the TPU kernel's
//   _ragged_meta(cover_all_groups=True) builds one.
// - k clipped to the group: a group's rows are rarely a multiple of BK, and
//   the last chunk's k loop stops at the group's last row (fdp_tile's
//   CLIP_K), so no product is formed for k >= n_e (with BK = 32 and 56-75
//   rows a group that would be a quarter more products).
// - The launcher (kernels/fdp_gemm.py, ragged_dw_launch) knows only the
//   shapes: the dense layout for E groups (the batch) of D rows, F columns
//   and ceil(T / E) rows deep.
//
// Offsets are int64 (E*D*F passes 2^31).

#include "fdp_tile.cuh"

namespace {

using fdp::Layout;
using fdp::THREADS;
using fdp::Tile;

// Column tile blockIdx.x, row tile blockIdx.y of dW[e], group e = blockIdx.z.
template <int LC, int TM, bool RNE, bool MASKED>
__global__ void __launch_bounds__(THREADS, Tile<LC>::BLOCKS)
fdp_ragged_dw_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ G,
                     const int32_t* __restrict__ group_sizes, float* __restrict__ O,
                     int T, int D, int F, long long sxt, long long sxd,
                     long long sgt, long long sgf, fdp::Spec spec, fdp::Fmt fmt, Layout lay) {
  const int e = blockIdx.z;
  // This group's row window [start, end), clipped at T.
  long long start = 0;
  for (int g = 0; g < e; ++g) start += group_sizes[g];
  long long end = start + group_sizes[e];
  start = start < T ? start : T;
  end = end < T ? end : T;
  const int m0 = blockIdx.y * (lay.ty * TM), n0 = blockIdx.x * (lay.tx * Tile<LC>::TN);
  fdp::fdp_tile<LC, TM, RNE, MASKED, 0, true>(X + start * sxt, sxd, sxt, m0, D,
                                              G + start * sgt, sgt, sgf, n0, F,
                                              (int)(end - start), O, (long long)e * D, spec,
                                              fmt, lay);
}

template <int LC, int TM, bool RNE, bool MASKED>
struct Launch {
  static cudaError_t run(const uint32_t* x, const uint32_t* g, const int32_t* gs, float* o,
                         int T, int E, int D, int F, long long sxt, long long sxd,
                         long long sgt, long long sgf, fdp::Spec spec, fdp::Fmt fmt,
                         Layout lay, cudaStream_t stream) {
    const long long smem = fdp::tile_smem<LC, TM>(spec, lay);
    const long long BM = (long long)lay.ty * TM, BN = (long long)lay.tx * Tile<LC>::TN;
    const long long gx = (F + BN - 1) / BN, gy = (D + BM - 1) / BM;
    if (smem < 0 || gx > 2147483647LL || gy > 65535 || E > 65535)
      return cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)E);
    fdp_ragged_dw_kernel<LC, TM, RNE, MASKED><<<grid, THREADS, (size_t)smem, stream>>>(
        x, g, gs, o, T, D, F, sxt, sxd, sgt, sgf, spec, fmt, lay);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x: (T, D) and g: (T, F) rows sorted by group, both with element strides;
// group_sizes: (E,) contiguous int32 on the device; o: (E, D, F) contiguous
// f32. lc, tm, tx, ty, ks and bks are a layout of the dense kernel's
// (kernels/fdp_gemm.py:ragged_dw_launch picks it). Launches on `stream`,
// allocates nothing, and returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it refuses (0 = success).
int fdp_ragged_dw_launch(const void* x, const void* g, const void* group_sizes,
                         void* o, int T, int E, int D, int F, long long sxt,
                         long long sxd, long long sgt, long long sgf, int lsb,
                         int width, int num_limbs, int rne, int saturate,
                         int posit, int nbits, int es, int lc, int tm, int tx, int ty,
                         int ks, int bks, void* stream) {
  if (num_limbs < 1 || T < 0 || E < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const fdp::Spec spec{lsb, width, num_limbs, rne, saturate};
  return (int)fdp::dispatch_tile<Launch>(
      lc, tm, spec, static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(g),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(o), T, E, D, F, sxt, sxd,
      sgt, sgf, spec, fdp::Fmt{posit, nbits, es}, Layout{tx, ty, ks, bks},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
