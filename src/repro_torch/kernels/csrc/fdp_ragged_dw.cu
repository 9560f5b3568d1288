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
// fdp_ragged_dw_pallas), with the same bits: the device math (decode,
// product entry, carry normalization, read-out) is fdp_common.cuh's, shared
// with fdp_gemm.cu and fdp_ragged_gemm.cu.
//
// The TPU kernel walks a (6, NT) tile table from
// _ragged_meta(cover_all_groups=True), because a BlockSpec index map routes
// token blocks to their group's output block and must visit every group's
// block, empty ones included. Here every output element has its own
// thread, which finds its group's row window from the E group sizes on the
// device (a scan over E, as fdp_ragged_gemm.cu; the host never reads them),
// so every (e, i, j) is visited by construction and no table is built.
//
// Grid (ceil(F / TILE_N), ceil(D / ROWS), E), blockDim (TILE_N, ROWS): a
// warp walks 32 consecutive columns j of one row i, so G's rows are read
// coalesced and X's element is the same for the whole warp (a broadcast).
// grid.x holds the column tiles (336 at F = 10752), grid.y the row tiles
// (1344 at D = 10752) and grid.z the experts, all inside CUDA's limits.
// Unlike the forward kernels, K is not split over threads: K is the
// group's row count, a few dozen at a training step's widths, while the
// outputs number E*D*F (1.057 G at dbrx's), so one thread per output keeps
// the card full and reads each output out once with no shared-memory
// reduction. Carries normalize every SAFE_CHUNK products, so a group of any
// length stays exact. Offsets are 64-bit (E*D*F passes 2^31).
//
// Bound: int32 CUDA-core operations per exact product, as the other
// kernels; with few rows per group the read-out of each of the E*D*F
// outputs (two's-complement magnitude, 24-bit RNE, the f32 cast) is a real
// share of the work as well. This simple design decodes both operands of
// every product and shares no decoded tile between the threads that read
// the same X or G element; doing so is later work.

#include "fdp_common.cuh"

namespace {

using fdp::TILE_N;
constexpr int ROWS = 8;   // rows i of dW[e] per block

template <int LC>
__global__ void __launch_bounds__(TILE_N * ROWS)
fdp_ragged_dw_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ G,
                     const int32_t* __restrict__ group_sizes, float* __restrict__ O,
                     int T, int D, int F, long long sxt, long long sxd,
                     long long sgt, long long sgf, fdp::Spec spec, fdp::Fmt fmt) {
  const int j = blockIdx.x * TILE_N + threadIdx.x;
  const int i = blockIdx.y * ROWS + threadIdx.y;
  const int e = blockIdx.z;
  if (i >= D || j >= F) return;

  // This group's row window [start, end), clipped at T.
  long long start = 0;
  for (int g = 0; g < e; ++g) start += group_sizes[g];
  long long end = start + group_sizes[e];
  start = start < T ? start : T;
  end = end < T ? end : T;

  const int L = spec.num_limbs;
  uint32_t limb[LC];
#pragma unroll
  for (int l = 0; l < LC; ++l) limb[l] = 0u;

  const uint32_t* x = X + start * sxt + (long long)i * sxd;
  const uint32_t* g = G + start * sgt + (long long)j * sgf;
  int since = 0;
  for (long long t = start; t < end; ++t) {
    uint32_t sa, ma, sb, mb;
    int ea, eb;
    fdp::decode(*x, fmt, sa, ma, ea);
    fdp::decode(*g, fmt, sb, mb, eb);
    fdp::add_product(limb, L, sa, ma, ea, sb, mb, eb, spec.lsb, spec.rne);
    if (++since == fdp::SAFE_CHUNK) {
      fdp::carry_normalize(limb, L);
      since = 0;
    }
    x += sxt;
    g += sgt;
  }
  fdp::carry_normalize(limb, L);
  O[((long long)e * D + i) * F + j] = fdp::to_float(limb, spec);
}

template <int LC>
struct Launch {
  static cudaError_t run(const uint32_t* x, const uint32_t* g, const int32_t* gs,
                         float* o, int T, int E, int D, int F, long long sxt,
                         long long sxd, long long sgt, long long sgf,
                         fdp::Spec spec, fdp::Fmt fmt, cudaStream_t stream) {
    dim3 grid((F + TILE_N - 1) / TILE_N, (D + ROWS - 1) / ROWS, E);
    dim3 block(TILE_N, ROWS);
    fdp_ragged_dw_kernel<LC><<<grid, block, 0, stream>>>(
        x, g, gs, o, T, D, F, sxt, sxd, sgt, sgf, spec, fmt);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x: (T, D) and g: (T, F) rows sorted by group, both with element strides;
// group_sizes: (E,) contiguous int32 on the device; o: (E, D, F) contiguous
// f32. Launches on `stream`, allocates nothing, and returns the launch's
// cudaGetLastError() (0 = success).
int fdp_ragged_dw_launch(const void* x, const void* g, const void* group_sizes,
                         void* o, int T, int E, int D, int F, long long sxt,
                         long long sxd, long long sgt, long long sgf, int lsb,
                         int width, int num_limbs, int rne, int saturate,
                         int posit, int nbits, int es, void* stream) {
  return (int)fdp::dispatch_limbs<Launch>(
      num_limbs, static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(g),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(o), T, E, D, F,
      sxt, sxd, sgt, sgf, fdp::Spec{lsb, width, num_limbs, rne, saturate},
      fdp::Fmt{posit, nbits, es}, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
