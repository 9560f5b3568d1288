// Sorted-segment exact <ovf,msb,lsb> FDP GEMM (the MoE expert forward) for
// Hopper (sm_90a), CUDA C++ with a plain C entry point (loaded with ctypes;
// no PyTorch headers).
//
//   O[t, n] = round_f32( sum_k  q(X[t, k] * W[g(t), k, n]) )   t <  sum(gs)
//   O[t, n] = 0.0                                              t >= sum(gs)
//
// where the rows of X are sorted by group and g(t) is the group whose
// prefix-sum window [gs[0] + ... + gs[g-1], ... + gs[g]) holds t. It
// replaces the Pallas body repro/kernels/fdp_gemm.py:fdp_ragged_kernel
// (reached through fdp_ragged_gemm_pallas), with the same bits: the device
// math is fdp_common.cuh's, shared with the dense kernel fdp_gemm.cu.
//
// The TPU kernel walks a (6, NT) tile table built by _ragged_meta, because
// a Pallas BlockSpec index map needs a prefetched table to route a block
// to its expert. A CUDA block finds its row's group itself: it scans the E
// group sizes (a device int32 array, so the host never reads them and
// routing adds no host sync) and contracts X[t] against W[g] through
// strides, 64-bit offsets throughout (W[g] starts g*d*f elements in, past
// 2^31 bytes at dbrx's widths). Rows past sum(gs) write 0.0, as the TPU
// kernel's masked windows and the reference's jnp.where do. The work is
// O(T*d*f) products, as the TPU kernel's.
//
// Grid (T, ceil(f / TILE_N)), blockDim (TILE_N, K_SLICES): rows are the
// fastest grid axis, so the blocks in flight are the rows of one expert
// against the same 32 weight columns, and a weight tile read from device
// memory is served from L2 to the expert's other rows. Each thread column
// owns one output and K is split over K_SLICES threads whose registers are
// summed exactly in shared memory (fdp::contract_column), which keeps the
// card busy at decode, where T is 16.
//
// Bound: int32 CUDA-core operations per exact product, as the dense kernel.
// This simple design decodes both operands of every product and shares no
// decoded operand tile across the rows of one expert; doing so is later work.

#include "fdp_common.cuh"

namespace {

using fdp::K_SLICES;
using fdp::TILE_N;

template <int LC>
__global__ void __launch_bounds__(TILE_N * K_SLICES)
fdp_ragged_gemm_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ W,
                       const int32_t* __restrict__ group_sizes, float* __restrict__ O,
                       int E, int D, int F, long long sxt, long long sxk,
                       long long swe, long long swk, long long swn,
                       fdp::Spec spec, fdp::Fmt fmt) {
  __shared__ uint32_t red[K_SLICES][LC][TILE_N];
  const long long t = blockIdx.x;
  const int n = blockIdx.y * TILE_N + threadIdx.x;
  float* out = O + t * F + n;

  // g = the first group whose prefix-sum end exceeds t; E when none does.
  // The same for every thread of the block, so the early return below is
  // taken by the whole block or by none of it.
  int g = E;
  long long end = 0;
  for (int e = 0; e < E; ++e) {
    end += group_sizes[e];
    if (t < end) {
      g = e;
      break;
    }
  }
  if (g == E) {
    if (threadIdx.y == 0 && n < F) *out = 0.0f;
    return;
  }
  const bool active = n < F;
  const uint32_t* x_row = X + t * sxt;
  const uint32_t* w_col = W + (long long)g * swe + (active ? (long long)n * swn : 0);
  fdp::contract_column<LC>(red, x_row, sxk, w_col, swk, D, active, spec, fmt, out);
}

template <int LC>
struct Launch {
  static cudaError_t run(const uint32_t* x, const uint32_t* w, const int32_t* gs,
                         float* o, int T, int E, int D, int F, long long sxt,
                         long long sxk, long long swe, long long swk,
                         long long swn, fdp::Spec spec, fdp::Fmt fmt,
                         cudaStream_t stream) {
    dim3 grid(T, (F + TILE_N - 1) / TILE_N);
    dim3 block(TILE_N, K_SLICES);
    fdp_ragged_gemm_kernel<LC><<<grid, block, 0, stream>>>(
        x, w, gs, o, E, D, F, sxt, sxk, swe, swk, swn, spec, fmt);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// x: (T, D) rows sorted by group, w: (E, D, F), both with element strides;
// group_sizes: (E,) contiguous int32 on the device; o: (T, F) contiguous
// f32. Launches on `stream`, allocates nothing, and returns the launch's
// cudaGetLastError() (0 = success).
int fdp_ragged_gemm_launch(const void* x, const void* w, const void* group_sizes,
                           void* o, int T, int E, int D, int F, long long sxt,
                           long long sxk, long long swe, long long swk,
                           long long swn, int lsb, int width, int num_limbs,
                           int rne, int saturate, int posit, int nbits, int es,
                           void* stream) {
  return (int)fdp::dispatch_limbs<Launch>(
      num_limbs, static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(o), T, E, D, F,
      sxt, sxk, swe, swk, swn, fdp::Spec{lsb, width, num_limbs, rne, saturate},
      fdp::Fmt{posit, nbits, es}, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
