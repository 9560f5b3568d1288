// Exact <ovf,msb,lsb> FDP GEMM for Hopper (sm_90a), CUDA C++ with a plain C
// entry point (loaded with ctypes; no PyTorch headers).
//
//   C[b, m, n] = round_f32( sum_k  q(A[b, m, k] * B[b, k, n]) )
//
// q() quantizes each exact product onto the 2^lsb grid (trunc toward zero,
// or RNE), the sum is exact in a register of int32 limbs (16-bit digits with
// carry headroom), the register wraps or saturates at W bits, and the result
// is rounded once (RNE at 24 bits). Bit-identical to repro.core.fdp.fdp_gemm
// for every format, round mode and overflow mode; it replaces the Pallas
// body repro/kernels/fdp_gemm.py:fdp_gemm_kernel (reached through
// fdp_gemm_pallas and fdp_gemm_pallas_batched). The device math is in
// fdp_common.cuh, shared with the sorted-segment kernel fdp_ragged_gemm.cu.
//
// Grid: one thread column per output element, blockDim (32, K_SLICES).
// threadIdx.x walks 32 consecutive n (coalesced reads of B's rows; A's
// element is the same for the whole warp and is broadcast), threadIdx.y
// takes one contiguous slice of K. blockIdx = (n tile, m, b). Each thread
// keeps its limbs in registers (the limb count is a template parameter and
// every limb index is a compile-time constant, so nothing spills to local
// memory), normalizes carries every SAFE_CHUNK = 2^13 products (the carry
// headroom of a 16-bit digit in an int32 limb, as core.accumulator's
// SAFE_CHUNK), and the K_SLICES partial registers of one output are summed
// in shared memory.
// Integer limb addition is exact and order-free, so the split over K does
// not change the bits. Splitting K is what keeps the card busy at decode,
// where M = 1: B*N threads alone (e.g. 4*2048 for attn_q) would fill half
// of the 132 SMs with one warp each.
//
// Bound: int32 CUDA-core operations per exact product (align, split into
// four 16-bit pieces, add them into four limbs), not memory and not the
// tensor cores, which have no exact wide-integer accumulate. This simple
// design spends more than the function needs: every thread decodes both
// operands of every product (the function needs one decode per operand
// element), and placement is compare-and-select over all LC limbs (a
// product reaches four). Sharing decoded operand tiles through shared
// memory is later work.

#include "fdp_common.cuh"

namespace {

using fdp::K_SLICES;
using fdp::TILE_N;

template <int LC>
__global__ void __launch_bounds__(TILE_N * K_SLICES)
fdp_gemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                float* __restrict__ C, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn,
                fdp::Spec spec, fdp::Fmt fmt) {
  __shared__ uint32_t red[K_SLICES][LC][TILE_N];
  const int n = blockIdx.x * TILE_N + threadIdx.x;
  const int m = blockIdx.y;
  const long long b = blockIdx.z;
  const bool active = n < N;
  const uint32_t* a_row = A + b * sab + (long long)m * sam;
  const uint32_t* b_col = B + b * sbb + (active ? (long long)n * sbn : 0);
  fdp::contract_column<LC>(red, a_row, sak, b_col, sbk, K, active, spec, fmt,
                           C + (b * M + m) * (long long)N + n);
}

template <int LC>
struct Launch {
  static cudaError_t run(const uint32_t* a, const uint32_t* b, float* c, int Bn,
                         int M, int N, int K, long long sab, long long sam,
                         long long sak, long long sbb, long long sbk,
                         long long sbn, fdp::Spec spec, fdp::Fmt fmt,
                         cudaStream_t stream) {
    dim3 grid((N + TILE_N - 1) / TILE_N, M, Bn);
    dim3 block(TILE_N, K_SLICES);
    fdp_gemm_kernel<LC><<<grid, block, 0, stream>>>(a, b, c, M, N, K, sab, sam,
                                                    sak, sbb, sbk, sbn, spec, fmt);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// a: (B, M, K), b: (B, K, N) with element strides (0 broadcasts); c: (B, M, N)
// contiguous f32. Launches on `stream`, allocates nothing, and returns the
// launch's cudaGetLastError() (0 = success).
int fdp_gemm_launch(const void* a, const void* b, void* c, int Bn, int M, int N,
                    int K, long long sab, long long sam, long long sak,
                    long long sbb, long long sbk, long long sbn, int lsb,
                    int width, int num_limbs, int rne, int saturate, int posit,
                    int nbits, int es, void* stream) {
  return (int)fdp::dispatch_limbs<Launch>(
      num_limbs, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<float*>(c), Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn,
      fdp::Spec{lsb, width, num_limbs, rne, saturate}, fdp::Fmt{posit, nbits, es},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
