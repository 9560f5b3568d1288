// The seed's per-k exact <ovf,msb,lsb> FDP GEMM for Hopper (sm_90a), CUDA C++
// with a plain C entry point (loaded with ctypes; no PyTorch headers).
//
//   C[m, n] = round_f32( sum_{k = 0 .. K-1}  q(A[m, k] * B[k, n]) )
//
// The same function as fdp_gemm.cu, computed in the seed's order: it
// replaces the Pallas body repro/kernels/fdp_gemm.py:fdp_gemm_kernel_looped
// (reached through fdp_gemm_pallas(impl="loop")), whose fori_loop enters one
// product per k into the (bm, bn, L) limb register and normalizes carries
// once per K block of bk <= SAFE_CHUNK products, then reads out once. It is
// the baseline that the vectorized engine is measured against, so what it
// keeps is that order, not the TPU's grid: here one thread owns one output
// (m, n) and walks k = 0 .. K-1 in order, adding each product into registers
// of LC limbs, with no K split and no shared-memory reduction (that is the
// vector kernel's design), and normalizes carries after every bk products.
// The device math (decode, product entry, carry normalization, read-out) is
// fdp_common.cuh's, shared with the other kernels, so the bits are
// repro.core.fdp.fdp_gemm's for every format, round mode and overflow mode.
//
// The plan is honoured: a CUDA block covers the plan's bm x bn output tile
// (grid (ceil(N / bn), ceil(M / bm))), and its threads stride over the tile
// when bm * bn exceeds the block's 1024 threads; consecutive threads take
// consecutive n, so B's rows are read coalesced and A's element is a
// broadcast. Edges are masked, so nothing is padded. Offsets are 64-bit and
// operands go through their element strides.
//
// Bound: int32 CUDA-core operations per exact product, as the other kernels.
// This simple design decodes both operands of every product and places
// each product by compare-and-select over all LC limbs; a 3-limb spec runs
// the 6-limb instantiation (fdp::dispatch_limbs starts at 6).

#include "fdp_common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

template <int LC>
__global__ void __launch_bounds__(MAX_THREADS)
fdp_gemm_looped_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K, int bm, int bn,
                       int bk, long long sam, long long sak, long long sbk,
                       long long sbn, fdp::Spec spec, fdp::Fmt fmt) {
  const int L = spec.num_limbs;
  const int tile = bm * bn;
  for (int idx = threadIdx.x; idx < tile; idx += blockDim.x) {
    const int m = blockIdx.y * bm + idx / bn;
    const int n = blockIdx.x * bn + idx % bn;
    if (m >= M || n >= N) continue;
    uint32_t limb[LC];
#pragma unroll
    for (int l = 0; l < LC; ++l) limb[l] = 0u;
    const uint32_t* a = A + (long long)m * sam;
    const uint32_t* b = B + (long long)n * sbn;
    int since = 0;
    for (int k = 0; k < K; ++k) {
      uint32_t sa, ma, sb, mb;
      int ea, eb;
      fdp::decode(a[k * sak], fmt, sa, ma, ea);
      fdp::decode(b[k * sbk], fmt, sb, mb, eb);
      fdp::add_product(limb, L, sa, ma, ea, sb, mb, eb, spec.lsb, spec.rne);
      if (++since == bk) {                       // once per K block
        fdp::carry_normalize(limb, L);
        since = 0;
      }
    }
    fdp::carry_normalize(limb, L);
    C[(long long)m * N + n] = fdp::to_float(limb, spec);
  }
}

template <int LC>
struct Launch {
  static cudaError_t run(const uint32_t* a, const uint32_t* b, float* c, int M, int N,
                         int K, int bm, int bn, int bk, long long sam, long long sak,
                         long long sbk, long long sbn, fdp::Spec spec, fdp::Fmt fmt,
                         cudaStream_t stream) {
    if (bm < 1 || bn < 1 || bk < 1 || bk > fdp::SAFE_CHUNK) return cudaErrorInvalidValue;
    const int tile = bm * bn;
    dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
    dim3 block(tile < MAX_THREADS ? tile : MAX_THREADS);
    fdp_gemm_looped_kernel<LC><<<grid, block, 0, stream>>>(
        a, b, c, M, N, K, bm, bn, bk, sam, sak, sbk, sbn, spec, fmt);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// a: (M, K), b: (K, N) with element strides; c: (M, N) contiguous f32; the
// plan's tile (bm, bn) and carry cadence bk (1 <= bk <= SAFE_CHUNK).
// Launches on `stream`, allocates nothing, and returns the launch's
// cudaGetLastError() (0 = success).
int fdp_gemm_looped_launch(const void* a, const void* b, void* c, int M, int N, int K,
                           int bm, int bn, int bk, long long sam, long long sak,
                           long long sbk, long long sbn, int lsb, int width,
                           int num_limbs, int rne, int saturate, int posit, int nbits,
                           int es, void* stream) {
  return (int)fdp::dispatch_limbs<Launch>(
      num_limbs, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<float*>(c), M, N, K, bm, bn, bk, sam, sak, sbk, sbn,
      fdp::Spec{lsb, width, num_limbs, rne, saturate}, fdp::Fmt{posit, nbits, es},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
