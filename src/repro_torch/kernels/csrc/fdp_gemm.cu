// Exact <ovf,msb,lsb> FDP GEMM for Hopper (sm_90a), CUDA C++ with a plain C
// entry point (loaded with ctypes; no PyTorch headers).
//
//   C[b, m, n] = round_f32( sum_k  q(A[b, m, k] * B[b, k, n]) )
//
// q() quantizes each exact product onto the 2^lsb grid (trunc toward zero,
// or RNE), the sum is exact in a W-bit register that wraps or saturates, and
// the result is rounded once (RNE at 24 bits). Bit-identical to
// repro.core.fdp.fdp_gemm for every format, round mode and overflow mode.
// It replaces the Pallas body repro/kernels/fdp_gemm.py:fdp_gemm_kernel
// (reached through fdp_gemm_pallas_batched for every N-D call and
// fdp_gemm_pallas for the 2-D ones, here the batched call with B = 1).
//
// What bounds it: int32 CUDA-core operations per exact product (form the
// 48-bit significand product, align it to the grid, add it into the
// register), not bytes and not the tensor cores: wgmma and IMMA accumulate
// linearly, and the FDP quantizes each product before its exact sum, which
// is not linear. The design spends few operations per product:
//
// 1. Each operand element is decoded once per block, not once per product.
//    The block's threads walk K in chunks of BK; per chunk they decode the A
//    tile (BM x BK) and the B tile (BK x BN) together, each element once,
//    into shared memory as (significand | sign << 31, exponent); A's
//    exponent already has lsb taken off. Loads go through the operands'
//    strides, along whichever dimension has unit stride, so transposed
//    views read coalesced. The inner loop reads decoded values only: TM + TN
//    shared loads for TM x TN products.
// 2. Placement is two shifts a word and a carry chain, not a
//    compare-and-select over every limb. The register of L limbs is exact
//    modulo 2^(16(L-1)+32), so it is held as one two's-complement integer
//    of NW = LC/2 + 1 32-bit words (LC the capacity, L <= LC). Window word j
//    of a product m * 2^q is m >> (32j - q) or (m mod 2^32) << (q - 32j),
//    whichever amount is not negative (PTX shifts give 0 past the width, so
//    the two are ORed); the sign is an XOR and a carry-in; one
//    add-with-carry chain enters the product. Carries never wait, so no
//    carry normalization is needed at any cadence; the read-out turns the
//    words into normalized limbs for fdp::to_float.
// 3. Several outputs per thread and one pass over a broadcast weight. A
//    block owns a BM x BN output tile; each thread owns TM rows x TN columns
//    (4 x 2 up to LC = 8, 2 x 2 at LC = 12 and 16, 1 x 1 from LC = 24, so
//    the TM*TN*NW words stay in registers; csrc/fdp_gemm_tiles.def), so a
//    decoded B element serves TM products and an A element TN. The
//    launcher may give a thread TM/2 or TM/4 rows instead, each its own
//    instantiation: a call with fewer rows than TM (attention at decode:
//    2 rows a head group) then forms no products for rows it lacks, and a
//    call too small to fill the card spreads over more threads. The wrapper
//    folds a weight broadcast over the batch (batch stride 0) into the
//    rows, (B*M, K) @ (K, N), so the weight is read once, not once per
//    batch element.
// 4. Narrow registers are cheaper. The capacity is a template parameter
//    (LC = 2, 4, 6, 8, 12, 16, 24, 32, 40; NW = 2 ... 21 words), and the
//    per-product work is about three operations a window word, so a 3-limb
//    <9,6,-20> register (LC = 4, 3 words) costs less than the 6-limb
//    91-bit one (LC = 6, 4 words).
//
// Where the output tiles alone cannot fill the card (decode: B*M <= 4
// rows; attention: small N; the 2-D router), K is also split over KS groups
// of a block's threads, each taking its share of every chunk; their words
// are summed exactly at the end in shared memory, in a tree of
// add-with-carry chains (integer addition is exact and order-free, so the
// split does not change the bits). The launcher (kernels/fdp_gemm.py,
// dense_launch) picks the capacity, the rows a thread owns, the thread
// layout (TX columns x TY rows x KS slices = 256) and the chunk depth; this
// file checks them. Offsets are int64; ragged edges are masked (zeros
// decode to nothing), nothing is padded.
//
// The block tile's body (decode, products, K-split tree, read-out) is
// fdp::fdp_tile in csrc/fdp_tile.cuh, shared with the sorted-segment
// forward kernel (fdp_ragged_gemm.cu) and weight gradient
// (fdp_ragged_dw.cu); this file maps a block to its batch element, row tile
// and column tile.

#include "fdp_tile.cuh"

namespace {

using fdp::Layout;
using fdp::THREADS;
using fdp::Tile;

// Batch element blockIdx.z, row tile blockIdx.y, column tile blockIdx.x;
// TM rows x Tile<LC>::TN columns of outputs a thread (fdp_tile.cuh).
template <int LC, int TM, bool RNE, bool MASKED>
__global__ void __launch_bounds__(THREADS, Tile<LC>::BLOCKS)
fdp_gemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                float* __restrict__ C, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn,
                fdp::Spec spec, fdp::Fmt fmt, Layout lay) {
  const int m0 = blockIdx.y * (lay.ty * TM), n0 = blockIdx.x * (lay.tx * Tile<LC>::TN);
  const long long bz = blockIdx.z;
  fdp::fdp_tile<LC, TM, RNE, MASKED>(A + bz * sab, sam, sak, m0, M, B + bz * sbb, sbk, sbn, n0,
                                     N, K, C, bz * M, spec, fmt, lay);
}

template <int LC, int TM, bool RNE, bool MASKED>
struct Launch {
  static cudaError_t run(const uint32_t* a, const uint32_t* b, float* c, int Bn, int M, int N,
                         int K, long long sab, long long sam, long long sak, long long sbb,
                         long long sbk, long long sbn, fdp::Spec spec, fdp::Fmt fmt,
                         Layout lay, cudaStream_t stream) {
    const long long smem = fdp::tile_smem<LC, TM>(spec, lay);
    const long long BM = (long long)lay.ty * TM, BN = (long long)lay.tx * Tile<LC>::TN;
    const long long gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
    if (smem < 0 || gx > 2147483647LL || gy > 65535 || Bn > 65535)
      return cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)Bn);
    fdp_gemm_kernel<LC, TM, RNE, MASKED><<<grid, THREADS, (size_t)smem, stream>>>(
        a, b, c, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, fmt, lay);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// a: (B, M, K), b: (B, K, N) with element strides (0 broadcasts); c: (B, M, N)
// contiguous f32. lc is the register capacity in limbs (a capacity of
// csrc/fdp_gemm_tiles.def, at least num_limbs); tm the rows of outputs a
// thread owns (the table's TM, TM/2 or TM/4); tx * ty * ks = 256 threads
// (powers of two) and bks k per slice per chunk, as
// kernels/fdp_gemm.py:dense_launch picks them. Launches on `stream`, allocates nothing, and returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// refuses (0 = success).
int fdp_gemm_launch(const void* a, const void* b, void* c, int Bn, int M, int N, int K,
                    long long sab, long long sam, long long sak, long long sbb,
                    long long sbk, long long sbn, int lsb, int width, int num_limbs,
                    int rne, int saturate, int posit, int nbits, int es, int lc, int tm,
                    int tx, int ty, int ks, int bks, void* stream) {
  if (num_limbs < 1 || M < 0 || N < 0 || K < 0 || Bn < 0) return (int)cudaErrorInvalidValue;
  const fdp::Spec spec{lsb, width, num_limbs, rne, saturate};
  return (int)fdp::dispatch_tile<Launch>(
      lc, tm, spec, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<float*>(c), Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec,
      fdp::Fmt{posit, nbits, es}, Layout{tx, ty, ks, bks}, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
