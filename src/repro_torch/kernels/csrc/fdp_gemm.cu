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
// file checks them. Offsets
// are int64; ragged edges are masked (zeros decode to nothing), nothing is
// padded.

#include "fdp_common.cuh"

namespace {

constexpr int THREADS = 256;

// the dynamic shared memory a block may take, and at capacity LC the most
// rows (TM) and the columns (TN) of outputs a thread owns and the blocks an
// SM should hold: the table of csrc/fdp_gemm_tiles.def, which the launcher
// reads too
#define FDP_DENSE_TILE(lc, tm, tn, blocks)
#define FDP_DENSE_SMEM_LIMIT(bytes) constexpr int SMEM_LIMIT = bytes;
#include "fdp_gemm_tiles.def"
#undef FDP_DENSE_SMEM_LIMIT
#undef FDP_DENSE_TILE

template <int LC> struct Tile;
#define FDP_DENSE_SMEM_LIMIT(bytes)
#define FDP_DENSE_TILE(lc, tm, tn, blocks) \
  template <> struct Tile<lc> { static constexpr int TM = tm, TN = tn, BLOCKS = blocks; };
#include "fdp_gemm_tiles.def"
#undef FDP_DENSE_TILE
#undef FDP_DENSE_SMEM_LIMIT

struct Layout {
  int tx, ty, ks, bks;       // threads along N, along M, K slices; k per slice per chunk
};

// Decode one operand element into its shared-memory form: x = significand
// | sign << 31 (significands are < 2^24), y = exponent - lsb_off. NaN, Inf,
// zero, NaR and elements past the edge decode to significand 0.
__device__ __forceinline__ uint2 decode_element(const uint32_t* p, bool inside,
                                                const fdp::Fmt& fmt, int lsb_off) {
  uint2 d = make_uint2(0u, 0u);
  if (inside) {
    uint32_t sign, mant;
    int exp;
    fdp::decode(*p, fmt, sign, mant, exp);
    d.x = mant | (sign << 31);
    d.y = (uint32_t)(exp - lsb_off);
  }
  return d;
}

// Decode the tile of 2^rlog x 2^clog elements at (r0, c0) of an operand with
// strides (sr, sc) into dst[c << rlog | r]; r_fast walks r along neighbouring
// threads (the unit-stride dimension), else c. Past (rlim, clim): zeros.
__device__ __forceinline__ void load_tile(uint2* dst, const uint32_t* base, int r0, int c0,
                                          int rlim, int clim, int rlog, int clog,
                                          long long sr, long long sc, bool r_fast,
                                          const fdp::Fmt& fmt, int lsb_off) {
  const int rows = 1 << rlog, cols = 1 << clog, n = rows * cols;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    int r, c;
    if (r_fast) {
      r = e & (rows - 1);
      c = e >> rlog;
    } else {
      c = e & (cols - 1);
      r = e >> clog;
    }
    const int gr = r0 + r, gc = c0 + c;
    const bool inside = gr < rlim && gc < clim;
    dst[(c << rlog) | r] = decode_element(
        base + (inside ? (long long)gr * sr + (long long)gc * sc : 0), inside, fmt, lsb_off);
  }
}

// A decoded element as the product needs it: significand, sign as a mask
// (0 or ~0), exponent.
__device__ __forceinline__ void unpack(uint2 v, uint32_t& mant, uint32_t& smask, int& exp) {
  mant = v.x & 0x7FFFFFFFu;
  smask = (uint32_t)((int32_t)v.x >> 31);
  exp = (int)v.y;
}

// Unpack N consecutive decoded elements (16-byte loads where N is even).
template <int N>
__device__ __forceinline__ void load_decoded(const uint2* p, uint32_t (&mant)[N],
                                             uint32_t (&smask)[N], int (&exp)[N]) {
  uint2 v[N];
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      v[i] = make_uint2(u.x, u.y);
      v[i + 1] = make_uint2(u.z, u.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) unpack(v[i], mant[i], smask[i], exp[i]);
}

// TM rows x Tile<LC>::TN columns of outputs a thread
template <int LC, int TM, bool RNE, bool MASKED>
__global__ void __launch_bounds__(THREADS, Tile<LC>::BLOCKS)
fdp_gemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                float* __restrict__ C, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn,
                fdp::Spec spec, fdp::Fmt fmt, Layout lay) {
  constexpr int TN = Tile<LC>::TN;
  constexpr int NW = LC / 2 + 1, PW = LC / 2;
  extern __shared__ uint4 smem_raw[];
  uint2* smem = reinterpret_cast<uint2*>(smem_raw);

  const int TX = lay.tx, TY = lay.ty, KS = lay.ks, BKS = lay.bks;
  const int BM = TY * TM, BN = TX * TN, BK = KS * BKS;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = (tid / TX) % TY, slice = tid / (TX * TY);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;
  const int bm_log = __ffs(BM) - 1, bn_log = __ffs(BN) - 1, bk_log = __ffs(BK) - 1;
  uint2* sA = smem;                    // [BK][BM]
  uint2* sB = smem + BK * BM;          // [BK][BN]
  const uint32_t* Ab = A + bz * sab;
  const uint32_t* Bb = B + bz * sbb;
  const bool a_m_fast = sak != 1 && sam == 1;
  const bool b_k_fast = sbn != 1 && sbk == 1;

  uint32_t mask[PW];
  fdp::window_masks<PW>(mask, spec.num_limbs);
  uint32_t acc[TM][TN][NW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[i][j][w] = 0u;

  const uint2* a_at = sA + ty * TM;
  const uint2* b_at = sB + tx;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    // A tile: r = m, c = k; B tile: r = n, c = k (both k-major in shared memory)
    load_tile(sA, Ab, m0, k0, M, K, bm_log, bk_log, sam, sak, a_m_fast, fmt, spec.lsb);
    load_tile(sB, Bb, n0, k0, N, K, bn_log, bk_log, sbn, sbk, !b_k_fast, fmt, 0);
    __syncthreads();
    for (int kk = slice * BKS, kend = kk + BKS; kk < kend; ++kk) {
      uint32_t ma[TM], sa[TM], mb[TN], sb[TN];
      int ea[TM], eb[TN];
      load_decoded<TM>(a_at + kk * BM, ma, sa, ea);        // this thread's rows
#pragma unroll
      for (int j = 0; j < TN; ++j)                         // its columns, TX apart
        unpack(b_at[kk * BN + j * TX], mb[j], sb[j], eb[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          fdp::add_product_words<NW, RNE, MASKED>(acc[i][j], mask, ma[i], mb[j],
                                                  ea[i] + eb[j], sa[i] ^ sb[j]);
    }
  }

  // the KS slices' registers summed exactly, in a tree; slice 0 keeps the sum
  if (KS > 1) {
    uint32_t* red = reinterpret_cast<uint32_t*>(smem);
    const int NO = TX * TY, o = tid % NO;
    for (int half = KS >> 1; half > 0; half >>= 1) {
      __syncthreads();
      if (slice >= half && slice < 2 * half) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int w = 0; w < NW; ++w)
              red[(((i * TN + j) * NW + w) * half + slice - half) * NO + o] = acc[i][j][w];
      }
      __syncthreads();
      if (slice < half) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            uint32_t x[NW];
#pragma unroll
            for (int w = 0; w < NW; ++w)
              x[w] = red[(((i * TN + j) * NW + w) * half + slice) * NO + o];
            fdp::add_words<NW>(acc[i][j], x, 0u);
          }
      }
    }
    if (slice != 0) return;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < M && n < N) {
        uint32_t limb[LC];
        fdp::words_to_limbs<LC>(acc[i][j], spec.num_limbs, limb);
        C[(bz * M + m) * (long long)N + n] = fdp::to_float<LC>(limb, spec);
      }
    }
  }
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <int LC, int TM, bool RNE, bool MASKED>
cudaError_t launch(const uint32_t* a, const uint32_t* b, float* c, int Bn, int M, int N,
                   int K, long long sab, long long sam, long long sak, long long sbb,
                   long long sbk, long long sbn, fdp::Spec spec, fdp::Fmt fmt, Layout lay,
                   cudaStream_t stream) {
  constexpr int TN = Tile<LC>::TN, NW = LC / 2 + 1;
  if (spec.num_limbs > LC || !pow2(lay.tx) || !pow2(lay.ty) || !pow2(lay.ks) ||
      !pow2(lay.bks) || lay.tx * lay.ty * lay.ks != THREADS)
    return cudaErrorInvalidValue;
  const long long BM = (long long)lay.ty * TM, BN = (long long)lay.tx * TN;
  const long long BK = (long long)lay.ks * lay.bks;
  const long long tile = (BM + BN) * BK * (long long)sizeof(uint2);
  const long long red = lay.ks > 1 ? (long long)(lay.ks / 2) * lay.tx * lay.ty * TM * TN * NW * 4
                                   : 0;
  const long long smem = tile > red ? tile : red;
  const long long gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  if (smem > SMEM_LIMIT || gx > 2147483647LL || gy > 65535 || Bn > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)Bn);
  fdp_gemm_kernel<LC, TM, RNE, MASKED><<<grid, THREADS, (size_t)smem, stream>>>(
      a, b, c, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, fmt, lay);
  return cudaGetLastError();
}

template <int LC, int TM>
cudaError_t launch_tm(const uint32_t* a, const uint32_t* b, float* c, int Bn, int M, int N,
                      int K, long long sab, long long sam, long long sak, long long sbb,
                      long long sbk, long long sbn, fdp::Spec spec, fdp::Fmt fmt, Layout lay,
                      cudaStream_t stream) {
  // the window mask matters only to a saturating register narrower than LC
  const bool masked = spec.saturate && spec.num_limbs < LC;
#define FDP_LAUNCH(rne, masked)                                                          \
  launch<LC, TM, rne, masked>(a, b, c, Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, fmt, \
                              lay, stream)
  if (spec.rne) return masked ? FDP_LAUNCH(true, true) : FDP_LAUNCH(true, false);
  return masked ? FDP_LAUNCH(false, true) : FDP_LAUNCH(false, false);
#undef FDP_LAUNCH
}

// tm: Tile<LC>::TM, or TM/2 or TM/4 where that is at least 1
template <int LC>
cudaError_t launch_lc(int tm, const uint32_t* a, const uint32_t* b, float* c, int Bn, int M,
                      int N, int K, long long sab, long long sam, long long sak, long long sbb,
                      long long sbk, long long sbn, fdp::Spec spec, fdp::Fmt fmt, Layout lay,
                      cudaStream_t stream) {
  constexpr int TM = Tile<LC>::TM;
#define FDP_LAUNCH(rows) \
  launch_tm<LC, rows>(a, b, c, Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, fmt, lay, stream)
  if (tm == TM) return FDP_LAUNCH(TM);
  if constexpr (TM >= 2) {
    if (tm == TM / 2) return FDP_LAUNCH(TM / 2);
  }
  if constexpr (TM >= 4) {
    if (tm == TM / 4) return FDP_LAUNCH(TM / 4);
  }
  return cudaErrorInvalidValue;
#undef FDP_LAUNCH
}

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
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  float* pc = static_cast<float*>(c);
  const fdp::Spec spec{lsb, width, num_limbs, rne, saturate};
  const fdp::Fmt fmt{posit, nbits, es};
  const Layout lay{tx, ty, ks, bks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDP_DENSE_SMEM_LIMIT(bytes)
#define FDP_DENSE_TILE(n, tm_, tn_, blocks_)                                               \
  case n:                                                                                  \
    return (int)launch_lc<n>(tm, pa, pb, pc, Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, \
                             fmt, lay, s);
  switch (lc) {
#include "fdp_gemm_tiles.def"
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FDP_DENSE_TILE
#undef FDP_DENSE_SMEM_LIMIT
}

}  // extern "C"
