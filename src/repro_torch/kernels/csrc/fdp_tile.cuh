// The output-tile body of the tiled FDP kernels, shared by the dense kernel
// (fdp_gemm.cu), the sorted-segment forward kernel (fdp_ragged_gemm.cu) and
// the sorted-segment weight gradient (fdp_ragged_dw.cu): each __global__
// kernel finds its block's operand bases, row window and column tile, and
// calls fdp::fdp_tile, which computes
//
//   C[m, n] = round_f32( sum_k  q(A[m, k] * B[k, n]) )   r0 <= m < rlim, n0 <= n < N
//
// for one block tile of BM x BN outputs. The design (why it spends few
// int32 operations a product) is in fdp_gemm.cu's note; in short:
//
// - Per K chunk of BK, the block decodes its A tile (BM x BK) and B tile
//   (BK x BN) once into shared memory as (significand | sign << 31,
//   exponent); A's exponent already has lsb taken off. Loads go along
//   whichever dimension has unit stride, so transposed views read
//   coalesced. Rows past `rows`, columns past N and k past K decode to 0;
//   with CLIP_K the last chunk's k loop also stops at K, so no product is
//   formed for them (the weight gradient, whose K is a group's few rows).
// - Each thread owns TM rows x TN columns of outputs, each a word register
//   of NW = LC/2 + 1 32-bit words (fdp::add_product_words: two shifts a
//   word and one add-with-carry chain, no carry ever pending).
// - K may be split over KS groups of the block's threads; their words are
//   summed exactly in shared memory in a tree of add-with-carry chains, and
//   slice 0 reads the sums out (fdp::words_to_limbs -> fdp::to_float).
// - Each thread loads and decodes its share of a tile one element after
//   another (load_tile). A block of one row may instead stream its B
//   elements through registers (row_chunks): each serves one thread only,
//   so shared memory adds nothing there.
//
// The tile table (capacities, rows and columns a thread owns, blocks an SM)
// and the shared-memory limit come from fdp_gemm_tiles.def, their one copy,
// which the launcher (kernels/fdp_gemm.py) reads too. dispatch_tile turns a
// launch's (capacity, rows a thread, round mode, window mask) into one of
// the 76 instantiations of a kernel.
#pragma once

#include "fdp_common.cuh"

namespace fdp {

constexpr int THREADS = 256;

// the dynamic shared memory a block may take, and at capacity LC the most
// rows (TM) and the columns (TN) of outputs a thread owns and the blocks an
// SM should hold
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
// zero and NaR decode to significand 0, and so do the bits 0 in every
// format.
__device__ __forceinline__ uint2 decode_raw(uint32_t bits, const Fmt& fmt, int lsb_off) {
  uint32_t sign, mant;
  int exp;
  decode(bits, fmt, sign, mant, exp);
  return make_uint2(mant | (sign << 31), (uint32_t)(exp - lsb_off));
}

// The same for the element at p; elements past the edge decode to 0.
__device__ __forceinline__ uint2 decode_element(const uint32_t* p, bool inside,
                                                const Fmt& fmt, int lsb_off) {
  return inside ? decode_raw(*p, fmt, lsb_off) : make_uint2(0u, 0u);
}

// Decode the tile of 2^rlog x 2^clog elements at (r0, c0) of an operand with
// strides (sr, sc) into dst[c << rlog | r]; r_fast walks r along neighbouring
// threads (the unit-stride dimension), else c. Past (rlim, clim): zeros.
__device__ __forceinline__ void load_tile(uint2* dst, const uint32_t* base, int r0, int c0,
                                          int rlim, int clim, int rlog, int clog,
                                          long long sr, long long sc, bool r_fast,
                                          const Fmt& fmt, int lsb_off) {
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

// The chunk loop of a block tile of one row (BM = 1), where each B element
// serves one thread's products and no other: a thread loads and decodes
// its own B elements in registers (columns n0 + tx + j TX, the k of its
// slice's share of every chunk), and keeps PB of them a column in flight
// into the next chunk, each reloaded as soon as its product is formed;
// only the A row goes through shared memory, its first RA THREADS elements
// of the next chunk in flight behind this chunk's products (loaded one
// after another, the row made a dbrx decode launch on an H100 a fifth
// slower). Every (k, column) pair is the shared-memory loop's, so the
// register's sum is the same; it is written to `out`. Not inlined, so that
// its registers are allocated apart from the shared-memory loop's.
template <int TN, int NW, bool RNE, bool MASKED, int RA, int PB>
__device__ __noinline__ void row_chunks(uint32_t (&out)[1][TN][NW], const uint32_t* A,
                                        long long sam, long long sak, int r0, int rlim,
                                        int a_lsb,
                                        const uint32_t* B, long long sbk, long long sbn, int n0,
                                        int N, int K, int TX, int BKS, int BK, int tx, int slice,
                                        int num_limbs, const Fmt fmt) {
  extern __shared__ uint4 smem_raw[];
  uint2* sA = reinterpret_cast<uint2*>(smem_raw);
  const int tid = threadIdx.x;
  const bool has_row = r0 < rlim;
  uint32_t mask[NW - 1];
  window_masks<NW - 1>(mask, num_limbs);
  uint32_t acc[1][TN][NW];
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[0][j][w] = 0u;
  const uint32_t* col[TN];
  bool in_n[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + j * TX;
    in_n[j] = n < N;
    col[j] = B + (in_n[j] ? (long long)n * sbn : 0);
  }
  const int kb = slice * BKS;                      // the slice's first k of a chunk
  auto raw_a = [&](int k) -> uint32_t {
    return has_row && k < K ? A[(long long)r0 * sam + (long long)k * sak] : 0u;
  };
  auto raw_b = [&](int j, int k) -> uint32_t {
    return in_n[j] && k < K ? col[j][(long long)k * sbk] : 0u;
  };
  auto products = [&](int kk, const uint32_t (&bits)[TN]) {
    uint32_t ma[1], sa[1];
    int ea[1];
    load_decoded<1>(sA + kb + kk, ma, sa, ea);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      uint32_t mb, sb;
      int eb;
      unpack(decode_raw(bits[j], fmt, 0), mb, sb, eb);
      add_product_words<NW, RNE, MASKED>(acc[0][j], mask, ma[0], mb, ea[0] + eb, sa[0] ^ sb);
    }
  };
  uint32_t ra[RA], rb[TN][PB];
#pragma unroll
  for (int u = 0; u < RA; ++u) ra[u] = tid + u * THREADS < BK ? raw_a(tid + u * THREADS) : 0u;
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int u = 0; u < PB; ++u) rb[j][u] = u < BKS ? raw_b(j, kb + u) : 0u;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < RA; ++u)
      if (tid + u * THREADS < BK) sA[tid + u * THREADS] = decode_raw(ra[u], fmt, a_lsb);
    for (int e = tid + RA * THREADS; e < BK; e += THREADS)
      sA[e] = decode_raw(raw_a(k0 + e), fmt, a_lsb);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < RA; ++u)
      ra[u] = tid + u * THREADS < BK ? raw_a(k0 + BK + tid + u * THREADS) : 0u;
#pragma unroll
    for (int u = 0; u < PB; ++u) {
      if (u < BKS) {
        uint32_t bits[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bits[j] = rb[j][u];
          rb[j][u] = raw_b(j, k0 + BK + kb + u);
        }
        products(u, bits);
      }
    }
    for (int kk = PB; kk < BKS; ++kk) {
      uint32_t bits[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bits[j] = raw_b(j, k0 + kb + kk);
      products(kk, bits);
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w) out[0][j][w] = acc[0][j][w];
}

// One block tile: rows r0 .. r0 + BM of A (strides sam, sak), those below
// rlim valid, against columns n0 .. n0 + BN of the N columns of B (strides
// sbk, sbn); row m's outputs go to C[(c0 + m) N + n]. Every thread of the
// block calls it (it synchronizes) with the same arguments. (The dense
// kernel's kernel parameters stay in the constant bank this way, not in
// registers held across the chunk loop.)
//
// ROW > 0 (TM = 1): a block of one row runs row_chunks, ROW B elements a
// column and 2 A elements a thread in flight. CLIP_K: each slice's k loop
// stops at K in the last chunk (off for the dense and forward kernels,
// whose K is long and whose code stays as it was).
template <int LC, int TM, bool RNE, bool MASKED, int ROW = 0, bool CLIP_K = false>
__device__ __forceinline__ void fdp_tile(const uint32_t* __restrict__ A, long long sam,
                                         long long sak, int r0, int rlim,
                                         const uint32_t* __restrict__ B, long long sbk,
                                         long long sbn, int n0, int N, int K,
                                         float* __restrict__ C, long long c0,
                                         const Spec& spec, const Fmt& fmt, const Layout& lay) {
  constexpr int TN = Tile<LC>::TN;
  constexpr int NW = LC / 2 + 1, PW = LC / 2;
  extern __shared__ uint4 smem_raw[];
  uint2* smem = reinterpret_cast<uint2*>(smem_raw);

  const int TX = lay.tx, TY = lay.ty, KS = lay.ks, BKS = lay.bks;
  const int BM = TY * TM, BN = TX * TN, BK = KS * BKS;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = (tid / TX) % TY, slice = tid / (TX * TY);
  const int bm_log = __ffs(BM) - 1, bn_log = __ffs(BN) - 1, bk_log = __ffs(BK) - 1;
  uint2* sA = smem;                    // [BK][BM]
  uint2* sB = smem + BK * BM;          // [BK][BN]
  const bool a_m_fast = sak != 1 && sam == 1;
  const bool b_k_fast = sbn != 1 && sbk == 1;

  uint32_t mask[PW];
  window_masks<PW>(mask, spec.num_limbs);
  uint32_t acc[TM][TN][NW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[i][j][w] = 0u;

  const uint2* a_at = sA + ty * TM;
  const uint2* b_at = sB + tx;
  bool row = false;
  if constexpr (ROW > 0 && TM == 1) {
    if (TY == 1) {
      uint32_t racc[1][TN][NW];
      row_chunks<TN, NW, RNE, MASKED, 2, ROW>(racc, A, sam, sak, r0, rlim, spec.lsb, B, sbk,
                                              sbn, n0, N, K, TX, BKS, BK, tx, slice,
                                              spec.num_limbs, fmt);
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int w = 0; w < NW; ++w) acc[0][j][w] = racc[0][j][w];
      row = true;
    }
  }
  // A tile: r = m, c = k; B tile: r = n, c = k (both k-major in shared memory)
  for (int k0 = row ? K : 0; k0 < K; k0 += BK) {           // none after row_chunks
    __syncthreads();
    load_tile(sA, A, r0, k0, rlim, K, bm_log, bk_log, sam, sak, a_m_fast, fmt, spec.lsb);
    load_tile(sB, B, n0, k0, N, K, bn_log, bk_log, sbn, sbk, !b_k_fast, fmt, 0);
    __syncthreads();
    for (int kk = slice * BKS, kend = CLIP_K ? min(kk + BKS, K - k0) : kk + BKS; kk < kend;
         ++kk) {
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
          add_product_words<NW, RNE, MASKED>(acc[i][j], mask, ma[i], mb[j], ea[i] + eb[j],
                                             sa[i] ^ sb[j]);
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
            add_words<NW>(acc[i][j], x, 0u);
          }
      }
    }
    if (slice != 0) return;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < rlim && n < N) {
        uint32_t limb[LC];
        words_to_limbs<LC>(acc[i][j], spec.num_limbs, limb);
        C[(c0 + m) * (long long)N + n] = to_float<LC>(limb, spec);
      }
    }
  }
}

inline bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The dynamic shared memory in bytes of a block of layout `lay` at capacity
// LC with TM rows a thread (the decoded tiles, or the K split's partial
// registers if larger), or -1 for a launch the tile body does not take: a
// spec wider than LC, a layout that is not 256 threads in powers of two, or
// more than SMEM_LIMIT bytes.
template <int LC, int TM>
long long tile_smem(const Spec& spec, const Layout& lay) {
  constexpr int TN = Tile<LC>::TN, NW = LC / 2 + 1;
  if (spec.num_limbs > LC || !pow2(lay.tx) || !pow2(lay.ty) || !pow2(lay.ks) ||
      !pow2(lay.bks) || lay.tx * lay.ty * lay.ks != THREADS)
    return -1;
  const long long BM = (long long)lay.ty * TM, BN = (long long)lay.tx * TN;
  const long long BK = (long long)lay.ks * lay.bks;
  const long long tile = (BM + BN) * BK * (long long)sizeof(uint2);
  const long long red =
      lay.ks > 1 ? (long long)(lay.ks / 2) * lay.tx * lay.ty * TM * TN * NW * 4 : 0;
  const long long smem = tile > red ? tile : red;
  return smem > SMEM_LIMIT ? -1 : smem;
}

// Op<LC, TM, RNE, MASKED>::run(args...) for the capacity lc of the tile
// table and tm of its TM, TM/2 or TM/4 rows a thread; the window mask only
// for a saturating register narrower than its capacity. Any other lc or tm:
// cudaErrorInvalidValue.
template <template <int, int, bool, bool> class Op, int LC, int TM, typename... Args>
cudaError_t dispatch_modes(const Spec& spec, Args... args) {
  const bool masked = spec.saturate && spec.num_limbs < LC;
  if (spec.rne)
    return masked ? Op<LC, TM, true, true>::run(args...) : Op<LC, TM, true, false>::run(args...);
  return masked ? Op<LC, TM, false, true>::run(args...) : Op<LC, TM, false, false>::run(args...);
}

template <template <int, int, bool, bool> class Op, int LC, typename... Args>
cudaError_t dispatch_rows(int tm, const Spec& spec, Args... args) {
  constexpr int TM = Tile<LC>::TM;
  if (tm == TM) return dispatch_modes<Op, LC, TM>(spec, args...);
  if constexpr (TM >= 2) {
    if (tm == TM / 2) return dispatch_modes<Op, LC, TM / 2>(spec, args...);
  }
  if constexpr (TM >= 4) {
    if (tm == TM / 4) return dispatch_modes<Op, LC, TM / 4>(spec, args...);
  }
  return cudaErrorInvalidValue;
}

template <template <int, int, bool, bool> class Op, typename... Args>
cudaError_t dispatch_tile(int lc, int tm, const Spec& spec, Args... args) {
#define FDP_DENSE_SMEM_LIMIT(bytes)
#define FDP_DENSE_TILE(n, tm_, tn_, blocks_) \
  case n:                                    \
    return dispatch_rows<Op, n>(tm, spec, args...);
  switch (lc) {
#include "fdp_gemm_tiles.def"
    default:
      return cudaErrorInvalidValue;
  }
#undef FDP_DENSE_TILE
#undef FDP_DENSE_SMEM_LIMIT
}

}  // namespace fdp
