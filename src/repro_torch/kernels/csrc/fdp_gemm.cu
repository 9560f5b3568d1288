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
// fdp_gemm_pallas and fdp_gemm_pallas_batched).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LIMB_BITS = 16;
constexpr uint32_t LIMB_MASK = 0xFFFFu;
constexpr int TILE_N = 32;
constexpr int K_SLICES = 8;
constexpr int SAFE_CHUNK = 1 << 13;

struct Spec {
  int lsb;
  int width;
  int num_limbs;   // runtime L <= the template capacity LC
  int rne;
  int saturate;
};

struct Fmt {
  int posit;       // 0: IEEE value carried as f32 bits; 1: posit pattern in int32
  int nbits;
  int es;
};

// ---------------------------------------------------------------------------
// Decode to (sign, mant, exp): value = (-1)^sign * mant * 2^exp; NaN, Inf,
// zero and NaR decode to mant = 0 and contribute nothing.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void decode_ieee(uint32_t bits, uint32_t& sign,
                                            uint32_t& mant, int& exp) {
  sign = bits >> 31;
  uint32_t biased = (bits >> 23) & 0xFFu;
  uint32_t frac = bits & 0x7FFFFFu;
  mant = biased == 0 ? frac : (frac | 0x800000u);
  exp = biased == 0 ? -149 : (int)biased - 150;
  if (biased == 0xFFu) mant = 0;
}

__device__ __forceinline__ void decode_posit(uint32_t p, int n, int es,
                                             uint32_t& sign, uint32_t& mant,
                                             int& exp) {
  uint32_t mask = n == 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
  uint32_t u = p & mask;
  sign = (u >> (n - 1)) & 1u;
  bool special = (u == 0u) || (u == (1u << (n - 1)));
  uint32_t body = sign ? ((0u - u) & mask) : u;
  body &= (1u << (n - 1)) - 1u;                  // low n-1 bits
  uint32_t aligned = body << (33 - n);           // bit n-2 -> bit 31
  uint32_t first = aligned >> 31;
  uint32_t probe = first ? ~aligned : aligned;
  int run = min(__clz(probe), n - 1);            // __clz(0) == 32
  int k = first ? run - 1 : -run;
  int rem = max(n - 1 - run - 1, 0);             // bits for es + fraction
  uint32_t tail = body & ((1u << rem) - 1u);
  int e_take = min(rem, es);
  int e_val = (int)(tail >> (rem - e_take)) << (es - e_take);
  int f_bits = rem - e_take;
  uint32_t frac = tail & ((1u << f_bits) - 1u);
  mant = special ? 0u : ((1u << f_bits) | frac);
  exp = k * (1 << es) + e_val - f_bits;
}

__device__ __forceinline__ void decode(uint32_t x, const Fmt& fmt, uint32_t& sign,
                                       uint32_t& mant, int& exp) {
  if (fmt.posit) {
    decode_posit(x, fmt.nbits, fmt.es, sign, mant, exp);
  } else {
    decode_ieee(x, sign, mant, exp);
  }
}

// ---------------------------------------------------------------------------
// Product entry: place the exact product's magnitude at grid offset
// q = ea + eb - lsb as four 16-bit pieces on limbs j0..j0+3 (pieces below
// limb 0 and above limb L-1 are dropped), add the RNE increment to limb 0,
// then apply the sign. Limbs are accumulated as uint32 (two's-complement
// wrap, as the reference's int32 adds).
// ---------------------------------------------------------------------------
template <int LC>
__device__ __forceinline__ void add_product(uint32_t (&limb)[LC], int L,
                                            uint32_t sa, uint32_t ma, int ea,
                                            uint32_t sb, uint32_t mb, int eb,
                                            int lsb, int rne) {
  uint64_t m = (uint64_t)ma * (uint64_t)mb;      // < 2^48
  int q = ea + eb - lsb;
  int j0 = q >> 4;                               // floor(q / 16)
  int r = q & 15;
  uint64_t P = m << r;                           // < 2^63
  uint32_t neg = sa ^ sb;
  uint32_t pc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = (uint32_t)(P >> (16 * i)) & LIMB_MASK;
    v = (j0 + i < L) ? v : 0u;                   // above limb L-1: dropped
    pc[i] = neg ? 0u - v : v;
  }
  if (rne) {
    // guard = product bit at grid position -1, sticky = OR of the bits
    // below it, lsb_bit = product bit at grid position 0 (bits of m >= 48
    // read as 0, as the reference's three 16-bit digits).
    int pg = -1 - q;
    uint32_t guard = (pg >= 0 && pg < 48) ? (uint32_t)(m >> pg) & 1u : 0u;
    bool sticky = pg <= 0 ? false
                : pg >= 48 ? (m != 0)
                : (m & ((1ull << pg) - 1ull)) != 0;
    int pl = -q;
    uint32_t lsb_bit = (pl >= 0 && pl < 48) ? (uint32_t)(m >> pl) & 1u : 0u;
    uint32_t inc = (guard && (sticky || lsb_bit)) ? 1u : 0u;
    limb[0] += neg ? 0u - inc : inc;
  }
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    int d = l - j0;
    uint32_t v = d == 0 ? pc[0] : d == 1 ? pc[1] : d == 2 ? pc[2] : d == 3 ? pc[3] : 0u;
    limb[l] += v;
  }
}

// Limbs 0..L-2 to [0, 2^16); the top limb keeps the full signed remainder.
template <int LC>
__device__ __forceinline__ void carry_normalize(uint32_t (&limb)[LC], int L) {
  int32_t carry = 0;
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    if (l < L - 1) {
      int32_t t = (int32_t)(limb[l] + (uint32_t)carry);
      carry = t >> LIMB_BITS;                    // arithmetic shift = floor
      limb[l] = (uint32_t)t & LIMB_MASK;
    } else if (l == L - 1) {
      limb[l] += (uint32_t)carry;
    } else {
      limb[l] = 0u;                              // beyond the register
    }
  }
}

template <int LC>
__device__ __forceinline__ uint32_t limb_at(const uint32_t (&mag)[LC], int L, int idx) {
  uint32_t out = 0u;
#pragma unroll
  for (int l = 0; l < LC; ++l) out = (l == idx && l < L) ? mag[l] : out;
  return out;
}

// Bits [start, start + nbits) of the magnitude register, start may be < 0.
template <int LC>
__device__ __forceinline__ uint32_t extract_bits(const uint32_t (&mag)[LC], int L,
                                                 int start, int nbits) {
  int j = start >> 4;
  int s = start & 15;
  uint32_t part0 = limb_at(mag, L, j) >> s;
  uint32_t part1 = limb_at(mag, L, j + 1) << (LIMB_BITS - s);
  int sh2 = min(max(2 * LIMB_BITS - s, 0), 31);
  uint32_t part2 = s > 2 * LIMB_BITS - nbits ? limb_at(mag, L, j + 2) << sh2 : 0u;
  return (part0 | part1 | part2) & ((1u << nbits) - 1u);
}

// OR of the magnitude bits at positions <= below.
template <int LC>
__device__ __forceinline__ bool any_below(const uint32_t (&mag)[LC], int L, int below) {
  bool any = false;
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    int nb = min(max(below + 1 - l * LIMB_BITS, 0), LIMB_BITS);
    any = any || (l < L && (mag[l] & ((1u << nb) - 1u)) != 0u);
  }
  return any;
}

// Read-out: W-bit wrap or saturation, then one RNE rounding to f32. The
// float is mant * 2^exp formed exactly in f64 and cast once (the plain
// version does the same, see repro_torch.core.formats._ldexp_f32).
template <int LC>
__device__ float to_float(uint32_t (&limb)[LC], const Spec& spec) {
  const int L = spec.num_limbs;
  const int top_bits = spec.width - LIMB_BITS * (L - 1);   // 1..16
  int32_t top = (int32_t)limb_at(limb, L, L - 1);
  if (!spec.saturate) {
    int sh = 32 - top_bits;
    top = (int32_t)((uint32_t)top << sh) >> sh;             // sign-extend
  } else {
    int32_t lo = -(1 << (top_bits - 1)), hi = (1 << (top_bits - 1)) - 1;
    if (top > hi || top < lo) {
#pragma unroll
      for (int l = 0; l < LC; ++l) limb[l] = top > hi ? LIMB_MASK : 0u;
      top = top > hi ? hi : lo;
    }
  }
  const bool sign_neg = top < 0;
  uint32_t mag[LC];
  uint32_t borrow = 0u;
  int top_idx = 0;
  bool any_nz = false;
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    int32_t v = l == L - 1 ? top : (int32_t)limb[l];
    if (l >= L) {
      mag[l] = 0u;
      continue;
    }
    if (sign_neg) {
      int32_t t = -v - (int32_t)borrow;
      borrow = t < 0 ? 1u : 0u;
      v = t < 0 ? t + (1 << LIMB_BITS) : t;
    }
    mag[l] = (uint32_t)v;
    if (mag[l] != 0u) { top_idx = l; any_nz = true; }
  }
  if (!any_nz) return 0.0f;
  uint32_t top_val = limb_at(mag, L, top_idx);
  int hb = (31 - __clz(top_val)) + top_idx * LIMB_BITS;
  const int p = 24;
  int take_from = hb - p + 1;
  uint32_t mant = extract_bits(mag, L, take_from, p);
  uint32_t guard = extract_bits(mag, L, take_from - 1, 1);
  bool sticky = any_below(mag, L, take_from - 2);
  if (guard && (sticky || (mant & 1u))) mant += 1u;
  int exp = take_from + spec.lsb;
  if (mant == (1u << p)) { mant = 1u << (p - 1); exp += 1; }
  exp = min(max(exp, -1022), 1023);
  double pow2 = __longlong_as_double((long long)(exp + 1023) << 52);
  float v = __double2float_rn((double)mant * pow2);
  return sign_neg ? -v : v;
}

template <int LC>
__global__ void __launch_bounds__(TILE_N * K_SLICES)
fdp_gemm_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                float* __restrict__ C, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn,
                Spec spec, Fmt fmt) {
  __shared__ uint32_t red[K_SLICES][LC][TILE_N];
  const int tx = threadIdx.x, ks = threadIdx.y;
  const int n = blockIdx.x * TILE_N + tx;
  const int m = blockIdx.y;
  const long long b = blockIdx.z;
  const int L = spec.num_limbs;

  uint32_t limb[LC];
#pragma unroll
  for (int l = 0; l < LC; ++l) limb[l] = 0u;

  if (n < N) {
    const uint32_t* a_row = A + b * sab + (long long)m * sam;
    const uint32_t* b_col = B + b * sbb + (long long)n * sbn;
    const int per = (K + K_SLICES - 1) / K_SLICES;
    const int k_begin = min(K, ks * per);
    const int k_end = min(K, k_begin + per);
    int since = 0;
    for (int k = k_begin; k < k_end; ++k) {
      uint32_t sa, ma, sb, mb;
      int ea, eb;
      decode(a_row[k * sak], fmt, sa, ma, ea);
      decode(b_col[k * sbk], fmt, sb, mb, eb);
      add_product(limb, L, sa, ma, ea, sb, mb, eb, spec.lsb, spec.rne);
      if (++since == SAFE_CHUNK) {
        carry_normalize(limb, L);
        since = 0;
      }
    }
    carry_normalize(limb, L);
  }
#pragma unroll
  for (int l = 0; l < LC; ++l) red[ks][l][tx] = limb[l];
  __syncthreads();
  if (ks != 0 || n >= N) return;
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    uint32_t s = 0u;
#pragma unroll
    for (int j = 0; j < K_SLICES; ++j) s += red[j][l][tx];
    limb[l] = s;
  }
  carry_normalize(limb, L);
  C[(b * M + m) * (long long)N + n] = to_float(limb, spec);
}

template <int LC>
cudaError_t launch(const uint32_t* a, const uint32_t* b, float* c, int Bn, int M,
                   int N, int K, long long sab, long long sam, long long sak,
                   long long sbb, long long sbk, long long sbn, Spec spec, Fmt fmt,
                   cudaStream_t stream) {
  dim3 grid((N + TILE_N - 1) / TILE_N, M, Bn);
  dim3 block(TILE_N, K_SLICES);
  fdp_gemm_kernel<LC><<<grid, block, 0, stream>>>(a, b, c, M, N, K, sab, sam, sak,
                                                  sbb, sbk, sbn, spec, fmt);
  return cudaGetLastError();
}

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
  Spec spec{lsb, width, num_limbs, rne, saturate};
  Fmt fmt{posit, nbits, es};
  const uint32_t* A = static_cast<const uint32_t*>(a);
  const uint32_t* B = static_cast<const uint32_t*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FDP_LAUNCH(LC)                                                          \
  return (int)launch<LC>(A, B, C, Bn, M, N, K, sab, sam, sak, sbb, sbk, sbn, spec, \
                         fmt, s)
  if (num_limbs < 1) return (int)cudaErrorInvalidValue;
  if (num_limbs <= 6) FDP_LAUNCH(6);
  if (num_limbs <= 8) FDP_LAUNCH(8);
  if (num_limbs <= 12) FDP_LAUNCH(12);
  if (num_limbs <= 16) FDP_LAUNCH(16);
  if (num_limbs <= 24) FDP_LAUNCH(24);
  if (num_limbs <= 32) FDP_LAUNCH(32);
  if (num_limbs <= 40) FDP_LAUNCH(40);
#undef FDP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
