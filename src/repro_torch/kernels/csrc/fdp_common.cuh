// Device math shared by the FDP kernels: decode to (sign, mant, exp); the
// limb register of the seed-order kernel (fdp_gemm_looped.cu: exact product
// entry into int32 limbs, carry normalization every SAFE_CHUNK products);
// the word register of the tiled kernels (fdp_tile.cuh, for fdp_gemm.cu,
// fdp_ragged_gemm.cu and fdp_ragged_dw.cu); and the W-bit wrap/saturate
// read-out with one RNE rounding to f32 that both registers end in.
// Bit-identical to repro.core.fdp.fdp_gemm for every format, round mode and
// overflow mode.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fdp {

constexpr int LIMB_BITS = 16;
constexpr uint32_t LIMB_MASK = 0xFFFFu;
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

// Runs Launch<LC>::run(args...) for the smallest register capacity LC that
// holds num_limbs limbs (limb indices must be compile-time constants so the
// limbs stay in registers); more than 40 limbs is refused.
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_limbs(int num_limbs, Args... args) {
  if (num_limbs < 1) return cudaErrorInvalidValue;
  if (num_limbs <= 6) return Launch<6>::run(args...);
  if (num_limbs <= 8) return Launch<8>::run(args...);
  if (num_limbs <= 12) return Launch<12>::run(args...);
  if (num_limbs <= 16) return Launch<16>::run(args...);
  if (num_limbs <= 24) return Launch<24>::run(args...);
  if (num_limbs <= 32) return Launch<32>::run(args...);
  if (num_limbs <= 40) return Launch<40>::run(args...);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The word register (the tiled kernels, fdp_tile.cuh): the register as one
// two's-complement integer of NW 32-bit words, every product added with the
// hardware carry chain, so no carry is ever pending. A register of L limbs
// is exact modulo 2^(16(L-1) + 32) (limbs 0..L-2 of 16 bits and the 32-bit
// top limb), so NW = LC/2 + 1 words hold any L <= LC; its low PW = LC/2
// words cover the limb window [0, 16 LC) that a product may reach.
// ---------------------------------------------------------------------------

// acc[0..N) += x[0..N) + (c != 0) in one carry chain, returning the carry
// out (0 or 1) when COUT. A carry crosses asm statements only through a
// register, so a chain is at most four words.
template <int N, bool COUT>
__device__ __forceinline__ uint32_t add_chunk(uint32_t* acc, const uint32_t* x,
                                              uint32_t c);

#define FDP_CARRY_IN(c) "{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %" #c ", 0xFFFFFFFF;\n\t"
template <>
__device__ __forceinline__ uint32_t add_chunk<1, false>(uint32_t* a, const uint32_t* x,
                                                        uint32_t c) {
  asm(FDP_CARRY_IN(2) "addc.u32 %0, %0, %1;\n\t}"
      : "+r"(a[0]) : "r"(x[0]), "r"(c));
  return 0u;
}
template <>
__device__ __forceinline__ uint32_t add_chunk<2, false>(uint32_t* a, const uint32_t* x,
                                                        uint32_t c) {
  asm(FDP_CARRY_IN(4)
      "addc.cc.u32 %0, %0, %2;\n\taddc.u32 %1, %1, %3;\n\t}"
      : "+r"(a[0]), "+r"(a[1]) : "r"(x[0]), "r"(x[1]), "r"(c));
  return 0u;
}
template <>
__device__ __forceinline__ uint32_t add_chunk<3, false>(uint32_t* a, const uint32_t* x,
                                                        uint32_t c) {
  asm(FDP_CARRY_IN(6)
      "addc.cc.u32 %0, %0, %3;\n\taddc.cc.u32 %1, %1, %4;\n\taddc.u32 %2, %2, %5;\n\t}"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]) : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(c));
  return 0u;
}
template <>
__device__ __forceinline__ uint32_t add_chunk<4, false>(uint32_t* a, const uint32_t* x,
                                                        uint32_t c) {
  asm(FDP_CARRY_IN(8)
      "addc.cc.u32 %0, %0, %4;\n\taddc.cc.u32 %1, %1, %5;\n\t"
      "addc.cc.u32 %2, %2, %6;\n\taddc.u32 %3, %3, %7;\n\t}"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(c));
  return 0u;
}
template <>
__device__ __forceinline__ uint32_t add_chunk<4, true>(uint32_t* a, const uint32_t* x,
                                                       uint32_t c) {
  uint32_t out = 0u;
  asm(FDP_CARRY_IN(9)
      "addc.cc.u32 %0, %0, %5;\n\taddc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\taddc.cc.u32 %3, %3, %8;\n\taddc.u32 %4, %4, 0;\n\t}"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(out)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(c));
  return out;
}
#undef FDP_CARRY_IN

// acc += x + (c != 0) over all NW words (two's complement, modulo 2^(32 NW)).
template <int NW>
__device__ __forceinline__ void add_words(uint32_t (&acc)[NW], const uint32_t (&x)[NW],
                                          uint32_t c) {
  constexpr int FULL = (NW - 1) / 4;               // chunks of 4 before the last
#pragma unroll
  for (int i = 0; i < FULL; ++i) c = add_chunk<4, true>(acc + 4 * i, x + 4 * i, c);
  add_chunk<NW - 4 * FULL, false>(acc + 4 * FULL, x + 4 * FULL, c);
}

// Bits of a 64-bit value as PTX shifts them: an amount past the width
// (unsigned, so a negative int is one) gives 0.
__device__ __forceinline__ uint32_t shr64_lo(uint64_t x, int d) {
  uint32_t r;
  asm("{\n\t.reg .b64 t;\n\tshr.b64 t, %1, %2;\n\tcvt.u32.u64 %0, t;\n\t}"
      : "=r"(r) : "l"(x), "r"(d));
  return r;
}
__device__ __forceinline__ uint64_t shl64(uint64_t x, int d) {
  uint64_t r;
  asm("shl.b64 %0, %1, %2;" : "=l"(r) : "l"(x), "r"(d));
  return r;
}
__device__ __forceinline__ uint32_t shl32(uint32_t x, int d) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(d));
  return r;
}

// The RNE increment of a product m at grid offset q, as add_product forms
// it (guard = bit -1 on the grid, sticky = OR of the bits below it, lsb =
// bit 0; bits of m >= 48 read as 0), without branches: m < 2^48, so a bit
// index past 47 reads 0, and where the sticky shift is out of range the
// guard is 0.
__device__ __forceinline__ uint32_t rne_increment(uint64_t m, int q) {
  const int pg = -1 - q;
  const uint32_t guard = shr64_lo(m, pg) & 1u;
  const uint32_t lsb_bit = shr64_lo(m, -q) & 1u;
  const uint32_t sticky = shl64(m, 64 - pg) != 0ull;
  return guard & (sticky | lsb_bit);
}

// Word masks of the limb window [0, 16 L): a product's bits at or above limb
// L are dropped, as add_product drops its pieces above limb L-1.
template <int PW>
__device__ __forceinline__ void window_masks(uint32_t (&mask)[PW], int L) {
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    int bits = min(max(16 * L - 32 * j, 0), 32);
    mask[j] = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  }
}

// Enter one exact product into the word register: m = ma * mb at grid offset
// q = ea + eb - lsb, truncated below grid bit 0 (no word below word 0 is
// formed) or RNE, then negated when smask (0 or ~0, the XOR of the operands'
// signs) says so: acc += (v ^ smask) + (sign XOR inc). Window word j is
// bits [32j, 32j + 32) of m * 2^q: m >> (32j - q) where that amount is >= 0,
// (m mod 2^32) << (q - 32j) where it is > 0; each shift gives 0 where the
// other applies, so placement is two shifts and a LOP3 a word, no select.
// MASKED cuts v to the window [0, 16 L) (add_product drops the pieces above
// limb L-1): only a saturating register with L < LC reads those bits (its
// top limb's full 32 bits); a wrapping one keeps bits below W <= 16 L, which
// the bits above never reach.
template <int NW, bool RNE, bool MASKED>
__device__ __forceinline__ void add_product_words(uint32_t (&acc)[NW],
                                                  const uint32_t (&mask)[NW - 1],
                                                  uint32_t ma, uint32_t mb, int q,
                                                  uint32_t smask) {
  constexpr int PW = NW - 1;
  const uint64_t m = (uint64_t)ma * (uint64_t)mb;  // < 2^48
  const uint32_t lo = (uint32_t)m;
  uint32_t x[NW];
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    uint32_t v = shr64_lo(m, 32 * j - q) | shl32(lo, q - 32 * j);
    if (MASKED) v &= mask[j];
    x[j] = v ^ smask;
  }
  x[PW] = smask;
  uint32_t c = smask;
  if (RNE) c ^= 0u - rne_increment(m, q);
  add_words<NW>(acc, x, c);
}

// The word register as normalized limbs for to_float: limbs 0..L-2 are its
// 16-bit digits, limb L-1 the 32 bits from 16 (L-1) (the full signed
// remainder, wrapped), limbs past L zero.
template <int LC>
__device__ __forceinline__ void words_to_limbs(const uint32_t (&acc)[LC / 2 + 1], int L,
                                               uint32_t (&limb)[LC]) {
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    const uint32_t w0 = acc[l >> 1];
    const uint32_t digit = (l & 1) ? w0 >> 16 : w0 & LIMB_MASK;
    const uint32_t top = (l & 1) ? __funnelshift_r(w0, acc[(l >> 1) + 1], 16) : w0;
    limb[l] = l < L - 1 ? digit : l == L - 1 ? top : 0u;
  }
}

}  // namespace fdp
