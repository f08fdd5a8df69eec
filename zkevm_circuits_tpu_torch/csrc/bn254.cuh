// BN254 field arithmetic shared by the port's Hopper kernels.
//
// A field element is 32 little-endian bytes, which on the card are read in
// place as four u64 limbs (the (..., 32) uint8 layout of the Python side).
// Values are Montgomery residues with R = 2^256.  Every function here takes
// canonical inputs (< p) and returns canonical outputs.
//
// The field kernels' u64 helpers below (adc, sbb, mac, fe_add, fe_sub,
// cond_sub_p, fe_mul) serve K3's REDC, K4's butterfly and field_add_sub's
// add and subtract.  The other Montgomery products (K1, K2, K5, K6) are
// the 8 x u32 form at the end of this file, on the integer pipe's carry
// chains, instantiated once for each field.
#pragma once
#include <cstdint>

namespace bn254 {

// field selector, as passed by the Python wrappers
constexpr int FIELD_FR = 0;
constexpr int FIELD_FQ = 1;

static __constant__ uint64_t P_LIMBS[2][4] = {
    {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL, 0xb85045b68181585dULL,
     0x30644e72e131a029ULL},
    {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL,
     0x30644e72e131a029ULL},
};
// -p^-1 mod 2^64
static __constant__ uint64_t NP0[2] = {0xc2e1f593efffffffULL,
                                       0x87d20782e4866389ULL};

struct Fe {
  uint64_t v[4];
};

// low 64 bits of a*b + c + carry; carry <- high 64 bits (no overflow:
// (2^64-1)^2 + 2(2^64-1) = 2^128 - 1)
__device__ __forceinline__ uint64_t mac(uint64_t a, uint64_t b, uint64_t c,
                                        uint64_t &carry) {
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  lo += c;
  hi += (lo < c);
  lo += carry;
  hi += (lo < carry);
  carry = hi;
  return lo;
}

__device__ __forceinline__ uint64_t adc(uint64_t a, uint64_t b,
                                        uint64_t &carry) {
  uint64_t s = a + b;
  uint64_t c1 = (s < a);
  uint64_t s2 = s + carry;
  uint64_t c2 = (s2 < s);
  carry = c1 | c2;
  return s2;
}

__device__ __forceinline__ uint64_t sbb(uint64_t a, uint64_t b,
                                        uint64_t &borrow) {
  uint64_t d = a - b;
  uint64_t b1 = (a < b);
  uint64_t d2 = d - borrow;
  uint64_t b2 = (d < borrow);
  borrow = b1 | b2;
  return d2;
}

// x < 2p -> x mod p
__device__ __forceinline__ Fe cond_sub_p(const Fe &x, int f) {
  Fe s;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) s.v[j] = sbb(x.v[j], P_LIMBS[f][j], borrow);
  return borrow ? x : s;
}

__device__ __forceinline__ Fe fe_add(const Fe &a, const Fe &b, int f) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) s.v[j] = adc(a.v[j], b.v[j], carry);
  return cond_sub_p(s, f);  // a + b < 2p < 2^255: no carry out
}

__device__ __forceinline__ Fe fe_sub(const Fe &a, const Fe &b, int f) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) d.v[j] = sbb(a.v[j], b.v[j], borrow);
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) d.v[j] = adc(d.v[j], P_LIMBS[f][j], carry);
  }
  return d;
}

// Montgomery product a * b * 2^-256 mod p, CIOS over u64 limbs (K4 only:
// its stages measured slower on the 8 x u32 product)
__device__ __forceinline__ Fe fe_mul(const Fe &a, const Fe &b, int f) {
  const uint64_t p0 = P_LIMBS[f][0], p1 = P_LIMBS[f][1], p2 = P_LIMBS[f][2],
                 p3 = P_LIMBS[f][3];
  const uint64_t np0 = NP0[f];
  uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint64_t bi = b.v[i];
    uint64_t c = 0;
    t0 = mac(a.v[0], bi, t0, c);
    t1 = mac(a.v[1], bi, t1, c);
    t2 = mac(a.v[2], bi, t2, c);
    t3 = mac(a.v[3], bi, t3, c);
    t4 += c;
    uint64_t t5 = (t4 < c);
    const uint64_t m = t0 * np0;
    c = 0;
    (void)mac(m, p0, t0, c);  // low word is zero by construction
    t0 = mac(m, p1, t1, c);
    t1 = mac(m, p2, t2, c);
    t2 = mac(m, p3, t3, c);
    t3 = t4 + c;
    t4 = t5 + (t3 < c);
  }
  Fe r;
  r.v[0] = t0;
  r.v[1] = t1;
  r.v[2] = t2;
  r.v[3] = t3;
  return cond_sub_p(r, f);  // t < 2p < 2^255, so t4 == 0 here
}

__device__ __forceinline__ Fe fe_load(const uint64_t *p, int64_t row) {
  Fe r;
  const uint64_t *q = p + 4 * row;
#pragma unroll
  for (int j = 0; j < 4; j++) r.v[j] = q[j];
  return r;
}

__device__ __forceinline__ void fe_store(uint64_t *p, int64_t row,
                                         const Fe &a) {
  uint64_t *q = p + 4 * row;
#pragma unroll
  for (int j = 0; j < 4; j++) q[j] = a.v[j];
}

// The same rows as two 16-byte vector accesses each (the row must be 16-byte
// aligned): neighbouring threads take neighbouring rows, so a warp moves its
// 1 KB in two instructions; the read goes through the read-only path
// (ld.global.nc.v2.u64).
__device__ __forceinline__ Fe fe_load2(const uint64_t *p, int64_t row) {
  const ulonglong2 *q = reinterpret_cast<const ulonglong2 *>(p) + 2 * row;
  const ulonglong2 lo = __ldg(q), hi = __ldg(q + 1);
  Fe r;
  r.v[0] = lo.x;
  r.v[1] = lo.y;
  r.v[2] = hi.x;
  r.v[3] = hi.y;
  return r;
}

__device__ __forceinline__ void fe_store2(uint64_t *p, int64_t row,
                                          const Fe &a) {
  ulonglong2 *q = reinterpret_cast<ulonglong2 *>(p) + 2 * row;
  q[0] = make_ulonglong2(a.v[0], a.v[1]);
  q[1] = make_ulonglong2(a.v[2], a.v[3]);
}

// the field kernels' add, subtract and negate, by op code
constexpr int OP_ADD = 0;  // a + b
constexpr int OP_SUB = 1;  // a - b
constexpr int OP_NEG = 2;  // -a, b unread (0 maps to 0)

__device__ __forceinline__ Fe fe_add_sub(int op, const Fe &a, const Fe &b,
                                         int f) {
  if (op == OP_ADD) return fe_add(a, b, f);
  if (op == OP_SUB) return fe_sub(a, b, f);
  const Fe zero = {{0, 0, 0, 0}};
  return fe_sub(zero, a, f);  // 0 - a borrows, and adds p, unless a = 0
}

// ---------------------------------------------------------------------------
// Fr and Fq over 8 x u32 words on the integer pipe's carry chains
// ---------------------------------------------------------------------------
// The same 32-byte rows, read in place as eight little-endian u32 words.
// A 32 x 32-bit partial product is two instructions, mad.lo and madc.hi,
// that add into the accumulator word with the carry flag: no carry is
// recovered by a compare and no 64 x 64-bit product is emulated.
//
// A row of a product (a * b_i into columns i..i+8) is two carry chains: one
// over the even words of a, whose low and high halves fill the consecutive
// columns i..i+7, and one over the odd words, columns i+1..i+8.  Each chain
// ends in a single carry word, so no carry has to ripple through the
// columns above it.  A squaring computes the 28 cross products a_i a_j
// (i < j) once, doubles them with one add chain and adds the 8 squares
// a_i^2 with one more.  Both leave the 512-bit t = a * b in 16 words, which
// REDC reduces a word at a time (m = t_0 * -p^-1 mod 2^32; t += m p;
// t >>= 32), again with an even and an odd chain, bringing in the next high
// word of t as the window slides.  Operands < p give t < p^2, so REDC ends
// below 2p and one conditional subtraction makes the result canonical.
//
// Instruction counts: a product is 128 + 128 multiply halves plus 8 for the
// m's (264); a squaring 56 + 16 + 128 + 8 (208).
//
// K1 and K2 take Fr or Fq as FrField or FqField (a template argument:
// one kernel instance a field); K5 and K6 take Fq through the fq_*
// wrappers.
//
// The carry flag lives between the asm statements below: each is volatile,
// so the compiler keeps their order, and nothing between two of them in a
// chain writes the flag.
namespace cc {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo(a * b) + c, carry out
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
// lo(a * b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a * b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a * b) + c + carry
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace cc

// A field as compile-time words: the modulus p (P0..P7, little-endian) and
// -p^-1 mod 2^32 (NP0).  The functions below are templates over it, so one
// kernel instance serves one field and nothing is chosen per element.
struct FrField {
  static constexpr uint32_t P0 = 0xf0000001u, P1 = 0x43e1f593u,
                            P2 = 0x79b97091u, P3 = 0x2833e848u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t NP0 = 0xefffffffu;
};
struct FqField {
  static constexpr uint32_t P0 = 0xd87cfd47u, P1 = 0x3c208c16u,
                            P2 = 0x6871ca8du, P3 = 0x97816a91u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t NP0 = 0xe4866389u;
};
// the eight words F::X0..F::X7 as an array initialiser
#define BN254_WORDS(F, X)                                                \
  {F::X##0, F::X##1, F::X##2, F::X##3, F::X##4, F::X##5, F::X##6, F::X##7}

struct Fe32 {
  uint32_t w[8];
};
using Fq32 = Fe32;

// Fq's 2^256 mod p (Montgomery 1) as u32 words
constexpr uint32_t FQ_ONE0 = 0xc58f0d9du, FQ_ONE1 = 0xd35d438du,
                   FQ_ONE2 = 0xf5c70b3du, FQ_ONE3 = 0x0a78eb28u,
                   FQ_ONE4 = 0x7879462cu, FQ_ONE5 = 0x666ea36fu,
                   FQ_ONE6 = 0x9a07df2fu, FQ_ONE7 = 0x0e0a77c1u;

// x < 2p -> x mod p
template <class F>
__device__ __forceinline__ Fe32 reduce_once32(const Fe32 &x) {
  const uint32_t p[8] = BN254_WORDS(F, P);
  Fe32 s;
  s.w[0] = cc::sub_cc(x.w[0], p[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) s.w[j] = cc::subc_cc(x.w[j], p[j]);
  const uint32_t borrow = cc::subc(0u, 0u);  // all ones if x < p
#pragma unroll
  for (int j = 0; j < 8; j++) s.w[j] = borrow ? x.w[j] : s.w[j];
  return s;
}

template <class F>
__device__ __forceinline__ Fe32 add32(const Fe32 &a, const Fe32 &b) {
  Fe32 s;
  s.w[0] = cc::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) s.w[j] = cc::addc_cc(a.w[j], b.w[j]);
  s.w[7] = cc::addc(a.w[7], b.w[7]);  // a + b < 2p < 2^255: no carry out
  return reduce_once32<F>(s);
}

template <class F>
__device__ __forceinline__ Fe32 sub32(const Fe32 &a, const Fe32 &b) {
  const uint32_t p[8] = BN254_WORDS(F, P);
  Fe32 d;
  d.w[0] = cc::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d.w[j] = cc::subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = cc::subc(0u, 0u);  // all ones if a < b: add p back
  d.w[0] = cc::add_cc(d.w[0], p[0] & mask);
#pragma unroll
  for (int j = 1; j < 7; j++) d.w[j] = cc::addc_cc(d.w[j], p[j] & mask);
  d.w[7] = cc::addc(d.w[7], p[7] & mask);
  return d;
}

// t[0..15] (a 512-bit value < p^2) -> t * 2^-256 mod p
template <class F>
__device__ __forceinline__ Fe32 redc32(const uint32_t t[16]) {
  const uint32_t p[8] = BN254_WORDS(F, P);
  // u = u[0..7] + u8 2^256 is the window: after step i it holds
  // (t mod 2^(256 + 32 (i + 1)) + M_i p) / 2^(32 (i + 1)) < 2^257
  uint32_t u[8], u8 = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) u[j] = t[j];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t m = u[0] * F::NP0;
    // even words of p: columns 0..7, carry into u8
    u[0] = cc::mad_lo_cc(m, p[0], u[0]);
    u[1] = cc::madc_hi_cc(m, p[0], u[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      u[j] = cc::madc_lo_cc(m, p[j], u[j]);
      u[j + 1] = cc::madc_hi_cc(m, p[j], u[j + 1]);
    }
    u8 = cc::addc(u8, 0u);
    // odd words of p: columns 1..8 (u + m p < 2^287: no carry out of u8)
    u[1] = cc::mad_lo_cc(m, p[1], u[1]);
    u[2] = cc::madc_hi_cc(m, p[1], u[2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      u[j] = cc::madc_lo_cc(m, p[j], u[j]);
      u[j + 1] = cc::madc_hi_cc(m, p[j], u[j + 1]);
    }
    u[7] = cc::madc_lo_cc(m, p[7], u[7]);
    u8 = cc::madc_hi(m, p[7], u8);
    // u[0] is 0: shift down a word and bring in t[8 + i]
#pragma unroll
    for (int j = 0; j < 7; j++) u[j] = u[j + 1];
    u[7] = cc::add_cc(u8, t[8 + i]);
    u8 = cc::addc(0u, 0u);
  }
  Fe32 r;  // < 2p < 2^255, so u8 is 0 here
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = u[j];
  return reduce_once32<F>(r);
}

// Montgomery product a * b * 2^-256 mod p
template <class F>
__device__ __forceinline__ Fe32 mul32(const Fe32 &a, const Fe32 &b) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; j++) t[j] = 0;
  // row i adds a * b_i into columns i..i+8; after it, t < 2^(32 (i + 9)),
  // so column i + 8 is still 0 when the row starts and nothing carries
  // out of it
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b.w[i];
    t[i] = cc::mad_lo_cc(a.w[0], bi, t[i]);
    t[i + 1] = cc::madc_hi_cc(a.w[0], bi, t[i + 1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      t[i + j] = cc::madc_lo_cc(a.w[j], bi, t[i + j]);
      t[i + j + 1] = cc::madc_hi_cc(a.w[j], bi, t[i + j + 1]);
    }
    t[i + 8] = cc::addc(0u, 0u);
    t[i + 1] = cc::mad_lo_cc(a.w[1], bi, t[i + 1]);
    t[i + 2] = cc::madc_hi_cc(a.w[1], bi, t[i + 2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      t[i + j] = cc::madc_lo_cc(a.w[j], bi, t[i + j]);
      t[i + j + 1] = cc::madc_hi_cc(a.w[j], bi, t[i + j + 1]);
    }
    t[i + 7] = cc::madc_lo_cc(a.w[7], bi, t[i + 7]);
    t[i + 8] = cc::madc_hi(a.w[7], bi, t[i + 8]);
  }
  return redc32<F>(t);
}

// Montgomery square a^2 * 2^-256 mod p
template <class F>
__device__ __forceinline__ Fe32 sqr32(const Fe32 &a) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; j++) t[j] = 0;
  // cross products: row i adds a_i * a_j (j > i) into columns 2i+1..i+8;
  // after it, t < 2^(32 (i + 9)), so column i + 8 is 0 when it starts
#pragma unroll
  for (int i = 0; i < 7; i++) {
    const uint32_t ai = a.w[i];
    // chain over j = i+1, i+3, ...: columns 2i+1 .. i+j_last+1
    t[2 * i + 1] = cc::mad_lo_cc(a.w[i + 1], ai, t[2 * i + 1]);
    t[2 * i + 2] = cc::madc_hi_cc(a.w[i + 1], ai, t[2 * i + 2]);
#pragma unroll
    for (int j = i + 3; j < 8; j += 2) {
      t[i + j] = cc::madc_lo_cc(a.w[j], ai, t[i + j]);
      t[i + j + 1] = cc::madc_hi_cc(a.w[j], ai, t[i + j + 1]);
    }
    if ((7 - i) % 2 == 0) t[i + 8] = cc::addc(0u, 0u);  // ended at i + 7
    // chain over j = i+2, i+4, ...: columns 2i+2 .. i+j_last+1
    if (i + 2 < 8) {
      t[2 * i + 2] = cc::mad_lo_cc(a.w[i + 2], ai, t[2 * i + 2]);
      t[2 * i + 3] = cc::madc_hi_cc(a.w[i + 2], ai, t[2 * i + 3]);
#pragma unroll
      for (int j = i + 4; j < 8; j += 2) {
        t[i + j] = cc::madc_lo_cc(a.w[j], ai, t[i + j]);
        t[i + j + 1] = cc::madc_hi_cc(a.w[j], ai, t[i + j + 1]);
      }
      if ((7 - i) % 2 == 1) t[i + 8] = cc::addc(t[i + 8], 0u);  // ended at i + 7
    }
  }
  // double the cross products (2 sum < a^2 < 2^512: no carry out)
  t[0] = cc::add_cc(t[0], t[0]);
#pragma unroll
  for (int j = 1; j < 15; j++) t[j] = cc::addc_cc(t[j], t[j]);
  t[15] = cc::addc(t[15], t[15]);
  // add the squares a_i^2 into columns 2i, 2i+1
  t[0] = cc::mad_lo_cc(a.w[0], a.w[0], t[0]);
  t[1] = cc::madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; i++) {
    t[2 * i] = cc::madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = cc::madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[14] = cc::madc_lo_cc(a.w[7], a.w[7], t[14]);
  t[15] = cc::madc_hi(a.w[7], a.w[7], t[15]);
  return redc32<F>(t);
}

// the curve kernels' Fq (K5, K6)
__device__ __forceinline__ Fq32 fq_add(const Fq32 &a, const Fq32 &b) {
  return add32<FqField>(a, b);
}
__device__ __forceinline__ Fq32 fq_sub(const Fq32 &a, const Fq32 &b) {
  return sub32<FqField>(a, b);
}
__device__ __forceinline__ Fq32 fq_mul(const Fq32 &a, const Fq32 &b) {
  return mul32<FqField>(a, b);
}
__device__ __forceinline__ Fq32 fq_sqr(const Fq32 &a) {
  return sqr32<FqField>(a);
}

__device__ __forceinline__ bool fq_is_zero(const Fq32 &a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3] | a.w[4] | a.w[5] | a.w[6] |
          a.w[7]) == 0;
}

__device__ __forceinline__ Fq32 fq_one_mont() {
  return Fq32{{FQ_ONE0, FQ_ONE1, FQ_ONE2, FQ_ONE3, FQ_ONE4, FQ_ONE5, FQ_ONE6,
               FQ_ONE7}};
}

__device__ __forceinline__ Fq32 fq_zero() {
  return Fq32{{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
}

// the four u64 limbs of a row as its eight u32 words, and back: a u64 is
// a pair of 32-bit registers, so these move nothing
__device__ __forceinline__ Fe32 to32(const Fe &x) {
  Fe32 r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    r.w[2 * j] = static_cast<uint32_t>(x.v[j]);
    r.w[2 * j + 1] = static_cast<uint32_t>(x.v[j] >> 32);
  }
  return r;
}

__device__ __forceinline__ Fe from32(const Fe32 &x) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++)
    r.v[j] = static_cast<uint64_t>(x.w[2 * j]) |
             (static_cast<uint64_t>(x.w[2 * j + 1]) << 32);
  return r;
}

// row `row` of a (..., 32) u8 tensor, read as four u64 loads
__device__ __forceinline__ Fq32 fq_load(const uint64_t *p, int64_t row) {
  Fq32 r;
  const uint64_t *q = p + 4 * row;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const uint64_t v = q[j];
    r.w[2 * j] = static_cast<uint32_t>(v);
    r.w[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  }
  return r;
}

__device__ __forceinline__ void fq_store(uint64_t *p, int64_t row,
                                         const Fq32 &a) {
  uint64_t *q = p + 4 * row;
#pragma unroll
  for (int j = 0; j < 4; j++)
    q[j] = static_cast<uint64_t>(a.w[2 * j]) |
           (static_cast<uint64_t>(a.w[2 * j + 1]) << 32);
}

}  // namespace bn254
