// BN254 field arithmetic shared by the port's Hopper kernels.
//
// A field element is 32 little-endian bytes, which on the card are read in
// place as four u64 limbs (the (..., 32) uint8 layout of the Python side).
// Values are Montgomery residues with R = 2^256.  Every function here takes
// canonical inputs (< p) and returns canonical outputs.
//
// The multiply is CIOS over 4 x u64 limbs with __umul64hi: 16 limb
// products for a*b, 16 for m*p and 4 for the m's, all in registers.  Both
// BN254 moduli are < 2^254, so the running sum stays below 2p and one
// conditional subtraction makes the result canonical.
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
// Montgomery one: 2^256 mod p
static __constant__ uint64_t ONE_MONT[2][4] = {
    {0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL, 0x666ea36f7879462eULL,
     0x0e0a77c19a07df2fULL},
    {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL,
     0x0e0a77c19a07df2fULL},
};

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

// Montgomery product a * b * 2^-256 mod p (CIOS)
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

__device__ __forceinline__ bool fe_is_zero(const Fe &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe &a, const Fe &b) {
  return c ? a : b;
}

__device__ __forceinline__ Fe fe_one_mont(int f) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.v[j] = ONE_MONT[f][j];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.v[j] = 0;
  return r;
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

}  // namespace bn254
