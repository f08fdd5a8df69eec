// K5: BN254 G1 Jacobian addition over Fq (a = 0), three modes and a
// bucket-step form, and
// K6: BN254 G1 Jacobian doubling over Fq (a = 0), repeated k times.
//
// K5 replaces zkevm_circuits_tpu/ops/pallas_curve.py::g1_add_fused
// (_add_kernel / _add_kernel_incomplete / _add_kernel_affine).
//
//   mode 0, complete   (11 products + 5 squarings, and the doubling's 2 + 5
//                      where P = Q): P = Q, P = -Q and infinity resolved as
//                      the select ladder of crypto/curve.py::g1_add, whose
//                      bytes it reproduces (P = -Q gives (mont 1, mont 1, 0));
//   mode 1, incomplete (11 + 5): operands distinct or infinity;
//   mode 2, affine     (4 + 2): z in {0, mont(1)}, operands distinct or
//                      infinity.
//
// The bucket-step form (zk_g1_bucket_add) is what the MSM launches: one
// thread per (column, lane, window) adds the lane's point into the bucket
// its digit selects, in place, with the complete add; digit 0 does nothing.
//
// K6 replaces zkevm_circuits_tpu/ops/pallas_curve.py::g1_double_fused
// (_dbl_kernel): dbl-2009-l (2 products + 5 squarings), the bytes of
// crypto/curve.py::g1_double; infinity (z = 0) stays z = 0, with x3, y3 as
// the formula gives them.  One launch applies it `times` times in registers.
//
// What bounds them on the H100: the integer pipe.  A complete add reads 192
// bytes and writes 96 against about 4,000 32-bit multiply halves, so at any
// batch that fills the card they are bound by operations.  The design:
//   * Fq arithmetic on 8 x u32 words with PTX carry chains and a dedicated
//     squaring (bn254.cuh, Fq32), in place of u64 CIOS whose carries came
//     from compares;
//   * the complete mode's doubling runs only in warps where some row has
//     P = Q (a vote, __any_sync): the TPU kernel's branch-free ladder
//     computed it on every row, and in the MSM's bucket steps such rows
//     practically never occur;
//   * registers: temporaries are ordered so that few field elements are
//     live at once, the infinity selects read the operand row again from
//     memory instead of holding it, and __launch_bounds__ sets the warps an
//     SM holds to hide the latency of the dependent carry chains: 16 for
//     the complete add and the bucket form (128 registers a thread), 20
//     for the doubling (102), 12 for the incomplete and affine adds (168:
//     at 128 they spill).  The contract form and K6 index rows in 32 bits
//     (the entry points refuse 2^31 rows or more, 192 GiB of coordinates),
//     which let ptxas recompute a row's address from the kernel parameter
//     in one wide multiply-add instead of holding it; the bucket form does
//     not spill with 64-bit indices and keeps them;
//   * the MSM's gather -> add -> scatter around each bucket step is one
//     launch that reads and writes the buckets in place (a thread owns a
//     distinct bucket row within a step), and the window Horner's doublings
//     are one launch a window.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int THREADS = 128;
// blocks of THREADS an SM holds: register caps of 128, 168 and 102
constexpr int BLOCKS_ADD = 4, BLOCKS_ADD_LIGHT = 3, BLOCKS_DOUBLE = 5;

struct Pt {
  Fq32 x, y, z;
};

__device__ __forceinline__ Pt load_pt(const uint64_t *x, const uint64_t *y,
                                      const uint64_t *z, int64_t row) {
  return Pt{fq_load(x, row), fq_load(y, row), fq_load(z, row)};
}

__device__ __forceinline__ void store_pt(uint64_t *x, uint64_t *y,
                                         uint64_t *z, int64_t row,
                                         const Pt &p) {
  fq_store(x, row, p.x);
  fq_store(y, row, p.y);
  fq_store(z, row, p.z);
}

// crypto/curve.py::g1_double (dbl-2009-l), infinity stays infinity
__device__ __forceinline__ Pt dbl(const Pt &p) {
  Pt r;
  const Fq32 a = fq_sqr(p.x);  // X^2
  const Fq32 b = fq_sqr(p.y);  // Y^2
  r.z = fq_mul(p.y, p.z);
  r.z = fq_add(r.z, r.z);  // 2 Y Z
  Fq32 d = fq_sqr(fq_add(p.x, b));
  Fq32 c = fq_sqr(b);  // Y^4
  d = fq_sub(fq_sub(d, a), c);
  d = fq_add(d, d);  // 2 ((X + B)^2 - A - C)
  const Fq32 e = fq_add(fq_add(a, a), a);  // 3 X^2
  r.x = fq_sub(fq_sqr(e), fq_add(d, d));
  c = fq_add(c, c);
  c = fq_add(c, c);
  c = fq_add(c, c);  // 8 C
  r.y = fq_sub(fq_mul(e, fq_sub(d, r.x)), c);
  return r;
}

// add-2007-bl without its special cases: 11 products and 5 squarings.
// h = U2 - U1 and r = S2 - S1 come back through h_zero and r_zero.
__device__ __forceinline__ Pt add_jacobian(const Pt &p, const Pt &q,
                                           bool &h_zero, bool &r_zero) {
  const Fq32 z1z1 = fq_sqr(p.z);
  const Fq32 z2z2 = fq_sqr(q.z);
  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2 = 2 Z1 Z2, the factor of Z3 besides H
  Fq32 zz = fq_sub(fq_sub(fq_sqr(fq_add(p.z, q.z)), z1z1), z2z2);
  const Fq32 u1 = fq_mul(p.x, z2z2);
  const Fq32 s1 = fq_mul(fq_mul(p.y, q.z), z2z2);
  const Fq32 h = fq_sub(fq_mul(q.x, z1z1), u1);
  Fq32 r = fq_sub(fq_mul(fq_mul(q.y, p.z), z1z1), s1);
  h_zero = fq_is_zero(h);
  r_zero = fq_is_zero(r);
  Pt o;
  o.z = fq_mul(zz, h);
  const Fq32 i = fq_sqr(fq_add(h, h));
  const Fq32 j = fq_mul(h, i);
  const Fq32 v = fq_mul(u1, i);
  r = fq_add(r, r);
  o.x = fq_sub(fq_sub(fq_sqr(r), j), fq_add(v, v));
  const Fq32 s1j = fq_mul(s1, j);
  o.y = fq_sub(fq_mul(r, fq_sub(v, o.x)), fq_add(s1j, s1j));
  return o;
}

// the affine mode's sum (z = mont(1) on both sides): 4 products, 2 squarings
__device__ __forceinline__ Pt add_affine(const Pt &p, const Pt &q) {
  const Fq32 h = fq_sub(q.x, p.x);
  Fq32 r = fq_sub(q.y, p.y);
  Pt o;
  o.z = fq_add(h, h);
  const Fq32 i = fq_sqr(o.z);
  const Fq32 j = fq_mul(h, i);
  const Fq32 v = fq_mul(p.x, i);
  r = fq_add(r, r);
  o.x = fq_sub(fq_sub(fq_sqr(r), j), fq_add(v, v));
  const Fq32 s1j = fq_mul(p.y, j);
  o.y = fq_sub(fq_mul(r, fq_sub(v, o.x)), fq_add(s1j, s1j));
  return o;
}

// o[oi] = p[pi] + q[qi] in mode MODE.  p may alias o (the bucket form
// updates in place): every read of p comes before the one store.  All 32
// lanes of the warp call it (the complete mode votes); `live` is false on a
// lane with no row, which then reads and writes nothing.
//
// The select ladder of crypto/curve.py::g1_add, later selects winning:
//   same (P = Q, both finite)  -> 2P
//   oppo (P = -Q, both finite) -> (mont 1, mont 1, 0)
//   P at infinity              -> Q
//   Q at infinity              -> P
// The four conditions exclude one another except the last two, so the
// ladder is applied as q_inf ? P : p_inf ? Q : oppo ? inf : same ? 2P : sum.
template <int MODE>
__device__ __forceinline__ void add_rows(
    const uint64_t *px, const uint64_t *py, const uint64_t *pz, int64_t pi,
    const uint64_t *qx, const uint64_t *qy, const uint64_t *qz, int64_t qi,
    uint64_t *ox, uint64_t *oy, uint64_t *oz, int64_t oi, bool live) {
  Pt o;
  bool same = false;
  if (live) {
    bool p_inf, q_inf, h_zero = false, r_zero = false;
    {
      const Pt p = load_pt(px, py, pz, pi);
      const Pt q = load_pt(qx, qy, qz, qi);
      p_inf = fq_is_zero(p.z);
      q_inf = fq_is_zero(q.z);
      o = MODE == 2 ? add_affine(p, q) : add_jacobian(p, q, h_zero, r_zero);
    }
    if (q_inf) {
      o = load_pt(px, py, pz, pi);
    } else if (p_inf) {
      o = load_pt(qx, qy, qz, qi);
    } else if (MODE == 0 && h_zero) {
      if (r_zero)
        same = true;
      else
        o = Pt{fq_one_mont(), fq_one_mont(), fq_zero()};
    }
  }
  if (MODE == 0 && __any_sync(0xffffffffu, same)) {
    // a warp-uniform branch: the doubling runs only where some row needs it
    if (same) o = dbl(load_pt(px, py, pz, pi));
  }
  if (live) store_pt(ox, oy, oz, oi, o);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS,
                                  MODE == 0 ? BLOCKS_ADD : BLOCKS_ADD_LIGHT)
    g1_add_kernel(const uint64_t *__restrict__ ax,
                  const uint64_t *__restrict__ ay,
                  const uint64_t *__restrict__ az,
                  const uint64_t *__restrict__ bx,
                  const uint64_t *__restrict__ by,
                  const uint64_t *__restrict__ bz, uint64_t *__restrict__ ox,
                  uint64_t *__restrict__ oy, uint64_t *__restrict__ oz,
                  uint32_t n) {
  // no early return: every lane of the warp reaches the vote
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  add_rows<MODE>(ax, ay, az, i, bx, by, bz, i, ox, oy, oz, i, i < n);
}

// One bucket step of the MSM.  Thread t = (column, lane, window) of
// `rows` = c * lanes * n_win; buckets are (c, lanes, n_win, n_buck, 32)
// rows per coordinate, digits (c, lanes, n_win) u8, points (lanes, 32).
__global__ void __launch_bounds__(THREADS, BLOCKS_ADD)
    g1_bucket_add_kernel(uint64_t *bx, uint64_t *by, uint64_t *bz,
                         const uint8_t *__restrict__ digits,
                         const uint64_t *__restrict__ px,
                         const uint64_t *__restrict__ py,
                         const uint64_t *__restrict__ pz, int64_t rows,
                         int lanes, int n_win, int n_buck) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int d = t < rows ? digits[t] : 0;
  const int64_t lane = (t / n_win) % lanes;
  const int64_t b = t * n_buck + d;
  add_rows<0>(bx, by, bz, b, px, py, pz, lane, bx, by, bz, b, d != 0);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_DOUBLE)
    g1_double_kernel(const uint64_t *__restrict__ ax,
                     const uint64_t *__restrict__ ay,
                     const uint64_t *__restrict__ az,
                     uint64_t *__restrict__ ox, uint64_t *__restrict__ oy,
                     uint64_t *__restrict__ oz, uint32_t n, int times) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p = load_pt(ax, ay, az, i);
  for (int k = 0; k < times; k++) p = dbl(p);
  store_pt(ox, oy, oz, i, p);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int zk_g1_add(const void *ax, const void *ay, const void *az,
                         const void *bx, const void *by, const void *bz,
                         void *ox, void *oy, void *oz, int64_t n, int mode,
                         void *stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 2 || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZK_ARGS                                                            \
  static_cast<const uint64_t *>(ax), static_cast<const uint64_t *>(ay),    \
      static_cast<const uint64_t *>(az), static_cast<const uint64_t *>(bx), \
      static_cast<const uint64_t *>(by), static_cast<const uint64_t *>(bz), \
      static_cast<uint64_t *>(ox), static_cast<uint64_t *>(oy),            \
      static_cast<uint64_t *>(oz), n
  if (mode == 0)
    g1_add_kernel<0><<<blocks_for(n), THREADS, 0, s>>>(ZK_ARGS);
  else if (mode == 1)
    g1_add_kernel<1><<<blocks_for(n), THREADS, 0, s>>>(ZK_ARGS);
  else
    g1_add_kernel<2><<<blocks_for(n), THREADS, 0, s>>>(ZK_ARGS);
#undef ZK_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_g1_bucket_add(void *bx, void *by, void *bz,
                                const void *digits, const void *px,
                                const void *py, const void *pz, int64_t rows,
                                int lanes, int n_win, int n_buck,
                                void *stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (lanes <= 0 || n_win <= 0 || n_buck <= 0 || n_buck > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  g1_bucket_add_kernel<<<blocks_for(rows), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t *>(bx), static_cast<uint64_t *>(by),
      static_cast<uint64_t *>(bz), static_cast<const uint8_t *>(digits),
      static_cast<const uint64_t *>(px), static_cast<const uint64_t *>(py),
      static_cast<const uint64_t *>(pz), rows, lanes, n_win, n_buck);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_g1_double(const void *ax, const void *ay, const void *az,
                            void *ox, void *oy, void *oz, int64_t n,
                            int times, void *stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (times < 1 || n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  g1_double_kernel<<<blocks_for(n), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t *>(ax), static_cast<const uint64_t *>(ay),
      static_cast<const uint64_t *>(az), static_cast<uint64_t *>(ox),
      static_cast<uint64_t *>(oy), static_cast<uint64_t *>(oz), n, times);
  return static_cast<int>(cudaGetLastError());
}
