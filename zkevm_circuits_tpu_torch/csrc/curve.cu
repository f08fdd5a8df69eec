// K5: BN254 G1 Jacobian addition over Fq (a = 0), three modes, and
// K6: BN254 G1 Jacobian doubling over Fq (a = 0).
//
// K5 replaces zkevm_circuits_tpu/ops/pallas_curve.py::g1_add_fused
// (_add_kernel / _add_kernel_incomplete / _add_kernel_affine).
//
//   mode 0, complete   (23 muls): P = Q, P = -Q and infinity handled
//                      branch-free by the select ladder of
//                      crypto/curve.py::g1_add, whose bytes it reproduces
//                      (P = -Q gives (mont 1, mont 1, 0));
//   mode 1, incomplete (16 muls): no doubling branch, operands distinct or
//                      infinity;
//   mode 2, affine     (6 muls): z in {0, mont(1)}, operands distinct or
//                      infinity.
//
// K6 replaces zkevm_circuits_tpu/ops/pallas_curve.py::g1_double_fused
// (_dbl_kernel): dbl-2009-l, 7 muls, the bytes of crypto/curve.py::
// g1_double; infinity (z = 0) stays z = 0, with x3, y3 as the formula
// gives them.
//
// What bounds them on the H100: one point (pair) per thread.  K5 complete
// reads 192 bytes and writes 96 against 23 Montgomery products (about
// 3,200 32-bit multiply-adds), so it is compute bound on the integer pipes
// once the batch fills the card; K6 reads 96 and writes 96 bytes against 7
// products (about 1,000 multiply-adds), also bound by operations.  At the
// MSM's shapes (16K-point bucket steps for K5, the window Horner's 10
// points for K6) a launch is short and the host's launch rate dominates.
// The design keeps every intermediate of the add and of the doubling in
// registers (the TPU kernel's (B, 63) digit planes become 4-limb values)
// and keeps the TPU kernel's branch-free select ladder: every row computes
// the sum and the doubling, and per-limb selects pick the result.
#include <cstdint>
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int THREADS = 128;
constexpr int F = FIELD_FQ;

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Fe mul(const Fe &a, const Fe &b) {
  return fe_mul(a, b, F);
}
__device__ __forceinline__ Fe add(const Fe &a, const Fe &b) {
  return fe_add(a, b, F);
}
__device__ __forceinline__ Fe sub(const Fe &a, const Fe &b) {
  return fe_sub(a, b, F);
}

// crypto/curve.py::g1_double (dbl-2009-l), infinity stays infinity
__device__ __forceinline__ Pt dbl(const Pt &p) {
  Fe a = mul(p.x, p.x);
  Fe b = mul(p.y, p.y);
  Fe yz = mul(p.y, p.z);
  Fe xb = add(p.x, b);
  Fe e = add(add(a, a), a);
  Fe c = mul(b, b);
  Fe xb2 = mul(xb, xb);
  Fe f = mul(e, e);
  Fe d = sub(sub(xb2, a), c);
  d = add(d, d);
  Pt r;
  r.x = sub(f, add(d, d));
  Fe c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  r.y = sub(mul(e, sub(d, r.x)), c8);
  r.z = add(yz, yz);
  return r;
}

__device__ __forceinline__ Pt sel(bool c, const Pt &a, const Pt &b) {
  return Pt{fe_select(c, a.x, b.x), fe_select(c, a.y, b.y),
            fe_select(c, a.z, b.z)};
}

__device__ Pt add_complete(const Pt &p, const Pt &q) {
  Fe z1z1 = mul(p.z, p.z);
  Fe z2z2 = mul(q.z, q.z);
  Fe u1 = mul(p.x, z2z2);
  Fe u2 = mul(q.x, z1z1);
  Fe s1 = mul(mul(p.y, q.z), z2z2);
  Fe s2 = mul(mul(q.y, p.z), z1z1);
  Fe h = sub(u2, u1);
  Fe r = sub(s2, s1);
  bool h_zero = fe_is_zero(h), r_zero = fe_is_zero(r);
  bool p_inf = fe_is_zero(p.z), q_inf = fe_is_zero(q.z);
  Fe h2 = add(h, h);
  Fe rr = add(r, r);
  Fe zs = add(p.z, q.z);
  Fe i = mul(h2, h2);
  Fe rr2 = mul(rr, rr);
  Fe zs2 = mul(zs, zs);
  Fe j = mul(h, i);
  Fe v = mul(u1, i);
  Pt o;
  o.x = sub(sub(rr2, j), add(v, v));
  Fe s1j = mul(s1, j);
  o.y = sub(mul(rr, sub(v, o.x)), add(s1j, s1j));
  o.z = mul(sub(sub(zs2, z1z1), z2z2), h);
  // select ladder of crypto/curve.py::g1_add (later selects win); the
  // doubling is computed for every row, as in the TPU kernel
  Pt d = dbl(p);
  bool same = h_zero && r_zero && !p_inf && !q_inf;
  bool oppo = h_zero && !r_zero && !p_inf && !q_inf;
  o = sel(same, d, o);
  Pt inf{fe_one_mont(F), fe_one_mont(F), fe_zero()};
  o = sel(oppo, inf, o);
  o = sel(p_inf, q, o);
  return sel(q_inf, p, o);
}

__device__ Pt add_incomplete(const Pt &p, const Pt &q) {
  Fe z1z1 = mul(p.z, p.z);
  Fe z2z2 = mul(q.z, q.z);
  Fe u1 = mul(p.x, z2z2);
  Fe u2 = mul(q.x, z1z1);
  Fe s1 = mul(mul(p.y, q.z), z2z2);
  Fe s2 = mul(mul(q.y, p.z), z1z1);
  Fe h = sub(u2, u1);
  Fe r = sub(s2, s1);
  bool p_inf = fe_is_zero(p.z), q_inf = fe_is_zero(q.z);
  Fe h2 = add(h, h);
  Fe i = mul(h2, h2);
  Fe rr = add(r, r);
  Fe rr2 = mul(rr, rr);
  Fe j = mul(h, i);
  Fe v = mul(u1, i);
  Pt o;
  o.x = sub(sub(rr2, j), add(v, v));
  Fe zs = add(p.z, q.z);
  Fe zs2 = mul(zs, zs);
  o.z = mul(sub(sub(zs2, z1z1), z2z2), h);
  Fe s1j = mul(s1, j);
  o.y = sub(mul(rr, sub(v, o.x)), add(s1j, s1j));
  o = sel(p_inf, q, o);
  return sel(q_inf, p, o);
}

__device__ Pt add_affine(const Pt &p, const Pt &q) {
  Fe h = sub(q.x, p.x);
  Fe r = sub(q.y, p.y);
  bool p_inf = fe_is_zero(p.z), q_inf = fe_is_zero(q.z);
  Fe h2 = add(h, h);
  Fe i = mul(h2, h2);
  Fe rr = add(r, r);
  Fe rr2 = mul(rr, rr);
  Fe j = mul(h, i);
  Fe v = mul(p.x, i);
  Pt o;
  o.x = sub(sub(rr2, j), add(v, v));
  o.z = add(h, h);
  Fe s1j = mul(p.y, j);
  o.y = sub(mul(rr, sub(v, o.x)), add(s1j, s1j));
  o = sel(p_inf, q, o);
  return sel(q_inf, p, o);
}

template <int MODE>
__global__ void g1_add_kernel(const uint64_t *__restrict__ ax,
                              const uint64_t *__restrict__ ay,
                              const uint64_t *__restrict__ az,
                              const uint64_t *__restrict__ bx,
                              const uint64_t *__restrict__ by,
                              const uint64_t *__restrict__ bz,
                              uint64_t *__restrict__ ox,
                              uint64_t *__restrict__ oy,
                              uint64_t *__restrict__ oz, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p{fe_load(ax, i), fe_load(ay, i), fe_load(az, i)};
  Pt q{fe_load(bx, i), fe_load(by, i), fe_load(bz, i)};
  Pt o;
  if (MODE == 0)
    o = add_complete(p, q);
  else if (MODE == 1)
    o = add_incomplete(p, q);
  else
    o = add_affine(p, q);
  fe_store(ox, i, o.x);
  fe_store(oy, i, o.y);
  fe_store(oz, i, o.z);
}

__global__ void g1_double_kernel(const uint64_t *__restrict__ ax,
                                 const uint64_t *__restrict__ ay,
                                 const uint64_t *__restrict__ az,
                                 uint64_t *__restrict__ ox,
                                 uint64_t *__restrict__ oy,
                                 uint64_t *__restrict__ oz, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt o = dbl(Pt{fe_load(ax, i), fe_load(ay, i), fe_load(az, i)});
  fe_store(ox, i, o.x);
  fe_store(oy, i, o.y);
  fe_store(oz, i, o.z);
}

}  // namespace

extern "C" int zk_g1_add(const void *ax, const void *ay, const void *az,
                         const void *bx, const void *by, const void *bz,
                         void *ox, void *oy, void *oz, int64_t n, int mode,
                         void *stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZK_ARGS                                                            \
  static_cast<const uint64_t *>(ax), static_cast<const uint64_t *>(ay),    \
      static_cast<const uint64_t *>(az), static_cast<const uint64_t *>(bx), \
      static_cast<const uint64_t *>(by), static_cast<const uint64_t *>(bz), \
      static_cast<uint64_t *>(ox), static_cast<uint64_t *>(oy),            \
      static_cast<uint64_t *>(oz), n
  if (mode == 0)
    g1_add_kernel<0><<<blocks, THREADS, 0, s>>>(ZK_ARGS);
  else if (mode == 1)
    g1_add_kernel<1><<<blocks, THREADS, 0, s>>>(ZK_ARGS);
  else
    g1_add_kernel<2><<<blocks, THREADS, 0, s>>>(ZK_ARGS);
#undef ZK_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_g1_double(const void *ax, const void *ay, const void *az,
                            void *ox, void *oy, void *oz, int64_t n,
                            void *stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  g1_double_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t *>(ax), static_cast<const uint64_t *>(ay),
      static_cast<const uint64_t *>(az), static_cast<uint64_t *>(ox),
      static_cast<uint64_t *>(oy), static_cast<uint64_t *>(oz), n);
  return static_cast<int>(cudaGetLastError());
}
