"""The kernels' device arithmetic compiled for the host with a C++
compiler, against Python integers and the plain versions of K5 and K6,
exact bytes: the 8 x u32 Montgomery arithmetic of csrc/bn254.cuh over Fr
and Fq, K1's row (csrc/field.cu, with either operand broadcast), the
curve kernels' add and double (csrc/curve.cu) and field_add_sub's row
(bn254.cuh fe_add_sub over 16-byte row access).

The PTX carry-chain primitives (namespace cc in bn254.cuh) are replaced by
C++ that keeps the carry flag in a variable, with the semantics of the
PTX instructions they wrap: add.cc/sub.cc write the flag, addc/subc/madc
read it, the .cc forms write it again.  A read of the flag after a form
that does not write it aborts, so a chain that relies on a flag it did not
set fails here.  Everything else is the kernels' own source, so the word
order, the even/odd chains, REDC, the squaring and the select ladder run
as they do on the card; only the kernels' launch and indexing wrappers are
left out.  Skips without a C++ compiler.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.crypto.curve import G1
from zkevm_circuits_tpu_torch.crypto.field import fq
from zkevm_circuits_tpu_torch.crypto.params import FQ_MODULUS, FR_MODULUS
from zkevm_circuits_tpu_torch.ops import cuda_curve as cc
from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

CSRC = os.path.join(os.path.dirname(__file__), "..", "zkevm_circuits_tpu_torch", "csrc")
R = 1 << 256

_PRELUDE = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#define __device__
#define __forceinline__ inline
#define __constant__
static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
static inline bool __any_sync(unsigned, bool p) { return p; }
struct ulonglong2 { unsigned long long x, y; };
static inline ulonglong2 make_ulonglong2(unsigned long long x, unsigned long long y) {
  return ulonglong2{x, y};
}
template <class T> static inline T __ldg(const T *p) { return *p; }
"""

_CARRY = r"""
namespace cc {
static uint32_t CF = 2;  // 2: not written by the last flag-writing form
static inline uint32_t cf() {
  if (CF > 1) { fprintf(stderr, "carry flag read before it was set\n"); abort(); }
  return CF;
}
static inline uint32_t put(uint64_t s) { CF = (uint32_t)(s >> 32); return (uint32_t)s; }
static inline uint32_t end(uint64_t s) { CF = 2; return (uint32_t)s; }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b + cf()); }
inline uint32_t addc(uint32_t a, uint32_t b) { return end((uint64_t)a + b + cf()); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r = a - b; CF = a < b; return r;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + cf(); uint32_t r = (uint32_t)(a - s); CF = a < s; return r;
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + cf(); CF = 2; return (uint32_t)(a - s);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)(uint32_t)((uint64_t)a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)(uint32_t)((uint64_t)a * b) + c + cf());
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((((uint64_t)a * b) >> 32) + c + cf());
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint64_t s = (((uint64_t)a * b) >> 32) + c + cf();
  if (s >> 32) { fprintf(stderr, "carry out of madc.hi lost\n"); abort(); }
  return end(s);
}
}  // namespace cc
"""

_ENTRY = r"""
extern "C" void k1_rows(int field, const uint64_t *a, const uint64_t *b,
                        uint64_t *o, long n, int abc, int bbc) {
  for (long i = 0; i < n; i++) {
    if (field == 0) mont_mul_row<FrField>(a, b, o, i, abc, bbc);
    else mont_mul_row<FqField>(a, b, o, i, abc, bbc);
  }
}
extern "C" void fq_rows(int op, const uint64_t *a, const uint64_t *b,
                        uint64_t *o, long n) {
  for (long i = 0; i < n; i++) {
    const Fq32 x = fq_load(a, i), y = fq_load(b, i);
    fq_store(o, i, op == 0 ? fq_mul(x, y) : op == 1 ? fq_sqr(x)
                          : op == 2 ? fq_add(x, y) : fq_sub(x, y));
  }
}
extern "C" void fe_rows(int op, int f, const uint64_t *a, const uint64_t *b,
                        uint64_t *o, long n) {
  for (long i = 0; i < n; i++) {
    const Fe x = fe_load2(a, i);
    fe_store2(o, i, fe_add_sub(op, x, op == OP_NEG ? x : fe_load2(b, i), f));
  }
}
extern "C" void add_rows_host(int mode, const uint64_t *const *p,
                              const uint64_t *const *q, uint64_t *const *o,
                              const long *pi, const long *qi, long n) {
  for (long i = 0; i < n; i++) {
    bool live = pi[i] >= 0;
    long r = live ? pi[i] : 0;
    if (mode == 0)
      add_rows<0>(p[0], p[1], p[2], r, q[0], q[1], q[2], qi[i], o[0], o[1], o[2], r, live);
    else if (mode == 1)
      add_rows<1>(p[0], p[1], p[2], r, q[0], q[1], q[2], qi[i], o[0], o[1], o[2], r, live);
    else
      add_rows<2>(p[0], p[1], p[2], r, q[0], q[1], q[2], qi[i], o[0], o[1], o[2], r, live);
  }
}
extern "C" void double_rows(const uint64_t *const *p, uint64_t *const *o,
                            long n, int times) {
  for (long i = 0; i < n; i++) {
    Pt x = load_pt(p[0], p[1], p[2], i);
    for (int k = 0; k < times; k++) x = dbl(x);
    store_pt(o[0], o[1], o[2], i, x);
  }
}
"""


def _host_source() -> str:
    hdr = open(os.path.join(CSRC, "bn254.cuh")).read()
    a, b = hdr.index("namespace cc {"), hdr.index("}  // namespace cc")
    hdr = hdr[:a] + _CARRY + hdr[b + len("}  // namespace cc"):]
    dev = ""
    for name, end in (("curve.cu", "template <int MODE>\n__global__"),
                      ("field.cu", "template <class F>\n__global__")):
        cu = open(os.path.join(CSRC, name)).read()
        ns = name[:-3]
        dev += (cu[cu.index("namespace {"):cu.index(end)].replace(
            "namespace {", f"namespace {ns} {{", 1) + f"}}  // namespace {ns}\n"
            + f"using namespace {ns};\n")
    return (_PRELUDE + hdr.replace("#pragma once", "") + "using namespace bn254;\n"
            + dev + _ENTRY)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    src, so = d / "curve_host.cpp", d / "curve_host.so"
    src.write_text(_host_source())
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _ptrs(arrs) -> ctypes.Array:
    return (ctypes.c_void_p * 3)(*(a.ctypes.data for a in arrs))


def _rand_fq(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % FQ_MODULUS for _ in range(n)]
    vals[:6] = [0, 1, FQ_MODULUS - 1, FQ_MODULUS - 2, (1 << 255) % FQ_MODULUS, R % FQ_MODULUS]
    return vals


def _u8(vals) -> np.ndarray:
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])


_FQ_OPS = {
    "mul": (0, lambda x, y: x * y * pow(R, -1, FQ_MODULUS) % FQ_MODULUS),
    "sqr": (1, lambda x, y: x * x * pow(R, -1, FQ_MODULUS) % FQ_MODULUS),
    "add": (2, lambda x, y: (x + y) % FQ_MODULUS),
    "sub": (3, lambda x, y: (x - y) % FQ_MODULUS),
}


@pytest.mark.parametrize("op", list(_FQ_OPS))
def test_fq32_matches_python_ints(lib, op):
    code, fn = _FQ_OPS[op]
    x, y = _rand_fq(1, 500), _rand_fq(2, 500)[::-1]
    a, b = _u8(x), _u8(y)
    out = np.zeros_like(a)
    lib.fq_rows(code, _ptr(a), _ptr(b), _ptr(out), ctypes.c_long(len(x)))
    got = [int.from_bytes(r.tobytes(), "little") for r in out]
    assert got == [fn(u, v) for u, v in zip(x, y)]


def _k1_values(p: int, seed: int, n: int) -> list[int]:
    """n seeded values below p, led by 0, 1, p - 1 and values whose low
    words are all 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    edge = [0, 1, p - 1, (1 << 253) - 1, (1 << 224) - 1, (p >> 128 << 128) - 1,
            (p >> 32 << 32) - 1, (1 << 32) - 1]
    vals[:len(edge)] = edge
    return vals


@pytest.mark.parametrize("field", [0, 1])
@pytest.mark.parametrize("bcast", ["rows", "a_row", "b_row"])
def test_k1_product_matches_python_ints(lib, bcast, field):
    """K1's row over Fr and Fq against Python ints: row against row on 10^4
    seeded pairs, led by (0, 0), (1, 1), (p - 1, p - 1) and words of
    0xFFFFFFFF against each of them; or a (a_row) or b (b_row) one
    broadcast row (p - 1, 1, and a seeded value) against 1, 7 and 301
    rows."""
    p = FR_MODULUS if field == 0 else FQ_MODULUS
    rinv = pow(R, -1, p)
    x, y = _k1_values(p, 50 + field, 10_000), _k1_values(p, 60 + field, 10_000)
    edge = x[:8]
    x[8:8 + 64] = [u for u in edge for _ in edge]
    y[8:8 + 64] = [v for _ in edge for v in edge]

    def run(xs, ys, abc, bbc, n):
        a, b = _u8(xs), _u8(ys)
        out = np.zeros((n, 32), np.uint8)
        lib.k1_rows(field, _ptr(a), _ptr(b), _ptr(out), ctypes.c_long(n), abc, bbc)
        return [int.from_bytes(r.tobytes(), "little") for r in out]

    if bcast == "rows":
        assert run(x, y, 0, 0, len(x)) == [u * v * rinv % p for u, v in zip(x, y)]
        return
    for n in (1, 7, 301):
        for s in (p - 1, 1, x[5000]):
            if bcast == "a_row":
                assert run([s], y[:n], 1, 0, n) == [s * v * rinv % p for v in y[:n]]
            else:
                assert run(x[:n], [s], 0, 1, n) == [u * s * rinv % p for u in x[:n]]


_FE_OPS = {"add": (0, lambda x, y, p: (x + y) % p),
           "sub": (1, lambda x, y, p: (x - y) % p),
           "neg": (2, lambda x, y, p: -x % p)}


@pytest.mark.parametrize("field", [0, 1])
@pytest.mark.parametrize("op", list(_FE_OPS))
def test_field_add_sub_row_matches_python_ints(lib, op, field):
    """field_add_sub's row (csrc/field.cu: fe_load2, bn254.cuh fe_add_sub,
    fe_store2) over Fr or Fq, with 0, 1, p - 1, pairs summing to p and
    equal pairs among the rows."""
    p = FR_MODULUS if field == 0 else FQ_MODULUS
    code, fn = _FE_OPS[op]
    rng = np.random.default_rng(30 + field)
    x = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(300)]
    y = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(300)]
    x[:4], y[:4] = [0, 1, p - 1, 0], [0, p - 1, 1, p - 1]
    y[10:20] = [(p - v) % p for v in x[10:20]]
    y[20:30] = x[20:30]
    a, b = _u8(x), _u8(y)
    out = np.zeros_like(a)
    lib.fe_rows(code, field, _ptr(a), _ptr(b), _ptr(out), ctypes.c_long(len(x)))
    got = [int.from_bytes(r.tobytes(), "little") for r in out]
    assert got == [fn(u, v, p) for u, v in zip(x, y)]


def _jacobian(n, seed):
    """n seeded SRS points moved to random Jacobian representatives."""
    Q = fq()
    p = srs_g1_powers(n, seed, "cpu")
    z = torch.as_tensor(_u8([v * R % FQ_MODULUS for v in _rand_fq(seed, n + 6)[6:]]))
    z2 = Q.mul(z, z)
    return G1(Q.mul(p.x, z2), Q.mul(p.y, Q.mul(z2, z)), z), p


def _add_case(mode, n=64):
    Q = fq()
    (pj, pa), (qj, qa) = _jacobian(n, 40), _jacobian(n, 41)
    if mode == "affine":
        p, q = [c.clone() for c in pa], [c.clone() for c in qa]
    else:
        p, q = [c.clone() for c in pj], [c.clone() for c in qj]
    p[2][0] = 0  # P at infinity
    q[2][1] = 0  # Q at infinity
    p[2][2], q[2][2] = 0, 0  # both
    if mode == "complete":
        for cp, cq in zip(p, q):
            cq[3] = cp[3]  # P = Q
        q[0][4], q[2][4] = p[0][4], p[2][4]
        q[1][4] = Q.neg(p[1][4])  # P = -Q
    return [c.contiguous().numpy() for c in p], [c.contiguous().numpy() for c in q]


@pytest.mark.parametrize("mode", ["complete", "incomplete", "affine"])
def test_k5_device_code_matches_plain(lib, mode):
    p, q = _add_case(mode)
    n = p[0].shape[0]
    out = [np.zeros_like(c) for c in p]
    idx = np.arange(n, dtype=np.int64)
    lib.add_rows_host(["complete", "incomplete", "affine"].index(mode), _ptrs(p),
                      _ptrs(q), _ptrs(out), _ptr(idx), _ptr(idx), ctypes.c_long(n))
    want = cc.g1_add_plain(*(torch.as_tensor(c) for c in (*p, *q)), mode=mode)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(out, want))


def test_k5_bucket_step_device_code_matches_plain(lib):
    """The bucket form's row add in place (the bucket is both operand and
    output), digit-0 rows not live: two steps, the second adding each
    point to a bucket that holds it (the doubling)."""
    c, lanes, n_win, n_buck = 2, 4, 3, 8
    pts, _ = _jacobian(lanes, 42)
    pts = [t.contiguous().numpy() for t in pts]
    rng = np.random.default_rng(43)
    dig = rng.integers(0, n_buck, size=(c, lanes, n_win), dtype=np.uint8)
    dig[0, 1] = 0
    inf = [fq().ones_mont((c, lanes, n_win, n_buck), "cpu"),
           fq().ones_mont((c, lanes, n_win, n_buck), "cpu"),
           torch.zeros((c, lanes, n_win, n_buck, 32), dtype=torch.uint8)]
    got = [t.numpy().copy() for t in inf]
    want = [t.clone() for t in inf]
    t = np.arange(c * lanes * n_win)
    rows = np.where(dig.reshape(-1) != 0, t * n_buck + dig.reshape(-1), -1).astype(np.int64)
    lane = ((t // n_win) % lanes).astype(np.int64)
    for _ in range(2):
        lib.add_rows_host(0, _ptrs(got), _ptrs(pts), _ptrs(got), _ptr(rows), _ptr(lane),
                          ctypes.c_long(t.size))
        cc.g1_bucket_add_plain(*want, torch.as_tensor(dig), *(torch.as_tensor(p) for p in pts))
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


@pytest.mark.parametrize("times", [1, 3, 8])
def test_k6_device_code_matches_plain(lib, times):
    p, _ = _jacobian(40, 44)
    p = [c.clone() for c in p]
    p[0][:2], p[1][:2] = fq().ones_mont((2,), "cpu"), fq().ones_mont((2,), "cpu")
    p[2][:4] = 0  # infinity: (1, 1, 0) and random (x, y, 0)
    p = [c.contiguous().numpy() for c in p]
    out = [np.zeros_like(c) for c in p]
    lib.double_rows(_ptrs(p), _ptrs(out), ctypes.c_long(p[0].shape[0]), times)
    want = cc.g1_double_plain(*(torch.as_tensor(c) for c in p), times=times)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(out, want))
