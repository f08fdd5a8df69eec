"""Port G1 arithmetic (zkevm_circuits_tpu_torch.crypto.curve and the
plain versions of kernels K5 and K6) against the JAX package and the
host-int oracle, exact bytes.
"""

import jax
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.crypto import curve as jc
from zkevm_circuits_tpu_torch.crypto import curve as tc
from zkevm_circuits_tpu_torch.crypto.params import FQ_MODULUS, FR_MODULUS, G1_GEN
from zkevm_circuits_tpu_torch.ops import cuda_curve as cc

torch.set_num_threads(2)
# one compile each, shared by every case (all cases have ROWS rows)
_jadd = jax.jit(jc.g1_add)
_jdbl = jax.jit(jc.g1_double)
ROWS = 10


def _affine_points(seed, n):
    rng = np.random.default_rng(seed)
    scal = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS for _ in range(n)]
    return [jc.host_g1_mul(G1_GEN, s) for s in scal]


def _jacobian(points, seed):
    """Host-int Jacobian representatives (x z^2, y z^3, z) with random z."""
    rng = np.random.default_rng(seed)
    q = FQ_MODULUS
    out = []
    for p in points:
        z = int.from_bytes(rng.bytes(32), "little") % (q - 1) + 1
        out.append((p[0] * z * z % q, p[1] * z * z * z % q, z))
    return out


def _jac_g1(triples):
    """Host Jacobian int triples -> reference (numpy) G1 batch."""
    F = jc.F
    mont = lambda vals: F.from_ints([v * F.R % F.modulus for v in vals])  # noqa: E731
    return jc.G1(*(mont([t[i] for t in triples]) for i in range(3)))


def _to_t(p):
    return tc.G1(*(torch.as_tensor(np.ascontiguousarray(np.asarray(c))) for c in p))


def _same(jp, tp):
    return all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jp, tp))


def _affine(tp):
    return tc.g1_to_affine_ints(tp)


def _cases(mode):
    """ROWS point pairs that are valid inputs of `mode`."""
    extra = 4 if mode == "complete" else 2
    a = _affine_points(1, ROWS - extra)
    b = _affine_points(2, ROWS - extra)
    if mode == "affine":
        pa = a + [None, a[0]]
        qa = b + [b[1], None]
        return jc.g1_from_affine_ints(pa), jc.g1_from_affine_ints(qa), pa, qa
    pj, qj = _jacobian(a, 3), _jacobian(b, 4)
    p_aff, q_aff = list(a), list(b)
    if mode == "incomplete":
        pj += [(1, 1, 0), pj[0]]
        qj += [qj[1], (1, 1, 0)]
        p_aff += [None, a[0]]
        q_aff += [b[1], None]
    else:
        # P = Q, P = -Q, P = inf, Q = inf
        pj += [pj[0], pj[1], (1, 1, 0), pj[2]]
        qj += [pj[0], (pj[1][0], (-pj[1][1]) % FQ_MODULUS, pj[1][2]), qj[3], (1, 1, 0)]
        p_aff += [a[0], a[1], None, a[2]]
        q_aff += [a[0], (a[1][0], (-a[1][1]) % FQ_MODULUS), b[3], None]
    return _jac_g1(pj), _jac_g1(qj), p_aff, q_aff


@pytest.mark.parametrize("mode", ["complete", "incomplete", "affine"])
def test_k5_plain_matches_reference_and_oracle(mode):
    p, q, p_aff, q_aff = _cases(mode)
    got = tc.G1(*cc.g1_add_plain(*_to_t(p), *_to_t(q), mode=mode))
    assert _same(_jadd(p, q), got)
    want = [jc.host_g1_add(x, y) for x, y in zip(p_aff, q_aff)]
    assert _affine(got) == want


def test_g1_add_routes_cpu_to_plain():
    p, q, _, _ = _cases("complete")
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf

    cf.reset_launches()
    got = tc.g1_add(_to_t(p), _to_t(q))
    assert cf.LAUNCHES["g1_add"] == 0
    assert _same(_jadd(p, q), got)


def test_g1_double_matches_reference():
    a = _affine_points(5, ROWS - 1)
    pj = _jacobian(a, 6) + [(1, 1, 0)]
    p = _jac_g1(pj)
    got = tc.g1_double(_to_t(p))
    assert _same(_jdbl(p), got)
    assert _affine(got) == [jc.host_g1_add(x, x) for x in a] + [None]


def _double_case(rows):
    """`rows` seeded Jacobian points, rows 3 and 7 at infinity: (1, 1, 0)
    and a random (x, y) with z = 0."""
    pj = _jacobian(_affine_points(10, rows), 11)
    pj[3] = (1, 1, 0)
    pj[7] = (pj[7][0], pj[7][1], 0)
    return _jac_g1(pj)


def test_k6_plain_matches_reference_and_fused_kernel():
    from zkevm_circuits_tpu.ops.pallas_curve import g1_double_fused

    p = _double_case(16)  # the fused kernel takes 8-row multiples below 128
    got = tc.G1(*cc.g1_double_plain(*_to_t(p)))
    assert _same(jc.g1_double(p), got)
    assert _same(g1_double_fused(*p, interpret=True), got)
    assert got.z[3].eq(0).all() and got.z[7].eq(0).all()


@pytest.mark.parametrize("times", [1, 3, 8])
def test_k6_plain_times_matches_repeated_reference(times):
    """g1_double_plain(times=k) is k applications of the JAX g1_double,
    rows at infinity included."""
    p = _double_case(ROWS)
    got = tc.G1(*cc.g1_double_plain(*_to_t(p), times=times))
    want = p
    for _ in range(times):
        want = _jdbl(want)
    assert _same(want, got)
    assert got.z[3].eq(0).all() and got.z[7].eq(0).all()
    assert _same(want, tc.g1_double(_to_t(p), times=times))


def _bucket_case(c, lanes, n_win, n_buck, steps):
    """Seeded bucket steps: points (steps, lanes) in the affine layout as
    the SRS gives them, digits (steps, c, lanes, n_win) with zeros, one
    repeated digit across a row's windows, and, in step 1, lane 0's point
    and digits of step 0 again (its buckets then hold P and add P)."""
    aff = _affine_points(12, steps * lanes)
    aff[lanes] = aff[0]
    pts = _to_t(jc.g1_from_affine_ints(aff))
    pts = tc.G1(*(t.reshape(steps, lanes, 32) for t in pts))
    rng = np.random.default_rng(13)
    dig = rng.integers(0, n_buck, size=(steps, c, lanes, n_win), dtype=np.uint8)
    dig[:, 0, 1] = 0
    dig[:, 0, 2] = dig[:, 0, 2, :1]
    dig[:, 1] *= rng.integers(0, 2, size=(steps, lanes, n_win), dtype=np.uint8)
    dig[1, :, 0] = dig[0, :, 0]
    return pts, torch.as_tensor(dig)


def test_bucket_add_plain_matches_gather_add_scatter():
    """K5's bucket form (plain) equals gather -> g1_add_plain -> scatter
    over all rows, on every bucket except bucket 0, which it leaves at
    infinity."""
    c, lanes, n_win, n_buck, steps = 2, 4, 3, 16, 3
    pts, dig = _bucket_case(c, lanes, n_win, n_buck, steps)
    got = tc.g1_infinity((c, lanes, n_win, n_buck), "cpu")
    want = [t.clone() for t in got]
    ci = torch.arange(c)[:, None, None]
    li = torch.arange(lanes)[None, :, None]
    wi = torch.arange(n_win)[None, None, :]
    for s in range(steps):
        tc.g1_bucket_add(got, dig[s], tc.G1(*(t[s] for t in pts)))
        d = dig[s].long()
        cur = [a[ci, li, wi, d] for a in want]
        pt = [t[s][None, :, None, :].expand(c, lanes, n_win, 32) for t in pts]
        for a, o in zip(want, cc.g1_add_plain(*cur, *pt)):
            a[ci, li, wi, d] = o
    assert all(torch.equal(g[..., 1:, :], w[..., 1:, :]) for g, w in zip(got, want))
    inf = tc.g1_infinity((c, lanes, n_win), "cpu")
    assert all(torch.equal(g[..., 0, :], i) for g, i in zip(got, inf))
    # the buckets hold the sums of their points, as group elements
    host = {}
    for s in range(steps):
        for cc_, l, w in np.ndindex(c, lanes, n_win):
            dd = int(dig[s, cc_, l, w])
            if dd:
                key = (cc_, l, w, dd)
                pt = _affine(tc.G1(*(t[s, l][None] for t in pts)))[0]
                host[key] = jc.host_g1_add(host.get(key), pt)
    flat = _affine(tc.G1(*(t.reshape(-1, 32) for t in got)))
    for (cc_, l, w, dd), want_pt in host.items():
        assert flat[((cc_ * lanes + l) * n_win + w) * n_buck + dd] == want_pt


def test_g1_bucket_add_routes_cpu_to_plain():
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf

    pts, dig = _bucket_case(2, 4, 2, 4, 2)
    acc = tc.g1_infinity((2, 4, 2, 4), "cpu")
    cf.reset_launches()
    tc.g1_bucket_add(acc, dig[0], tc.G1(*(t[0] for t in pts)))
    assert cf.LAUNCHES["g1_bucket_add"] == 0 and cf.LAUNCHES["g1_add"] == 0


def test_g1_double_routes_cpu_to_plain():
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf

    p = _double_case(ROWS)
    cf.reset_launches()
    got = tc.g1_double(_to_t(p))
    assert cf.LAUNCHES["g1_double"] == 0
    assert _same(_jdbl(p), got)


def test_g1_scalar_mul_matches_host():
    a = _affine_points(7, 2)
    scal = [5, (1 << 200) + 12345]
    p = _to_t(jc.g1_from_affine_ints(a))
    digits = np.array([list(s.to_bytes(32, "little")) for s in scal], np.uint8)
    got = tc.g1_scalar_mul(p, torch.as_tensor(digits))
    assert _affine(got) == [jc.host_g1_mul(x, s) for x, s in zip(a, scal)]


def test_normalize_neg_select_and_affine_ints():
    a = _affine_points(8, 3)
    pj = _jacobian(a, 9) + [(1, 1, 0)]
    p = _jac_g1(pj)
    tp = _to_t(p)
    assert _affine(tc.g1_normalize(tp)) == a + [None]
    norm = tc.g1_normalize(tp)
    assert torch.equal(norm.z[:3], torch.as_tensor(np.stack([jc.F.ONE_MONT] * 3)))
    assert _same(jc.g1_from_affine_ints(a), tc.G1(*(c[:3] for c in norm)))
    neg = tc.g1_neg(tp)
    assert _affine(neg) == [(x, (-y) % FQ_MODULUS) for x, y in a] + [None]
    cond = torch.as_tensor([True, False, True, False])
    sel = tc.g1_select(cond, tp, neg)
    assert _affine(sel) == [a[0], _affine(neg)[1], a[2], None]
    assert _affine(tp) == a + [None]
    back = tc.g1_from_affine_ints(a + [None], device="cpu")
    assert _same(jc.g1_from_affine_ints(a + [None]), back)
