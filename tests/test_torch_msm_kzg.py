"""Port MSM, SRS, commitments, transcript and SHPLONK against the JAX
package and the host-int oracle, exact bytes (MSM results in affine)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.crypto import curve as jc
from zkevm_circuits_tpu.crypto.field import fr as jfr
from zkevm_circuits_tpu.crypto.params import FR_MODULUS, to_digits
from zkevm_circuits_tpu.poly import kzg as jkzg
from zkevm_circuits_tpu.poly import msm as jmsm
from zkevm_circuits_tpu.poly import transcript as jtr
from zkevm_circuits_tpu_torch.convert import srs_from_numpy
from zkevm_circuits_tpu_torch.crypto import curve as tc
from zkevm_circuits_tpu_torch.poly import kzg as tkzg
from zkevm_circuits_tpu_torch.poly import msm as tmsm
from zkevm_circuits_tpu_torch.poly import transcript as ttr

torch.set_num_threads(2)
K = 5
TAU = 987654321


@pytest.fixture(scope="module")
def srs_pair():
    return (jkzg.Srs.unsafe_setup(K, tau=TAU),
            tkzg.Srs.unsafe_setup(K, tau=TAU, device="cpu"))


def _coeffs(seed, shape):
    F = jfr()
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % F.modulus for _ in range(n)]
    return F.from_ints(vals).reshape(*shape, 32)


def test_srs_powers_bit_identical(srs_pair):
    js, ts = srs_pair
    for a, b in zip(js.g1_powers, ts.g1_powers):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert ts.g2 == js.g2 and ts.s_g2 == js.s_g2


@pytest.mark.parametrize("n", [1, 7, 64])
def test_msm_matches_host_msm(n):
    rng = np.random.default_rng(n)
    scal = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    scal[0] = 0
    aff = [jc.host_g1_mul(jc.G1_GEN, int.from_bytes(rng.bytes(16), "little"))
           for _ in range(n)]
    if n > 2:
        aff[1] = None
        aff[2] = aff[min(3, n - 1)]  # a repeated point
    pts = tc.g1_from_affine_ints(aff, device="cpu")
    digits = torch.as_tensor(np.array([list(s.to_bytes(32, "little")) for s in scal],
                                      np.uint8))
    got = tmsm.msm(pts, digits)
    got_aff = tc.g1_to_affine_ints(tc.G1(*(c[None] for c in got)))[0]
    assert got_aff == jc.host_msm(aff, scal)


SPARSE_N = 12  # one JAX msm shape, compiled once for every case


def _sparse_case(kind):
    """SPARSE_N affine points and scalars: all 0 or 1, or random with about
    half their bytes zero (one scalar 0, one with a single nonzero byte)."""
    rng = np.random.default_rng(17)
    aff = [jc.host_g1_mul(jc.G1_GEN, int.from_bytes(rng.bytes(16), "little"))
           for _ in range(SPARSE_N)]
    if kind == "zero_one":
        scal = [int(b) for b in rng.integers(0, 2, SPARSE_N)]
    else:
        raw = rng.integers(0, 256, size=(SPARSE_N, 32), dtype=np.uint8)
        raw *= rng.integers(0, 2, size=(SPARSE_N, 32), dtype=np.uint8)
        raw[0] = 0
        raw[1] = 0
        raw[1, 7] = 0x5A
        scal = [int.from_bytes(r.tobytes(), "little") % FR_MODULUS for r in raw]
    return aff, scal


def _digits(scal):
    return np.array([list(s.to_bytes(32, "little")) for s in scal], np.uint8)


@pytest.mark.parametrize("kind", ["zero_one", "zero_bytes"])
def test_msm_on_sparse_scalars_matches_jax_and_host(kind):
    """Digit-0 rows add nothing in the port's bucket steps: sums over 0/1
    scalars and scalars with zero bytes equal the JAX msm and host_msm."""
    aff, scal = _sparse_case(kind)
    want = jc.host_msm(aff, scal)
    jpts = jc.g1_from_affine_ints(aff)
    jsc = jnp.asarray(np.array([to_digits(v) for v in scal], np.uint8))
    jout = jmsm.msm(jpts, jsc)
    assert jc.g1_to_affine_ints(jax.tree.map(lambda x: x[None], jout))[0] == want
    pts = tc.g1_from_affine_ints(aff, device="cpu")
    got = tmsm.msm(pts, torch.as_tensor(_digits(scal)))
    assert tc.g1_to_affine_ints(tc.G1(*(c[None] for c in got)))[0] == want


def test_msm_many_on_sparse_scalar_stack():
    """One bucket pass over a (3, n) stack: the two sparse cases and a
    column of zeros."""
    aff, s01 = _sparse_case("zero_one")
    _, szb = _sparse_case("zero_bytes")
    stack = np.stack([_digits(s01), _digits(szb), _digits([0] * SPARSE_N)])
    pts = tc.g1_from_affine_ints(aff, device="cpu")
    got = tc.g1_to_affine_ints(tmsm.msm_many(pts, torch.as_tensor(stack)))
    assert got == [jc.host_msm(aff, s01), jc.host_msm(aff, szb), None]


def test_srs_from_numpy(srs_pair):
    js, ts = srs_pair
    conv = srs_from_numpy(K, *(np.asarray(c) for c in js.g1_powers), js.g2,
                          js.s_g2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(conv.g1_powers, ts.g1_powers))
    assert conv.k == K and conv.s_g2 == js.s_g2


def _host_affine(srs):
    """Affine ints of an SRS in the affine layout (z = mont(1))."""
    Fq = jc.F
    rinv = pow(Fq.R, -1, Fq.modulus)
    xs, ys = (Fq.to_ints(np.asarray(c)) for c in srs.g1_powers[:2])
    return [(x * rinv % Fq.modulus, y * rinv % Fq.modulus) for x, y in zip(xs, ys)]


def test_commit_many_matches_host_msm(srs_pair):
    js, ts = srs_pair
    F = jfr()
    cols = _coeffs(1, (2, 1 << K))
    cols[1, 5:] = 0
    got = ts.commit_many(torch.as_tensor(cols))
    rinv = pow(F.R, -1, F.modulus)
    powers = _host_affine(js)
    for c, pt in zip(cols, got):
        scal = [v * rinv % F.modulus for v in F.to_ints(c)]
        assert pt == jc.host_msm(powers, scal)
    assert ts.commit_affine(torch.as_tensor(cols[1])) == got[1]


def test_eval_batch_matches_reference_horner():
    F = jfr()
    cols = _coeffs(2, (3, 16))
    x = 0x1234567890ABCDEF
    rinv = pow(F.R, -1, F.modulus)
    want = [jkzg.host_eval_poly([v * rinv % F.modulus for v in F.to_ints(c)], x)
            for c in cols]
    assert tkzg.eval_batch(torch.as_tensor(cols), x) == want


def test_blake2b_transcript_bytes_and_challenges():
    seq = [("scalar", 5), ("point", (1, 2)), ("squeeze", None),
           ("point", None), ("scalar", 2**250 + 7), ("squeeze", None)]
    outs = []
    for mod in (jtr, ttr):
        t = mod.Blake2bTranscript()
        ch = []
        for kind, v in seq:
            if kind == "scalar":
                t.write_scalar(v)
            elif kind == "point":
                t.write_point(v)
            else:
                ch.append(t.squeeze_challenge())
        outs.append((bytes(t.proof), ch))
    assert outs[0] == outs[1]
    rd = ttr.Blake2bReader(outs[1][0])
    assert rd.read_scalar() == 5 and rd.read_point() == (1, 2)
    assert rd.squeeze_challenge() == outs[1][1][0]


def test_shplonk_open_verify_round_trip(srs_pair):
    _, ts = srs_pair
    F = jfr()
    polys = [torch.as_tensor(c) for c in _coeffs(3, (2, 1 << K))]
    pts = [11, 22]
    comms = ts.commit_many(torch.stack(polys))
    claims = [(0, pts[0]), (0, pts[1]), (1, pts[0])]
    evals = [tkzg.eval_at(polys[i], p) for i, p in claims]
    # the evaluations are those of the polynomials as host ints
    rinv = pow(F.R, -1, F.modulus)
    c0 = [v * rinv % F.modulus for v in F.to_ints(polys[0].numpy())]
    assert evals[0] == tkzg.host_eval_poly(c0, pts[0])
    tr = ttr.Blake2bTranscript()
    tkzg.shplonk_open(ts, [tkzg.Query(polys[i], p, e, None)
                           for (i, p), e in zip(claims, evals)], tr)
    vq = [tkzg.VerifierQuery(comms[i], p, e, i) for (i, p), e in zip(claims, evals)]
    assert tkzg.shplonk_verify((ts.g2, ts.s_g2), vq, ttr.Blake2bReader(bytes(tr.proof)))
    bad = [tkzg.VerifierQuery(q.commitment, q.point, (q.eval + 1) % F.modulus, q.poly_id)
           for q in vq]
    assert not tkzg.shplonk_verify((ts.g2, ts.s_g2), bad,
                                   ttr.Blake2bReader(bytes(tr.proof)))
