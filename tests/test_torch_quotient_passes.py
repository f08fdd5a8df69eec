"""The prover's quotient, one group of sub-cosets at a time.

`plonk/prover.py` evaluates the quotient in passes of b consecutive
sub-cosets of the extended coset (b n about QUOTIENT_CHUNK rows): each
pass transforms the per-proof columns to its own sub-cosets with size-n
NTTs, and only h is held at the extended size.  Here, on the CPU:
  * the k=5 DemoCircuit's proof (permutation, rotations, a permuted
    lookup) equals the reference's golden bytes with b = 1, 2 and R (one
    pass), and with b = 1 walked in windows of n / 2 rows, its
    commitments computed by the host MSM over Python ints
    (crypto/curve.py::host_msm: the same points as the plain MSM, in a
    fraction of its time);
  * the Copy golden's circuit (logUps of several inputs) proved with a
    stand-in for the commitments gives the same bytes at each of those,
    and its h has the degree the constraints allow (the coefficients above
    it are zero), which a wrong value on any extended point would break;
  * a spy on poly/ntt.py sees every forward transform at size n and one
    inverse at n_ext, h's;
  * the sliced logUp inversion equals the stacked one.
The slow tier proves the Copy golden for real at b = 1 and 2 against its
sha256."""

import hashlib

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.curve import (G1, g1_from_affine_ints,
                                                   g1_to_affine_ints, host_msm)
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo, prover
from zkevm_circuits_tpu_torch.plonk.keygen import keygen, quotient_degree
from zkevm_circuits_tpu_torch.poly import ntt as ntt_mod
from zkevm_circuits_tpu_torch.poly.kzg import Srs

F = fr()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file's proofs, restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _host_commitments(srs: Srs) -> Srs:
    """`srs` whose commitments come from the host MSM over Python ints
    (the same points as the plain MSM), memoised by the bytes of their
    input, so a later proof of the same columns reuses them."""
    powers = g1_to_affine_ints(srs.g1_powers)
    seen = {}

    def commit_many(cols):
        key = cols.contiguous().numpy().tobytes()
        if key not in seen:
            seen[key] = [host_msm(powers[:cols.shape[-2]], F.to_ints(F.from_mont(c)))
                         for c in cols]
        return seen[key]

    srs.commit_many = commit_many
    srs.commit_points = lambda cols: g1_from_affine_ints(  # noqa: E731
        commit_many(cols), device="cpu")
    return srs


def _stand_in_commitments(srs: Srs) -> Srs:
    """`srs` whose commitments are all the generator: the transcript stays
    deterministic and no MSM runs (the proof is not a valid one)."""
    gen = g1_to_affine_ints(G1(*(c[:1] for c in srs.g1_powers)))[0]
    srs.commit_many = lambda cols: [gen] * cols.shape[0]  # noqa: E731
    srs.commit_points = lambda cols: G1(*(  # noqa: E731
        c[:1].expand(cols.shape[0], 32).clone() for c in srs.g1_powers))
    return srs


# QUOTIENT_CHUNK values by name: b = 1, 2 or R (every sub-coset in one
# pass) sub-cosets a pass, or b = 1 walked in windows of n / 2 rows (as a
# sub-coset above QUOTIENT_CHUNK rows is)
CHUNKS = {"b=1": lambda n, n_ext: n, "b=2": lambda n, n_ext: 2 * n,
          "b=R": lambda n, n_ext: n_ext, "windows": lambda n, n_ext: n // 2}


def _chunk(pk, name: str) -> int:
    return CHUNKS[name](pk.n, 1 << pk.k_ext)


class Spy:
    """Records (function, shape) of every call to poly/ntt.py's public
    transforms, as the prover or anyone else reaches them, and keeps the
    output of each inverse at the extended size."""

    def __init__(self, monkeypatch):
        self.calls, self.ext_outputs = [], []
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            fn = getattr(ntt_mod, name)
            spy = self._wrap(name, fn)
            monkeypatch.setattr(ntt_mod, name, spy)
            if hasattr(prover, name):
                monkeypatch.setattr(prover, name, spy)

    def _wrap(self, name, fn):
        def spy(x, k=None):
            self.calls.append((name, tuple(x.shape)))
            out = fn(x, k)
            if name == "coset_intt":
                self.ext_outputs.append(out)
            return out

        return spy


@pytest.fixture(scope="module")
def demo_keys():
    srs = _host_commitments(
        Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu"))
    pk, _ = keygen(demo.DemoCircuit(), demo.K, srs, device="cpu")
    return srs, pk


def _demo_proof(demo_keys, chunk, monkeypatch):
    srs, pk = demo_keys
    monkeypatch.setattr(prover, "QUOTIENT_CHUNK", _chunk(pk, chunk))
    return prover.prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                        rng=np.random.default_rng(demo.GOLDEN_SEED), device="cpu")


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_demo_proof_equals_golden_at_every_pass_size(demo_keys, chunk, monkeypatch):
    pk = demo_keys[1]
    assert (1 << pk.k_ext) // pk.n >= 4, "the demo must have several sub-cosets"
    proof = _demo_proof(demo_keys, chunk, monkeypatch)
    assert len(proof) == demo.GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.GOLDEN_SHA256


def _assert_low_degree(h_coeffs, pk):
    """h = C / (X^n - 1) has degree below (d - 1) n for constraints of
    degree d: its higher coefficients are zero."""
    d = quotient_degree(pk.vk.cs)
    top = h_coeffs[(d - 1) * pk.n:]
    assert top.numel() and not top.any(), (d, pk.n, h_coeffs.shape)
    assert h_coeffs[:(d - 1) * pk.n].any()


def test_no_per_proof_column_is_transformed_at_the_extended_size(
        demo_keys, monkeypatch):
    """Every transform inside prove is at size n, but one inverse at
    n_ext: h's, into coefficients of the degree the constraints allow."""
    pk = demo_keys[1]
    n, n_ext = pk.n, 1 << pk.k_ext
    spy = Spy(monkeypatch)
    proof = _demo_proof(demo_keys, "b=1", monkeypatch)
    assert hashlib.sha256(proof).hexdigest() == demo.GOLDEN_SHA256
    at_ext = [c for c in spy.calls if c[1][-2] != n]
    assert at_ext == [("coset_intt", (n_ext, 32))], at_ext
    assert {name for name, _ in spy.calls} == {"ntt", "intt", "coset_intt"}
    assert any(name == "ntt" and len(shape) == 4 for name, shape in spy.calls)
    _assert_low_degree(spy.ext_outputs[0], pk)


@pytest.fixture(scope="module")
def copy_keys():
    k, _, _ = demo.PARTNER_GOLDENS["copy"]
    srs = _stand_in_commitments(
        Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu"))
    pk, _ = keygen(demo.partner_golden("copy"), k, srs, device="cpu")
    cs = pk.vk.cs
    assert max(len(lg.inputs) for lg in cs.logups) >= 2
    return srs, pk


@pytest.fixture(scope="module")
def copy_baseline(copy_keys):
    """The stand-in proof at one pass per sub-coset, and its h."""
    srs, pk = copy_keys
    mp = pytest.MonkeyPatch()
    try:
        spy = Spy(mp)
        mp.setattr(prover, "QUOTIENT_CHUNK", _chunk(pk, "b=1"))
        proof = prover.prove(pk, demo.partner_golden("copy"), [], srs,
                             rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                             device="cpu")
    finally:
        mp.undo()
    return proof, spy.ext_outputs[0]


def test_copy_quotient_has_the_constraints_degree(copy_keys, copy_baseline):
    _assert_low_degree(copy_baseline[1], copy_keys[1])


@pytest.mark.parametrize("chunk", ["b=2", "b=R", "windows"])
def test_copy_proof_bytes_do_not_depend_on_the_pass_size(
        copy_keys, copy_baseline, chunk, monkeypatch):
    srs, pk = copy_keys
    assert (1 << pk.k_ext) // pk.n > 2
    monkeypatch.setattr(prover, "QUOTIENT_CHUNK", _chunk(pk, chunk))
    proof = prover.prove(pk, demo.partner_golden("copy"), [], srs,
                         rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                         device="cpu")
    assert proof == copy_baseline[0]


@pytest.mark.parametrize("inputs,slice_", [(7, 3), (7, 1), (4, 64)])
def test_sliced_logup_inversion_equals_the_stacked_one(inputs, slice_, monkeypatch):
    """1 / (a + beta) on the usable rows, 0 elsewhere (and 0 for a zero
    denominator), slice by slice as one batch inversion of the whole
    stack."""
    rng = np.random.default_rng(inputs * 100 + slice_)
    n, u = 16, 12
    vals = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
            for _ in range(inputs)]
    beta = int.from_bytes(rng.bytes(32), "little") % R
    vals[1][3] = (R - beta) % R  # a + beta = 0 on one row
    a = torch.as_tensor(np.stack([F.from_ints([v * F.R % R for v in col])
                                  for col in vals]))
    beta_m = F.scalar(beta, "cpu")
    row_lt_u = torch.arange(n) < u
    stacked = F.select(row_lt_u, F.batch_inv(F.add(a, beta_m), axis=1),
                       F.zeros((n,), "cpu"))
    monkeypatch.setattr(prover, "LOGUP_INV_SLICE", slice_)
    got = prover._logup_inverses(a, beta_m, row_lt_u)
    assert torch.equal(got, stacked)
    want = [[pow(v + beta, -1, R) * F.R % R if i < u and (v + beta) % R else 0
             for i, v in enumerate(col)] for col in vals]
    assert [F.to_ints(c) for c in got] == want


@pytest.mark.slow
@pytest.mark.parametrize("chunk", ["b=1", "b=2"])
def test_copy_golden_at_pass_size(chunk, monkeypatch):
    """The Copy golden's real proof (about two minutes at 2 threads)."""
    k, sha, length = demo.PARTNER_GOLDENS["copy"]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    pk, _ = keygen(demo.partner_golden("copy"), k, srs, device="cpu")
    monkeypatch.setattr(prover, "QUOTIENT_CHUNK", _chunk(pk, chunk))
    proof = prover.prove(pk, demo.partner_golden("copy"), [], srs,
                         rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                         device="cpu")
    assert len(proof) == length
    assert hashlib.sha256(proof).hexdigest() == sha

