"""End-to-end: the port proves the k=5 DemoCircuit on the CPU, byte for
byte the reference's proof (its sha256 is the golden in plonk/demo.py),
and its verifier accepts it and rejects wrong statements.  The slow tier
re-derives the golden from a live JAX proof and crosses keys, proofs and
verifiers between the two packages."""

import hashlib

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.keygen import keygen
from zkevm_circuits_tpu_torch.plonk.prover import prove
from zkevm_circuits_tpu_torch.plonk.verifier import verify
from zkevm_circuits_tpu_torch.poly.kzg import Srs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_keys():
    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device="cpu")
    return srs, pk, vk


@pytest.fixture(scope="module")
def port_proof(port_keys):
    srs, pk, _ = port_keys
    return prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                 rng=np.random.default_rng(demo.GOLDEN_SEED), device="cpu")


def test_demo_proof_matches_golden(port_proof):
    assert len(port_proof) == demo.GOLDEN_LEN
    assert hashlib.sha256(port_proof).hexdigest() == demo.GOLDEN_SHA256


def test_verifier_accepts(port_keys, port_proof):
    assert verify(port_keys[2], [[demo.A_IN]], port_proof)


def test_verifier_rejects_wrong_instance(port_keys, port_proof):
    assert not verify(port_keys[2], [[demo.A_IN + 1]], port_proof)


def test_corrupt_witness_rejected(port_keys):
    srs, pk, vk = port_keys
    proof = prove(pk, demo.DemoCircuit(corrupt_row=5), [[demo.A_IN]], srs,
                  rng=np.random.default_rng(1), device="cpu")
    assert not verify(vk, [[demo.A_IN]], proof)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Srs.unsafe_setup(2, tau=5)


# ---------------------------------------------------------------------------
# slow tier: live cross-checks with the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_side():
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_plonk_prove import DemoCircuit as JDemo
    from zkevm_circuits_tpu.plonk.keygen import keygen as jkeygen
    from zkevm_circuits_tpu.poly.kzg import Srs as JSrs

    srs = JSrs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU)
    pk, vk = jkeygen(JDemo(), demo.K, srs)
    return JDemo, srs, pk, vk


@pytest.mark.slow
def test_live_jax_proof_equals_port(jax_side, port_proof):
    from zkevm_circuits_tpu.plonk.prover import prove as jprove

    JDemo, srs, pk, _ = jax_side
    ref = jprove(pk, JDemo(), [[demo.A_IN]], srs,
                 rng=np.random.default_rng(demo.GOLDEN_SEED))
    assert hashlib.sha256(ref).hexdigest() == demo.GOLDEN_SHA256
    assert ref == port_proof


@pytest.mark.slow
def test_jax_verifier_accepts_port_proof(jax_side, port_keys, port_proof):
    from zkevm_circuits_tpu.plonk.verifier import verify as jverify

    _, _, _, jvk = jax_side
    assert jverify(jvk, [[demo.A_IN]], port_proof)
    assert verify(port_keys[2], [[demo.A_IN]], port_proof)


@pytest.mark.slow
def test_keygen_agrees_field_by_field(jax_side, port_keys):
    from zkevm_circuits_tpu_torch.convert import PK_ARRAYS, proving_key_from_numpy

    _, jsrs, jpk, jvk = jax_side
    srs, pk, vk = port_keys
    for name in PK_ARRAYS:
        assert np.array_equal(np.asarray(getattr(jpk, name)),
                              getattr(pk, name).numpy()), name
    assert vk.fixed_commitments == jvk.fixed_commitments
    assert vk.sigma_commitments == jvk.sigma_commitments
    assert pk.k_ext == jpk.k_ext and pk.delta_pows == jpk.delta_pows
    conv = proving_key_from_numpy(
        demo.DemoCircuit(), demo.K,
        {name: np.asarray(getattr(jpk, name)) for name in PK_ARRAYS},
        {"fixed_commitments": jvk.fixed_commitments,
         "sigma_commitments": jvk.sigma_commitments,
         "g2": jvk.g2, "s_g2": jvk.s_g2},
        jpk.delta_pows, device="cpu")
    proof = prove(conv, demo.DemoCircuit(), [[demo.A_IN]], srs,
                  rng=np.random.default_rng(demo.GOLDEN_SEED), device="cpu")
    assert hashlib.sha256(proof).hexdigest() == demo.GOLDEN_SHA256


@pytest.mark.slow
def test_state_k8_proof_byte_identical():
    from zkevm_circuits_tpu.circuits.state import StateCircuit as JState
    from zkevm_circuits_tpu.circuits.state import StateParams as JParams
    from zkevm_circuits_tpu.plonk.keygen import keygen as jkeygen
    from zkevm_circuits_tpu.plonk.prover import prove as jprove
    from zkevm_circuits_tpu.poly.kzg import Srs as JSrs
    from zkevm_circuits_tpu.service.bench_circuits import synthetic_rw_workload
    from zkevm_circuits_tpu_torch.circuits.state import StateCircuit, StateParams
    from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
    from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

    k = 8
    small = dict(limb_bits=4, id_bits=8, addr_bits=16, key_bits=16, rwc_bits=8)
    payload = usable_rows(1 << k) - 8
    jsrs = JSrs.unsafe_setup(k, tau=0xBE2C4)
    jc = JState(synthetic_rw_workload(payload), JParams(**small))
    jpk, _ = jkeygen(jc, k, jsrs)
    ref = jprove(jpk, jc, [], jsrs, rng=np.random.default_rng(7))
    srs = Srs.unsafe_setup(k, tau=0xBE2C4, device="cpu")
    tcirc = StateCircuit(tbench.synthetic_rw_workload(payload), StateParams(**small))
    pk, vk = keygen(tcirc, k, srs, device="cpu")
    proof = prove(pk, tcirc, [], srs, rng=np.random.default_rng(7), device="cpu")
    assert proof == ref
    assert verify(vk, [], proof)


def _reference_multiplicities(t_u, a_us, n):
    """The reference prover's multiplicity mapping (plonk/prover.py, the
    logUp section), over numpy digit rows."""
    u = t_u.shape[0]
    uniq, inv = np.unique(np.concatenate([t_u] + a_us, axis=0), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)
    first_idx = np.full(uniq.shape[0], n, np.int64)
    np.minimum.at(first_idx, inv[:u], np.arange(u))
    mapped = first_idx[inv[u:]]
    assert not (mapped >= n).any()
    return np.bincount(mapped, minlength=n)


@pytest.mark.parametrize("seed", range(3))
def test_logup_multiplicities_match_reference_mapping(seed):
    from zkevm_circuits_tpu_torch.plonk.prover import _logup_multiplicities

    rng = np.random.default_rng(seed)
    n, u, m = 256, 250, 5
    distinct = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    distinct[0] = 0
    t_u = distinct[rng.integers(0, 40, size=u)]  # repeated table values
    a_us = [distinct[rng.integers(0, 40 if j else 1, size=u)] for j in range(m)]
    got = _logup_multiplicities("t", torch.as_tensor(t_u),
                                torch.as_tensor(np.stack(a_us)), n)
    assert np.array_equal(got.numpy(), _reference_multiplicities(t_u, a_us, n))
    assert int(got.sum()) == m * u
    a_us[3][17] = 7  # a value of no table row
    with pytest.raises(ValueError, match="input value not in table"):
        _logup_multiplicities("t", torch.as_tensor(t_u),
                              torch.as_tensor(np.stack(a_us)), n)


def test_sum_rows_is_the_field_sum():
    from zkevm_circuits_tpu_torch.plonk.prover import _sum_rows

    F = fr()
    rng = np.random.default_rng(4)
    for m in (1, 2, 5, 8):
        vals = [[int(rng.integers(0, 1 << 62)) * (R // (1 << 62)) % R
                 for _ in range(6)] for _ in range(m)]
        x = torch.as_tensor(np.stack([F.from_ints(v) for v in vals]))
        want = [sum(col) % R for col in zip(*vals)]
        assert F.to_ints(_sum_rows(x)) == want
