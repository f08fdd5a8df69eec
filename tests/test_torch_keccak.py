"""Port Keccak (zkevm_circuits_tpu_torch.crypto.keccak and
circuits.keccak) against the JAX package: the plain permutation and hash,
the circuit's constraint system at every packing, and its fixed and
witness columns, exact bytes, on seeded inputs.  The slow tier proves
KeccakCircuit([b"abc"]) at k=9 on the CPU against the golden sha256 of
the reference's proof (plonk/demo.py); with the plain versions of the
kernels its 658-column commitments take hours there (the card holds the
same golden in tests/test_torch_gpu.py and chip_smoke.py)."""

import hashlib

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.circuits import keccak as jk
from zkevm_circuits_tpu.crypto import keccak as jkh
from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
from zkevm_circuits_tpu.plonk.circuit import assemble_fixed as j_fixed
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.plonk.mock import mock_challenges as j_chal
from zkevm_circuits_tpu_torch.circuits import keccak as tk
from zkevm_circuits_tpu_torch.crypto import keccak as tkh
from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem as TCS
from zkevm_circuits_tpu_torch.plonk.circuit import assemble_fixed as t_fixed
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.plonk.mock import mock_challenges as t_chal

torch.set_num_threads(2)


def _rand_state(rng):
    return [[int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
             for _ in range(5)] for _ in range(5)]


def test_constants_match_reference():
    assert tkh.RC == jkh.RC
    assert tkh.ROTC == jkh.ROTC
    assert tkh.EMPTY_HASH == jkh.EMPTY_HASH == tkh.keccak256(b"")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keccak_f_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        st = _rand_state(rng)
        assert tkh.keccak_f(st) == jkh.keccak_f(st)
    zero = [[0] * 5 for _ in range(5)]
    assert tkh.keccak_f(zero)[0][0] == 0xF1258F7940E1DDE7


@pytest.mark.parametrize("length", [0, 135, 136, 137, 272])
def test_keccak256_matches_reference(length):
    msg = np.random.default_rng(length).bytes(length)
    assert tkh.keccak256(msg) == jkh._keccak256_py(msg) == jkh.keccak256(msg)
    assert tkh.keccak256_int(msg) == jkh.keccak256_int(msg)


def test_keccak256_batch_matches_reference():
    msgs = [np.random.default_rng(i).bytes(40 * i) for i in range(5)]
    assert tkh.keccak256_batch(msgs) == jkh.keccak256_batch(msgs)


def _both(msgs, z):
    jc, tc = jk.KeccakCircuit(msgs, z), tk.KeccakCircuit(msgs, z)
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    return jc, jcs, tc, tcs


@pytest.mark.parametrize("z", [1, 2, 4, 8])
def test_constraint_system_matches_reference(z):
    _, jcs, _, tcs = _both([b"abc"], z)
    assert tcs.num_advice == jcs.num_advice
    assert tcs.advice_phases == jcs.advice_phases
    assert tcs.num_fixed == jcs.num_fixed
    assert tcs.challenge_phases == jcs.challenge_phases
    assert [g.name for g in tcs.gates] == [g.name for g in jcs.gates]
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert tqd(tcs) == jqd(jcs)
    if z == 8:
        assert (tcs.num_advice, tcs.num_fixed) == (658, 21)
        assert sum(len(g.polys) for g in tcs.gates) == 1716
        assert tk.ROWS_PER_PERM == jk.ROWS_PER_PERM == 200


def _same_columns(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for ci in a:
        assert np.array_equal(np.asarray(a[ci]), np.asarray(b[ci])), ci


# (z, k, messages): the default packing at k=9, the two-block sponge
# message of tests/test_keccak_sponge.py at k=10, and two narrower
# packings with edge-length messages
WITNESS_CASES = [
    (8, 9, [b"abc"]),
    (8, 10, [b"x" * 200]),
    (4, 11, [b"", b"q" * 136]),
    (2, 12, [b"r" * 135]),
]


@pytest.mark.parametrize("z,k,msgs", WITNESS_CASES,
                         ids=[f"z{c[0]}-k{c[1]}" for c in WITNESS_CASES])
def test_columns_match_reference(z, k, msgs):
    n = 1 << k
    jc, jcs, tc, tcs = _both(msgs, z)
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    _same_columns(jc.synthesize(0, n, {}, []), tc.synthesize(0, n, {}, []))
    assert tc._final_states == jc._final_states
    _same_columns(jc.synthesize(1, n, j_chal(jcs), []),
                  tc.synthesize(1, n, t_chal(tcs), []))


def test_keccak_f_circuit_columns_match_reference():
    rng = np.random.default_rng(11)
    states = [_rand_state(rng) for _ in range(2)]
    n = 1 << 9
    jc, tc = jk.KeccakFCircuit(states), tk.KeccakFCircuit(states)
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    _same_columns(jc.synthesize(0, n, {}, []), tc.synthesize(0, n, {}, []))
    assert tc._final_states == {i: jkh.keccak_f(s) for i, s in enumerate(states)}


def test_pad_blocks_match_reference():
    for length in (0, 1, 135, 136, 271, 272):
        msg = bytes(range(256))[:length] if length <= 256 else b"\x07" * length
        assert tk._pad_blocks(msg) == jk._pad_blocks(msg)


# ---------------------------------------------------------------------------
# slow tier: the port's CPU proof against the golden
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_keccak_k9_proof_matches_golden(monkeypatch):
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly import msm
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    # small column groups keep the CPU plain path's memory low; the sums
    # do not depend on the grouping
    monkeypatch.setattr(msm, "BUCKET_BYTES_BUDGET", 64 << 20)
    k = demo.KECCAK_GOLDEN_K
    srs = Srs.unsafe_setup(k, tau=demo.KECCAK_GOLDEN_TAU, device="cpu")
    msgs = list(demo.KECCAK_GOLDEN_MESSAGES)
    pk, vk = keygen(tk.KeccakCircuit(msgs), k, srs, device="cpu")
    proof = prove(pk, tk.KeccakCircuit(msgs), [], srs,
                  rng=np.random.default_rng(demo.KECCAK_GOLDEN_SEED),
                  device="cpu")
    assert len(proof) == demo.KECCAK_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.KECCAK_GOLDEN_SHA256
    assert verify(vk, [], proof)
