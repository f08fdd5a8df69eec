"""The Poseidon hash, the Poseidon transcript and the Poseidon circuit in
the port (zkevm_circuits_tpu_torch crypto/poseidon.py, poly/transcript.py,
circuits/poseidon.py) against the JAX package's, exact, on the same
seeded inputs: the Grain-LFSR constants, the host permutation, its round
states and hashes, the batched permutation (the port's plain version of
K1), sponge traces, transcript bytes and challenges, the circuit's
constraint system and columns and its MockProver verdicts; and the k=5
DemoCircuit proved under the Poseidon transcript, byte for byte the
reference's proof (plonk/demo.py's golden).  The slow tier proves the
Poseidon golden on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from zkevm_circuits_tpu.circuits import mpt as jmpt
from zkevm_circuits_tpu.circuits import pi as jpi
from zkevm_circuits_tpu.circuits import poseidon as jposeidon
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.crypto import poseidon as jp
from zkevm_circuits_tpu.plonk import circuit as jcircuit
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.poly import transcript as jt
from zkevm_circuits_tpu.witness import mpt as jmpt_witness
from zkevm_circuits_tpu_torch.circuits import poseidon as tposeidon
from zkevm_circuits_tpu_torch.crypto import poseidon as tp
from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import circuit as tcircuit
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.keygen import keygen
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.plonk.prover import prove
from zkevm_circuits_tpu_torch.plonk.verifier import verify
from zkevm_circuits_tpu_torch.poly import transcript as tt
from zkevm_circuits_tpu_torch.poly.kzg import Srs

torch.set_num_threads(2)
F = fr()
K = 9

JAX = dict(poseidon=jposeidon, mpt=jmpt, pi=jpi, keccak=jkeccak,
           mpt_witness=jmpt_witness, circuit=jcircuit)
PORT = dict(demo.chain_modules(), circuit=tcircuit)


def _states(seed: int, n: int) -> list[list[int]]:
    """n seeded length-3 states: field elements, with 0, 1 and P - 1."""
    rng = np.random.default_rng(seed)
    out = [[0, 0, 0], [1, R - 1, 0], [R - 1, R - 1, R - 1]]
    while len(out) < n:
        out.append([int.from_bytes(rng.bytes(32), "little") % R for _ in range(3)])
    return out


def test_spec_matches_reference():
    t, j = tp.spec(), jp.spec()
    assert (t.p, t.rc, t.mds) == (j.p, j.rc, j.mds)
    assert (tp.T, tp.ALPHA, tp.R_FULL, tp.R_PARTIAL) == \
        (jp.T, jp.ALPHA, jp.R_FULL, jp.R_PARTIAL)
    assert [t.is_full_round(r) for r in range(t.n_rounds)] == \
        [j.is_full_round(r) for r in range(j.n_rounds)]


@pytest.mark.parametrize("seed", [1, 2])
def test_permute_and_round_states_match_reference(seed):
    for s in _states(seed, 24):
        assert tp.permute(s) == jp.permute(s)
        assert tp.round_states(s) == jp.round_states(s)


def test_unreduced_inputs_match_reference():
    """Inputs at or above p and below 0 reduce as the reference's do."""
    for s in ([R, 2 * R + 5, 3], [-1, -R - 2, 7], [1 << 255, 1 << 254, 0]):
        assert tp.permute(s) == jp.permute(s)
        assert tp.round_states(s) == jp.round_states(s)


def test_hashes_match_reference():
    rng = np.random.default_rng(3)
    word = lambda: int.from_bytes(rng.bytes(32), "little") % R  # noqa: E731
    for _ in range(8):
        a, b = word(), word()
        assert tp.hash2(a, b) == jp.hash2(a, b)
    for n in range(6):
        msg = [word() for _ in range(n)]
        assert tp.hash_msg(msg) == jp.hash_msg(msg)
        assert tp.hash_msg(msg, cap=n + 7) == jp.hash_msg(msg, cap=n + 7)


def _mont(states):
    return np.stack([F.from_ints([v * F.R % R for v in s]) for s in states])


def test_permute_batch_matches_reference():
    """64 seeded states: the port's batch (K1's plain version on the CPU)
    against the JAX package's batch and the host permutation."""
    states = _states(4, 64)
    x = _mont(states)
    got = tp.permute_batch(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, np.asarray(jp.permute_batch(x)))
    assert np.array_equal(got, _mont([tp.permute(s) for s in states]))


# ---------------------------------------------------------------------------
# the Poseidon transcript


def _drive(t, rng):
    """A seeded sequence of absorbs, writes and squeezes; the challenges."""
    word = lambda: int.from_bytes(rng.bytes(32), "little") % R  # noqa: E731
    pt = lambda: (word(), word())  # noqa: E731
    out = []
    for i in range(6):
        for _ in range(i % 3 + 1):
            t.write_scalar(word())
        t.write_point(pt() if i % 2 else None)
        t.common_scalar(word())
        t.common_point(pt())
        out.append(t.squeeze_challenge())
        if i % 2:
            out.append(t.squeeze_challenge())  # consecutive squeezes chain
    return out


def test_transcript_matches_reference():
    assert tt.SQUEEZE_TAG == jt.SQUEEZE_TAG
    t, j = tt.PoseidonTranscript(), jt.PoseidonTranscript()
    got, want = _drive(t, np.random.default_rng(5)), _drive(j, np.random.default_rng(5))
    assert got == want
    assert bytes(t.proof) == bytes(j.proof)
    assert t._sponge.trace == j._sponge.trace
    # the reader replays the writer's challenges from its bytes
    rd, jrd = tt.PoseidonReader(bytes(t.proof)), jt.PoseidonReader(bytes(j.proof))
    assert rd.read_scalar() == jrd.read_scalar()
    assert rd.read_point() == jrd.read_point()
    assert rd.squeeze_challenge() == jrd.squeeze_challenge()
    assert rd.sponge.trace == jrd.sponge.trace
    assert not rd.exhausted() and not jrd.exhausted()


def test_sponge_matches_reference():
    for vals in ([], [7], [1, 2], [2, 1], [R - 1, 0, 5]):
        t, j = tt.PoseidonSponge(), jt.PoseidonSponge()
        t.absorb(*vals)
        j.absorb(*vals)
        assert [t.squeeze(), t.squeeze()] == [j.squeeze(), j.squeeze()]
        assert t.trace == j.trace


@pytest.fixture(scope="module")
def demo_keys():
    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device="cpu")
    return srs, pk, vk


def test_poseidon_transcript_proof_matches_golden(demo_keys):
    """tests/test_poseidon_transcript.py's proof on the CPU: the golden's
    bytes; the PoseidonReader accepts it, the Blake2b reader and a wrong
    instance do not."""
    srs, pk, vk = demo_keys
    inst = [[demo.A_IN]]
    proof = prove(pk, demo.DemoCircuit(), inst, srs,
                  transcript=tt.PoseidonTranscript(),
                  rng=np.random.default_rng(demo.POSEIDON_TRANSCRIPT_GOLDEN_SEED),
                  device="cpu")
    assert len(proof) == demo.POSEIDON_TRANSCRIPT_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.POSEIDON_TRANSCRIPT_GOLDEN_SHA256
    assert verify(vk, inst, proof, transcript=tt.PoseidonReader(proof))
    assert not verify(vk, inst, proof)
    assert not verify(vk, [[demo.A_IN + 1]], proof,
                      transcript=tt.PoseidonReader(proof))


# ---------------------------------------------------------------------------
# the Poseidon circuit


def test_golden_witness_matches_reference():
    """The golden's circuit (tests/test_poseidon.py's two events, seven
    blocks at k=9): constraint system, fixed and advice columns, verdicts."""
    jc, _ = demo.chain_golden("poseidon", JAX)
    tc, _ = demo.chain_golden("poseidon")
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert (tcs.num_advice, tcs.num_fixed) == (6, 7)
    assert tc.n_blocks(1 << K) == 7
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []
    assert tposeidon.ROWS_PER_BLOCK == jposeidon.ROWS_PER_BLOCK == 66


def test_seeded_blocks_match_reference():
    """Every block filled with seeded events."""
    evs = [(d % 4, a, b) for d, a, b in _states(6, 7)]
    jc = jposeidon.PoseidonCircuit([jposeidon.PoseidonEvent(*e) for e in evs])
    tc = tposeidon.PoseidonCircuit([tposeidon.PoseidonEvent(*e) for e in evs])
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=1)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []


# tests/test_poseidon.py: (events, [(column, rows, new value)])
CORRUPTIONS = {
    "wrong_state": ([(0, 1, 2)], [(lambda c: c.c_s[0], [65], lambda v: 99)]),
    "table_binds_inputs": ([(0, 1, 2)],
                           [(lambda c: c.c_in0, range(66), lambda v: 42)]),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_verdicts_match_reference(case):
    evs, cells = CORRUPTIONS[case]
    edits = [(0, col, (lambda c, r=r: r), new)
             for col, rows, new in cells for r in rows]
    got = TMock(K, corrupt(tposeidon.PoseidonCircuit, edits)(
        [tposeidon.PoseidonEvent(*e) for e in evs])).verify()
    want = JMock(K, corrupt(jposeidon.PoseidonCircuit, edits)(
        [jposeidon.PoseidonEvent(*e) for e in evs])).verify()
    assert got == want
    assert got and all("poseidon" in f for f in got), got
    assert all(f.startswith("gate ") for f in got), got  # no lookup fails


@pytest.mark.slow
def test_cpu_proof_matches_golden():
    k, sha, length = demo.CHAIN_GOLDENS["poseidon"]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    c, inst = demo.chain_golden("poseidon")
    pk, vk = keygen(c, k, srs, device="cpu")
    proof = prove(pk, demo.chain_golden("poseidon")[0], inst, srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                  device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, inst, proof)
