"""The Sig (ecrecover) circuit in the port (zkevm_circuits_tpu_torch
circuits/sig.py) against the JAX package's: the host trace of an ECDSA
verification and its MulMod events, the rejected invalid signature, the
standalone circuit at k=13 (embedded MulMod and Keccak circuits, the
Keccak circuit sharing the Sig circuit's challenge) with its constraint
system, fixed columns and both phases' columns, and the MockProver
verdicts on the good witness (fast tier) and on the corruptions of
tests/test_sig_circuit.py (slow tier: two minutes each), exact, on the
same inputs.  Its own file, so that --dist loadfile gives its k=13 cases
a worker of their own."""

import numpy as np
import pytest
import torch

from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from zkevm_circuits_tpu.circuits import sig as jsig
from zkevm_circuits_tpu.crypto import secp256k1 as jsecp
from zkevm_circuits_tpu.plonk import circuit as jcircuit
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu_torch.circuits import sig as tsig
from zkevm_circuits_tpu_torch.crypto import secp256k1 as tsecp
from zkevm_circuits_tpu_torch.plonk import circuit as tcircuit
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock

torch.set_num_threads(2)
K = 13
SK = 0xB0B5_5EED_1DEA_F00D
Z = 0xDEADBEEF_12345678
JAX = dict(circuit=jcircuit)
PORT = dict(circuit=tcircuit)


def _event(sig, secp, sk=SK, z=Z):
    r, s, _v = secp.sign(sk, z.to_bytes(32, "big"))
    return sig.SigEvent(msg_hash=z, r=r, s=s, pubkey=secp.pubkey(sk))


def _plain(x):
    """Traces as plain data: MulMod events as dicts, the rest as is."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return vars(x)
    return x


def test_constants_match_reference():
    assert (tsig.D_PT, tsig.T1_PT, tsig.E_PT, tsig.NEG_E_PT) == \
        (jsig.D_PT, jsig.T1_PT, jsig.E_PT, jsig.NEG_E_PT)
    assert (tsig.EV_ROWS, tsig.N_WALK) == (jsig.EV_ROWS, jsig.N_WALK) == (258, 256)
    assert tsecp._add(tsig.E_PT, tsig.NEG_E_PT) is None
    assert vars(tsig._dummy_event()) == vars(jsig._dummy_event())


@pytest.mark.parametrize("seed", range(3))
def test_trace_matches_reference(seed):
    """Seeded keys and message hashes: the setup, the 256 walk rows, the
    final block and the MulMod events, equal; the recovered address is
    the key's."""
    rng = np.random.default_rng(seed)
    sk = int.from_bytes(rng.bytes(32), "big") % (tsecp.N - 1) + 1
    z = int.from_bytes(rng.bytes(32), "big")
    t, j = _event(tsig, tsecp, sk, z), _event(jsig, jsecp, sk, z)
    assert vars(t) == vars(j)
    tt, jt = t.trace(), j.trace()
    assert len(tt[1]) == 256
    assert _plain(tt) == _plain(jt)
    assert t.pubkey_bytes() == j.pubkey_bytes()
    assert t.address == j.address == tsecp.eth_address(sk)
    for e in tt[3]:
        if e.n:
            want = (e.a % e.n + e.b) % e.n if e.is_add else (e.a % e.n) * e.b % e.n
            assert want == e.r


def test_trace_rejects_invalid_signature():
    for sig, secp in ((tsig, tsecp), (jsig, jsecp)):
        ev = _event(sig, secp)
        bad = sig.SigEvent(msg_hash=ev.msg_hash, r=ev.r, s=ev.s + 1,
                           pubkey=ev.pubkey)
        with pytest.raises(AssertionError):
            bad.trace()


def test_sig_circuit_matches_reference():
    """One signature at k=13: 1,434 advice columns in two phases (the
    embedded Keccak circuit's RLC columns in phase 1, on the Sig circuit's
    challenge), the constraint system, the fixed and both phases' columns,
    and the verdicts (none)."""
    jc, tc = jsig.SigCircuit([_event(jsig, jsecp)]), tsig.SigCircuit([_event(tsig, tsecp)])
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert (tcs.num_advice, max(tcs.advice_phases) + 1) == (1434, 2)
    assert tcs.challenge_phases == [0]
    assert tc.kc.r is tc.r_word and tc.r_word.index == jc.r_word.index
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []


# tests/test_sig_circuit.py: (column, row, new value from the old)
CORRUPTIONS = {
    # a u1 bit flipped on a mid-walk row
    "scalar_bit": (lambda c: c.c_b1, 1 + 100, lambda v: 1 - v),
    # a recovered address byte on the final row
    "address_byte": (lambda c: c.c_db[20], 1 + 256, lambda v: v ^ 1),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_verdicts_match_reference(case):
    col, row, value = CORRUPTIONS[case]
    edits = [(0, col, lambda c: row, value)]
    got = TMock(K, corrupt(tsig.SigCircuit, edits)([_event(tsig, tsecp)])).verify()
    want = JMock(K, corrupt(jsig.SigCircuit, edits)([_event(jsig, jsecp)])).verify()
    assert got == want and got
    if case == "address_byte":
        assert any("keccak" in f for f in got), got
    else:
        assert all(f.startswith("gate 'sig ") for f in got), got
