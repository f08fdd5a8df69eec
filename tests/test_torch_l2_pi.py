"""The L2 block-trace ingestion and the PI circuit in the port
(zkevm_circuits_tpu_torch witness/l2.py and circuits/pi.py) against the
JAX package's, exact, on the same inputs: tests/test_l2_trace.py's block
trace (made by each package's tracer, the same JSON) replayed by
builder_from_l2_trace into the same steps and RW rows, its pre-state
fields and block environment; the chunk statement's bytes and instance
(tests/test_pi_circuit.py's PublicData, and one deriving its data hash
from a block and transactions); the PI circuit's constraint system and
columns, standalone and bound to a keccak table, and its MockProver
verdicts on tests/test_pi_circuit.py's four cases.  The slow tier feeds
the ingested block into the two-level trie witness and proves the PI
golden on the CPU."""

import hashlib
import json

import numpy as np
import pytest
import torch

from test_torch_evm_witness import _plain
from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from test_torch_poseidon import JAX, PORT
from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import pi as jpi
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.plonk.expression import Advice as JAdvice
from zkevm_circuits_tpu.plonk.expression import Fixed as JFixed
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.tracer import evm as jtr_evm
from zkevm_circuits_tpu.witness import l2 as jl2
from zkevm_circuits_tpu.witness import mpt as jw
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.circuits import pi as tpi
from zkevm_circuits_tpu_torch.crypto import keccak as tkeccak
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.expression import Advice as TAdvice
from zkevm_circuits_tpu_torch.plonk.expression import Fixed as TFixed
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.tracer import evm as ttr_evm
from zkevm_circuits_tpu_torch.witness import l2 as tl2
from zkevm_circuits_tpu_torch.witness import mpt as tw

torch.set_num_threads(2)
K = 9
SENDER, CONTRACT = 0xA11CE, 0xB0B


def _fixture(tracer, types, keccak, evm):
    """tests/test_l2_trace.py::_fixture through one package's tracer: a
    BlockTrace JSON as a sequencer would send it."""
    code = (types.Bytecode()
            .push(1, 0x2A).push(1, 5).op("SSTORE")
            .push(1, 5).op("SLOAD").op("POP")
            .op("STOP"))
    ch = int.from_bytes(keccak.keccak256(code.to_bytes()), "big")
    env = evm.BlockEnv(number=42, coinbase=0xC01, base_fee=7)
    state = tracer.StateDB(
        {SENDER: tracer.Account(balance=10**18),
         CONTRACT: tracer.Account(code=code.to_bytes(), storage={5: 7})})
    interp = tracer.Interpreter(state, block=env)
    traces = [interp.run_tx(tracer.Tx(from_addr=SENDER, to=CONTRACT)).to_json()
              for _ in range(2)]
    return json.dumps({
        "chain_id": 1337, "coinbase": hex(0xC01), "number": 42,
        "timestamp": 1000, "gas_limit": 30_000_000, "base_fee": 7,
        "prev_hashes": {"41": hex(0xABC)},
        "accounts_before": {
            hex(SENDER): {"nonce": 0, "balance": hex(10**18),
                          "code_hash": "0x0"},
            hex(CONTRACT): {"nonce": 0, "balance": 0, "code_hash": hex(ch)},
        },
        "storage_before": {hex(CONTRACT): {"0x5": "0x7"}},
        "codes": {hex(ch): "0x" + code.to_bytes().hex()},
        "transactions": [
            {"from": hex(SENDER), "to": hex(CONTRACT), "value": 0,
             "gas": 1_000_000, "gas_price": 10, "calldata": "0x"}
            for _ in range(2)],
        "execution_results": traces,
    })


@pytest.fixture(scope="module")
def block_trace():
    js = _fixture(ttr, tty, tkeccak, ttr_evm)
    assert js == _fixture(jtr, jty, jkeccak, jtr_evm)
    return js


def test_l2_builder_matches_reference(block_trace):
    tbt, jbt = tl2.BlockTrace.from_json(block_trace), jl2.BlockTrace.from_json(block_trace)
    t, j = tl2.builder_from_l2_trace(tbt), jl2.builder_from_l2_trace(jbt)
    assert _plain(t.steps) == _plain(j.steps)
    assert _plain(t.rws.rws) == _plain(j.rws.rws)
    assert _plain(t.txs) == _plain(j.txs)
    assert [s.exec_state for s in t.steps].count("EndTx") == 2
    assert _plain(tl2.accounts_before_fields(tbt)) == \
        _plain(jl2.accounts_before_fields(jbt))
    assert _plain(tl2.block_env(tbt)) == _plain(jl2.block_env(jbt))
    assert tl2.block_env(tbt).prev_hashes == {41: 0xABC}


# ---------------------------------------------------------------------------
# the PI circuit


def _pd(pi, keccak, derived=False):
    """tests/test_pi_circuit.py::_pd; `derived`: its data hash from a
    block and two transaction hashes instead."""
    post, withdraw, data = (keccak.keccak256(s) for s in demo.PI_GOLDEN_DIGESTS_OF)
    extra = {}
    if derived:
        evm = ttr_evm if pi is tpi else jtr_evm
        extra = dict(block=evm.BlockEnv(number=42, timestamp=1000, base_fee=7),
                     tx_hashes=[keccak.keccak256(b"tx1"), keccak.keccak256(b"tx2")])
    return pi.PublicData(chain_id=demo.PI_GOLDEN_CHAIN_ID,
                         prev_state_root=demo.PI_GOLDEN_PREV_ROOT,
                         post_state_root=post, withdraw_root=withdraw,
                         data_hash=data, **extra)


@pytest.mark.parametrize("derived", [False, True])
def test_public_data_matches_reference(derived):
    t, j = _pd(tpi, tkeccak, derived), _pd(jpi, jkeccak, derived)
    assert t.pi_bytes() == j.pi_bytes() and len(t.pi_bytes()) == 136
    assert t.digest() == j.digest()
    assert t.instance() == j.instance()
    hi, lo = t.instance()
    assert (hi << 128) | lo == int.from_bytes(tkeccak.keccak256(t.pi_bytes()), "big")
    assert tpi.padded_pi_bytes(t.pi_bytes()) == jpi.padded_pi_bytes(j.pi_bytes())
    if derived:
        assert t.data_bytes() == j.data_bytes()
        assert t.derived_data_hash() == tkeccak.keccak256(t.data_bytes())


def test_golden_witness_matches_reference():
    """The golden's circuit: constraint system, fixed and both phases'
    columns, verdicts with its instances, the state-root cells."""
    jc, jinst = demo.chain_golden("pi", JAX)
    tc, tinst = demo.chain_golden("pi")
    assert tinst == jinst == [_pd(tpi, tkeccak).instance()]
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert max(tcs.advice_phases) == 1
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    assert TMock(K, tc, tinst).verify() == JMock(K, jc, jinst).verify() == []
    assert repr(tc.state_root_cells()) == repr(jc.state_root_cells())
    assert repr(tc.copy_constraints(1 << K)) == repr(jc.copy_constraints(1 << K))


def test_keccak_table_mode_matches_reference():
    """configure(cs, keccak_table=...) with the table's columns from
    outside: the same constraint system."""
    def cs_of(pi, keccak, pkg, adv, fix):
        c = pi.PiCircuit(_pd(pi, keccak))
        cs = pkg["circuit"].ConstraintSystem()
        tbl = [fix(cs.fixed_column()), adv(cs.advice_column(phase=1)),
               adv(cs.advice_column(phase=1))]
        c.configure(cs, keccak_table=tbl)
        assert not c.standalone
        return cs

    assert_same_cs(cs_of(tpi, tkeccak, PORT, TAdvice, TFixed),
                   cs_of(jpi, jkeccak, JAX, JAdvice, JFixed))


def _bump_digest_byte(v):
    return (v + 1) % 256


# tests/test_pi_circuit.py: (instance edit, [(phase, column, row, new)])
PI_CASES = {
    "satisfied": (None, []),
    "wrong_instance": (1, []),
    "wrong_digest": (None, [(0, lambda c: c.c_dig[5], 0, _bump_digest_byte)]),
    "tampered_statement_byte": (None, [(0, lambda c: c.c_byte, 10, lambda v: 0x77)]),
}


@pytest.mark.parametrize("case", sorted(PI_CASES))
def test_pi_verdicts_match_reference(case):
    bump, cells = PI_CASES[case]
    edits = [(ph, col, (lambda c, r=r: r), new) for ph, col, r, new in cells]
    verdicts = []
    for pi, keccak, mock in ((tpi, tkeccak, TMock), (jpi, jkeccak, JMock)):
        pd = _pd(pi, keccak)
        hi, lo = pd.instance()
        inst = [[hi, (lo + bump) % (1 << 128)]] if bump else [[hi, lo]]
        verdicts.append(mock(K, corrupt(pi.PiCircuit, edits)(pd), inst).verify())
    got, want = verdicts
    assert got == want
    assert bool(got) == (case != "satisfied"), got
    if case == "tampered_statement_byte":
        # gate-only (chip_smoke.py's rejected PI proof): no lookup fails
        assert all(f.startswith("gate ") for f in got), got


# ---------------------------------------------------------------------------
# slow tier


@pytest.mark.slow
def test_l2_trace_two_level_state(block_trace):
    """tests/test_l2_trace.py::test_l2_trace_two_level_state: the ingested
    block's two-level trie witness, the same in both packages."""
    out = []
    for l2, w in ((tl2, tw), (jl2, jw)):
        bt = l2.BlockTrace.from_json(block_trace)
        b = l2.builder_from_l2_trace(bt)
        out.append(w.two_level_updates_from_rws(
            b.rws.rws, l2.accounts_before_fields(bt)))
    (ts, tg, ta, (tt, _)), (js, jg, ja, (jt, _)) = out
    assert (_plain(ts), tg, _plain(ta)) == (_plain(js), jg, _plain(ja))
    assert tt.root() == jt.root() == ta[-1].mpt.new_root
    assert next(au for au in ta if au.addr == SENDER).new.nonce == 2
    assert next(au for au in ta if au.addr == CONTRACT).new.storage_root != 0


@pytest.mark.slow
def test_cpu_proof_matches_golden():
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.CHAIN_GOLDENS["pi"]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    c, inst = demo.chain_golden("pi")
    pk, vk = keygen(c, k, srs, device="cpu")
    proof = prove(pk, demo.chain_golden("pi")[0], inst, srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                  device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, inst, proof)
    assert not verify(vk, [[inst[0][0], inst[0][1] ^ 1]], proof)
