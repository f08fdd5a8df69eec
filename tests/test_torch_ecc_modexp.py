"""The ECC and ModExp precompile circuits in the port (zkevm_circuits_tpu_torch
circuits/ecblocks.py, ecc.py and modexp.py) against the JAX package's: the
host blocks' MulMod events, the constraint systems, the fixed and witness
columns, and the MockProver verdicts on the witnesses and corruptions of
tests/test_ecc_circuit.py, test_modexp_circuit.py and the fast cases of
test_modexp_var.py (EVM + ModExp through both builders), exact, on the
same inputs; the precompile goldens' witnesses and shapes, the k=13
workloads' fill, and (slow tier) the port's CPU proof of each golden."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from test_torch_sha256 import JAX, PORT
from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu.circuits import ecblocks as jblocks
from zkevm_circuits_tpu.circuits import ecc as jecc
from zkevm_circuits_tpu.circuits import modexp as jmodexp
from zkevm_circuits_tpu.circuits.evm import EvmCircuit as JEvm
from zkevm_circuits_tpu.circuits.evm import EvmParams as JEvmParams
from zkevm_circuits_tpu.crypto import secp256k1 as jsecp
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.types import Bytecode as JBytecode
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch.circuits import ecblocks as tblocks
from zkevm_circuits_tpu_torch.circuits import ecc as tecc
from zkevm_circuits_tpu_torch.circuits import modexp as tmodexp
from zkevm_circuits_tpu_torch.circuits.evm import EvmCircuit as TEvm
from zkevm_circuits_tpu_torch.circuits.evm import EvmParams as TEvmParams
from zkevm_circuits_tpu_torch.crypto.curve import host_g1_add, host_g1_mul
from zkevm_circuits_tpu_torch.crypto.params import FQ_MODULUS, G1_GEN
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench
from zkevm_circuits_tpu_torch.types import Bytecode as TBytecode
from zkevm_circuits_tpu_torch.witness import builder as tb

torch.set_num_threads(2)
O = (0, 0)


def _plain(events):
    return [vars(e) for e in events]


def _aff(p):
    return O if p is None else p


def _pt(k):
    return host_g1_mul(G1_GEN, k)


def _same_circuit(jc, tc, k, seed):
    """Constraint system, fixed and witness columns, and the MockProver
    verdicts of the reference's circuit `jc` and the port's `tc` at k;
    returns the port's verdict."""
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << k, seed=seed)
    got = TMock(k, tc).verify()
    assert got == JMock(k, jc).verify()
    return got


# ---------------------------------------------------------------------------
# ecblocks: the affine add and double blocks over MulMod rows


@pytest.mark.parametrize("modulus", ["bn254", "secp256k1"])
def test_host_blocks_match_reference(modulus):
    rng = np.random.default_rng(5)
    if modulus == "bn254":
        p = FQ_MODULUS
        pts = [_pt(int(rng.integers(1, 2**62))) for _ in range(3)]
    else:
        p = jsecp.P
        pts = [jsecp._mul(jsecp.G, int(rng.integers(1, 2**62))) for _ in range(3)]
    for P, Q in ((pts[0], pts[1]), (pts[1], pts[2])):
        te, je = [], []
        assert tblocks.host_add_block(te, P, Q, p) == \
            jblocks.host_add_block(je, P, Q, p)
        assert tblocks.host_dbl_block(te, P, p) == \
            jblocks.host_dbl_block(je, P, p)
        assert _plain(te) == _plain(je)
        assert len(te) == 10 + 11
    assert (tblocks.ADD_CELLS, tblocks.DBL_CELLS, tblocks.ONE) == \
        (jblocks.ADD_CELLS, jblocks.DBL_CELLS, jblocks.ONE)
    assert tblocks.halves(p) == jblocks.halves(p)


# ---------------------------------------------------------------------------
# ECC (tests/test_ecc_circuit.py)


def test_ecc_constants_match_reference():
    assert (tecc.D_PT, tecc.T1G_PT, tecc.E_PT, tecc.NEG_E_PT) == \
        (jecc.D_PT, jecc.T1G_PT, jecc.E_PT, jecc.NEG_E_PT)
    assert (tecc.TAG_ADD, tecc.TAG_MUL, tecc.EV_ROWS) == \
        (jecc.TAG_ADD, jecc.TAG_MUL, jecc.EV_ROWS) == (1, 2, 258)


def test_ecadd_cases_match_reference():
    """The six EcAdd cases (the ECC golden's witness) at k=9, their
    case flags and MulMod events."""
    jc, tc = demo.precompile_golden("ecc", JAX), demo.precompile_golden("ecc")
    assert [e._case() for e in tc.add_events] == \
        ["gen", "dbl", "opp", "pz", "qz", "pz"]
    for te, je in zip(tc.add_events, jc.add_events):
        assert _plain(te.mulmod_events()) == _plain(je.mulmod_events())
    assert _same_circuit(jc, tc, 9, seed=9) == []


def _ecmul(pkg, case):
    P = _pt(9) if case == "product" else _pt(21)
    if case == "product":
        k = 0xDEADBEEF_CAFEBABE_0123456789ABCDEF
    elif case == "zero_point":
        P, k = O, 123
    elif case == "zero_scalar":
        P, k = _pt(3), 0
    else:  # the walk of tests/test_ecc_circuit.py::test_ecmul_catches_wrong_product
        k = 0x1234567
    r = O if P == O or k == 0 else _aff(host_g1_mul(P, k))
    return pkg["ecc"].EcMulEvent(p=P, k=k, r=r)


@pytest.mark.parametrize("case", ["product", "zero_point", "zero_scalar"])
def test_ecmul_matches_reference(case):
    """EcMul at k=13: a full walk, and the trivial events (P = O, k = 0),
    which run the fixed dummy walk (base G, scalar 1) and expose R = O."""
    tev, jev = _ecmul(PORT, case), _ecmul(JAX, case)
    assert tev.trivial == jev.trivial == (case != "product")
    assert _plain(tev.mulmod_events()) == _plain(jev.mulmod_events())
    assert _same_circuit(jecc.EccCircuit(mul_events=[jev]),
                         tecc.EccCircuit(mul_events=[tev]), 13, seed=13) == []


def _bump(v):
    return v + 1


def _flip(v):
    return 1 - v


# (k, events, column, row, new value from the old)
ECC_CORRUPTIONS = {
    # the sum's x low half on the statement row
    "wrong_sum": (9, lambda pkg: dict(add_events=[pkg["ecc"].EcAddEvent(
        p=_pt(7), q=_pt(13), r=_aff(host_g1_add(_pt(7), _pt(13))))]),
        lambda c: c.pairs["arx"][0], 0, _bump),
    # a walked bit flipped mid-walk
    "wrong_product": (13, lambda pkg: dict(mul_events=[_ecmul(pkg, "walk")]),
                      lambda c: c.c_b, 1 + 200, _flip),
}


@pytest.mark.parametrize("case", sorted(ECC_CORRUPTIONS))
def test_ecc_corruption_verdicts_match_reference(case):
    k, events, col, row, value = ECC_CORRUPTIONS[case]
    edits = [(0, col, lambda c: row, value)]
    got = TMock(k, corrupt(tecc.EccCircuit, edits)(**events(PORT))).verify()
    want = JMock(k, corrupt(jecc.EccCircuit, edits)(**events(JAX))).verify()
    assert got == want and got


def test_ecc_padded_targets_match_reference():
    """EccParams targets above the event counts pad both regions."""
    P, Q = _pt(2), _pt(3)
    evs = lambda pkg: [pkg["ecc"].EcAddEvent(  # noqa: E731
        p=P, q=Q, r=_aff(host_g1_add(P, Q)))]
    jc = jecc.EccCircuit(add_events=evs(JAX), params=jecc.EccParams(4, 0))
    tc = tecc.EccCircuit(add_events=evs(PORT), params=tecc.EccParams(4, 0))
    assert _same_circuit(jc, tc, 9, seed=4) == []


# ---------------------------------------------------------------------------
# ModExp (tests/test_modexp_circuit.py)


@pytest.mark.parametrize("base,exp,mod", [
    (23, 123, 1009), (7, 0, 13), (2**140 + 5, 1, 997), (7, 5, 0), (5, 0, 1),
    (2**255 + 17, 65537, 10**60 + 7), (3, 2**256 - 1, (1 << 255) - 19),
])
def test_modexp_steps_match_reference(base, exp, mod):
    assert tmodexp.modexp_steps(base, exp, mod) == \
        jmodexp.modexp_steps(base, exp, mod)
    steps, result = tmodexp.modexp_steps(base, exp, mod)
    assert result == (pow(base, exp, mod) if mod else 0)
    for a, b, d in steps:
        assert d == (a * b % mod if mod else 0)


def _modexp_events(pkg, triples):
    ev = pkg["modexp"].ModExpEvent
    return [ev(base=b, exponent=e, modulus=n, result=pow(b, e, n) if n else 0)
            for b, e, n in triples]


MODEXP_SETS = {
    "satisfied": demo.MODEXP_GOLDEN_EVENTS,
    "small_exponents_and_zero_modulus": (
        (12345, 0, 1009), (2**140 + 5, 1, 997), (7, 5, 0), (5, 0, 1)),
}


@pytest.mark.parametrize("name", sorted(MODEXP_SETS))
def test_modexp_circuit_matches_reference(name):
    tev = _modexp_events(PORT, MODEXP_SETS[name])
    jev = _modexp_events(JAX, MODEXP_SETS[name])
    for t, j in zip(tev, jev):
        assert _plain(t.mulmod_events()) == _plain(j.mulmod_events())
    assert _same_circuit(jmodexp.ModExpCircuit(jev),
                         tmodexp.ModExpCircuit(tev), 9, seed=5) == []


def test_modexp_padded_target_matches_reference():
    triples = MODEXP_SETS["small_exponents_and_zero_modulus"]
    jc = jmodexp.ModExpCircuit(_modexp_events(JAX, triples),
                               jmodexp.ModExpParams(target_rows=20))
    tc = tmodexp.ModExpCircuit(_modexp_events(PORT, triples),
                               tmodexp.ModExpParams(target_rows=20))
    assert _same_circuit(jc, tc, 9, seed=6) == []


# (events, column, row, new value from the old)
MODEXP_CORRUPTIONS = {
    # the result's low half bumped on the first (result) row
    "wrong_result": (((7, 6, 1009),), lambda c: c.c_d_lo, _bump),
    # exponent 11 claimed on the statement row
    "tampered_exponent": (((3, 10, 101),), lambda c: c.c_exp[0],
                          lambda v: 11),
}


@pytest.mark.parametrize("case", sorted(MODEXP_CORRUPTIONS))
def test_modexp_corruption_verdicts_match_reference(case):
    triples, col, value = MODEXP_CORRUPTIONS[case]
    edits = [(0, col, lambda c: 0, value)]
    got = TMock(9, corrupt(tmodexp.ModExpCircuit, edits)(
        _modexp_events(PORT, triples))).verify()
    want = JMock(9, corrupt(jmodexp.ModExpCircuit, edits)(
        _modexp_events(JAX, triples))).verify()
    assert got == want and got


def test_modexp_full_mulmod_table_verdict_matches_reference():
    """Steps that fill every usable row of k=10 with MulMod rows (events
    and the padding row) but for one ModExp row: the disabled row's
    all-zero lookup input then has no disabled MulMod row to match, in
    both packages alike (bench_circuits' workloads stop one row short)."""
    cap = usable_rows(1 << 10)
    triples, rows = [], 0
    while rows < cap - 1:
        e = (1 << min(255, (cap - 1 - rows) // 2)) | 1
        triples.append((3, e, 1009))
        rows += len(tmodexp.modexp_steps(3, e, 1009)[0])
    assert rows + 1 == cap
    got = TMock(10, tmodexp.ModExpCircuit(
        _modexp_events(PORT, triples))).verify()
    assert got == JMock(10, jmodexp.ModExpCircuit(
        _modexp_events(JAX, triples))).verify()


# ---------------------------------------------------------------------------
# variable-length MODEXP calls (tests/test_modexp_var.py, the fast cases):
# the EVM circuit and the ModExp circuit at k=10, through both builders

SENDER, CONTRACT = 0xCAFE, 0xC0DE


def _modexp_call(tr_, b_, Bytecode, bl, el, ml, base, exp, mod):
    stream = (bl.to_bytes(32, "big") + el.to_bytes(32, "big")
              + ml.to_bytes(32, "big") + base.to_bytes(bl, "big")
              + exp.to_bytes(el, "big") + mod.to_bytes(ml, "big"))
    code = Bytecode()
    for i in range(0, len(stream), 32):
        chunk = stream[i:i + 32].ljust(32, b"\x00")
        code.push(32, int.from_bytes(chunk, "big")).push(2, i).op("MSTORE")
    code.push(1, ml).push(2, 0x100)
    code.push(2, len(stream)).push(1, 0)
    code.push(1, 5).push(3, 0xFFFFF).op("STATICCALL").op("POP")
    code.push(2, 0x100).op("MLOAD").op("POP").op("STOP")
    st = tr_.StateDB({SENDER: tr_.Account(balance=10**18),
                      CONTRACT: tr_.Account(code=code.to_bytes())})
    tr = tr_.Interpreter(st).run_tx(tr_.Tx(from_addr=SENDER, to=CONTRACT))
    assert not tr.failed
    b = b_.CircuitInputBuilder()
    b.handle_tx(dict(from_addr=SENDER, to_addr=CONTRACT, value=0,
                     calldata=b""), tr, code_db={CONTRACT: code.to_bytes()})
    return b


@pytest.mark.parametrize("bl,el,ml,base,exp,mod", [
    (1, 1, 1, 3, 5, 7),                        # minimal
    (0, 1, 8, 0, 3, 0xFFFFFFFF_FFFFFFFB),      # empty base
])
def test_modexp_variable_lengths_match_reference(bl, el, ml, base, exp, mod):
    args = (bl, el, ml, base, exp, mod)
    t = _modexp_call(ttr, tb, TBytecode, *args)
    j = _modexp_call(jtr, jb, JBytecode, *args)
    assert _plain(t.modexp_events) == _plain(j.modexp_events)
    ev = t.modexp_events[-1]
    assert (ev.base, ev.exponent, ev.modulus, ev.result) == \
        (base, exp, mod, pow(base, exp, mod) if mod else 0)
    tp = TEvmParams(target_steps=64, rw_target=768)
    jp = JEvmParams(target_steps=64, rw_target=768)
    got = TMock(10, TEvm(t.steps, t.rws.rws, tp)).verify()
    assert got == JMock(10, JEvm(j.steps, j.rws.rws, jp)).verify() == []
    got = TMock(10, tmodexp.ModExpCircuit(t.modexp_events)).verify()
    assert got == JMock(10, jmodexp.ModExpCircuit(j.modexp_events)).verify() == []


def test_modexp_oversize_operand_raises():
    with pytest.raises(NotImplementedError):
        _modexp_call(ttr, tb, TBytecode, 33, 1, 1, 1 << 260, 1, 7)


# ---------------------------------------------------------------------------
# the goldens and the k=13 workloads


@pytest.mark.parametrize("name", ["modexp", "ecc"])
def test_golden_witness_matches_reference(name):
    jc, tc = demo.precompile_golden(name, JAX), demo.precompile_golden(name)
    assert _same_circuit(jc, tc, 9, seed=7) == []


def test_precompile_shapes():
    """The column, phase, gate polynomial and logUp counts of each
    golden's circuit."""
    shapes = {}
    for name in sorted(demo.PRECOMPILE_GOLDENS):
        cs = configured(demo.precompile_golden(name), PORT)
        shapes[name] = (cs.num_advice, cs.num_fixed,
                        max(cs.advice_phases) + 1,
                        sum(len(g.polys) for g in cs.gates), len(cs.logups),
                        sum(len(lg.inputs) for lg in cs.logups))
    assert shapes == {
        "sha256": (108, 11, 2, 181, 0, 0),
        "modexp": (508, 4, 1, 72, 3, 489),
        "ecc": (619, 7, 1, 121, 2, 505),
    }
    assert all(k == 9 and len(sha) == 64 and n > 0
               for k, sha, n in demo.PRECOMPILE_GOLDENS.values())


def test_k13_workloads_fill_the_rows():
    """The seeded k=13 workloads of bench_circuits: SHA-256 in whole
    blocks with the padding's edge lengths, ECC with every EcAdd case,
    ModExp with exponents 0 and 1 and modulus 0, each >= PRECOMPILE_FILL
    of the usable rows (ECC and ModExp: of whichever of the circuit's own
    rows and its MulMod rows runs out first); Sig one signature."""
    k, cap = 13, usable_rows(1 << 13)
    msgs, st = tbench.sha256_workload(7, k)
    assert [len(m) for m in msgs[:4]] == list(tbench.SHA256_EDGE_LENGTHS)
    assert all(len(m) <= 300 for m in msgs)
    assert st["blocks"] == sum(len(demo.precompile_modules()["sha256"]
                                   .sha256_trace(m)) for m in msgs)
    assert st["rows"] == 72 * st["blocks"] <= cap < st["rows"] + 72
    adds, muls, st_e = tbench.ecc_workload(7, k)
    assert {e._case() for e in adds} == {"pz", "qz", "opp", "dbl", "gen"}
    assert len(muls) == 1 and not muls[0].trivial
    assert st_e["mulmod_rows"] == 1 + sum(
        len(e.mulmod_events()) for e in adds + muls) <= cap
    events, st_m = tbench.modexp_workload(7, k)
    assert [e.exponent for e in events[:2]] == [0, 1]
    assert events[2].modulus == 0 and events[2].result == 0
    assert st_m["rows"] == sum(len(e.steps()) for e in events)
    assert st_m["mulmod_rows"] == st_m["rows"] + 1 <= cap
    for s in (st, st_e, st_m):
        assert s["fill"] >= tbench.PRECOMPILE_FILL and s["usable_rows"] == cap
    sig, st_s = tbench.sig_workload(7, k)
    assert len(sig) == 1 and st_s["rows"] == 258
    assert st_s["mulmod_rows"] == 1 + len(sig[0].mulmod_events()) <= cap


def test_small_workloads_satisfied():
    """The SHA-256 and ModExp workloads at k=10 satisfy the MockProver."""
    for name in ("sha256", "modexp"):
        c, st = tbench.precompile_circuit(name, 10, 3)
        assert st["fill"] >= tbench.PRECOMPILE_FILL
        assert TMock(10, c).verify() == []


# slow tier: the port's CPU proof against a golden (40 minutes to 4 hours)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(demo.PRECOMPILE_GOLDENS))
def test_cpu_proof_matches_golden(name):
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.PRECOMPILE_GOLDENS[name]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.precompile_golden(name), k, srs, device="cpu")
    proof = prove(pk, demo.precompile_golden(name), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                  device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, [], proof)
