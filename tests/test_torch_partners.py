"""The EVM's table partners in the port (zkevm_circuits_tpu_torch.circuits
mulmod, exp, bytecode, copy, and the testing.py harness) against the JAX
package's: the constraint system, the fixed columns and every phase's
witness columns of each small-k golden witness (plonk/demo.py), and the
MockProver verdicts on the good witnesses and on every corruption of
tests/test_exp_circuit.py, test_copy_circuit.py, test_bytecode_circuit.py
and test_testing_harness.py, exact bytes, on the same inputs.
tests/test_torch_bytecode_keccak.py does the same for the Bytecode +
Keccak binding, tests/test_torch_tx_rlp.py for the RLP and Tx circuits."""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import testing as jtesting
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import bytecode as jbytecode
from zkevm_circuits_tpu.circuits import copy as jcopy
from zkevm_circuits_tpu.circuits import exp as jexp
from zkevm_circuits_tpu.circuits import keccak as jkeccak
from zkevm_circuits_tpu.circuits import mulmod as jmulmod
from zkevm_circuits_tpu.circuits import rlp as jrlp
from zkevm_circuits_tpu.circuits import tx as jtx
from zkevm_circuits_tpu.plonk import circuit as jcircuit
from zkevm_circuits_tpu.plonk.expression import Fixed as JFixed
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.types import transaction as jtransaction
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu.witness import rw as jrw
from zkevm_circuits_tpu.witness import test_ctx as jctx
from zkevm_circuits_tpu_torch import testing as ttesting
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.circuits import bytecode as tbytecode
from zkevm_circuits_tpu_torch.circuits import exp as texp
from zkevm_circuits_tpu_torch.circuits import keccak as tkeccak
from zkevm_circuits_tpu_torch.circuits import mulmod as tmulmod
from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import circuit as tcircuit
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.expression import Fixed as TFixed
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.witness import builder as tb
from zkevm_circuits_tpu_torch.witness import rw as trw
from zkevm_circuits_tpu_torch.witness import test_ctx as tctx

torch.set_num_threads(2)
F = fr()
M256 = 1 << 256

JAX = dict(types=jty, transaction=jtransaction, tracer=jtr, builder=jb,
           mulmod=jmulmod, exp=jexp, bytecode=jbytecode, tx=jtx, copy=jcopy,
           rlp=jrlp, keccak=jkeccak, circuit=jcircuit, mock=JMock, rw=jrw,
           testing=jtesting, test_ctx=jctx, Fixed=JFixed)
PORT = dict(demo.port_modules(), keccak=tkeccak, circuit=tcircuit, mock=TMock,
            rw=trw, testing=ttesting, test_ctx=tctx, Fixed=TFixed)


# ---------------------------------------------------------------------------
# shared checks (tests/test_torch_tx_rlp.py uses them too)


def configured(circuit, pkg, **kw):
    cs = pkg["circuit"].ConstraintSystem()
    circuit.configure(cs, **kw)
    return cs


def assert_same_cs(tcs, jcs):
    """Column counts and phases, gates and their polynomials, lookups,
    logUp arguments, permutation columns, queries and quotient degree."""
    assert tcs.num_advice == jcs.num_advice
    assert tcs.advice_phases == jcs.advice_phases
    assert tcs.num_fixed == jcs.num_fixed
    assert tcs.num_instance == jcs.num_instance
    assert tcs.challenge_phases == jcs.challenge_phases
    assert [g.name for g in tcs.gates] == [g.name for g in jcs.gates]
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]
    assert [(lk.name, repr(lk)) for lk in tcs.lookups] == \
        [(lk.name, repr(lk)) for lk in jcs.lookups]
    assert [(lg.name, [[repr(e) for e in tup] for tup in lg.inputs],
             [repr(e) for e in lg.table]) for lg in tcs.logups] == \
        [(lg.name, [[repr(e) for e in tup] for tup in lg.inputs],
          [repr(e) for e in lg.table]) for lg in jcs.logups]
    assert tcs.perm_columns == jcs.perm_columns
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert tqd(tcs) == jqd(jcs)


def _same_columns(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for ci in a:
        assert np.array_equal(np.asarray(a[ci]), np.asarray(b[ci])), ci


def challenge(seed):
    """A challenge drawn from `seed`, for each package (JAX, port)."""
    v = int.from_bytes(np.random.default_rng(seed).bytes(32), "little") % R
    return np.asarray(F.scalar(v, "cpu")), F.scalar(v, "cpu")


def assert_same_columns(jc, jcs, tc, tcs, n, seed):
    """The fixed columns and the columns of every phase, each later phase
    given the same challenges in both packages."""
    assert np.array_equal(jcircuit.assemble_fixed(jc, jcs, n),
                          tcircuit.assemble_fixed(tc, tcs, n))
    jch, tch = {}, {}
    for phase in range(max(tcs.advice_phases, default=0) + 1):
        if phase:
            for i, ph in enumerate(tcs.challenge_phases):
                if ph == phase - 1:
                    jch[i], tch[i] = challenge(seed + i)
        _same_columns(jc.synthesize(phase, n, dict(jch), []),
                      tc.synthesize(phase, n, dict(tch), []))


def plain(arr, row) -> int:
    """The plain value of a Montgomery digit row."""
    return int.from_bytes(bytes(np.asarray(arr[row])), "little") * pow(F.R, -1, R) % R


def edit(cols, col, row, value):
    """Column `col` with the cell at `row` set to value(plain value)."""
    arr = np.array(cols[col])
    arr[row] = F.from_int(value(plain(arr, row)) % R * F.R % R)
    cols[col] = arr


def corrupt(base, edits):
    """`base` with `edits` [(phase, column of the circuit, row of the
    circuit, new value from the old)] applied to its synthesized columns."""
    class Corrupt(base):
        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            for ph, col, row, value in edits:
                if ph == phase:
                    edit(cols, col(self), row(self), value)
            return cols

    return Corrupt


def audit_phases(cs):
    """tests/test_phase_discipline.py::_audit: every challenge in phase 0,
    every phase-1 advice column referenced by a gate or a lookup."""
    assert all(p == 0 for p in cs.challenge_phases)
    referenced = {col for kind, col, _ in cs.all_queries() if kind == "advice"}
    free = [ci for ci, ph in enumerate(cs.advice_phases)
            if ph >= 1 and ci not in referenced]
    assert not free, free


# ---------------------------------------------------------------------------
# the goldens' witnesses: constraint system and columns


@pytest.mark.parametrize("name", sorted(demo.PARTNER_GOLDENS))
def test_golden_witness_matches_reference(name):
    k = demo.PARTNER_GOLDENS[name][0]
    jc, tc = demo.partner_golden(name, JAX), demo.partner_golden(name)
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << k, seed=k)
    assert TMock(k, tc).verify() == JMock(k, jc).verify() == []


def test_partner_shapes():
    """The column, gate and logUp counts of each standalone circuit."""
    shapes = {}
    for name in sorted(demo.PARTNER_GOLDENS):
        cs = configured(demo.partner_golden(name), PORT)
        shapes[name] = (cs.num_advice, cs.num_fixed,
                        max(cs.advice_phases) + 1, len(cs.gates),
                        len(cs.logups), sum(len(lg.inputs) for lg in cs.logups))
    assert shapes == {
        "mulmod": (428, 2, 1, 25, 1, 424),
        "exp": (185, 3, 1, 30, 1, 178),
        "bytecode": (10, 3, 2, 16, 1, 1),
        "rlp": (34, 9, 2, 87, 7, 7),
        "tx": (13, 9, 2, 13, 1, 1),
        "copy": (28, 3, 2, 40, 2, 3),
    }


# ---------------------------------------------------------------------------
# MulMod: the builder's events


@pytest.mark.parametrize("wide", [False, True])
def test_mulmod_circuit_matches_reference(wide):
    """MULMOD/ADDMOD events through both builders, then the circuit's
    columns and verdicts; `wide` adds 256-bit operands and a padded
    target."""
    ops = demo.MULMOD_GOLDEN_OPS if wide else demo.MULMOD_GOLDEN_OPS[:3]
    circs = []
    for pkg in (JAX, PORT):
        code = pkg["types"].Bytecode()
        for op, nn, b, a in ops:
            code.push(32, nn).push(32, b).push(32, a).op(op).op("POP")
        b = demo.partner_builder(pkg, code.op("STOP").to_bytes())
        params = pkg["mulmod"].MulModParams(target_rows=10 if wide else 0)
        circs.append(pkg["mulmod"].MulModCircuit(b.mulmod_events, params))
    jc, tc = circs
    assert [vars(e) for e in tc.events] == [vars(e) for e in jc.events]
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << 9, seed=3)
    assert TMock(9, tc).verify() == JMock(9, jc).verify() == []


def test_mulmod_catches_wrong_result():
    """The claimed remainder's low byte bumped on the first row."""
    edits = [(0, lambda c: c.c_r[0], lambda c: 0, lambda v: (v + 1) % 256)]
    got, want = (
        TMock(9, corrupt(tmulmod.MulModCircuit, edits)(
            demo.partner_golden("mulmod").events)).verify(),
        JMock(9, corrupt(jmulmod.MulModCircuit, edits)(
            demo.partner_golden("mulmod", JAX).events)).verify())
    assert got == want and got


# ---------------------------------------------------------------------------
# Exp (tests/test_exp_circuit.py)


def _exp_events(pkg, pairs):
    code = pkg["types"].Bytecode()
    for base, e in pairs:
        code.push(32, e).push(32, base).op("EXP").op("POP")
    return demo.partner_builder(pkg, code.op("STOP").to_bytes()).exp_events


def _bump_d0(v):
    return (v + 1) % 256


EXP_CASES = {
    "satisfied": ([(3, 5), (2**120 + 7, 2**130 + 3)], []),
    "overflow_wraps": ([(2**255 + 17, 19)], []),
    "wrong_result": ([(7, 6)], [(0, lambda c: c.c_d[0], lambda c: 0, _bump_d0)]),
}


@pytest.mark.parametrize("case", sorted(EXP_CASES))
def test_exp_verdicts_match_reference(case):
    pairs, edits = EXP_CASES[case]
    jev, tev = _exp_events(JAX, pairs), _exp_events(PORT, pairs)
    assert [vars(e) for e in tev] == [vars(e) for e in jev]
    assert tev[0].exponentiation == pow(*pairs[0], M256)
    got = TMock(9, corrupt(texp.ExpCircuit, edits)(tev)).verify()
    want = JMock(9, corrupt(jexp.ExpCircuit, edits)(jev)).verify()
    assert got == want
    assert bool(got) == bool(edits), got


def test_exp_by_squaring_matches_reference():
    js, ts = [], []
    assert tb.exp_by_squaring(23, 123, ts) == jb.exp_by_squaring(23, 123, js)
    assert ts == js


# ---------------------------------------------------------------------------
# Copy (tests/test_copy_circuit.py)


def _copy_circuit(pkg, length, src, edits=()):
    data = demo.COPY_GOLDEN_CALLDATA
    code = (pkg["types"].Bytecode().push(1, length).push(1, src).push(1, 0)
            .op("CALLDATACOPY").op("STOP").to_bytes())
    b = demo.partner_builder(pkg, code, data)
    cls = corrupt(pkg["copy"].CopyCircuit, list(edits))
    return cls(b.copy_events, rw_rows=b.rws.rws,
               tx_rows=[(1, i, byte) for i, byte in enumerate(data)])


COPY_CASES = {
    "satisfied": (4, 0, []),
    "out_of_range_pad": (6, 2, []),
    "corrupt_byte": (4, 0, [(0, lambda c: c.c_byte, lambda c: 2,
                            lambda v: 0x99)]),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copy_verdicts_match_reference(case):
    length, src, edits = COPY_CASES[case]
    jc, tc = _copy_circuit(JAX, length, src, edits), _copy_circuit(PORT, length, src, edits)
    assert [vars(e) for e in tc.events] == [vars(e) for e in jc.events]
    if not edits:
        jcs, tcs = configured(jc, JAX), configured(tc, PORT)
        assert_same_columns(jc, jcs, tc, tcs, 1 << 7, seed=length)
    got, want = TMock(7, tc).verify(), JMock(7, jc).verify()
    assert got == want
    assert bool(got) == bool(edits), got


# ---------------------------------------------------------------------------
# Bytecode (tests/test_bytecode_circuit.py)


def _rows_edit(row, field, value):
    """A BytecodeCircuit._rows hook: row `row`'s tuple field `field` set."""
    def hook(rows):
        bad = list(rows)
        r = list(bad[row])
        for f in field:
            r[f] = value
        bad[row] = tuple(r)
        return bad
    return hook


BYTECODE_CASES = {
    "satisfied": (demo.BYTECODE_GOLDEN_CODES, None),
    "empty_code": ((b"",), None),
    "bad_is_code": (demo.BYTECODE_GOLDEN_CODES, _rows_edit(2, (4,), 1)),
    "bad_length": (demo.BYTECODE_GOLDEN_CODES, _rows_edit(0, (2, 3), 99)),
    "bad_byte_range": (demo.BYTECODE_GOLDEN_CODES, _rows_edit(1, (3,), 300)),
}


def _bytecode_circuit(pkg, codes, hook):
    base = pkg["bytecode"].BytecodeCircuit
    if hook is not None:
        class Corrupt(base):
            def _rows(self, n):
                return hook(super()._rows(n))
        base = Corrupt
    return base([pkg["types"].Bytecode(c) for c in codes])


@pytest.mark.parametrize("case", sorted(BYTECODE_CASES))
def test_bytecode_verdicts_match_reference(case):
    codes, hook = BYTECODE_CASES[case]
    got = TMock(9, _bytecode_circuit(PORT, codes, hook)).verify()
    want = JMock(9, _bytecode_circuit(JAX, codes, hook)).verify()
    assert got == want
    assert bool(got) == (hook is not None), got
    if case == "bad_byte_range":
        assert any("push table" in f for f in got), got


def test_bytecode_push_sizes_match_reference():
    assert [tbytecode.push_size_of(b) for b in range(256)] == \
        [jbytecode.push_size_of(b) for b in range(256)]


def test_bytecode_phases_match_reference():
    """tests/test_phase_discipline.py::test_bytecode_circuit_phases."""
    codes = [bytes([0x60, 1, 0x00])]
    tcs = configured(tbytecode.BytecodeCircuit([tty.Bytecode(c) for c in codes]), PORT)
    jcs = configured(jbytecode.BytecodeCircuit([jty.Bytecode(c) for c in codes]), JAX)
    assert tcs.advice_phases == jcs.advice_phases
    audit_phases(tcs)


# ---------------------------------------------------------------------------
# the harness (tests/test_testing_harness.py)


def _harness(pkg, case):
    contract = pkg["test_ctx"].MOCK_ACCOUNTS[1]
    B = pkg["types"].Bytecode
    ctx = pkg["test_ctx"].TestContext()
    if case == "arith_memory_storage":
        code = (B().push(1, 5).push(1, 7).op("ADD").push(1, 0).op("MSTORE")
                .push(1, 3).push(1, 1).op("SSTORE").push(1, 1).op("SLOAD")
                .op("POP").push(1, 0).op("MLOAD").op("POP").op("STOP"))
        ctx = ctx.account(contract, code=code)
    elif case == "existing_storage":
        code = B().push(1, 1).op("SLOAD").op("POP").op("STOP")
        ctx = ctx.account(contract, code=code, storage={1: 42})
    else:
        code = B().push(1, 5).push(1, 7).op("ADD").op("POP").op("STOP")
        ctx = ctx.account(contract, code=code)
    b = pkg["testing"].CircuitTestBuilder(ctx.tx(to=contract))
    if case == "corrupt_rw":
        def corrupt_rw(builder):
            for r in builder.rws.rws:
                if r.tag == pkg["rw"].RwTag.Stack and not r.is_write:
                    r.value = (r.value + 1) % (1 << 16)
                    break
        b = b.block_modifier(corrupt_rw)
    return b


def _run(b) -> str:
    try:
        b.run()
    except AssertionError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("case", ["arith_memory_storage", "existing_storage",
                                  "corrupt_rw"])
def test_harness_matches_reference(case):
    got, want = _run(_harness(PORT, case)), _run(_harness(JAX, case))
    assert got == want
    assert bool(got) == (case == "corrupt_rw"), got


# ---------------------------------------------------------------------------
# the full-width workloads of service/bench_circuits.py (chip_smoke.py's
# partners_k16 path)

CHIP_SMOKE_SEED = 20261016  # chip_smoke.SEED


def _jax_bench(monkeypatch):
    """bench_circuits with the JAX package's tracer, builder and types."""
    from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

    for name, mod in (("StateDB", jtr), ("Account", jtr), ("Interpreter", jtr),
                      ("Tx", jtr), ("Bytecode", jty),
                      ("CircuitInputBuilder", jb)):
        monkeypatch.setattr(tbench, name, getattr(mod, name))
    monkeypatch.setattr(tbench, "ExpCircuit", jexp.ExpCircuit)
    monkeypatch.setattr(tbench, "CopyCircuit", jcopy.CopyCircuit)
    monkeypatch.setattr(tbench, "BytecodeCircuit", jbytecode.BytecodeCircuit)
    return tbench


@pytest.mark.parametrize("name,k", [("exp", 11), ("copy", 10), ("bytecode", 10)])
def test_workload_matches_reference(monkeypatch, name, k):
    """A partner workload at small k through the port's tracer and builder
    and through the reference's: the same stats, constraint system,
    columns and (empty) MockProver verdicts."""
    from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

    tc, tstats = tbench.partner_circuit(name, k, CHIP_SMOKE_SEED)
    jc, jstats = _jax_bench(monkeypatch).partner_circuit(name, k, CHIP_SMOKE_SEED)
    tstats.pop("workload_s")
    jstats.pop("workload_s")
    assert tstats == jstats
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << k, seed=k)
    assert TMock(k, tc).verify() == JMock(k, jc).verify() == []


def test_k16_workloads_fill_the_rows():
    """partners_k16's workloads: at least PARTNER_FILL of the usable rows
    of 2^16, with the edge cases they promise."""
    from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

    b, st = tbench.exp_workload(CHIP_SMOKE_SEED, 16)
    assert st["fill"] >= tbench.PARTNER_FILL
    assert {0, 1} <= {ev.base for ev in b.exp_events}
    assert st["exps"] == st["events"] + 2  # exponents 0 and 1: no rows
    b, tx_rows, st = tbench.copy_workload(CHIP_SMOKE_SEED, 16)
    assert st["fill"] >= tbench.PARTNER_FILL and st["padded_bytes"] > 0
    assert st["kinds"] == ["bytecode->memory", "calldata->memory", "memory->txlog"]
    assert st["memory_rw_rows"] <= st["usable_rows"] and len(tx_rows) >= 4000
    codes, st = tbench.bytecode_workload(CHIP_SMOKE_SEED, 16)
    assert st["fill"] >= tbench.PARTNER_FILL
    assert len(codes[0]) == 0 and any(len(c) % 32 for c in codes)
    pushes = {b for c in codes for b, m in zip(c.to_bytes(), c.is_code_marks())
              if m and 0x60 <= b <= 0x7F}
    assert pushes == set(range(0x60, 0x80))  # PUSH1 to PUSH32


# ---------------------------------------------------------------------------
# slow tier: the port's CPU proof against a golden (minutes each)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["copy", "bytecode"])
def test_cpu_proof_matches_golden(name):
    import hashlib

    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.PARTNER_GOLDENS[name]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.partner_golden(name), k, srs, device="cpu")
    proof = prove(pk, demo.partner_golden(name), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                  device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, [], proof)
