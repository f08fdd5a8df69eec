"""Port EVM circuit (zkevm_circuits_tpu_torch.circuits.evm, and the
BlockTable's circuits.block it configures against) against the JAX
package's: the constraint system, the fixed columns and both phases'
witness columns at k=9 over the programs of tests/test_evm_circuit.py,
and MockProver verdicts on good witnesses and on that file's corruptions,
exact bytes, on the same seeded inputs.  The slow tier holds the k=14
workload's columns (chip_smoke.py's evm_k14 path) against the reference's
and the reference's proving key, passed through convert.py, against the
port's keygen at k=9."""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import block as jblk
from zkevm_circuits_tpu.circuits import evm as jevm
from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
from zkevm_circuits_tpu.plonk.circuit import assemble_fixed as j_fixed
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.circuits import block as tblk
from zkevm_circuits_tpu_torch.circuits import evm as tevm
from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem as TCS
from zkevm_circuits_tpu_torch.plonk.circuit import assemble_fixed as t_fixed
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench
from zkevm_circuits_tpu_torch.witness import builder as tb

torch.set_num_threads(2)
F = fr()
K = demo.EVM_GOLDEN_K
SENDER, CONTRACT = demo.EVM_GOLDEN_SENDER, demo.EVM_GOLDEN_CONTRACT
M256 = 1 << 256
MAX = M256 - 1  # -1 as a word
X = int.from_bytes(bytes(range(1, 33)), "big")
CHIP_SMOKE_SEED = 20261016  # chip_smoke.SEED

# programs of tests/test_evm_circuit.py the standalone circuit proves, by
# name: (code builder over a Bytecode class, calldata)
PROGRAMS = {
    "golden": (lambda B: B(demo.EVM_GOLDEN_CODE), b""),
    "push_add_pop": (lambda B: B().push(1, 5).push(2, 0x1234).op("ADD")
                     .op("POP").op("STOP"), b""),
    "sub_dup_swap_pc": (lambda B: B().push(1, 100).push(1, 30).op("JUMPDEST")
                        .op("DUP2").op("SUB").op("SWAP1").op("PC").op("POP")
                        .op("POP").op("POP").op("STOP"), b""),
    "mstore_mload": (lambda B: B().push(2, 0xBEEF).push(1, 7).op("MSTORE")
                     .push(1, 7).op("MLOAD").op("POP").op("STOP"), b""),
    "mstore": (lambda B: B().push(1, 0xAB).push(1, 0).op("MSTORE")
               .op("STOP"), b""),
    "sub_underflow": (lambda B: B().push(1, 9).push(1, 5).op("SUB").op("POP")
                      .op("STOP"), b""),
    "add_small": (lambda B: B().push(1, 5).push(1, 7).op("ADD").op("POP")
                  .op("STOP"), b""),
    "add_carry": (lambda B: B().push(1, 200).push(1, 100).op("ADD").op("POP")
                  .op("STOP"), b""),
    "mul_div_mod": (lambda B: B().push(32, M256 - 3).push(32, M256 - 5)
                    .op("MUL").op("POP").push(1, 7).push(1, 100).op("DIV")
                    .op("POP").push(1, 0).push(1, 5).op("DIV").op("POP")
                    .push(1, 7).push(1, 100).op("MOD").op("POP").push(1, 0)
                    .push(1, 9).op("MOD").op("POP").op("STOP"), b""),
    "div": (lambda B: B().push(1, 7).push(1, 100).op("DIV").op("POP")
            .op("STOP"), b""),
    "comparators": (lambda B: B().push(1, 5).push(2, 0x100).op("LT").op("POP")
                    .push(2, 0x100).push(1, 5).op("LT").op("POP").push(1, 9)
                    .push(1, 9).op("GT").op("POP").push(1, 7).push(1, 8)
                    .op("EQ").op("POP").push(1, 0).op("ISZERO").op("POP")
                    .push(32, M256 - 1 - 0xFF00).op("NOT").op("POP")
                    .op("STOP"), b""),
    "iszero": (lambda B: B().push(1, 42).op("ISZERO").op("POP").op("STOP"), b""),
    "pop": (lambda B: B().push(1, 5).op("POP").op("STOP"), b""),
    "storage": (lambda B: B().push(1, 0x42).push(1, 0x01).op("SSTORE")
                .push(1, 0x01).op("SLOAD").op("POP").push(1, 0x07)
                .op("SLOAD").op("POP").op("STOP"), b""),
    "context": (lambda B: B().op("CALLER").op("POP").op("ADDRESS").op("POP")
                .op("CALLVALUE").op("POP").op("CALLDATASIZE").op("POP")
                .op("STOP"), b"\x01\x02\x03"),
    "caller": (lambda B: B().op("CALLER").op("POP").op("STOP"), b""),
    "bitwise": (lambda B: B().push(32, X).push(32, X >> 5).op("AND").op("POP")
                .push(32, X).push(32, X >> 5).op("OR").op("POP")
                .push(32, X).push(32, X >> 5).op("XOR").op("POP")
                .op("STOP"), b""),
    "and": (lambda B: B().push(1, 0xF0).push(1, 0xFF).op("AND").op("POP")
            .op("STOP"), b""),
    "byte_shl_shr": (lambda B: B().push(32, X).push(1, 3).op("BYTE").op("POP")
                     .push(32, X).push(2, 300).op("BYTE").op("POP")
                     .push(1, 1).push(1, 4).op("SHL").op("POP")
                     .push(32, X).push(1, 200).op("SHL").op("POP")
                     .push(32, X).push(1, 100).op("SHR").op("POP")
                     .push(32, X).push(2, 300).op("SHR").op("POP")
                     .op("STOP"), b""),
    "shr": (lambda B: B().push(1, 0xF0).push(1, 4).op("SHR").op("POP")
            .op("STOP"), b""),
    "jump_jumpi": (lambda B: B().push(1, 4).op("JUMP").op("STOP")
                   .op("JUMPDEST").push(1, 1).push(1, 11).op("JUMPI")
                   .op("STOP").op("JUMPDEST").push(1, 0).push(1, 3)
                   .op("JUMPI").op("STOP"), b""),
    "jump": (lambda B: B().push(1, 3).op("JUMP").op("JUMPDEST").op("STOP"), b""),
    "mstore8": (lambda B: B().push(2, 0xBBAA).push(1, 5).op("MSTORE8")
                .push(1, 0).op("MLOAD").op("POP").op("STOP"), b""),
    "signed": (lambda B: B().push(1, 3).push(32, MAX - 12).op("SDIV")
               .op("POP").push(1, 3).push(32, MAX - 12).op("SMOD").op("POP")
               .push(1, 0x80).push(1, 0).op("SIGNEXTEND").op("POP")
               .push(2, 0x80FF).push(1, 1).op("SIGNEXTEND").op("POP")
               .push(32, MAX - 0xEE).push(1, 4).op("SAR").op("POP")
               .push(32, MAX).push(2, 300).op("SAR").op("POP")
               .push(1, 3).push(32, MAX - 12).op("SLT").op("POP")
               .push(32, 1 << 255).push(1, 0).op("SGT").op("POP")
               .op("STOP"), b""),
    "slt": (lambda B: B().push(1, 3).push(32, MAX - 12).op("SLT").op("POP")
            .op("STOP"), b""),
    "gas_msize": (lambda B: B().op("GAS").op("POP").op("MSIZE").op("POP")
                  .push(1, 0xAB).push(1, 64).op("MSTORE").op("MSIZE")
                  .op("POP").op("GAS").op("POP").op("STOP"), b""),
    "gas": (lambda B: B().op("GAS").op("POP").op("STOP"), b""),
}


def _steps(pkgs, name):
    """(steps, rws) of program `name` through one package's tracer and
    builder; `pkgs` is (types, tracer, builder)."""
    types, tracer, builder = pkgs
    make, data = PROGRAMS[name]
    code = make(types.Bytecode).to_bytes()
    state = tracer.StateDB({SENDER: tracer.Account(balance=10**18),
                            CONTRACT: tracer.Account(code=code)})
    tr = tracer.Interpreter(state).run_tx(
        tracer.Tx(from_addr=SENDER, to=CONTRACT, data=data))
    assert not tr.failed
    b = builder.CircuitInputBuilder()
    b.handle_tx(dict(from_addr=SENDER, to_addr=CONTRACT, value=0,
                     calldata=data), tr, code_db={CONTRACT: code})
    return b.steps, b.rws.rws


JAX = (jty, jtr, jb)
PORT = (tty, ttr, tb)


def _params(mod):
    return mod.EvmParams(target_steps=demo.EVM_GOLDEN_TARGET_STEPS,
                         rw_target=demo.EVM_GOLDEN_RW_TARGET)


def _both(name):
    jc = jevm.EvmCircuit(*_steps(JAX, name), _params(jevm))
    tc = tevm.EvmCircuit(*_steps(PORT, name), _params(tevm))
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    return jc, jcs, tc, tcs


def test_constraint_system_matches_reference():
    _, jcs, _, tcs = _both("golden")
    assert tcs.num_advice == jcs.num_advice == 434
    assert tcs.advice_phases == jcs.advice_phases
    assert sorted(set(tcs.advice_phases)) == [0, 1]
    assert tcs.num_fixed == jcs.num_fixed == 16
    assert tcs.num_instance == jcs.num_instance
    assert tcs.challenge_phases == jcs.challenge_phases == [0]
    assert [g.name for g in tcs.gates] == [g.name for g in jcs.gates]
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]
    assert sum(len(g.polys) for g in tcs.gates) == 1694
    assert [lk.name for lk in tcs.lookups] == [lk.name for lk in jcs.lookups]
    assert [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
             [repr(e) for e in lg.table]) for lg in tcs.logups] == \
        [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
          [repr(e) for e in lg.table]) for lg in jcs.logups]
    assert [len(lg.inputs) for lg in tcs.logups] == \
        [1, 64, 64, 64, 1, 2, 1, 1, 1, 3, 341, 367]
    assert tcs.perm_columns == jcs.perm_columns
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert tqd(tcs) == jqd(jcs) == 8


def _same_columns(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for ci in a:
        assert np.array_equal(np.asarray(a[ci]), np.asarray(b[ci])), ci


def _challenge(seed):
    """The word-RLC challenge drawn from `seed`, for each package."""
    v = int.from_bytes(np.random.default_rng(seed).bytes(32), "little") % R
    return np.asarray(F.scalar(v, "cpu")), F.scalar(v, "cpu")


def _columns(jc, jcs, tc, tcs, n, seed):
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    _same_columns(jc.synthesize(0, n, {}, []), tc.synthesize(0, n, {}, []))
    jch, tch = _challenge(seed)
    _same_columns(jc.synthesize(1, n, {0: jch}, []),
                  tc.synthesize(1, n, {0: tch}, []))


COLUMN_PROGRAMS = ["golden", "mul_div_mod", "comparators", "storage",
                   "context", "byte_shl_shr", "jump_jumpi", "signed",
                   "gas_msize"]


@pytest.mark.parametrize("name", COLUMN_PROGRAMS)
def test_columns_match_reference(name):
    jc, jcs, tc, tcs = _both(name)
    _columns(jc, jcs, tc, tcs, 1 << K, seed=len(name))


def _edit(cols, col, row, value):
    """Column `col` with the cell at `row` set to value(plain int there)."""
    arr = np.array(cols[col])
    cur = F.to_int(arr[row]) * pow(F.R, -1, R) % R
    arr[row] = F.from_int(value(cur) % R * F.R % R)
    cols[col] = arr


def _at(state, offset=0):
    return lambda c: next(i for i, s in enumerate(c.steps)
                          if s.exec_state == state) + offset


def _rw_row_of_last_access(state):
    """The standalone RW table row of the last access of the first step in
    `state` (phase 1: the table is built in phase 0)."""
    def row(c):
        last = c.steps[_at(state)(c)].rw_indices[-1]
        return next(i for i, r in enumerate(c._rw_rows) if r.rw_counter == last)
    return row


def _const(v):
    return lambda cur: v


# (program, [(phase, column of the circuit, row, new value from the old)]):
# the corruptions of tests/test_evm_circuit.py, and the memory byte with
# the RW table's value changed to match (only the word's gate can catch it)
CORRUPTIONS = {
    "wrong_mem_byte": ("mstore", [(0, lambda c: c.c_mem[31], _at("MSTORE"), _const(0x99))]),
    "wrong_mem_byte_bus_agrees": ("golden", [
        (0, lambda c: c.c_mem[31], _at("MSTORE"), _const(0x99)),
        (1, lambda c: c.t_val, _rw_row_of_last_access("MSTORE"), _const(0x99))]),
    "bad_stack_value": ("add_small", [(1, lambda c: c.c_val_c, _at("ADD"), _const(0xBAD))]),
    "wrong_sum": ("add_carry", [(0, lambda c: c.c_carry[0], _at("ADD"),
                                 lambda cur: 1 - (cur != 0))]),
    "wrong_quotient": ("div", [(0, lambda c: c.c_bytes_c[0], _at("DIV"), _const(15))]),
    "bad_iszero_inverse": ("iszero", [(1, lambda c: c.c_inv, _at("ISZERO"), _const(1))]),
    "bad_pc": ("pop", [(0, lambda c: c.c_pc, lambda c: 1, _const(99))]),
    "wrong_sload_value": ("storage", [(1, lambda c: c.c_val_b, _at("SLOAD"), _const(0x43))]),
    "wrong_caller_bytes": ("caller", [(0, lambda c: c.c_bytes_a[0], _at("CALLER"), _const(0x13))]),
    "wrong_and_nibble": ("and", [(0, lambda c: c.c_bytes_d[0], _at("AND"), _const(1))]),
    "wrong_shr_result": ("shr", [(0, lambda c: c.c_bytes_c[0], _at("SHR"), _const(0x0E))]),
    "wrong_jump_target": ("jump", [(0, lambda c: c.c_pc, _at("JUMP", 1), _const(5))]),
    "wrong_slt_result": ("slt", [(0, lambda c: c.c_gx[0], _at("SLT"), _const(0))]),
    "wrong_gas_push": ("gas", [(0, lambda c: c.c_bytes_a[0], _at("GAS"),
                                lambda cur: cur + 1)]),
}


def _corrupt(base, edits):
    class Corrupt(base):
        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            for ph, col, row, value in edits:
                if ph == phase:
                    _edit(cols, col(self), row(self), value)
            return cols

    return Corrupt


# the good witnesses: the programs not written for one corruption alone
GOOD = ["golden", "push_add_pop", "sub_dup_swap_pc", "mstore_mload",
        "sub_underflow", "mul_div_mod", "comparators", "storage", "context",
        "bitwise", "byte_shl_shr", "jump_jumpi", "mstore8", "signed",
        "gas_msize"]
VERDICT_CASES = [(name, None) for name in GOOD] + \
    [(prog, case) for case, (prog, _) in CORRUPTIONS.items()]


@pytest.mark.parametrize("name,corruption", VERDICT_CASES,
                         ids=[c or f"good-{n}" for n, c in VERDICT_CASES])
def test_mock_verdicts_match_reference(name, corruption):
    jcls, tcls = jevm.EvmCircuit, tevm.EvmCircuit
    if corruption is not None:
        edits = CORRUPTIONS[corruption][1]
        jcls, tcls = _corrupt(jcls, edits), _corrupt(tcls, edits)
    want = JMock(K, jcls(*_steps(JAX, name), _params(jevm))).verify()
    got = TMock(K, tcls(*_steps(PORT, name), _params(tevm))).verify()
    assert got == want
    assert bool(got) == (corruption is not None), got
    if corruption == "wrong_mem_byte_bus_agrees":
        assert got == ["gate 'MEM word rlc' poly 0 not satisfied at rows [3]"]


def test_block_circuit_matches_reference():
    """circuits/block.py, whose BlockFieldTag the EVM circuit's context
    gadgets name: its constraint system and columns."""
    env = dict(number=1234, timestamp=99, gas_limit=30_000_000, base_fee=7,
               difficulty=0xDEADBEEF << 100, chain_id=1337,
               coinbase=0xC014BA5E,
               prev_hashes={1234 - i: (i * 0x9E3779B97F4A7C15) % M256
                            for i in range(1, 40)})
    jc, tc = jblk.BlockCircuit(jtr.BlockEnv(**env)), tblk.BlockCircuit(ttr.BlockEnv(**env))
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    assert [int(t) for t in tblk.BlockFieldTag] == [int(t) for t in jblk.BlockFieldTag]
    assert tcs.advice_phases == jcs.advice_phases
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]
    _columns(jc, jcs, tc, tcs, 1 << K, seed=5)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []


# ---------------------------------------------------------------------------
# slow tier


@pytest.mark.slow
def test_k14_workload_columns_match_reference(monkeypatch):
    """chip_smoke.py's evm_k14 witness (bench_circuits.evm_workload at
    its seed, k=14, EvmParams()) through both packages: 434 columns of
    2^14 rows, fixed and both phases."""
    k = 14
    tb_, tstats = tbench.evm_workload(CHIP_SMOKE_SEED, k)
    for name, mod in (("StateDB", jtr), ("Account", jtr), ("Interpreter", jtr),
                      ("Tx", jtr), ("Bytecode", jty),
                      ("CircuitInputBuilder", jb), ("AccountState", jb)):
        monkeypatch.setattr(tbench, name, getattr(mod, name))
    jb_, jstats = tbench.evm_workload(CHIP_SMOKE_SEED, k)
    assert tstats == jstats and tstats["rw_fill"] >= 0.9
    jc = jevm.EvmCircuit(jb_.steps, jb_.rws.rws, jevm.EvmParams())
    tc = tevm.EvmCircuit(tb_.steps, tb_.rws.rws, tevm.EvmParams())
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    _columns(jc, jcs, tc, tcs, 1 << k, seed=14)


@pytest.mark.slow
def test_reference_proving_key_converts_to_port_keygen():
    """The JAX package's EVM proving key at k=9, as numpy through
    convert.proving_key_from_numpy, against the port's keygen."""
    from zkevm_circuits_tpu.plonk.keygen import keygen as jkeygen
    from zkevm_circuits_tpu.poly.kzg import Srs as JSrs
    from zkevm_circuits_tpu_torch.convert import PK_ARRAYS, proving_key_from_numpy
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    jsrs = JSrs.unsafe_setup(K, tau=demo.EVM_GOLDEN_TAU)
    jpk, jvk = jkeygen(jevm.EvmCircuit(*_steps(JAX, "golden"), _params(jevm)),
                       K, jsrs)
    srs = Srs.unsafe_setup(K, tau=demo.EVM_GOLDEN_TAU, device="cpu")
    circuit = tevm.EvmCircuit(*_steps(PORT, "golden"), _params(tevm))
    pk, vk = keygen(circuit, K, srs, device="cpu")
    conv = proving_key_from_numpy(
        circuit, K, {name: np.asarray(getattr(jpk, name)) for name in PK_ARRAYS},
        {"fixed_commitments": jvk.fixed_commitments,
         "sigma_commitments": jvk.sigma_commitments,
         "g2": jvk.g2, "s_g2": jvk.s_g2},
        jpk.delta_pows, device="cpu")
    assert conv.vk.fixed_commitments == vk.fixed_commitments == jvk.fixed_commitments
    assert conv.vk.sigma_commitments == vk.sigma_commitments
    for name in PK_ARRAYS:
        assert torch.equal(getattr(conv, name), getattr(pk, name)), name
    assert conv.k_ext == pk.k_ext == K + 3
