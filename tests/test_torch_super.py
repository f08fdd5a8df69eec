"""Port SuperCircuit (zkevm_circuits_tpu_torch.circuits.super_circuit)
against the JAX package's, on the same witnesses: the constraint system
of the k=9 golden witness (plonk/demo.py::super_golden, the witness of
tests/test_super_circuit.py::_witness) and of the full composition, its
fixed and both phases' advice columns, the phase-discipline audit of
tests/test_phase_discipline.py on the port's configure, and MockProver
verdicts case by case.

The verdict cases run the reference's own tests twice: as they are, and
as their port twin, the same source with every import of the JAX package
pointed at the port (`twin`).  Each MockProver built in a test records
its verdict, and the two runs' verdicts must be equal, list for list.
tests/test_torch_super_cases.py holds the other half of the cases and the
slow tier's k=13 ones."""

import importlib
import inspect
import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import super_circuit as jsuper
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
from zkevm_circuits_tpu.plonk.circuit import assemble_fixed as j_fixed
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.types import transaction as jtx
from zkevm_circuits_tpu.utils.stats import circuit_stats as j_stats
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu_torch.crypto import field as tfield
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem as TCS
from zkevm_circuits_tpu_torch.plonk.circuit import assemble_fixed as t_fixed
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.utils.stats import circuit_stats as t_stats

torch.set_num_threads(2)
F = tfield.fr()
K = demo.SUPER_GOLDEN_K
JAX = dict(types=jty, transaction=jtx, tracer=jtr, builder=jb,
           keccak=jkeccak, super_circuit=jsuper)


# ---------------------------------------------------------------------------
# the reference's tests and their port twins

class _HostFr:
    """The port's Fr for the twins: the reference's tests hand numpy
    arrays to from_mont, which the port sends to the card unless told
    otherwise; here they stay on the CPU."""

    def __init__(self):
        self._f = tfield.fr()

    def __getattr__(self, name):
        return getattr(self._f, name)

    def from_mont(self, a):
        return self._f.from_mont(tfield.as_tensor(a, "cpu"))


_FIELD_SHIM = types.ModuleType("torch_twin_field")
_FIELD_SHIM.fr = _HostFr


def twin(modname: str) -> types.ModuleType:
    """The port twin of tests/<modname>.py: its source executed with
    every import of the JAX package pointed at the port (the field module
    at _HostFr), and its imports of other test modules at their twins."""
    name = "torch_twin_" + modname
    if name not in sys.modules:
        sys.modules.setdefault("torch_twin_field", _FIELD_SHIM)
        ref = importlib.import_module(modname)
        src = pathlib.Path(ref.__file__).read_text()
        for dep in set(re.findall(r"^\s*from (test_\w+) import", src, re.M)):
            twin(dep)
        src = re.sub(r"^(\s*)from (test_\w+) import", r"\1from torch_twin_\2 import",
                     src, flags=re.M)
        src = src.replace("zkevm_circuits_tpu.crypto.field", "torch_twin_field")
        src = re.sub(r"\bzkevm_circuits_tpu\b", "zkevm_circuits_tpu_torch", src)
        mod = types.ModuleType(name)
        mod.__file__ = ref.__file__
        sys.modules[name] = mod
        exec(compile(src, ref.__file__, "exec"), mod.__dict__)
    return sys.modules[name]


def _fixture_value(mod, name: str, cache: dict):
    """The value of module fixture `name` of `mod` (module scope)."""
    if (mod, name) not in cache:
        fx = getattr(mod, name)
        fn = (fx._get_wrapped_function() if hasattr(fx, "_get_wrapped_function")
              else getattr(getattr(fx, "__pytest_wrapped__", None), "obj", fx))
        cache[(mod, name)] = fn()
    return cache[(mod, name)]


_FIXTURES: dict = {}


def run_recording(mod, test: str) -> list:
    """Run mod.<test> with its MockProver recording each verdict; the
    list of verdicts (each a list of failure strings)."""
    seen = []
    base = mod.MockProver

    class Recording(base):
        def verify(self):
            out = super().verify()
            seen.append(out)
            return out

    fn = getattr(mod, test)
    args = [_fixture_value(mod, p, _FIXTURES)
            for p in inspect.signature(fn).parameters]
    mod.MockProver = Recording
    try:
        fn(*args)
    finally:
        mod.MockProver = base
    return seen


def verdicts_match(modname: str, test: str):
    """The reference test and its port twin pass, and every MockProver
    verdict of the twin equals the reference's."""
    want = run_recording(importlib.import_module(modname), test)
    got = run_recording(twin(modname), test)
    assert want, "the test built no MockProver"
    assert got == want


class _Captured(Exception):
    pass


def first_circuit(mod, test: str):
    """(k, circuit, instances) of the first MockProver mod.<test> builds
    (the test stops there)."""
    base = mod.MockProver

    class Capture(base):
        def __init__(self, k, circuit, instances=None):
            raise _Captured(k, circuit, instances)

    mod.MockProver = Capture
    try:
        getattr(mod, test)()
    except _Captured as e:
        return e.args
    finally:
        mod.MockProver = base
    raise AssertionError(f"{test} built no MockProver")


# ---------------------------------------------------------------------------
# constraint system and columns

def _systems(jc, tc):
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    return jcs, tcs


def _same_system(jcs, tcs):
    assert tcs.num_advice == jcs.num_advice
    assert tcs.advice_phases == jcs.advice_phases
    assert tcs.num_fixed == jcs.num_fixed
    assert tcs.num_instance == jcs.num_instance
    assert tcs.challenge_phases == jcs.challenge_phases == [0]
    assert [g.name for g in tcs.gates] == [g.name for g in jcs.gates]
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]
    assert [lk.name for lk in tcs.lookups] == [lk.name for lk in jcs.lookups]
    assert [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
             [repr(e) for e in lg.table]) for lg in tcs.logups] == \
        [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
          [repr(e) for e in lg.table]) for lg in jcs.logups]
    assert tcs.perm_columns == jcs.perm_columns
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert t_stats(tcs) == j_stats(jcs)
    assert tqd(tcs) == jqd(jcs)


def _copies(c, n):
    """The copy constraints of circuit `c` as plain tuples."""
    return [tuple((x.kind, x.col, x.row) for x in pair)
            for pair in c.copy_constraints(n)]


def _shape(cs):
    return (cs.num_advice, cs.num_fixed, sum(len(g.polys) for g in cs.gates),
            len(cs.logups), sum(len(lg.inputs) for lg in cs.logups), tqd(cs))


def test_constraint_system_matches_reference():
    jc, tc = demo.super_golden(JAX), demo.super_golden()
    assert [type(s).__name__ for s in tc.subs] == [type(s).__name__ for s in jc.subs] \
        == ["StateCircuit", "EvmCircuit", "BytecodeCircuit", "TxCircuit", "RlpCircuit"]
    assert tc.bind_bytecode and jc.bind_bytecode
    jcs, tcs = _systems(jc, tc)
    _same_system(jcs, tcs)
    assert _shape(tcs) == (605, 39, 1938, 30, 1059, 9)
    assert _copies(tc, 1 << K) == _copies(jc, 1 << K)


def test_full_composition_constraint_system_matches_reference():
    """tests/test_super_circuit.py::test_super_circuit_full_composition's
    circuit (Copy, Exp, MulMod, Keccak, PI and Poseidon on), configured
    only: its k=13 MockProver is the slow tier's."""
    mod = "test_super_circuit"
    test = "test_super_circuit_full_composition"
    jk, jc, jinst = first_circuit(importlib.import_module(mod), test)
    tk, tc, tinst = first_circuit(twin(mod), test)
    assert (tk, tinst) == (jk, jinst)
    assert [type(s).__name__ for s in tc.subs] == [type(s).__name__ for s in jc.subs]
    jcs, tcs = _systems(jc, tc)
    _same_system(jcs, tcs)
    assert _copies(tc, 1 << tk) == _copies(jc, 1 << tk) != []


def _same_columns(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for ci in a:
        assert np.array_equal(np.asarray(a[ci]), np.asarray(b[ci])), ci


# witnesses whose fixed and both phases' columns are compared: the golden,
# and reference tests' circuits that switch on MulMod, Copy and the block
COLUMN_CASES = ["golden", "test_super_circuit_mulmod_composed",
                "test_super_circuit_codecopy",
                "test_super_circuit_block_context_ops"]


@pytest.mark.parametrize("case", COLUMN_CASES)
def test_columns_match_reference(case):
    if case == "golden":
        k, jc, tc = K, demo.super_golden(JAX), demo.super_golden()
    else:
        k, jc, _ = first_circuit(importlib.import_module("test_super_circuit"), case)
        _, tc, _ = first_circuit(twin("test_super_circuit"), case)
    jcs, tcs = _systems(jc, tc)
    n = 1 << k
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    _same_columns(jc.synthesize(0, n, {}, []), tc.synthesize(0, n, {}, []))
    v = int.from_bytes(np.random.default_rng(len(case)).bytes(32), "little") % R
    _same_columns(jc.synthesize(1, n, {0: np.asarray(F.scalar(v, "cpu"))}, []),
                  tc.synthesize(1, n, {0: F.scalar(v, "cpu")}, []))


def test_golden_witness_is_the_reference_tests():
    """plonk/demo.py's golden witness is tests/test_super_circuit.py::
    _witness(): the same RW rows, steps, code and signed transaction."""
    import test_super_circuit as ref

    b, codes, txs = ref._witness()
    gb, gcodes, gtxs = demo.super_witness(JAX)
    assert [c.to_bytes() for c in gcodes] == [c.to_bytes() for c in codes]
    assert [t.rlp_signed() for t in gtxs] == [t.rlp_signed() for t in txs]
    assert [(r.rw_counter, int(r.tag), r.value) for r in gb.rws.rws] == \
        [(r.rw_counter, int(r.tag), r.value) for r in b.rws.rws]
    assert [s.exec_state for s in gb.steps] == [s.exec_state for s in b.steps]


# ---------------------------------------------------------------------------
# the phase discipline on the port's configure

PHASE_TESTS = ["test_state_circuit_phases", "test_rlp_circuit_phases",
               "test_keccak_circuit_phases", "test_bytecode_circuit_phases",
               "test_super_circuit_phases"]


@pytest.mark.parametrize("test", PHASE_TESTS)
def test_phase_discipline_on_port(test):
    """tests/test_phase_discipline.py's audit (every challenge in phase 0,
    no phase-1 advice column left free) over the port's configure; the
    SuperCircuit case with PI and with_sig on."""
    mod = twin("test_phase_discipline")
    assert mod.ConstraintSystem is TCS
    getattr(mod, test)()


# ---------------------------------------------------------------------------
# MockProver verdicts, the first half of the fast cases (k=9)

SUPER_CASES = [
    "test_super_circuit_satisfied",
    "test_super_circuit_mulmod_composed",
    "test_super_circuit_catches_wrong_opcode_binding",
    "test_super_circuit_cross_corruption",
    "test_super_circuit_nested_call",
    "test_super_circuit_staticcall_stop",
    "test_super_circuit_codecopy",
    "test_super_circuit_codecopy_with_padding",
    "test_super_circuit_returndata_ops",
    "test_super_circuit_catches_wrong_return_data",
]


@pytest.mark.parametrize("test", SUPER_CASES)
def test_mock_verdicts_match_reference(test):
    verdicts_match("test_super_circuit", test)
