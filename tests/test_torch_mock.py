"""Port MockProver (zkevm_circuits_tpu_torch.plonk.mock) against the JAX
package's: the same failure list, in the same order, for good and
corrupted witnesses of the Keccak permutation and sponge circuits, the
small State circuit and the k=5 DemoCircuit."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.circuits import keccak as jk
from zkevm_circuits_tpu.circuits import state as jstate
from zkevm_circuits_tpu.crypto.field import fr as j_fr
from zkevm_circuits_tpu.plonk import mock as jmock
from zkevm_circuits_tpu.service import bench_circuits as jbench
from zkevm_circuits_tpu_torch.circuits import keccak as tk
from zkevm_circuits_tpu_torch.circuits import state as tstate
from zkevm_circuits_tpu_torch.crypto.field import fr as t_fr
from zkevm_circuits_tpu_torch.crypto.keccak import keccak256
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk import mock as tmock
from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

sys.path.insert(0, os.path.dirname(__file__))
from test_plonk_prove import DemoCircuit as JDemo  # noqa: E402

torch.set_num_threads(2)


def _rand_state(rng):
    return [[int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
             for _ in range(5)] for _ in range(5)]


def _corrupt(base, phase, column, row, value, F):
    """Subclass of `base` whose witness column `column(self)` holds the
    Montgomery form of `value(cur)` at `row` (cur: 0/1, is the cell
    nonzero) in synthesis phase `phase`."""

    class Corrupt(base):
        def synthesize(self, ph, n, challenges, instances):
            cols = super().synthesize(ph, n, challenges, instances)
            if ph == phase:
                col = column(self)
                arr = np.array(cols[col])
                cur = int(np.any(arr[row]))
                arr[row] = F.from_int(value(cur) * F.R % F.modulus)
                cols[col] = arr
            return cols

    return Corrupt


def _flip(cur):
    return 1 - cur


def _verdicts(k, jcirc, tcirc, instances=None):
    jmp = jmock.MockProver(k, jcirc, instances)
    tmp = tmock.MockProver(k, tcirc, instances)
    assert np.array_equal(np.asarray(jmp.fixed), tmp.fixed)
    assert np.array_equal(np.asarray(jmp.advice), tmp.advice)
    assert np.array_equal(np.asarray(jmp.instance), tmp.instance)
    want = jmp.verify()
    got = tmp.verify()
    assert got == want
    return got, tmp


def test_mock_challenges_match_reference():
    jc, tc = jk.KeccakCircuit([b"abc"]), tk.KeccakCircuit([b"abc"])
    jmp_cs, tmp_cs = jmock.ConstraintSystem(), tmock.ConstraintSystem()
    jc.configure(jmp_cs)
    tc.configure(tmp_cs)
    jch, tch = jmock.mock_challenges(jmp_cs), tmock.mock_challenges(tmp_cs)
    assert sorted(jch) == sorted(tch) == [0]
    assert np.array_equal(np.asarray(jch[0]), tch[0].numpy())
    assert tch[0].device.type == "cpu"


@pytest.mark.parametrize("corrupt", [False, True], ids=["good", "bit-flip"])
def test_keccak_f_verdicts(corrupt):
    st = _rand_state(np.random.default_rng(0xC0FFEE))
    jcls, tcls = jk.KeccakFCircuit, tk.KeccakFCircuit
    if corrupt:
        # flip one state bit in round block 5, lane (2,3), z=17
        # (tests/test_keccak_circuit.py::test_keccak_f_catches_bit_flip)
        col = lambda c: c.c_a[2][3][17 % c.z]  # noqa: E731
        row = 5 * 8 + 17 // 8
        jcls = _corrupt(jcls, 0, col, row, _flip, j_fr())
        tcls = _corrupt(tcls, 0, col, row, _flip, t_fr())
    got, _ = _verdicts(9, jcls([st]), tcls([st]))
    assert bool(got) == corrupt


def test_keccak_sponge_verdicts_and_digest_rlc():
    msg = b"x" * 200  # two absorb blocks
    got, tmp = _verdicts(10, jk.KeccakCircuit([msg]), tk.KeccakCircuit([msg]))
    assert got == []
    circ = tmp.circuit
    F = t_fr()
    r_int = F.to_int(F.from_mont(tmp.challenges[circ.r.index]))
    first, count = circ._msg_perm_spans[0]
    row = (first + count - 1) * circ.rows_per_perm + 24 * circ.rpb
    out = tmp.advice[circ.c_out_rlc][row]
    got_rlc = F.to_int(F.from_mont(torch.as_tensor(out)))
    want = sum(b * pow(r_int, i, F.modulus)
               for i, b in enumerate(keccak256(msg))) % F.modulus
    assert got_rlc == want


def test_keccak_sponge_corrupt_chain_verdicts():
    # flip a data bit in the SECOND absorb block of msg 0
    # (tests/test_keccak_sponge.py::test_sponge_catches_corrupt_chain)
    col = lambda c: c.c_d[0][0]  # noqa: E731
    row = tk.ROWS_PER_PERM + 3
    jcls = _corrupt(jk.KeccakCircuit, 0, col, row, _flip, j_fr())
    tcls = _corrupt(tk.KeccakCircuit, 0, col, row, _flip, t_fr())
    got, _ = _verdicts(10, jcls([b"y" * 150]), tcls([b"y" * 150]))
    assert got


SMALL = dict(limb_bits=4, id_bits=8, addr_bits=16, key_bits=16, rwc_bits=8)


@pytest.mark.parametrize("case", ["good", "diff", "value"])
def test_state_verdicts(case):
    k = 8
    rows_j = jbench.synthetic_rw_workload(usable_rows(1 << k) - 8)
    rows_t = tbench.synthetic_rw_workload(usable_rows(1 << k) - 8)
    assert [dataclasses.astuple(r) for r in rows_j] == \
        [dataclasses.astuple(r) for r in rows_t]
    jcls, tcls = jstate.StateCircuit, tstate.StateCircuit
    if case != "good":
        # a limb difference out of its range table (phase 0), or a read
        # value that breaks read-after-write consistency (phase 1)
        phase, col = ((0, lambda c: c.col_diff) if case == "diff"
                      else (1, lambda c: c.col_value))
        jcls = _corrupt(jcls, phase, col, 10, lambda cur: 12345, j_fr())
        tcls = _corrupt(tcls, phase, col, 10, lambda cur: 12345, t_fr())
    got, _ = _verdicts(k, jcls(rows_j, jstate.StateParams(**SMALL)),
                       tcls(rows_t, tstate.StateParams(**SMALL)))
    assert bool(got) == (case != "good")


@pytest.mark.parametrize("corrupt_row", [None, 5])
def test_demo_verdicts(corrupt_row):
    got, _ = _verdicts(demo.K, JDemo(corrupt_row), demo.DemoCircuit(corrupt_row),
                       [[demo.A_IN]])
    assert bool(got) == (corrupt_row is not None)


def test_demo_wrong_instance_breaks_copy_constraint():
    got, _ = _verdicts(demo.K, JDemo(), demo.DemoCircuit(), [[demo.A_IN + 1]])
    assert any(f.startswith("copy constraint violated") for f in got)
