"""Port State circuit (zkevm_circuits_tpu_torch.circuits.state) against the
JAX package: constraint system shape, fixed columns and witness columns,
exact bytes (witness generation is numpy on both sides)."""

import dataclasses

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.circuits import state as jstate
from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.service import bench_circuits as jbench
from zkevm_circuits_tpu_torch.circuits import state as tstate
from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem as TCS
from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

K = 8
N = 1 << K
SMALL = dict(limb_bits=4, id_bits=8, addr_bits=16, key_bits=16, rwc_bits=8)


def _circuits(params):
    rows_j = jbench.synthetic_rw_workload(usable_rows(N) - 8)
    rows_t = tbench.synthetic_rw_workload(usable_rows(N) - 8)
    assert [dataclasses.astuple(r) for r in rows_j] == \
        [dataclasses.astuple(r) for r in rows_t]
    return (jstate.StateCircuit(rows_j, jstate.StateParams(**params)),
            tstate.StateCircuit(rows_t, tstate.StateParams(**params)))


@pytest.mark.parametrize("params", [SMALL, {}], ids=["small", "full-width"])
def test_constraint_system_shape(params):
    jc, tc = _circuits(params)
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    assert tcs.num_advice == jcs.num_advice
    assert tcs.advice_phases == jcs.advice_phases
    assert tcs.num_fixed == jcs.num_fixed
    assert [g.name for g in tcs.gates] == [g.name for g in jcs.gates]
    assert [len(lg.inputs) for lg in tcs.logups] == [len(lg.inputs) for lg in jcs.logups]
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert tqd(tcs) == jqd(jcs)
    assert [repr(p) for g in tcs.gates for p in g.polys] == \
        [repr(p) for g in jcs.gates for p in g.polys]


def test_fixed_columns():
    jc, tc = _circuits(SMALL)
    jc.configure(JCS())
    tc.configure(TCS())
    jf, tf = jc.fixed_columns(N), tc.fixed_columns(N)
    assert sorted(jf) == sorted(tf)
    for ci in jf:
        assert np.array_equal(np.asarray(jf[ci]), np.asarray(tf[ci]))


def test_witness_columns_both_phases():
    jc, tc = _circuits(SMALL)
    jcs, tcs = JCS(), TCS()
    jc.configure(jcs)
    tc.configure(tcs)
    j0 = jc.synthesize(0, N, {}, [])
    t0 = tc.synthesize(0, N, {}, [])
    assert sorted(j0) == sorted(t0)
    for ci in j0:
        assert np.array_equal(np.asarray(j0[ci]), np.asarray(t0[ci]))
    from zkevm_circuits_tpu.crypto.field import fr

    chal = fr().from_int(0xC0FFEE * fr().R % fr().modulus)
    j1 = jc.synthesize(1, N, {jc.r_word.index: chal}, [])
    t1 = tc.synthesize(1, N, {tc.r_word.index: torch.as_tensor(chal)}, [])
    assert sorted(j1) == sorted(t1)
    for ci in j1:
        assert np.array_equal(np.asarray(j1[ci]), np.asarray(t1[ci]))
