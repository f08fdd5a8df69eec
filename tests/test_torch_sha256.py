"""The SHA-256 precompile circuit in the port (zkevm_circuits_tpu_torch
crypto/sha256.py and circuits/sha256.py) against the JAX package's: the
per-round trace, the constraint system, the fixed columns and both phases'
witness columns, and the MockProver verdicts on the good witness and on
every corruption of tests/test_sha256_circuit.py, exact, on the same
inputs.  tests/test_torch_ecc_modexp.py holds the port's CPU proof of each
precompile golden (slow tier)."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from zkevm_circuits_tpu.circuits import ecc as jecc
from zkevm_circuits_tpu.circuits import modexp as jmodexp
from zkevm_circuits_tpu.circuits import sha256 as jsha
from zkevm_circuits_tpu.crypto import curve as jcurve
from zkevm_circuits_tpu.crypto import params as jparams
from zkevm_circuits_tpu.crypto import sha256 as jcsha
from zkevm_circuits_tpu.plonk import circuit as jcircuit
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu_torch.circuits import sha256 as tsha
from zkevm_circuits_tpu_torch.crypto import sha256 as tcsha
from zkevm_circuits_tpu_torch.plonk import circuit as tcircuit
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock

torch.set_num_threads(2)
K = 9

JAX = dict(sha256=jsha, modexp=jmodexp, ecc=jecc, curve=jcurve,
           params=jparams, circuit=jcircuit)
PORT = dict(demo.precompile_modules(), circuit=tcircuit)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 100, 119])
def test_trace_matches_reference_and_hashlib(length):
    msg = np.random.default_rng(length).bytes(length)
    assert tcsha.pad(msg) == jcsha.pad(msg)
    t, j = tcsha.sha256_trace(msg), jcsha.sha256_trace(msg)
    assert [vars(b) for b in t] == [vars(b) for b in j]
    assert len(t) == len(tcsha.pad(msg)) // 64
    digest = b"".join(x.to_bytes(4, "big") for x in t[-1].h_out)
    assert digest == hashlib.sha256(msg).digest()


def test_constants_match_reference():
    assert (tcsha.K, tcsha.H_INIT) == (jcsha.K, jcsha.H_INIT)
    block = np.random.default_rng(1).bytes(64)
    assert vars(tcsha.compress_trace(tcsha.H_INIT, block)) == \
        vars(jcsha.compress_trace(jcsha.H_INIT, block))


def test_golden_witness_matches_reference():
    """Sha256Circuit over [b"abc", b"", bytes(range(100))] at k=9: the
    constraint system, fixed columns, both phases' columns (the RLC
    columns given the same challenge) and the verdicts."""
    jc = demo.precompile_golden("sha256", JAX)
    tc = demo.precompile_golden("sha256")
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert max(tcs.advice_phases) == 1
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []


def _flip(v):
    return 1 - (v != 0)


# tests/test_sha256_circuit.py: (messages, column, row)
CORRUPTIONS = {
    "schedule_bit": ([b"abc"], lambda c: c.c_w[5], 4 + 20),
    "digest": ([b"abc"], lambda c: c.c_a[0], 71),
    "chain": ([bytes(range(100))], lambda c: c.c_e[7], 72 + 2),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_verdicts_match_reference(case):
    msgs, col, row = CORRUPTIONS[case]
    edits = [(0, col, lambda c: row, _flip)]
    got = TMock(K, corrupt(tsha.Sha256Circuit, edits)(msgs)).verify()
    want = JMock(K, corrupt(jsha.Sha256Circuit, edits)(msgs)).verify()
    assert got == want
    assert any("sha" in f for f in got), got

