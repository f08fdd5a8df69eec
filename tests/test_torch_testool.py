"""The port's testool (zkevm_circuits_tpu_torch/testool/) against the JAX
package's on the inputs of tests/test_testool.py: for each of its tests,
the port's StateTestResult (name, ok, skipped, reason) equals the
reference's at the same level, and the CLI prints the same lines.  A few
more cases reach the other reason strings (tracer failure, an expected
failure, a create tx, a wrong secret key).  The slow tier proves the
sstoreGas filler at the prove level on the CPU against the golden of
plonk/demo.py (the reference's proof)."""

import copy
import hashlib
import json

import pytest
import torch

from test_testool import FILLER
from zkevm_circuits_tpu import testool as J
from zkevm_circuits_tpu.testool import runner as j_runner
from zkevm_circuits_tpu_torch import testool as P
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.testool import runner as p_runner
from zkevm_circuits_tpu_torch.testool import statetest as p_statetest

torch.set_num_threads(2)
TARGET = "0x095e7baea6a6c7c4c2dfeb977efac326af552d87"
ORACLE_SPEC = ("call;;2000 "
               "12;PUSH1(0),SLOAD,CALLVALUE,EQ,PUSH1(1),SSTORE,STOP;;00:7d0")
MUL_SPEC = "call 12;PUSH1(3),PUSH1(4),MUL,PUSH1(0),SSTORE,STOP"
IDENTITY_SPEC = ("call 12;"
                 "PUSH1(0x2A),PUSH1(0),MSTORE,"
                 "PUSH1(32),PUSH1(64),PUSH1(32),PUSH1(0),PUSH1(0),PUSH1(4),"
                 "PUSH2(0xFFFF),CALL,POP,"
                 "PUSH1(64),MLOAD,PUSH1(0),SSTORE,STOP")


def _fields(r):
    if isinstance(r, Exception):
        return type(r).__name__, str(r)
    return (r.name, r.ok, r.skipped, r.reason, r.status)


def _run(m, st, config):
    """m.run_state_test(st, config), or the exception it raised."""
    try:
        return m.run_state_test(st, config)
    except Exception as e:  # compared with the other package's
        return e


def _filler(edit=None) -> str:
    doc = copy.deepcopy(FILLER)
    if edit:
        edit(doc["sstoreGas"])
    return json.dumps(doc)


def _both_fillers(text, level, k=9):
    """Each package's StateTestResult of the filler's only test."""
    (jt,), (pt,) = J.load_json_fillers(text), P.load_json_fillers(text)
    return (_run(J, jt, J.CircuitsConfig(level=level, k=k)),
            _run(P, pt, P.CircuitsConfig(level=level, k=k)))


def _both_oneliner(spec, storage, level, k=9):
    out = []
    for m in (J, P):
        st = m.parse_oneliner(spec)
        st.expect = {0x12: m.AccountState(storage=storage)}
        out.append(m.run_state_test(st, m.CircuitsConfig(level=level, k=k)))
    return out


def test_golden_filler_is_the_reference_tests():
    assert demo.TESTOOL_GOLDEN_FILLER == FILLER
    assert p_statetest.PROVE_SEED == demo.TESTOOL_GOLDEN_SEED
    cfg = P.CircuitsConfig()
    assert (cfg.k, cfg.srs_tau, cfg.device) == \
        (demo.TESTOOL_GOLDEN_K, demo.TESTOOL_GOLDEN_TAU, None)


def test_json_filler_parse():
    (jt,), (pt,) = J.load_json_fillers(_filler()), P.load_json_fillers(_filler())
    assert pt.tx_to == 0x095E7BAEA6A6C7C4C2DFEB977EFAC326AF552D87
    assert pt.expect[pt.tx_to].storage == {0: 2}
    for f in ("name", "tx_from", "tx_to", "tx_gas", "tx_gas_price", "tx_value",
              "tx_data", "tx_nonce", "expect_failure", "secret_key"):
        assert getattr(pt, f) == getattr(jt, f), f
    assert vars(pt.env) == vars(jt.env)
    assert {a: vars(s) for a, s in pt.pre.items()} == \
        {a: vars(s) for a, s in jt.pre.items()}
    assert {a: vars(s) for a, s in pt.expect.items()} == \
        {a: vars(s) for a, s in jt.expect.items()}


@pytest.mark.parametrize("level", ["trace", "witness", "mock"])
def test_json_filler_levels(level):
    j, p = _both_fillers(_filler(), level)
    assert _fields(p) == _fields(j)
    assert p.ok and not p.skipped, p.reason


def _wrong_storage(t):
    t["expect"][0]["result"][TARGET]["storage"]["0x00"] = "0x03"


def _low_gas(t):
    t["transaction"]["gasLimit"] = ["1000"]  # below the intrinsic 21000


def _poor_sender(t):
    t["pre"]["0xa94f5374fce5edbc8e2a8697c15331677e6ebf0b"]["balance"] = "5"


def _wrong_key(t):
    t["transaction"]["secretKey"] = "0x" + "11" * 32


def _no_key(t):
    del t["transaction"]["secretKey"]


def _create(t):
    t["transaction"]["to"] = ""
    t["expect"] = []


@pytest.mark.parametrize("edit, level", [
    (_wrong_storage, "trace"), (_low_gas, "trace"), (_poor_sender, "trace"),
    (_wrong_key, "mock"), (_no_key, "mock"), (_create, "trace"),
    (_create, "witness"),
], ids=["wrong_storage", "low_gas", "poor_sender", "wrong_key", "no_key",
        "create_trace", "create_witness"])
def test_reasons_match(edit, level):
    """test_wrong_expectation_fails and the other reason strings.  (At the
    witness level both packages' builders raise on a create tx, the same
    error.)"""
    j, p = _both_fillers(_filler(edit), level)
    assert _fields(p) == _fields(j)
    if edit is _wrong_storage:
        assert not p.ok and "storage" in p.reason


def test_expect_failure_matches():
    out = []
    for m in (J, P):
        st = m.load_json_fillers(_filler(_low_gas))[0]
        st.expect_failure = True
        out.append(m.run_state_test(st))
    assert _fields(out[1]) == _fields(out[0])
    assert out[1].ok


@pytest.mark.parametrize("spec, storage, level, k", [
    (ORACLE_SPEC, {1: 1}, "witness", 9),
    (MUL_SPEC, {0: 12}, "mock", 9),
    (IDENTITY_SPEC, {0: 0x2A}, "mock", 10),
], ids=["call_with_storage_check", "mock_level", "precompile_identity_mock"])
def test_oneliners(spec, storage, level, k):
    jst, pst = J.parse_oneliner(spec), P.parse_oneliner(spec)
    assert (pst.tx_from, pst.tx_to, pst.tx_gas, pst.tx_value, pst.tx_data) == \
        (jst.tx_from, jst.tx_to, jst.tx_gas, jst.tx_value, jst.tx_data)
    assert {a: vars(s) for a, s in pst.pre.items()} == \
        {a: vars(s) for a, s in jst.pre.items()}
    j, p = _both_oneliner(spec, storage, level, k)
    assert _fields(p) == _fields(j)
    assert p.ok and not p.skipped, p.reason


def test_runner_cli(tmp_path, capsys):
    """The same printed lines and exit codes: a passing filler, a failing
    one, a malformed file, and a one-liner."""
    (tmp_path / "a_filler.json").write_text(_filler())
    (tmp_path / "b_wrong.json").write_text(_filler(_wrong_storage))
    (tmp_path / "c_broken.json").write_text("{not json")
    runs = [["--path", str(tmp_path / "a_filler.json"), "--level", "trace"],
            ["--path", str(tmp_path), "--level", "witness"],
            ["--path", str(tmp_path), "--filter", "sstore"],
            ["--oneliner", MUL_SPEC, "--level", "witness"]]
    outs = []
    for argv in runs:
        rc_j = j_runner.main(argv)
        out_j = capsys.readouterr().out
        rc_p = p_runner.main(argv)
        out_p = capsys.readouterr().out
        assert (rc_p, out_p) == (rc_j, out_j), argv
        outs.append((rc_p, out_p))
    assert outs[0][0] == 0 and "1 passed" in outs[0][1]
    assert outs[1][0] == 1 and "[FAIL] c_broken.json  (parse: " in outs[1][1]


def test_collect_matches(tmp_path):
    (tmp_path / "x.json").write_text(_filler())
    (tmp_path / "y.json").write_text("[")
    j, p = j_runner.collect(tmp_path), p_runner.collect(tmp_path)
    assert len(j) == len(p) == 2
    assert p[0].name == j[0].name
    assert (p[1][0], str(p[1][1])) == (j[1][0], str(j[1][1]))


@pytest.mark.slow
def test_prove_level_cpu_matches_golden():
    """The prove level on the CPU: the proof equals the reference's
    (TESTOOL_GOLDEN_*) and verifies.  Hours at 2 threads."""
    st, = P.load_json_fillers(_filler())
    cfg = P.CircuitsConfig(level="prove", k=demo.TESTOOL_GOLDEN_K,
                           srs_tau=demo.TESTOOL_GOLDEN_TAU, device="cpu")
    result, circ = p_statetest._host_levels(st, cfg)
    assert result is None
    proof, ok = p_statetest._prove_level(circ, cfg)
    assert ok
    assert len(proof) == demo.TESTOOL_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.TESTOOL_GOLDEN_SHA256
