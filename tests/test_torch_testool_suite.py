"""The port's generated GeneralStateTests suite (testool/gen_suite.py)
against the JAX package's: write_suite writes the same bytes, every
generated filler parses to the same StateTests and gives the same
StateTestResult at the witness level in both packages, and the YAML
filler of tests/test_testool_suite.py runs the same.  The slow tier runs
the reference's three-family sample at the mock level in both."""

import dataclasses
import pathlib

import pytest

from zkevm_circuits_tpu.testool import gen_suite as j_gen
from zkevm_circuits_tpu.testool import json_parser as j_parser
from zkevm_circuits_tpu.testool import statetest as j_st
from zkevm_circuits_tpu_torch.testool import gen_suite as p_gen
from zkevm_circuits_tpu_torch.testool import json_parser as p_parser
from zkevm_circuits_tpu_torch.testool import statetest as p_st
from zkevm_circuits_tpu_torch.types.transaction import Transaction

YAML = """
addYaml:
  env:
    currentCoinbase: 0x2adc25665018aa1fe0e6bc666dac8fc2697ff9ba
    currentGasLimit: 30000000
    currentNumber: 1
    currentTimestamp: 1000
    currentBaseFee: 7
  pre:
    0xa94f5374fce5edbc8e2a8697c15331677e6ebf0b:
      balance: '0x0de0b6b3a7640000'
      nonce: 0
      code: '0x'
      storage: {}
    0x095e7baea6a6c7c4c2dfeb977efac326af552d87:
      balance: 0
      nonce: 0
      code: '0x600560070160005500'
      storage: {}
  transaction:
    data: ['0x']
    gasLimit: [10000000]
    gasPrice: 10
    nonce: 0
    secretKey: '0x45a915e4d060149eb4365960e6a7a45f334393093061116b197e3240065ff2d8'
    to: 0x095e7baea6a6c7c4c2dfeb977efac326af552d87
    value: [0]
  expect:
    - indexes: {data: -1, gas: -1, value: -1}
      network: ['>=Cancun']
      result:
        0x095e7baea6a6c7c4c2dfeb977efac326af552d87:
          storage: {0: 12}
"""


@pytest.fixture(scope="module")
def suite_dirs(tmp_path_factory):
    dj, dp = tmp_path_factory.mktemp("jax_suite"), tmp_path_factory.mktemp("port_suite")
    nj, np_ = j_gen.write_suite(dj), p_gen.write_suite(dp)
    assert nj == np_ >= 100
    return dj, dp


def _load_all(parser, d: pathlib.Path):
    tests = []
    for f in sorted(d.glob("*.json")):
        tests.extend(parser.load_json_fillers(f.read_text()))
    return tests


def _fields(r):
    return (r.name, r.ok, r.skipped, r.reason, r.status)


def test_write_suite_bytes_identical(suite_dirs):
    dj, dp = suite_dirs
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dp.iterdir())
    for name in names:
        assert (dp / name).read_bytes() == (dj / name).read_bytes(), name


def test_sender_is_the_secret_keys_address():
    assert Transaction(nonce=0).sign(p_gen.SENDER_SK).recover_sender() == p_gen.SENDER
    assert (p_gen.SENDER, p_gen.SENDER_SK, p_gen.CONTRACT) == \
        (j_gen.SENDER, j_gen.SENDER_SK, j_gen.CONTRACT)


def test_suite_parses_the_same(suite_dirs):
    dj, dp = suite_dirs
    jt, pt = _load_all(j_parser, dj), _load_all(p_parser, dp)
    assert len(pt) == len(jt) >= 100
    assert all(t.expect for t in pt)
    for a, b in zip(jt, pt):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.name


def test_suite_witness_level(suite_dirs):
    """Every generated filler at the witness level: the same result in
    both packages, and (as the reference asserts) none fails or skips."""
    dj, dp = suite_dirs
    jt, pt = _load_all(j_parser, dj), _load_all(p_parser, dp)
    jr = [j_st.run_state_test(t, j_st.CircuitsConfig(level="witness")) for t in jt]
    pr = [p_st.run_state_test(t, p_st.CircuitsConfig(level="witness")) for t in pt]
    assert [_fields(r) for r in pr] == [_fields(r) for r in jr]
    assert all(r.ok and not r.skipped for r in pr), \
        [f"{r.name}: {r.reason}" for r in pr if not r.ok or r.skipped][:10]


def test_yaml_fillers_parse_and_run():
    jt, pt = j_parser.load_yaml_fillers(YAML), p_parser.load_yaml_fillers(YAML)
    assert len(pt) == 1 and pt[0].secret_key is not None
    assert dataclasses.asdict(pt[0]) == dataclasses.asdict(jt[0])
    for level in ("trace", "witness"):
        j = j_st.run_state_test(jt[0], j_st.CircuitsConfig(level=level))
        p = p_st.run_state_test(pt[0], p_st.CircuitsConfig(level=level))
        assert _fields(p) == _fields(j)
        assert p.ok and not p.skipped, p.reason


@pytest.mark.slow
def test_suite_mock_level_sample(suite_dirs):
    """The reference's sample: the first test of the arithmetic, memory
    and storage families at the mock level, k=11, in both packages."""
    dj, dp = suite_dirs
    for fam in ("vmArithmeticTest.json", "vmMemoryTest.json",
                "vmStorageTest.json"):
        jt = j_parser.load_json_fillers((dj / fam).read_text())[0]
        pt = p_parser.load_json_fillers((dp / fam).read_text())[0]
        j = j_st.run_state_test(jt, j_st.CircuitsConfig(level="mock", k=11))
        p = p_st.run_state_test(pt, p_st.CircuitsConfig(level="mock", k=11))
        assert _fields(p) == _fields(j), fam
        assert p.ok and not p.skipped, f"{fam}/{p.name}: {p.reason}"
