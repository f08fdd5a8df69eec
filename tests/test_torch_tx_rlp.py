"""The RLP and Tx circuits in the port (zkevm_circuits_tpu_torch.circuits
rlp and tx) against the JAX package's: the constraint system and every
phase's columns, and the MockProver verdicts on the good witnesses and on
every corruption of tests/test_rlp_circuit.py, test_tx_circuit.py,
test_tx_rlp_binding.py and test_typed_tx.py, exact bytes, on the same
inputs; the RLP circuit's phases (tests/test_phase_discipline.py)."""

import dataclasses

import pytest

from test_torch_partners import (
    JAX, PORT, assert_same_columns, assert_same_cs, audit_phases, configured,
    edit,
)
from zkevm_circuits_tpu.circuits import rlp as jrlp
from zkevm_circuits_tpu.circuits import tx as jtx
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.types import rlp as jrlp_host
from zkevm_circuits_tpu_torch.circuits import rlp as trlp
from zkevm_circuits_tpu_torch.circuits import tx as ttx
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.types import rlp as trlp_host

K = 11
SK1 = 0x1111111111111111111111111111111111111111111111111111111111111111
SK2 = 0x2222222222222222222222222222222222222222222222222222222222222222
SK7 = 0x7777777777777777777777777777777777777777777777777777777777777777
SKT = 0xA1B2C3D4E5F60718293A4B5C6D7E8F90A1B2C3D4E5F60718293A4B5C6D7E8F9

# tests/test_rlp_circuit.py's transactions, as keyword arguments
TX_SHORT = dict(nonce=0, gas_price=10, gas=1_000_000, to=0xC0DE,
                value=0x1234, data=bytes([0xAA, 0xBB]), chain_id=1337)
TX_LONG = dict(nonce=7, gas_price=2**40 + 3, gas=21000, to=0xBEEF,
               value=2**128 + 5, data=bytes(range(40)), chain_id=1337)
TX_CREATE = dict(nonce=1, gas_price=1, gas=53000, to=None, value=0,
                 data=b"\x60\x01", chain_id=1)
TX_2930 = dict(nonce=3, gas_price=12, gas=60_000, to=0xD00D, value=5,
               data=b"\x01\x02\x03", chain_id=1337, tx_type="Eip2930",
               access_list=[(0xAAA, [7, 9]), (0xBBB, [])])
TX_1559 = dict(nonce=4, gas=70_000, to=0xFEED, value=0, data=b"",
               chain_id=1337, tx_type="Eip1559", max_fee_per_gas=100,
               max_priority_fee_per_gas=2, access_list=[(0xCCC, [2**200])])


def _tx(pkg, kw, sk=None):
    mod = pkg["transaction"]
    kw = dict(kw)
    if "tx_type" in kw:
        kw["tx_type"] = mod.TxType[kw["tx_type"]]
    tx = mod.Transaction(**kw)
    return tx.sign(sk) if sk is not None else tx


# ---------------------------------------------------------------------------
# RLP (tests/test_rlp_circuit.py)


def _rows_where(c, tag, pred=lambda r: True):
    return [i for i, r in enumerate(c.rows) if r[1] == int(tag) and pred(r)]


def _one(v):
    return lambda cur: v


def _tamper_gas_byte(c):
    return [(c.c_byte, next(iter(_rows_where(c, c.RlpTag.Gas, lambda r: not r[3]))),
             _one(0x99))]


def _gas_as_value(c):
    out = []
    for i in _rows_where(c, c.RlpTag.Gas):
        out += [(c.c_ind[c.RlpTag.Gas], i, _one(0)),
                (c.c_ind[c.RlpTag.Value], i, _one(1))]
    return out


def _data_tot_plus_one(c):
    return [(c.c_tot, _rows_where(c, c.RlpTag.Data)[0], lambda cur: cur + 1)]


def _swap_prio_gas_price(c):
    T = c.RlpTag
    i_prio = _rows_where(c, T.Prio)[0]
    i_gp = _rows_where(c, T.GasPrice, lambda r: r[0] == c.rows[i_prio][0])[0]
    out = []
    for a, b in ((i_prio, T.GasPrice), (i_gp, T.Prio)):
        for t in (T.Prio, T.GasPrice):
            out.append((c.c_ind[t], a, _one(int(t == b))))
    return out


def _type_zero(c):
    return [(c.c_type, i, _one(0)) for i in range(1 << K)]


def _rlp_corrupt(base, tags, edits_of):
    """`base` with the phase-0 cells that edits_of(circuit) names set;
    `tags` is the package's RlpTag."""
    class Corrupt(base):
        RlpTag = tags

        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            if phase == 0 and edits_of is not None:
                for col, row, value in edits_of(self):
                    edit(cols, col, row, value)
            return cols

    return Corrupt


RLP_CASES = {
    "satisfied": ((TX_SHORT, TX_LONG, TX_CREATE), None),
    "tampered_byte": ((TX_SHORT,), _tamper_gas_byte),
    "wrong_tag_order": ((TX_SHORT,), _gas_as_value),
    "wrong_length": ((TX_SHORT,), _data_tot_plus_one),
    "typed_satisfied": ((TX_SHORT, TX_2930, TX_1559), None),
    "typed_wrong_order": ((TX_1559,), _swap_prio_gas_price),
    "typed_wrong_type": ((TX_1559,), _type_zero),
}


def _rlp_circuit(pkg, case):
    txs, edits_of = RLP_CASES[case]
    cls = _rlp_corrupt(pkg["rlp"].RlpCircuit, pkg["rlp"].RlpTag, edits_of)
    return cls([_tx(pkg, kw) for kw in txs])


@pytest.mark.parametrize("case", sorted(RLP_CASES))
def test_rlp_verdicts_match_reference(case):
    tc, jc = _rlp_circuit(PORT, case), _rlp_circuit(JAX, case)
    assert tc.rows == jc.rows
    got, want = TMock(K, tc).verify(), JMock(K, jc).verify()
    assert got == want
    assert bool(got) == (RLP_CASES[case][1] is not None), got
    if case == "wrong_tag_order":
        assert any("rom" in f for f in got), got
    if case == "wrong_length":
        assert any("tot" in f for f in got), got


@pytest.mark.parametrize("kw", [TX_SHORT, TX_LONG, TX_CREATE, TX_2930, TX_1559],
                         ids=["short", "long", "create", "2930", "1559"])
def test_rlp_tx_rows_match_reference(kw):
    """rlp._tx_rows: the byte rows and the payload of each transaction."""
    rows, payload = trlp._tx_rows(_tx(PORT, kw), 1, 0)
    assert (rows, payload) == jrlp._tx_rows(_tx(JAX, kw), 1, 0)
    body = [r for r in rows if r[1] != int(trlp.RlpTag.Pad)]
    assert bytes(r[4] for r in body) == payload
    assert [int(t) for t in trlp.RlpTag] == [int(t) for t in jrlp.RlpTag]


def test_rlp_host_encoding_matches_reference():
    items = [0, 1, 127, 128, 2**64, b"", b"\x01", bytes(60), [b"ab", [1, 2]]]
    assert trlp_host.encode(items) == jrlp_host.encode(items)


def test_rlp_phases_match_reference():
    """tests/test_phase_discipline.py::test_rlp_circuit_phases: the keccak
    binding wired to a stand-in KeccakTable of three fixed columns."""
    css = []
    for pkg in (PORT, JAX):
        cs = pkg["circuit"].ConstraintSystem()
        pkg["rlp"].RlpCircuit([]).configure(
            cs, keccak_table=[pkg["Fixed"](cs.fixed_column()) for _ in range(3)])
        css.append(cs)
    assert_same_cs(*css)
    audit_phases(css[0])


def test_rlp_columns_match_reference():
    """Both phases of the typed mix's columns (the golden's mix is held in
    tests/test_torch_partners.py)."""
    tc, jc = _rlp_circuit(PORT, "typed_satisfied"), _rlp_circuit(JAX, "typed_satisfied")
    tcs, jcs = configured(tc, PORT), configured(jc, JAX)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=11)


# ---------------------------------------------------------------------------
# Tx (tests/test_tx_circuit.py)


def _tx_txs(pkg):
    return [_tx(pkg, kw, sk) for kw, sk in (
        (dict(nonce=0, to=0xBEEF, value=100, data=b"\x01\x02\x03",
              chain_id=1337), SK1),
        (dict(nonce=5, to=None, value=0, data=b"\x60\x00", chain_id=1337), SK2))]


def _broken_calldata_index(c, n):
    n_fixed, _ = c._layout(n)
    return [(c.c_index, n_fixed + 1, _one(7))]


TX_CASES = {"satisfied": (True, None), "empty": (False, None),
            "broken_calldata_index": (True, _broken_calldata_index)}


@pytest.mark.parametrize("case", sorted(TX_CASES))
def test_tx_verdicts_match_reference(case):
    with_txs, edits_of = TX_CASES[case]
    circs = []
    for pkg in (PORT, JAX):
        base = pkg["tx"].TxCircuit

        class Corrupt(base):
            def synthesize(self, phase, n, challenges, instances):
                cols = super().synthesize(phase, n, challenges, instances)
                if phase == 0 and edits_of is not None:
                    for col, row, value in edits_of(self, n):
                        edit(cols, col, row, value)
                return cols

        circs.append(Corrupt(_tx_txs(pkg) if with_txs else []))
    tc, jc = circs
    got, want = TMock(9, tc).verify(), JMock(9, jc).verify()
    assert got == want
    assert bool(got) == (edits_of is not None), got
    if edits_of is not None:
        assert any("continuity" in f for f in got), got


def test_tx_rejects_unsigned_like_reference():
    for pkg in (PORT, JAX):
        with pytest.raises(AssertionError):
            pkg["tx"].TxCircuit([_tx(pkg, dict(nonce=1, to=0xBEEF))])


def test_tx_tags_match_reference():
    assert [(t.name, int(t)) for t in ttx.TxFieldTag] == \
        [(t.name, int(t)) for t in jtx.TxFieldTag]
    assert [int(t) for t in ttx.FIXED_TAGS] == [int(t) for t in jtx.FIXED_TAGS]


# ---------------------------------------------------------------------------
# Tx + RLP bound (tests/test_tx_rlp_binding.py)


def _binding_txs(pkg):
    return [
        _tx(pkg, dict(nonce=3, gas_price=2**40 + 7, to=0xBEEF, value=2**65 + 1,
                      data=b"\x01\x02\x03", chain_id=1337), SK1),
        _tx(pkg, dict(nonce=0, to=None, value=0, data=b"", chain_id=1337), SK2),
    ]


def _tx_rlp(pkg, txs, edits_of=None, typed=False):
    """RLP + Tx in one constraint system, the bindings live; `edits_of(c,
    n, pkg)` names [(phase, column, row, new value from old)]."""
    class TxRlp(pkg["circuit"].Circuit):
        def __init__(self):
            self.rlp = pkg["rlp"].RlpCircuit(txs)
            self.tx = pkg["tx"].TxCircuit(txs)

        def configure(self, cs):
            r = cs.challenge(phase=0)
            self.rlp.configure(cs, challenge=r)
            kw = dict(tx_type_table=self.rlp.tx_type_table) if typed else {}
            self.tx.configure(cs, challenge=r, rlp_table=self.rlp.rlp_table,
                              data_len_table=self.rlp.data_len_table, **kw)

        def fixed_columns(self, n):
            out = dict(self.rlp.fixed_columns(n))
            out.update(self.tx.fixed_columns(n))
            return out

        def synthesize(self, phase, n, challenges, instances):
            out = dict(self.rlp.synthesize(phase, n, challenges, instances))
            out.update(self.tx.synthesize(phase, n, challenges, instances))
            for ph, col, row, value in (edits_of(self, n, pkg) if edits_of else ()):
                if ph == phase:
                    edit(out, col, row, value)
            return out

    return TxRlp()


def _fixed_row(tag_name, value, tx_index=0):
    def edits_of(c, n, pkg):
        tags = pkg["tx"].FIXED_TAGS
        tag = pkg["tx"].TxFieldTag[tag_name]
        return [(1, c.tx.c_value, tx_index * len(tags) + tags.index(tag), _one(value))]
    return edits_of


def _calldata_byte(c, n, pkg):
    n_fixed, _ = c.tx._layout(n)
    return [(1, c.tx.c_value, n_fixed, _one(0x77))]


def _chain_id(c, n, pkg):
    return [(0, c.tx.c_chain, pkg["tx"].FIXED_TAGS.index(pkg["tx"].TxFieldTag.SigV),
             _one(1338))]


def _pad_byte(c, n, pkg):
    row = next(i for i, r in enumerate(c.rlp.rows) if r[1] == int(pkg["rlp"].RlpTag.Pad))
    return [(0, c.rlp.c_byte, row + 1, _one(0x05))]


BINDING_CASES = {
    "satisfied": (None, None),
    "wrong_gas_price": (_fixed_row("GasPrice", 0x99), "tx rlp binding"),
    "wrong_callee": (_fixed_row("CalleeAddress", 0x99), "tx rlp binding"),
    "wrong_calldata_len": (_fixed_row("CallDataLength", 7), "tx data len binding"),
    "tampered_calldata_byte": (_calldata_byte, ""),
    "wrong_chain_id": (_chain_id, ""),
    "pad_pattern": (_pad_byte, "pad pattern"),
}


@pytest.mark.parametrize("case", sorted(BINDING_CASES))
def test_tx_rlp_binding_verdicts_match_reference(case):
    edits_of, needle = BINDING_CASES[case]
    tc = _tx_rlp(PORT, _binding_txs(PORT), edits_of)
    jc = _tx_rlp(JAX, _binding_txs(JAX), edits_of)
    got, want = TMock(K, tc).verify(), JMock(K, jc).verify()
    assert got == want
    assert bool(got) == (edits_of is not None), got
    if needle:
        assert any(needle in f for f in got), got
    if case == "wrong_chain_id":
        assert any("tx rlp binding" in f or "eip155" in f for f in got), got


def test_tx_rlp_binding_columns_match_reference():
    tc, jc = _tx_rlp(PORT, _binding_txs(PORT)), _tx_rlp(JAX, _binding_txs(JAX))
    tcs, jcs = configured(tc, PORT), configured(jc, JAX)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=17)


TYPED_1559 = dict(nonce=1, gas=60_000, to=0xFEED, value=9, data=b"\x01\x02",
                  chain_id=1337, tx_type="Eip1559", max_fee_per_gas=55,
                  max_priority_fee_per_gas=3, access_list=[(0xABC, [5])])


@pytest.mark.parametrize("wrong_parity", [False, True])
def test_typed_tx_rlp_binding_matches_reference(wrong_parity):
    """A signed 1559 transaction through Tx + RLP with the type table wired;
    with `wrong_parity`, a legacy-style v on it (which must fail)."""
    verdicts = []
    for pkg in (PORT, JAX):
        kw = dict(TYPED_1559, data=b"" if wrong_parity else TYPED_1559["data"],
                  access_list=[] if wrong_parity else TYPED_1559["access_list"])
        tx = _tx(pkg, kw, SK7)
        assert tx.v in (0, 1)
        if wrong_parity:
            tx = dataclasses.replace(tx, v=35 + 2 * tx.chain_id + tx.v)
        verdicts.append(pkg["mock"](K, _tx_rlp(pkg, [tx], typed=True)).verify())
    got, want = verdicts
    assert got == want
    assert bool(got) == wrong_parity, got


# ---------------------------------------------------------------------------
# typed transactions at the types level (tests/test_typed_tx.py)


TYPED_CASES = {
    "legacy": dict(nonce=1, to=0xBEEF, value=5),
    "2930": dict(nonce=2, to=0xBEEF, value=7, tx_type="Eip2930",
                 access_list=[(0xCAFE, [1, 2]), (0xD00D, [])]),
    "1559": dict(nonce=3, to=0xBEEF, tx_type="Eip1559", max_fee_per_gas=100,
                 max_priority_fee_per_gas=2),
    "1559_fee": dict(nonce=3, to=0xBEEF, tx_type="Eip1559",
                     max_fee_per_gas=101, max_priority_fee_per_gas=2),
}


@pytest.mark.parametrize("case", sorted(TYPED_CASES))
def test_typed_tx_matches_reference(case):
    out = []
    for pkg in (PORT, JAX):
        tx = _tx(pkg, TYPED_CASES[case], SKT)
        out.append((int(tx.tx_type), tx.sign_payload(), tx.sign_hash(),
                    tx.rlp_signed(), tx.tx_hash(), tx.v, tx.r, tx.s,
                    tx.recover_sender(), tx.intrinsic_access_list_gas(),
                    tx.effective_gas_price(base_fee=7),
                    tx.effective_gas_price(base_fee=99)))
    assert out[0] == out[1]
    assert out[0][8] is not None
