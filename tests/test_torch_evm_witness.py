"""Port witness pipeline (zkevm_circuits_tpu_torch.types, crypto.secp256k1,
tracer, witness.trace/builder/test_ctx/block) against the JAX package's
framework-free originals: the opcode table and gas constants, Bytecode,
RLP, transaction signing and hashing, Interpreter traces, and the
CircuitInputBuilder's steps, RW rows and copy events, on the same seeded
inputs.  Exact equality throughout: this is integer arithmetic."""

import dataclasses
import enum
import random

import numpy as np
import pytest

from test_fuzz_witness import _gen_program
from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.crypto import secp256k1 as jsecp
from zkevm_circuits_tpu.crypto.keccak import keccak256
from zkevm_circuits_tpu.types import evm as jevm
from zkevm_circuits_tpu.types import rlp as jrlp
from zkevm_circuits_tpu.types import transaction as jtx
from zkevm_circuits_tpu.witness import block as jblock
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu.witness import test_ctx as jctx
from zkevm_circuits_tpu.witness import trace as jtrace
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.crypto import secp256k1 as tsecp
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench
from zkevm_circuits_tpu_torch.types import evm as tevm
from zkevm_circuits_tpu_torch.types import rlp as trlp
from zkevm_circuits_tpu_torch.types import transaction as ttx
from zkevm_circuits_tpu_torch.witness import block as tblock
from zkevm_circuits_tpu_torch.witness import builder as tb
from zkevm_circuits_tpu_torch.witness import test_ctx as tctx
from zkevm_circuits_tpu_torch.witness import trace as ttrace

SENDER, CONTRACT, OTHER = 0xCAFE, 0xC0DE, 0xBEEF


def _plain(x):
    """A package-free value: dataclasses as (class name, fields), enums as
    (class name, member name, value), containers element by element."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, _plain(x.value))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return sorted((_plain(k), _plain(v)) for k, v in x.items())
    return x


# ---------------------------------------------------------------------------
# types


def test_opcode_table_matches_reference():
    assert [(o.name, int(o), o.pops, o.pushes, o.constant_gas)
            for o in tevm.OpcodeId] == \
        [(o.name, int(o), o.pops, o.pushes, o.constant_gas)
         for o in jevm.OpcodeId]
    for b in range(256):
        t, j = tevm.opcode_from_byte(b), jevm.opcode_from_byte(b)
        assert (t is None) == (j is None), b
        if t is not None:
            assert t.name == j.name
            assert (t.is_push, t.is_push_with_data, t.push_len, t.is_dup,
                    t.is_swap, t.is_log, t.is_call, t.is_create) == \
                (j.is_push, j.is_push_with_data, j.push_len, j.is_dup,
                 j.is_swap, j.is_log, j.is_call, j.is_create)
    assert [(g.name, int(g)) for g in tevm.GasCost] == \
        [(g.name, int(g)) for g in jevm.GasCost]
    for w in range(0, 200, 7):
        assert tevm.memory_word_size(w) == jevm.memory_word_size(w)
        assert tevm.memory_expansion_gas(w, 2 * w + 3) == \
            jevm.memory_expansion_gas(w, 2 * w + 3)


@pytest.mark.parametrize("seed", range(4))
def test_bytecode_matches_reference(seed):
    jcode, _ = _gen_program(random.Random(seed), 30, with_copies=True)
    raw = jcode.to_bytes()
    t, j = tty.Bytecode(raw), jty.Bytecode(raw)
    assert t.to_bytes() == j.to_bytes() == raw
    assert t.hash() == j.hash()
    assert t.is_code_marks() == j.is_code_marks()
    assert list(t.table_rows()) == list(j.table_rows())
    assert len(t) == len(j)
    # the fluent builder and the attribute form
    rng = np.random.default_rng(seed)
    tb_, jb_ = tty.Bytecode(), jty.Bytecode()
    for _ in range(20):
        n = int(rng.integers(1, 33))
        v = int.from_bytes(rng.bytes(n), "big")
        name = ("ADD", "MSTORE", "JUMPDEST", "DUP3", "SWAP2")[int(rng.integers(5))]
        tb_.push(n, v).op(name)
        jb_.push(n, v).op(name)
    tb_.STOP()
    jb_.STOP()
    assert tb_.to_bytes() == jb_.to_bytes()


def _rand_item(rng, depth=0):
    kind = int(rng.integers(0, 4 if depth < 3 else 2))
    if kind == 0:
        return int.from_bytes(rng.bytes(int(rng.integers(0, 33))), "big")
    if kind == 1:
        return rng.bytes(int(rng.integers(0, 80)))
    return [_rand_item(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]


@pytest.mark.parametrize("seed", range(4))
def test_rlp_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        item = _rand_item(rng)
        enc = trlp.encode(item)
        assert enc == jrlp.encode(item)
        assert trlp.decode(enc) == jrlp.decode(enc)


@pytest.mark.parametrize("seed", range(3))
def test_secp256k1_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sk = int.from_bytes(rng.bytes(32), "big") % (tsecp.N - 1) + 1
    msg = keccak256(rng.bytes(40))
    assert tsecp.pubkey(sk) == jsecp.pubkey(sk)
    assert tsecp.eth_address(sk) == jsecp.eth_address(sk)
    sig = tsecp.sign(sk, msg)
    assert sig == jsecp.sign(sk, msg)
    assert tsecp.recover(msg, *sig) == jsecp.recover(msg, *sig) == tsecp.pubkey(sk)
    assert tsecp.verify(tsecp.pubkey(sk), msg, sig[0], sig[1])


@pytest.mark.parametrize("tx_type", [0, 1, 2])
def test_transaction_matches_reference(tx_type):
    rng = np.random.default_rng(100 + tx_type)
    sk = int.from_bytes(rng.bytes(32), "big") % (tsecp.N - 1) + 1
    al = [(int(rng.integers(1, 1 << 40)), [int(rng.integers(0, 1 << 60))
                                            for _ in range(2)])]
    kw = dict(nonce=int(rng.integers(0, 300)), gas_price=7, gas=90_000,
              to=int.from_bytes(rng.bytes(20), "big"), value=12345,
              data=rng.bytes(37), chain_id=1337,
              access_list=al if tx_type else [],
              max_fee_per_gas=50 if tx_type == 2 else 0,
              max_priority_fee_per_gas=3 if tx_type == 2 else 0)
    t = ttx.Transaction(tx_type=ttx.TxType(tx_type), **kw).sign(sk)
    j = jtx.Transaction(tx_type=jtx.TxType(tx_type), **kw).sign(sk)
    assert (t.v, t.r, t.s) == (j.v, j.r, j.s)
    assert t.sign_payload() == j.sign_payload()
    assert t.rlp_signed() == j.rlp_signed()
    assert t.tx_hash() == j.tx_hash()
    assert t.effective_gas_price(7) == j.effective_gas_price(7)
    assert t.intrinsic_access_list_gas() == j.intrinsic_access_list_gas()
    assert t.recover_sender() == j.recover_sender() == tsecp.eth_address(sk)
    create = ttx.Transaction(nonce=1, to=None, data=b"\x60\x00").sign(sk)
    assert create.rlp_signed() == \
        jtx.Transaction(nonce=1, to=None, data=b"\x60\x00").sign(sk).rlp_signed()


# ---------------------------------------------------------------------------
# tracer


def _tracer_programs(B):
    """(name, code, {address: code} of other accounts, value, calldata):
    the programs of tests/test_tracer.py and tests/test_evm_circuit.py."""
    callee = (B().push(1, 42).push(1, 0).op("MSTORE")
              .push(1, 32).push(1, 0).op("RETURN"))
    initcode = (B().push(1, 0x00).push(1, 0).op("MSTORE8")
                .push(1, 1).push(1, 0).op("RETURN")).to_bytes()
    creator = B()
    for i, byte in enumerate(initcode):
        creator.push(1, byte).push(1, i).op("MSTORE8")
    creator.push(1, len(initcode)).push(1, 0).push(1, 0).op("CREATE").op("STOP")
    m = 1 << 256
    x = int.from_bytes(bytes(range(1, 33)), "big")
    return [
        ("add_mstore_return", B().push(1, 5).push(1, 7).op("ADD").push(1, 0)
         .op("MSTORE").push(1, 32).push(1, 0).op("RETURN"), {}, 0, b""),
        ("sstore_clear", B().push(1, 1).push(1, 0).op("SSTORE").push(1, 0)
         .push(1, 0).op("SSTORE").op("STOP"), {}, 0, b""),
        ("sload_warm", B().push(1, 9).push(1, 5).op("SSTORE").push(1, 5)
         .op("SLOAD").op("STOP"), {}, 0, b""),
        ("call_returndata", B().push(1, 32).push(1, 0).push(1, 0).push(1, 0)
         .push(1, 0).push(20, OTHER).push(3, 0xFFFF).op("CALL")
         .push(1, 32).push(1, 0).op("RETURN"), {OTHER: callee}, 0, b""),
        ("call_value", B().push(1, 0).push(1, 0).push(1, 0).push(1, 0)
         .push(1, 55).push(20, OTHER).push(2, 0xFFFF).op("CALL").op("STOP"),
         {}, 100, b""),
        ("revert", B().push(1, 7).push(1, 1).op("SSTORE").push(1, 0)
         .push(1, 0).op("REVERT"), {}, 0, b""),
        ("jump_over_invalid", B().push(1, 4).op("JUMP").op("INVALID")
         .op("JUMPDEST").op("STOP"), {}, 0, b""),
        ("bad_jump", B().push(1, 3).op("JUMP").op("STOP"), {}, 0, b""),
        ("create", creator, {}, 0, b""),
        ("staticcall_write", B().push(1, 0).push(1, 0).push(1, 0).push(1, 0)
         .push(20, OTHER).push(2, 0xFFFF).op("STATICCALL").op("STOP"),
         {OTHER: B().push(1, 1).push(1, 0).op("SSTORE").op("STOP")}, 0, b""),
        ("mul_div_mod", B().push(32, m - 3).push(32, m - 5).op("MUL").op("POP")
         .push(1, 7).push(1, 100).op("DIV").op("POP").push(1, 0).push(1, 5)
         .op("DIV").op("POP").push(1, 7).push(1, 100).op("MOD").op("POP")
         .op("STOP"), {}, 0, b""),
        ("signed", B().push(1, 3).push(32, m - 13).op("SDIV").op("POP")
         .push(1, 3).push(32, m - 13).op("SMOD").op("POP")
         .push(1, 0x80).push(1, 0).op("SIGNEXTEND").op("POP")
         .push(32, m - 0xEF).push(1, 4).op("SAR").op("POP")
         .push(1, 3).push(32, m - 13).op("SLT").op("POP").op("STOP"),
         {}, 0, b""),
        ("bitwise_byte_shift", B().push(32, x).push(1, 3).op("BYTE").op("POP")
         .push(1, 1).push(1, 4).op("SHL").op("POP").push(32, x).push(1, 100)
         .op("SHR").op("POP").push(32, x).push(32, x >> 3).op("XOR").op("POP")
         .op("STOP"), {}, 0, b""),
        ("context_gas_msize", B().op("CALLER").op("POP").op("ADDRESS")
         .op("POP").op("CALLVALUE").op("POP").op("CALLDATASIZE").op("POP")
         .op("GAS").op("POP").op("MSIZE").op("POP").push(1, 0xAB).push(1, 64)
         .op("MSTORE").op("MSIZE").op("POP").op("STOP"), {}, 9, b"\x01\x02"),
        ("mstore8_mload", B().push(2, 0xBBAA).push(1, 5).op("MSTORE8")
         .push(1, 0).op("MLOAD").op("POP").op("STOP"), {}, 0, b""),
        ("calldataload", B().push(1, 0).op("CALLDATALOAD").op("POP")
         .push(1, 20).op("CALLDATALOAD").op("POP").push(1, 200)
         .op("CALLDATALOAD").op("POP").op("STOP"), {}, 0, bytes(range(40))),
        ("copies", B().push(1, 24).push(1, 3).push(1, 64).op("CALLDATACOPY")
         .push(1, 16).push(1, 2).push(1, 0).op("CODECOPY")
         .push(1, 7).push(1, 20).push(1, 60).op("LOG1")
         .push(1, 32).push(1, 0).push(1, 0).push(1, 0).push(1, 0)
         .push(20, OTHER).push(3, 0xFFFF).op("CALL").op("POP")
         .push(1, 8).push(1, 4).push(1, 128).op("RETURNDATACOPY").op("STOP"),
         {OTHER: callee}, 0, bytes(range(50, 90))),
    ]


PROGRAM_NAMES = [p[0] for p in _tracer_programs(jty.Bytecode)]


def _trace(tracer, code: bytes, others: dict, value: int, data: bytes):
    state = tracer.StateDB({
        SENDER: tracer.Account(balance=10**18),
        CONTRACT: tracer.Account(code=code, balance=777),
        **{a: tracer.Account(code=c) for a, c in others.items()},
    })
    it = tracer.Interpreter(state)
    tr = it.run_tx(tracer.Tx(from_addr=SENDER, to=CONTRACT, value=value,
                             data=data, gas=2_000_000))
    accounts = {a: _plain(acct) for a, acct in state.accounts.items()}
    return tr, accounts, it.refund


def _case(name):
    (_, jcode, jothers, value, data), = [
        p for p in _tracer_programs(jty.Bytecode) if p[0] == name]
    (_, tcode, tothers, _, _), = [
        p for p in _tracer_programs(tty.Bytecode) if p[0] == name]
    assert tcode.to_bytes() == jcode.to_bytes()
    others = {a: c.to_bytes() for a, c in jothers.items()}
    assert others == {a: c.to_bytes() for a, c in tothers.items()}
    return jcode.to_bytes(), others, value, data


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_interpreter_trace_matches_reference(name):
    code, others, value, data = _case(name)
    ttr_, tacc, trefund = _trace(ttr, code, others, value, data)
    jtr_, jacc, jrefund = _trace(jtr, code, others, value, data)
    assert ttr_.to_json() == jtr_.to_json()
    assert tacc == jacc
    assert trefund == jrefund
    # the JSON schema round trip
    again = ttrace.GethExecTrace.from_json(ttr_.to_json())
    assert again.to_json() == jtrace.GethExecTrace.from_json(jtr_.to_json()).to_json()


@pytest.mark.parametrize("seed", range(6))
def test_interpreter_fuzz_trace_matches_reference(seed):
    rng = random.Random(seed)
    code, _ = _gen_program(rng, 24, with_copies=bool(seed % 2))
    data = bytes(rng.randrange(256) for _ in range(rng.randrange(96)))
    others = {OTHER: b"\x00"}
    t = _trace(ttr, code.to_bytes(), others, seed * 11, data)
    j = _trace(jtr, code.to_bytes(), others, seed * 11, data)
    assert t[0].to_json() == j[0].to_json()
    assert t[1:] == j[1:]


# ---------------------------------------------------------------------------
# builder


def _build(tracer, builder, code: bytes, others: dict, value: int, data: bytes):
    tr, _, _ = _trace(tracer, code, others, value, data)
    hashes = {a: int.from_bytes(keccak256(c), "big")
              for a, c in {CONTRACT: code, **others}.items()}
    b = builder.CircuitInputBuilder(accounts={
        SENDER: builder.AccountState(balance=10**18),
        CONTRACT: builder.AccountState(balance=777, code_hash=hashes[CONTRACT]),
        **{a: builder.AccountState(code_hash=hashes[a]) for a in others},
    })
    b.handle_tx(dict(from_addr=SENDER, to_addr=CONTRACT, value=value,
                     calldata=data, code_hash=hashes[CONTRACT]),
                tr, code_db={CONTRACT: code, **others})
    return b


def _same_builder(t, j):
    assert _plain(t.steps) == _plain(j.steps)
    assert _plain(t.rws.rws) == _plain(j.rws.rws)
    assert t.rws.check_consistency() == j.rws.check_consistency()
    assert _plain(t.copy_events) == _plain(j.copy_events)
    assert _plain(t.exp_events) == _plain(j.exp_events)
    assert _plain(t.txs) == _plain(j.txs)
    assert t.sha3_inputs == j.sha3_inputs
    assert _plain(t.accounts) == _plain(j.accounts)


@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_builder_matches_reference(name):
    code, others, value, data = _case(name)
    t = _build(ttr, tb, code, others, value, data)
    _same_builder(t, _build(jtr, jb, code, others, value, data))
    if name == "copies":
        assert len(t.copy_events) == 5


@pytest.mark.parametrize("seed", range(8))
def test_builder_fuzz_matches_reference(seed):
    """Seeded programs of tests/test_fuzz_witness.py, with the copy family
    (CALLDATACOPY, CODECOPY, LOG data) on odd seeds."""
    rng = random.Random(seed)
    code, _ = _gen_program(rng, 24, with_copies=bool(seed % 2))
    data = bytes(rng.randrange(256) for _ in range(rng.randrange(96)))
    args = (code.to_bytes(), {OTHER: b"\x00"}, seed * 11, data)
    _same_builder(_build(ttr, tb, *args), _build(jtr, jb, *args))


def test_builder_mulmod_events_match_reference():
    """MULMOD and ADDMOD steps record MulModEvents of circuits/mulmod.py:
    the port's equal the reference's field by field, with n = 0 among them
    (r = 0).  The modexp precompile records its ModExpEvent of
    circuits/modexp.py in both builders alike."""
    code = (tty.Bytecode().push(1, 7).push(1, 5).push(1, 3).op("MULMOD")
            .op("POP").push(1, 0).push(1, 5).push(1, 7).op("ADDMOD")
            .op("POP").op("STOP").to_bytes())
    t, j = _build(ttr, tb, code, {}, 0, b""), _build(jtr, jb, code, {}, 0, b"")
    _same_builder(t, j)
    assert _plain(t.mulmod_events) == _plain(j.mulmod_events)
    assert [(e.a, e.b, e.n, e.r, e.is_add) for e in t.mulmod_events] == \
        [(3, 5, 7, 1, False), (7, 5, 0, 0, True)]
    # MODEXP(3, 5, 7): three 32-byte lengths of 1, then the operands
    modexp = tty.Bytecode()
    for off in (0, 32, 64):
        modexp.push(1, 1).push(1, off).op("MSTORE")
    for off, v in ((96, 3), (97, 5), (98, 7)):
        modexp.push(1, v).push(1, off).op("MSTORE8")
    modexp = (modexp.push(1, 1).push(1, 200).push(1, 99).push(1, 0)
              .push(1, 5).op("GAS").op("STATICCALL").op("POP").op("STOP")
              .to_bytes())
    t, j = (_build(ttr, tb, modexp, {}, 0, b""),
            _build(jtr, jb, modexp, {}, 0, b""))
    _same_builder(t, j)
    assert _plain(t.modexp_events) == _plain(j.modexp_events)
    assert [(e.base, e.exponent, e.modulus, e.result)
            for e in t.modexp_events] == [(3, 5, 7, pow(3, 5, 7))]


def _mstore_word(code, offset, value):
    return code.push(32, value).push(2, offset).op("MSTORE")


def _static_call(code, addr, args_len, ret_off, ret_len):
    code.push(1, ret_len).push(2, ret_off).push(1, args_len).push(1, 0)
    return code.push(2, addr).push(2, 0xFFFF).op("STATICCALL").op("POP")


def _precompile_program(name):
    """The precompile programs of tests/test_super_circuit.py: ecAdd (after
    an identity call), ecMul, ecrecover, SHA-256 of 40 bytes and of none,
    and a 32/32/32-byte modexp."""
    from zkevm_circuits_tpu_torch.crypto.curve import host_g1_add
    from zkevm_circuits_tpu_torch.crypto.params import G1_GEN

    code = tty.Bytecode()
    if name == "ecadd":
        g2 = host_g1_add(G1_GEN, G1_GEN)
        _mstore_word(code, 0, 0x1234)
        _static_call(code, 4, 32, 0x40, 32)
        code.push(1, 0x40).op("MLOAD").op("POP")
        for off, v in ((0, G1_GEN[0]), (32, G1_GEN[1]), (64, g2[0]),
                       (96, g2[1])):
            _mstore_word(code, off, v)
        _static_call(code, 6, 128, 0x100, 64)
    elif name == "ecmul":
        for off, v in ((0, G1_GEN[0]), (32, G1_GEN[1]), (64, 0xABCDEF123456789)):
            _mstore_word(code, off, v)
        _static_call(code, 7, 96, 0x100, 64)
    elif name == "ecrecover":
        z = 0x1122334455667788
        r, s, rec = tsecp.sign(0x5EED_BEEF_F00D, z.to_bytes(32, "big"))
        for off, v in ((0, z), (32, 27 + rec), (64, r), (96, s)):
            _mstore_word(code, off, v)
        _static_call(code, 1, 128, 0x100, 32)
    elif name == "sha256":
        msg = bytes(range(40))
        for i in range(0, 40, 32):
            _mstore_word(code, i, int.from_bytes(msg[i:i + 32].ljust(32, b"\x00"), "big"))
        _static_call(code, 2, 40, 0x100, 32)
    elif name == "sha256_empty":
        _static_call(code, 2, 0, 0x100, 32)
    elif name == "modexp":
        for off, v in ((0, 32), (32, 32), (64, 32), (96, 0x1234), (128, 0x1001),
                       (160, (1 << 200) + 7)):
            _mstore_word(code, off, v)
        _static_call(code, 5, 192, 0x200, 32)
    return code.push(2, 0x100).op("MLOAD").op("POP").op("STOP").to_bytes()


@pytest.mark.parametrize("name", ["ecadd", "ecmul", "ecrecover", "sha256",
                                  "sha256_empty", "modexp"])
def test_builder_precompile_events_match_reference(name):
    """Each precompile call records its event (circuits/sig.py, ecc.py,
    modexp.py; SHA-256 its input) in the port's builder as in the
    reference's, field by field."""
    code = _precompile_program(name)
    t, j = _build(ttr, tb, code, {}, 0, b""), _build(jtr, jb, code, {}, 0, b"")
    _same_builder(t, j)
    for field in ("sig_events", "ecadd_events", "ecmul_events",
                  "modexp_events", "sha256_inputs", "mulmod_events"):
        assert _plain(getattr(t, field)) == _plain(getattr(j, field)), field
    counts = {f: len(getattr(t, f)) for f in (
        "sig_events", "ecadd_events", "ecmul_events", "modexp_events",
        "sha256_inputs")}
    key = {"ecadd": "ecadd_events", "ecmul": "ecmul_events",
           "ecrecover": "sig_events", "sha256": "sha256_inputs",
           "sha256_empty": "sha256_inputs", "modexp": "modexp_events"}[name]
    assert counts == {f: int(f == key) for f in counts}
    if name == "ecrecover":
        assert t.sig_events[0].address == tsecp.eth_address(0x5EED_BEEF_F00D)
    if name.startswith("sha256"):
        assert t.sha256_inputs == [bytes(range(40)) if name == "sha256" else b""]


def test_builder_multi_tx_workload_matches_reference(monkeypatch):
    """bench_circuits.evm_workload (several transactions of looping
    contracts) at k=10, once through the port's tracer and builder and once
    through the JAX package's."""
    tb_, tstats = tbench.evm_workload(3, 10)
    for name, mod in (("StateDB", jtr), ("Account", jtr), ("Interpreter", jtr),
                      ("Tx", jtr), ("Bytecode", jty),
                      ("CircuitInputBuilder", jb), ("AccountState", jb)):
        monkeypatch.setattr(tbench, name, getattr(mod, name))
    jb_, jstats = tbench.evm_workload(3, 10)
    assert tstats == jstats
    assert tstats["txs"] >= 2 and tstats["rw_fill"] >= 0.9
    _same_builder(tb_, jb_)


# ---------------------------------------------------------------------------
# test_ctx + block


def _ctx_block(ctx_mod, block_mod, builder, tx_mod, sk):
    code = (ctx_mod.Bytecode().push(1, 3).push(1, 4).op("MUL").push(1, 0)
            .op("MSTORE").push(1, 32).push(1, 0).op("RETURN"))
    sender = tx_mod.Transaction(nonce=0, to=CONTRACT, chain_id=1337).sign(sk)
    data = (ctx_mod.TestContext()
            .account(CONTRACT, code=code, balance=5, storage={1: 2})
            .account(sender.recover_sender(), balance=10**19)
            .tx(from_addr=sender.recover_sender(), to=CONTRACT, value=3)
            .build())
    b = builder.CircuitInputBuilder()
    b.handle_tx(dict(from_addr=sender.recover_sender(), to_addr=CONTRACT,
                     value=3, calldata=b""), data.geth_traces[0],
                code_db={CONTRACT: code.to_bytes()})
    return data, block_mod.block_convert(b, data, [sender])


def test_test_ctx_and_block_convert_match_reference():
    sk = 0x4C0883A69102937D6231471B5DBB6204FE512961708279F2A3E1B6D2E7A3C2D1
    td, tblk = _ctx_block(tctx, tblock, tb, ttx, sk)
    jd, jblk = _ctx_block(jctx, jblock, jb, jtx, sk)
    assert _plain(td.block) == _plain(jd.block)
    assert _plain(td.pre_state) == _plain(jd.pre_state)
    assert _plain(td.state.accounts) == _plain(jd.state.accounts)
    assert _plain(td.txs) == _plain(jd.txs)
    assert [t.to_json() for t in td.geth_traces] == \
        [t.to_json() for t in jd.geth_traces]
    assert tblk.num_rws == jblk.num_rws
    assert _plain(tblk.steps) == _plain(jblk.steps)
    assert _plain(tblk.rws.rws) == _plain(jblk.rws.rws)
    assert [bc.to_bytes() for bc in tblk.bytecodes] == \
        [bc.to_bytes() for bc in jblk.bytecodes]
    assert [t.rlp_signed() for t in tblk.txs] == [t.rlp_signed() for t in jblk.txs]
    assert tblk.keccak_inputs == jblk.keccak_inputs
    assert tblk.code_hashes == jblk.code_hashes
