"""One-liner spec parser (port of zkevm_circuits_tpu/testool/oneliner.py;
reference `testool --oneliner`,
testool/README.md "Run oneliner spec"):

    `txparams` `account 1` ... `account n`

    txparams: call|create[;calldata[;value[;gas]]]
    account:  address;code[;balance[;slot:value ...]]

`address` expands right-aligned (`12` -> 0x...12); `code` is hex or
asm (`PUSH1(1),PUSH1(2),ADD`); the first account is the called
contract for `call` specs.  The tx sender is a funded dev account
derived from DEFAULT_SK (the reference funds a fixed sender too).
"""

from __future__ import annotations

from ..types import Bytecode
from ..types.transaction import Transaction
from .statetest import AccountState, StateTest

DEFAULT_SK = 0x2E0A301E4914A1EB76B9E628C74DEE5B5B8E08A466CE3F90A4F54F5E8739AB66


def _parse_code(spec: str) -> bytes:
    spec = spec.strip()
    if not spec:
        return b""
    if all(c in "0123456789abcdefABCDEF" for c in spec) and len(spec) % 2 == 0:
        return bytes.fromhex(spec)
    bc = Bytecode()
    for part in spec.split(","):
        part = part.strip()
        if "(" in part:
            opname, arg = part.split("(", 1)
            arg = arg.rstrip(")")
            val = int(arg, 16 if arg.startswith("0x") else 10)
            opname = opname.strip().upper()
            assert opname.startswith("PUSH"), f"unsupported asm {part}"
            bc.push(int(opname[4:]), val)
        else:
            bc.op(part.upper())
    return bc.to_bytes()


def _expand_addr(a: str) -> int:
    return int(a, 16)


def parse_oneliner(spec: str, name: str = "oneliner") -> StateTest:
    parts = spec.split()
    assert parts, "empty oneliner"
    txp = parts[0].split(";")
    kind = txp[0]
    assert kind in ("call", "create"), f"bad tx kind {kind}"
    calldata = bytes.fromhex(txp[1]) if len(txp) > 1 and txp[1] else b""
    value = int(txp[2]) if len(txp) > 2 and txp[2] else 0
    gas = int(txp[3]) if len(txp) > 3 and txp[3] else 10_000_000

    pre: dict[int, AccountState] = {}
    first_addr = None
    for acc in parts[1:]:
        fields = acc.split(";")
        addr = _expand_addr(fields[0])
        first_addr = addr if first_addr is None else first_addr
        code = _parse_code(fields[1]) if len(fields) > 1 else b""
        balance = int(fields[2]) if len(fields) > 2 and fields[2] else 0
        storage = {}
        for sv in fields[3:]:
            if not sv:
                continue
            slot, val = sv.split(":")
            storage[int(slot, 16)] = int(val, 16)
        pre[addr] = AccountState(
            balance=balance, nonce=0, code=code, storage=storage
        )

    sender = Transaction(nonce=0).sign(DEFAULT_SK).recover_sender()
    pre.setdefault(
        sender, AccountState(balance=10**18, nonce=0, code=b"", storage={})
    )
    to = None if kind == "create" else first_addr
    assert kind == "create" or to is not None, "call spec needs an account"
    return StateTest(
        name=name, pre=pre, tx_from=sender, tx_to=to, tx_gas=gas,
        tx_value=value, tx_data=calldata, tx_nonce=0,
        secret_key=DEFAULT_SK,
    )
