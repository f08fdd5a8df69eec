"""Official-format GeneralStateTests filler generator (port of
zkevm_circuits_tpu/testool/gen_suite.py; its own copy of the oracle, and
`write_suite` writes the same bytes).

The reference testool runs the ethereum/tests GeneralStateTests corpus
(`testool/src/statetest/yaml.rs` + the `testool/tests` submodule).  That
corpus is not vendorable here (no network egress; the reference checkout
carries an EMPTY submodule), so this module generates a pinned suite of
fillers in the official JSON filler format (env / pre / transaction /
expect — the exact schema `json_parser.py` consumes, which mirrors
`testool/src/statetest/json.rs`), spanning the VMTests families:
arithmetic, bitwise-logic, comparison, IO-and-flow, memory, storage,
context, sha3, dup/swap.

Every expected post-state value is computed by an INDEPENDENT plain-
Python semantics oracle below (not the repo's tracer), so the suite
cross-checks tracer + witness builder + circuits against a second
implementation of EVM semantics, exactly like the official corpus does.
"""

from __future__ import annotations

import json
import pathlib

from ..crypto.keccak import keccak256

M256 = 1 << 256
M255 = 1 << 255
SENDER = 0xA94F5374FCE5EDBC8E2A8697C15331677E6EBF0B  # classic tests sender
# The official corpus's well-known sender key (GeneralStateTests fillers all
# sign with it; SENDER above is exactly its derived address — asserted in
# tests/test_testool_suite.py).  Without it `run_state_test` skips the mock
# level ("no secret key for the Tx circuit", statetest.py).
SENDER_SK = 0x45A915E4D060149EB4365960E6A7A45F334393093061116B197E3240065FF2D8
CONTRACT = 0x095E7BAEA6A6C7C4C2DFEB977EFAC326AF552D87  # classic tests to


# ---------------------------------------------------------------------------
# independent 256-bit semantics oracle
# ---------------------------------------------------------------------------
def _sgn(x: int) -> int:
    return x - M256 if x >= M255 else x


def _u(x: int) -> int:
    return x % M256


OPS2 = {
    # name: (opcode byte, oracle(a, b)) — a is the TOP of the stack
    "add": (0x01, lambda a, b: _u(a + b)),
    "mul": (0x02, lambda a, b: _u(a * b)),
    "sub": (0x03, lambda a, b: _u(a - b)),
    "div": (0x04, lambda a, b: a // b if b else 0),
    "sdiv": (0x05, lambda a, b: _u(
        abs(_sgn(a)) // abs(_sgn(b))
        * (1 if (_sgn(a) < 0) == (_sgn(b) < 0) else -1)
    ) if b else 0),
    "mod": (0x06, lambda a, b: a % b if b else 0),
    "smod": (0x07, lambda a, b: _u(
        (abs(_sgn(a)) % abs(_sgn(b))) * (1 if _sgn(a) >= 0 else -1)
    ) if b else 0),
    "exp": (0x0A, lambda a, b: pow(a, b, M256)),
    "signextend": (0x0B, lambda a, b: _signextend(a, b)),
    "lt": (0x10, lambda a, b: int(a < b)),
    "gt": (0x11, lambda a, b: int(a > b)),
    "slt": (0x12, lambda a, b: int(_sgn(a) < _sgn(b))),
    "sgt": (0x13, lambda a, b: int(_sgn(a) > _sgn(b))),
    "eq": (0x14, lambda a, b: int(a == b)),
    "and": (0x16, lambda a, b: a & b),
    "or": (0x17, lambda a, b: a | b),
    "xor": (0x18, lambda a, b: a ^ b),
    "byte": (0x1A, lambda a, b: (b >> (8 * (31 - a))) & 0xFF
             if a < 32 else 0),
    "shl": (0x1B, lambda a, b: _u(b << a) if a < 256 else 0),
    "shr": (0x1C, lambda a, b: b >> a if a < 256 else 0),
    "sar": (0x1D, lambda a, b: _u(_sgn(b) >> a) if a < 256
            else (M256 - 1 if _sgn(b) < 0 else 0)),
}

OPS1 = {
    "iszero": (0x15, lambda a: int(a == 0)),
    "not": (0x19, lambda a: a ^ (M256 - 1)),
}

OPS3 = {
    "addmod": (0x08, lambda a, b, n: (a + b) % n if n else 0),
    "mulmod": (0x09, lambda a, b, n: (a * b) % n if n else 0),
}


def _signextend(i: int, x: int) -> int:
    if i >= 31:
        return x
    bit = 8 * (i + 1) - 1
    if (x >> bit) & 1:
        return x | (M256 - (1 << (bit + 1)))
    return x & ((1 << (bit + 1)) - 1)


# ---------------------------------------------------------------------------
# tiny assembler (independent byte emission; no repo Bytecode dependency)
# ---------------------------------------------------------------------------
def _push(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return bytes([0x5F + n]) + v.to_bytes(n, "big")


def _sstore0(code: bytes) -> bytes:
    """...result on stack -> SSTORE at slot 0 -> STOP."""
    return code + _push(0) + bytes([0x55, 0x00])


# operand pools (edge values the official arithmetic fillers cycle)
PAIRS = [
    (0, 0), (1, 1), (5, 7), (2, 3),
    (M256 - 1, 1), (M256 - 1, M256 - 1), (M255, 1), (M255, M255),
    (0xFF00, 0x0FF0), (7, 0), (0, 7),
]
SHIFT_PAIRS = [(0, 1), (1, 1), (8, 0xFF00), (255, M255), (256, M255),
               (1, M256 - 1), (31, 0xAA55)]
TRIPLES = [(5, 7, 11), (M256 - 1, M256 - 1, 12), (3, 4, 0), (0, 0, 1)]


def _filler(name: str, code: bytes, storage_expect: dict,
            tx: dict | None = None, pre_storage: dict | None = None,
            value: int = 0, data: bytes = b"") -> dict:
    return {
        "env": {
            "currentCoinbase": "0x2adc25665018aa1fe0e6bc666dac8fc2697ff9ba",
            "currentDifficulty": "0x20000",
            "currentGasLimit": "0x1c9c380",
            "currentNumber": "0x1",
            "currentTimestamp": "0x3e8",
            "currentBaseFee": "0x7",
        },
        "pre": {
            f"0x{SENDER:040x}": {
                "balance": "0x0de0b6b3a7640000", "nonce": "0x0",
                "code": "0x", "storage": {},
            },
            f"0x{CONTRACT:040x}": {
                "balance": "0x0", "nonce": "0x0",
                "code": "0x" + code.hex(),
                "storage": {hex(k): hex(v)
                            for k, v in (pre_storage or {}).items()},
            },
        },
        "transaction": tx or {
            "data": ["0x" + data.hex()],
            "gasLimit": ["0x989680"],
            "gasPrice": "0x0a",
            "nonce": "0x0",
            "secretKey": f"0x{SENDER_SK:064x}",
            "sender": f"0x{SENDER:040x}",
            "to": f"0x{CONTRACT:040x}",
            "value": [hex(value)],
        },
        "expect": [{
            "indexes": {"data": -1, "gas": -1, "value": -1},
            "network": [">=Cancun"],
            "result": {
                f"0x{CONTRACT:040x}": {
                    "storage": {hex(k): hex(v)
                                for k, v in storage_expect.items()},
                },
            },
        }],
    }


def generate_suite() -> dict[str, dict]:
    """filename -> filler doc (possibly several tests per doc)."""
    suite: dict[str, dict] = {}

    # -- arithmetic / comparison / bitwise binops ---------------------------
    arith: dict = {}
    for opname, (byte, fn) in OPS2.items():
        pairs = SHIFT_PAIRS if opname in ("shl", "shr", "sar", "byte") \
            else PAIRS
        for i, (a, b) in enumerate(pairs):
            code = _sstore0(_push(b) + _push(a) + bytes([byte]))
            arith[f"{opname}_{i}"] = _filler(
                f"{opname}_{i}", code, {0: fn(a, b)}
            )
    suite["vmArithmeticTest.json"] = arith

    unary: dict = {}
    for opname, (byte, fn) in OPS1.items():
        for i, a in enumerate([0, 1, M256 - 1, M255, 0xFF00]):
            code = _sstore0(_push(a) + bytes([byte]))
            unary[f"{opname}_{i}"] = _filler(
                f"{opname}_{i}", code, {0: fn(a)}
            )
    suite["vmUnaryTest.json"] = unary

    modular: dict = {}
    for opname, (byte, fn) in OPS3.items():
        for i, (a, b, n) in enumerate(TRIPLES):
            code = _sstore0(_push(n) + _push(b) + _push(a) + bytes([byte]))
            modular[f"{opname}_{i}"] = _filler(
                f"{opname}_{i}", code, {0: fn(a, b, n)}
            )
    suite["vmModularTest.json"] = modular

    # -- IO and flow ---------------------------------------------------------
    flow: dict = {}
    # JUMP over a dead zone: PUSH1 dest JUMP INVALID ... JUMPDEST PUSH1 42
    dead = bytes([0xFE])
    dest = len(_push(0)) + 1 + len(dead)  # PUSH1 d | JUMP | dead | JUMPDEST
    code = _push(dest) + bytes([0x56]) + dead + bytes([0x5B])
    code = _sstore0(code + _push(42))
    flow["jump_simple"] = _filler("jump_simple", code, {0: 42})
    # JUMPI taken: cond=1 jumps over the dead byte to the JUMPDEST
    dst = 5 + len(dead)
    c = _push(1) + _push(dst) + bytes([0x57]) + dead + bytes([0x5B])
    flow["jumpi_taken"] = _filler(
        "jumpi_taken", _sstore0(c + _push(9)), {0: 9}
    )
    # JUMPI not taken: cond=0 falls through (no dead byte in that path)
    c = _push(0) + _push(7) + bytes([0x57])
    flow["jumpi_not_taken"] = _filler(
        "jumpi_not_taken", _sstore0(c + _push(4)), {0: 4}
    )
    # PC opcode
    code = _sstore0(bytes([0x58]))  # PC at offset 0 -> 0
    flow["pc_zero"] = _filler("pc_zero", code, {0: 0})
    code = _sstore0(bytes([0x5B, 0x58]))  # JUMPDEST PC -> 1
    flow["pc_after_jumpdest"] = _filler("pc_after_jumpdest", code, {0: 1})
    suite["vmIOandFlowOperations.json"] = flow

    # -- memory ---------------------------------------------------------------
    mem: dict = {}
    v = 0xDEADBEEFCAFE
    code = _push(v) + _push(0) + bytes([0x52])  # MSTORE @0
    code = _sstore0(code + _push(0) + bytes([0x51]))  # MLOAD @0
    mem["mstore_mload"] = _filler("mstore_mload", code, {0: v})
    code = _push(0xAB) + _push(31) + bytes([0x53])  # MSTORE8 @31
    code = _sstore0(code + _push(0) + bytes([0x51]))
    mem["mstore8"] = _filler("mstore8", code, {0: 0xAB})
    code = _push(1) + _push(32) + bytes([0x52])  # expand to 64 bytes
    code = _sstore0(code + bytes([0x59]))  # MSIZE
    mem["msize"] = _filler("msize", code, {0: 64})
    suite["vmMemoryTest.json"] = mem

    # -- storage ---------------------------------------------------------------
    sto: dict = {}
    code = _push(77) + _push(3) + bytes([0x55])  # SSTORE slot 3
    code = _sstore0(code + _push(3) + bytes([0x54]))  # SLOAD slot 3
    sto["sstore_sload"] = _filler("sstore_sload", code, {0: 77, 3: 77})
    # overwrite a pre-existing slot
    code = _sstore0(_push(5) + bytes([0x54]))  # SLOAD pre slot 5
    sto["sload_pre"] = _filler(
        "sload_pre", code, {0: 0x1234, 5: 0x1234}, pre_storage={5: 0x1234}
    )
    # delete (write 0) then read
    code = _push(0) + _push(5) + bytes([0x55])
    code = _sstore0(code + _push(5) + bytes([0x54]))
    sto["sstore_delete"] = _filler(
        "sstore_delete", code, {0: 0, 5: 0}, pre_storage={5: 9}
    )
    suite["vmStorageTest.json"] = sto

    # -- context ---------------------------------------------------------------
    ctx: dict = {}
    ctx["address"] = _filler(
        "address", _sstore0(bytes([0x30])), {0: CONTRACT}
    )
    ctx["caller"] = _filler(
        "caller", _sstore0(bytes([0x33])), {0: SENDER}
    )
    ctx["origin"] = _filler(
        "origin", _sstore0(bytes([0x32])), {0: SENDER}
    )
    ctx["callvalue"] = _filler(
        "callvalue", _sstore0(bytes([0x34])), {0: 123}, value=123
    )
    ctx["gasprice"] = _filler(
        "gasprice", _sstore0(bytes([0x3A])), {0: 10}
    )
    data = bytes(range(1, 37))
    ctx["calldatasize"] = _filler(
        "calldatasize", _sstore0(bytes([0x36])), {0: 36}, data=data
    )
    word = int.from_bytes(data[:32], "big")
    ctx["calldataload"] = _filler(
        "calldataload", _sstore0(_push(0) + bytes([0x35])), {0: word},
        data=data,
    )
    suite["vmContextTest.json"] = ctx

    # -- sha3 -------------------------------------------------------------------
    sha: dict = {}
    msg = (0x11).to_bytes(32, "big")
    code = _push(0x11) + _push(0) + bytes([0x52])  # MSTORE @0
    code = _sstore0(code + _push(32) + _push(0) + bytes([0x20]))
    sha["sha3_word"] = _filler(
        "sha3_word", code, {0: int.from_bytes(keccak256(msg), "big")}
    )
    code = _sstore0(_push(0) + _push(0) + bytes([0x20]))  # empty input
    sha["sha3_empty"] = _filler(
        "sha3_empty", code, {0: int.from_bytes(keccak256(b""), "big")}
    )
    suite["vmSha3Test.json"] = sha

    # -- dup / swap / pop --------------------------------------------------------
    ds: dict = {}
    for n in (1, 4, 16):
        # PUSH 1..n, DUPn copies the deepest (value 1)
        code = b"".join(_push(i + 1) for i in range(n))
        code = _sstore0(code + bytes([0x7F + n]))
        ds[f"dup{n}"] = _filler(f"dup{n}", code, {0: 1})
    for n in (1, 8):
        # PUSH 1..n+1; SWAPn brings the deepest (1) to the top
        code = b"".join(_push(i + 1) for i in range(n + 1))
        code = _sstore0(code + bytes([0x8F + n]))
        ds[f"swap{n}"] = _filler(f"swap{n}", code, {0: 1})
    code = _sstore0(_push(9) + _push(5) + bytes([0x50]))  # POP the 5
    ds["pop"] = _filler("pop", code, {0: 9})
    suite["vmDupSwapTest.json"] = ds

    return suite


def write_suite(path: str | pathlib.Path) -> int:
    """Write the suite to `path` (one filler file per family).  Returns
    the number of individual state tests generated."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    total = 0
    for fname, doc in generate_suite().items():
        (p / fname).write_text(json.dumps(doc, indent=1))
        total += len(doc)
    return total


if __name__ == "__main__":  # pragma: no cover
    import sys

    n = write_suite(sys.argv[1] if len(sys.argv) > 1 else "generated_tests")
    print(f"wrote {n} state tests")
