"""EVM opcode table, gas constants, stack/memory effects.

Equivalent of the reference's `eth-types/src/evm_types.rs`
(`OpcodeId/GasCost/Memory/Stack`, SURVEY.md §2.1 item 1) — Shanghai fork
surface.  Data-driven: one table row per opcode with (byte, pops, pushes,
constant_gas); predicates derive from byte ranges.

Port of zkevm_circuits_tpu/types/evm.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import enum


class GasCost(enum.IntEnum):
    ZERO = 0
    BASE = 2
    VERYLOW = 3
    LOW = 5
    MID = 8
    HIGH = 10
    WARM_ACCESS = 100
    COLD_SLOAD = 2100
    COLD_ACCOUNT_ACCESS = 2600
    SLOAD = 100
    SSTORE_SET = 20000
    SSTORE_RESET = 2900
    SSTORE_CLEARS_SCHEDULE = 4800
    JUMPDEST = 1
    CREATE = 32000
    SELFDESTRUCT = 5000
    CALL_VALUE = 9000
    CALL_STIPEND = 2300
    NEW_ACCOUNT = 25000
    EXP = 10
    EXP_BYTE = 50
    MEMORY = 3
    COPY = 3
    KECCAK256 = 30
    KECCAK256_WORD = 6
    LOG = 375
    LOG_DATA = 8
    LOG_TOPIC = 375
    TX = 21000
    TX_CREATE = 32000 + 21000
    TX_DATA_ZERO = 4
    TX_DATA_NONZERO = 16
    INIT_CODE_WORD = 2  # EIP-3860
    BALANCE = 100
    EXTCODESIZE = 100
    EXTCODEHASH = 100
    EXTCODECOPY = 100
    BLOCKHASH = 20


# name: (byte, pops, pushes, constant_gas)
_TABLE = {
    "STOP": (0x00, 0, 0, 0),
    "ADD": (0x01, 2, 1, 3), "MUL": (0x02, 2, 1, 5), "SUB": (0x03, 2, 1, 3),
    "DIV": (0x04, 2, 1, 5), "SDIV": (0x05, 2, 1, 5), "MOD": (0x06, 2, 1, 5),
    "SMOD": (0x07, 2, 1, 5), "ADDMOD": (0x08, 3, 1, 8), "MULMOD": (0x09, 3, 1, 8),
    "EXP": (0x0A, 2, 1, 10), "SIGNEXTEND": (0x0B, 2, 1, 5),
    "LT": (0x10, 2, 1, 3), "GT": (0x11, 2, 1, 3), "SLT": (0x12, 2, 1, 3),
    "SGT": (0x13, 2, 1, 3), "EQ": (0x14, 2, 1, 3), "ISZERO": (0x15, 1, 1, 3),
    "AND": (0x16, 2, 1, 3), "OR": (0x17, 2, 1, 3), "XOR": (0x18, 2, 1, 3),
    "NOT": (0x19, 1, 1, 3), "BYTE": (0x1A, 2, 1, 3),
    "SHL": (0x1B, 2, 1, 3), "SHR": (0x1C, 2, 1, 3), "SAR": (0x1D, 2, 1, 3),
    "SHA3": (0x20, 2, 1, 30),
    "ADDRESS": (0x30, 0, 1, 2), "BALANCE": (0x31, 1, 1, 100),
    "ORIGIN": (0x32, 0, 1, 2), "CALLER": (0x33, 0, 1, 2),
    "CALLVALUE": (0x34, 0, 1, 2), "CALLDATALOAD": (0x35, 1, 1, 3),
    "CALLDATASIZE": (0x36, 0, 1, 2), "CALLDATACOPY": (0x37, 3, 0, 3),
    "CODESIZE": (0x38, 0, 1, 2), "CODECOPY": (0x39, 3, 0, 3),
    "GASPRICE": (0x3A, 0, 1, 2), "EXTCODESIZE": (0x3B, 1, 1, 100),
    "EXTCODECOPY": (0x3C, 4, 0, 100), "RETURNDATASIZE": (0x3D, 0, 1, 2),
    "RETURNDATACOPY": (0x3E, 3, 0, 3), "EXTCODEHASH": (0x3F, 1, 1, 100),
    "BLOCKHASH": (0x40, 1, 1, 20), "COINBASE": (0x41, 0, 1, 2),
    "TIMESTAMP": (0x42, 0, 1, 2), "NUMBER": (0x43, 0, 1, 2),
    "DIFFICULTY": (0x44, 0, 1, 2), "GASLIMIT": (0x45, 0, 1, 2),
    "CHAINID": (0x46, 0, 1, 2), "SELFBALANCE": (0x47, 0, 1, 5),
    "BASEFEE": (0x48, 0, 1, 2),
    "POP": (0x50, 1, 0, 2), "MLOAD": (0x51, 1, 1, 3), "MSTORE": (0x52, 2, 0, 3),
    "MSTORE8": (0x53, 2, 0, 3), "SLOAD": (0x54, 1, 1, 100),
    "SSTORE": (0x55, 2, 0, 0), "JUMP": (0x56, 1, 0, 8), "JUMPI": (0x57, 2, 0, 10),
    "PC": (0x58, 0, 1, 2), "MSIZE": (0x59, 0, 1, 2), "GAS": (0x5A, 0, 1, 2),
    "JUMPDEST": (0x5B, 0, 0, 1),
    "PUSH0": (0x5F, 0, 1, 2),
    **{f"PUSH{i}": (0x5F + i, 0, 1, 3) for i in range(1, 33)},
    **{f"DUP{i}": (0x7F + i, i, i + 1, 3) for i in range(1, 17)},
    **{f"SWAP{i}": (0x8F + i, i + 1, i + 1, 3) for i in range(1, 17)},
    **{f"LOG{i}": (0xA0 + i, i + 2, 0, 375) for i in range(0, 5)},
    "CREATE": (0xF0, 3, 1, 32000), "CALL": (0xF1, 7, 1, 100),
    "CALLCODE": (0xF2, 7, 1, 100), "RETURN": (0xF3, 2, 0, 0),
    "DELEGATECALL": (0xF4, 6, 1, 100), "CREATE2": (0xF5, 4, 1, 32000),
    "STATICCALL": (0xFA, 6, 1, 100), "REVERT": (0xFD, 2, 0, 0),
    "INVALID": (0xFE, 0, 0, 0), "SELFDESTRUCT": (0xFF, 1, 0, 5000),
}


class OpcodeId(enum.IntEnum):
    """All Shanghai-fork opcodes, by byte value."""

    def __new__(cls, byte, pops, pushes, gas):
        obj = int.__new__(cls, byte)
        obj._value_ = byte
        obj.pops = pops
        obj.pushes = pushes
        obj.constant_gas = gas
        return obj

    @property
    def is_push(self) -> bool:
        return 0x5F <= self <= 0x7F

    @property
    def is_push_with_data(self) -> bool:
        return 0x60 <= self <= 0x7F

    @property
    def push_len(self) -> int:
        return self - 0x5F if self.is_push_with_data else 0

    @property
    def is_dup(self) -> bool:
        return 0x80 <= self <= 0x8F

    @property
    def is_swap(self) -> bool:
        return 0x90 <= self <= 0x9F

    @property
    def is_log(self) -> bool:
        return 0xA0 <= self <= 0xA4

    @property
    def is_call(self) -> bool:
        return self in (
            OpcodeId.CALL, OpcodeId.CALLCODE, OpcodeId.DELEGATECALL,
            OpcodeId.STATICCALL,
        )

    @property
    def is_create(self) -> bool:
        return self in (OpcodeId.CREATE, OpcodeId.CREATE2)

    locals().update({name: row for name, row in _TABLE.items()})


_BY_BYTE = {int(op): op for op in OpcodeId}


def opcode_from_byte(b: int) -> OpcodeId | None:
    """None for invalid/undefined bytes (treated as INVALID by the EVM)."""
    return _BY_BYTE.get(b)


def opcode_from_name(name: str) -> OpcodeId:
    return OpcodeId[name]


MAX_WORD = (1 << 256) - 1


def memory_expansion_gas(cur_words: int, new_words: int) -> int:
    """EVM quadratic memory pricing delta."""

    def cost(w):
        return 3 * w + w * w // 512

    return max(0, cost(new_words) - cost(cur_words)) if new_words > cur_words else 0


def memory_word_size(addr_plus_len: int) -> int:
    return (addr_plus_len + 31) // 32
