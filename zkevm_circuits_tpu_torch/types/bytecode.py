"""Bytecode builder + analyzer.

Equivalent of the reference's `eth-types/src/bytecode.rs` (`Bytecode` +
the `bytecode!` macro, SURVEY.md §2.1 item 1).  The macro becomes a
fluent Python builder: `Bytecode().push(1, 5).push(1, 7).op("ADD")`.
Tracks is_code marks (push data vs opcodes) — the layout the Bytecode
circuit unrolls.

Port of zkevm_circuits_tpu/types/bytecode.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

from ..crypto.keccak import keccak256
from .evm import OpcodeId, opcode_from_byte


class Bytecode:
    def __init__(self, code: bytes = b""):
        self.code = bytearray(code)

    # -- builder --------------------------------------------------------------
    def op(self, name: str | OpcodeId) -> "Bytecode":
        opc = OpcodeId[name] if isinstance(name, str) else name
        self.code.append(int(opc))
        return self

    def push(self, n_bytes: int, value: int) -> "Bytecode":
        assert 1 <= n_bytes <= 32
        self.code.append(0x5F + n_bytes)
        self.code += int(value).to_bytes(n_bytes, "big")
        return self

    def append(self, raw: bytes) -> "Bytecode":
        self.code += raw
        return self

    def __getattr__(self, name: str):
        """bc.ADD() style sugar for plain opcodes."""
        if name.isupper() and name in OpcodeId.__members__:
            return lambda: self.op(name)
        raise AttributeError(name)

    # -- analysis ---------------------------------------------------------------
    def to_bytes(self) -> bytes:
        return bytes(self.code)

    def hash(self) -> bytes:
        return keccak256(bytes(self.code))

    def is_code_marks(self) -> list[bool]:
        """True where the byte is an opcode (not push data)."""
        marks = [True] * len(self.code)
        i = 0
        while i < len(self.code):
            opc = opcode_from_byte(self.code[i])
            skip = opc.push_len if opc is not None and opc.is_push_with_data else 0
            for j in range(i + 1, min(i + 1 + skip, len(self.code))):
                marks[j] = False
            i += 1 + skip
        return marks

    def table_rows(self):
        """(index, byte, is_code) rows — the Bytecode table layout
        (reference zkevm-circuits/src/witness/bytecode.rs shape)."""
        marks = self.is_code_marks()
        return [(i, b, marks[i]) for i, (b, _) in enumerate(zip(self.code, marks))]

    def __len__(self):
        return len(self.code)
