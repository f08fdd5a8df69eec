"""Bytecode circuit — unrolls contract bytecodes into constrained rows.

Equivalent of the reference's `zkevm-circuits/src/bytecode_circuit/`
(SURVEY.md §2.2 "Bytecode"): per bytecode a header row carrying the
length, then one row per byte with a running index, push-data marking
(is_code) driven by a (byte -> push_size) fixed table, and a byte-RLC
accumulator under the phase-0 challenge (the value the Keccak table will
bind to a code hash once the Keccak circuit lands).

Shape: the whole layout is columnar (one numpy pass builds all
rows for all bytecodes), is_code uses an explicit inverse-witness IsZero,
and the (value, push_size) pair rides the shared logUp argument which
simultaneously range-checks the byte.

Port of zkevm_circuits_tpu/circuits/bytecode.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..types.bytecode import Bytecode
from ..types.evm import opcode_from_byte

F = fr()


def push_size_of(byte: int) -> int:
    op = opcode_from_byte(byte)
    return op.push_len if op is not None and op.is_push_with_data else 0


@dataclasses.dataclass
class BytecodeParams:
    target_rows: int = 0  # 0 => usable rows


class BytecodeCircuit(Circuit):
    def __init__(self, bytecodes: list[Bytecode], params: BytecodeParams | None = None):
        self.bytecodes = bytecodes
        self.params = params or BytecodeParams()

    def configure(self, cs: ConstraintSystem, challenge=None,
                  keccak_table=None):
        """`keccak_table`: optional (is_enabled, input_rlc, output_rlc)
        expressions from KeccakCircuit.keccak_table_exprs() — when given,
        each bytecode's (value_rlc, code_hash) pair is looked up there,
        binding code hashes in-circuit (reference bytecode_circuit
        code-hash keccak lookup)."""
        self.q_en = cs.fixed_column()
        self.tbl_byte = cs.fixed_column()
        self.tbl_push = cs.fixed_column()
        self.has_hash_binding = keccak_table is not None

        self.c_is_byte = cs.advice_column()
        self.c_index = cs.advice_column()
        self.c_length = cs.advice_column()
        self.c_value = cs.advice_column()
        self.c_is_code = cs.advice_column()
        self.c_pdl = cs.advice_column()  # push_data_left
        self.c_inv_pdl = cs.advice_column()  # inverse witness of prev pdl
        self.c_push_size = cs.advice_column()
        self.c_rlc = cs.advice_column(phase=1)
        # code-hash RLC (fold of the keccak digest bytes under r): always
        # present so the EVM circuit can bind executed opcodes via
        # `bytecode_table_exprs`; the keccak lookup that PROVES the hash
        # additionally needs `keccak_table` (pad rows)
        self.c_hash = cs.advice_column(phase=1)
        if self.has_hash_binding:
            self.c_is_pad = cs.advice_column()
        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        q = Fixed(self.q_en)
        ib, ib_p, ib_n = (
            Advice(self.c_is_byte),
            Advice(self.c_is_byte, -1),
            Advice(self.c_is_byte, 1),
        )
        idx, idx_p = Advice(self.c_index), Advice(self.c_index, -1)
        ln, ln_p = Advice(self.c_length), Advice(self.c_length, -1)
        val = Advice(self.c_value)
        ic = Advice(self.c_is_code)
        pdl, pdl_p = Advice(self.c_pdl), Advice(self.c_pdl, -1)
        inv = Advice(self.c_inv_pdl)
        psz = Advice(self.c_push_size)
        rlc, rlc_p = Advice(self.c_rlc), Advice(self.c_rlc, -1)

        if self.has_hash_binding:
            ipad = Advice(self.c_is_pad)
            ipad_p = Advice(self.c_is_pad, -1)
            ipad_n = Advice(self.c_is_pad, 1)
            not_pad = 1 - ipad
        else:
            ipad = ipad_p = ipad_n = None
            not_pad = 1

        cs.create_gate("is_byte bool", q * ib * (ib - 1))
        cs.create_gate("is_code bool", q * ic * (ic - 1))
        cs.create_gate("header index 0", q * (1 - ib) * not_pad * idx)
        cs.create_gate(
            "header value is length", q * (1 - ib) * not_pad * (val - ln)
        )
        cs.create_gate("first byte index 0", q * ib * (1 - ib_p) * idx)
        cs.create_gate(
            "index increments", q * ib * ib_p * (idx - idx_p - 1)
        )
        cs.create_gate("length propagates", q * ib * (ln - ln_p))
        # is_code: first byte row => 1; else is_zero(prev pdl)
        cs.create_gate("first byte is code", q * ib * (1 - ib_p) * (ic - 1))
        cs.create_gate(
            "is_code def", q * ib * ib_p * (ic - (1 - pdl_p * inv))
        )
        cs.create_gate("is_code kill", q * ib * ib_p * ic * pdl_p)
        # push_data_left evolution
        cs.create_gate("pdl when code", q * ib * ic * (pdl - psz))
        cs.create_gate(
            "pdl when data", q * ib * ib_p * (1 - ic) * (pdl - pdl_p + 1)
        )
        # end-of-bytecode: last byte row binds length
        cs.create_gate(
            "length binds", q * ib * (1 - ib_n) * (idx + 1 - ln)
        )
        # byte RLC accumulator (phase 1)
        cs.create_gate("rlc first", q * ib * (1 - ib_p) * (rlc - val))
        cs.create_gate(
            "rlc step", q * ib * ib_p * (rlc - rlc_p * self.r - val)
        )
        # (value, push_size) in push table; also range-checks the byte.
        cs.lookup_logup(
            "push table",
            [[ib * val, ib * psz]],
            [Fixed(self.tbl_byte), Fixed(self.tbl_push)],
        )
        if self.has_hash_binding:
            # pad10*1 rows after the code bytes: the KeccakTable's
            # input_rlc covers the PADDED message (padding is injective,
            # so binding the padded stream binds the code).  One gate
            # pins the whole pad pattern: first pad byte contributes
            # 0x01, last contributes 0x80 (both on a single-row pad).
            cs.create_gate("is_pad bool", q * ipad * (ipad - 1))
            cs.create_gate("pad not byte", q * ipad * ib)
            cs.create_gate(
                "pad pattern",
                q * ipad * (val - (1 - ipad_p) - 128 * (1 - ipad_n)),
            )
            cs.create_gate(
                "pad rlc step", q * ipad * (rlc - rlc_p * self.r - val)
            )
            # last pad row: (1, padded-code RLC, hash RLC) must be an
            # enabled KeccakTable row
            g_last = q * ipad * (1 - ipad_n)
            cs.lookup_logup(
                "code hash keccak",
                [[g_last, g_last * rlc, g_last * Advice(self.c_hash)]],
                keccak_table,
            )
        # hash propagates across each bytecode's byte rows (the EVM
        # circuit's opcode binding reads (hash, index) pairs, so every
        # byte row must carry its bytecode's hash, not just the last),
        # and across the pad rows so the keccak lookup at the LAST pad
        # row pins the whole chain
        hsh, hsh_p = Advice(self.c_hash), Advice(self.c_hash, -1)
        cs.create_gate("hash propagates", q * ib * ib_p * (hsh - hsh_p))
        if self.has_hash_binding:
            cs.create_gate(
                "hash propagates pad", q * ipad * (hsh - hsh_p)
            )

    def bytecode_table_exprs(self):
        """BytecodeTable for cross-circuit lookups (reference
        `table.rs:1146` BytecodeTable): (is_enabled, code_hash_rlc, index,
        value, is_code) — all gated by the byte-row flag so disabled rows
        form the all-zero tuple logUp gating requires."""
        q = Fixed(self.q_en)
        ib = Advice(self.c_is_byte)
        g = q * ib
        return [
            g,
            g * Advice(self.c_hash),
            g * Advice(self.c_index),
            g * Advice(self.c_value),
            g * Advice(self.c_is_code),
        ]

    def bytecode_len_exprs(self):
        """(is_header, code_hash_rlc, length) — the header row is the row
        immediately before a bytecode's first byte row (reference
        BytecodeFieldTag::Header, `table.rs:1146`); padding and keccak-pad
        rows never precede a byte row, so the rotation flag is exact."""
        q = Fixed(self.q_en)
        ib = Advice(self.c_is_byte)
        g = q * (1 - ib) * Advice(self.c_is_byte, 1)
        return [g, g * Advice(self.c_hash), g * Advice(self.c_length)]

    # ------------------------------------------------------------------
    def _pad_len(self, code_len: int) -> int:
        return 136 - (code_len % 136)

    def _target(self, n: int) -> int:
        t = self.params.target_rows or usable_rows(n)
        extra = (
            sum(self._pad_len(len(bc)) for bc in self.bytecodes)
            if getattr(self, "has_hash_binding", False) else 0
        )
        need = sum(1 + len(bc) for bc in self.bytecodes) + extra
        assert need <= t <= usable_rows(n), (need, t)
        return t

    def fixed_columns(self, n: int):
        assert n >= 256, "domain must fit the 256-row push table"
        t = self._target(n)
        mont = F.mont_from_ints
        q = [1 if i < t else 0 for i in range(n)]
        tb = [i if i < 256 else 0 for i in range(n)]
        tp = [push_size_of(i) if i < 256 else 0 for i in range(n)]
        return {
            self.q_en: mont(q),
            self.tbl_byte: mont(tb),
            self.tbl_push: mont(tp),
        }

    def _rows(self, n: int):
        """(is_byte, index, length, value, is_code, pdl, inv_pdl,
        push_size, is_pad)"""
        binding = getattr(self, "has_hash_binding", False)
        rows = []
        for bc in self.bytecodes:
            code = bc.to_bytes()
            marks = bc.is_code_marks()
            rows.append((0, 0, len(code), len(code), 0, 0, 0, 0, 0))
            pdl = 0
            for i, b in enumerate(code):
                is_code = int(marks[i])
                prev_pdl = pdl
                psz = push_size_of(b)
                pdl = psz if is_code else prev_pdl - 1
                inv = pow(prev_pdl, -1, R) if (i > 0 and prev_pdl) else 0
                rows.append((1, i, len(code), b, is_code, pdl, inv, psz, 0))
            if binding:
                np_ = self._pad_len(len(code))
                for j in range(np_):
                    v = (1 if j == 0 else 0) + (128 if j == np_ - 1 else 0)
                    rows.append((0, 0, 0, v, 0, 0, 0, 0, 1))
        t = self._target(n)
        while len(rows) < t:
            rows.append((0, 0, 0, 0, 0, 0, 0, 0, 0))
        return rows

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        rows = self._rows(n)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        if phase == 0:
            cols = {}
            for ci, j in (
                (self.c_is_byte, 0), (self.c_index, 1), (self.c_length, 2),
                (self.c_value, 3), (self.c_is_code, 4), (self.c_pdl, 5),
                (self.c_inv_pdl, 6), (self.c_push_size, 7),
            ):
                cols[ci] = mont([r[j] for r in rows])
            if self.has_hash_binding:
                cols[self.c_is_pad] = mont([r[8] for r in rows])
            return cols
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        rlcs, acc = [], 0
        for row in rows:
            if row[0] == 1 or row[8] == 1:  # byte or pad row: accumulate
                acc = (acc * r_int + row[3]) % R
                rlcs.append(acc)
            else:
                acc = 0
                rlcs.append(0)
        out = {self.c_rlc: mont(rlcs)}
        from ..crypto.keccak import keccak256

        hashes = []
        for bc in self.bytecodes:
            digest = keccak256(bc.to_bytes())
            hr = sum(
                b * pow(r_int, i, R) for i, b in enumerate(digest)
            ) % R
            nrows = 1 + len(bc) + (
                self._pad_len(len(bc)) if self.has_hash_binding else 0
            )
            hashes += [hr] * nrows
        hashes += [0] * (len(rows) - len(hashes))
        out[self.c_hash] = mont(hashes)
        return out
