"""Block circuit — fills the shared BlockTable.

Equivalent of the reference's BlockTable (`zkevm-circuits/src/
table.rs:1309`, assigned from the witness `Block`'s `BlockContext`):
one row per block-context field, consumed by the EVM circuit's
block-context opcode gadgets (TIMESTAMP, NUMBER, COINBASE, GASLIMIT,
CHAINID, BASEFEE, DIFFICULTY/PREVRANDAO), plus a fixed 256-row BlockHash
region (tag=BlockHash, index=block number, value=hash word RLC) consumed
by the BLOCKHASH gadget (reference execution/blockhash.rs looks up
(BlockHash, number) pairs).

Value conventions: raw integers for fields < 2^160 (coinbase address,
timestamp, number, gas limit, chain id, base fee); word RLC for 256-bit
words (difficulty/prevrandao, block hashes).  The PI circuit commits the
same fields into the public-input statement (binding the two is the
documented remaining step, reference pi_circuit block-table copies).

The BlockHash region always spans exactly 256 rows so the fixed columns
(and hence the verifying key) are independent of the block witness:
rows carry the numbers [max(0, cur-256), cur), padded with `cur` itself —
never a valid BLOCKHASH query, since valid queries satisfy number < cur.

Port of zkevm_circuits_tpu/circuits/block.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import enum

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem
from ..plonk.expression import Advice, Fixed
from .state import word_rlc

F = fr()

N_HASH_ROWS = 256


class BlockFieldTag(enum.IntEnum):
    Coinbase = 1
    Timestamp = 2
    Number = 3
    Difficulty = 4  # prevrandao post-merge: a full 256-bit word
    GasLimit = 5
    ChainId = 6
    BaseFee = 7
    BlockHash = 8  # one row per ancestor block (number, hash)


WORD_TAGS = (BlockFieldTag.Difficulty, BlockFieldTag.BlockHash)


class BlockCircuit(Circuit):
    """One row per field + 256 BlockHash rows; `block` is a tracer
    BlockEnv (its `prev_hashes` dict maps ancestor number -> hash)."""

    def __init__(self, block):
        self.block = block

    def configure(self, cs: ConstraintSystem, challenge=None):
        self.q_row = cs.fixed_column()
        self.f_tag = cs.fixed_column()
        self.c_index = cs.advice_column()
        self.c_value = cs.advice_column(phase=1)
        self.r_word = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )
        q = Fixed(self.q_row)
        self.block_table = [
            q, q * Fixed(self.f_tag), q * Advice(self.c_index),
            q * Advice(self.c_value),
        ]

    def _fields(self):
        b = self.block
        return [
            (BlockFieldTag.Coinbase, b.coinbase),
            (BlockFieldTag.Timestamp, b.timestamp),
            (BlockFieldTag.Number, b.number),
            (BlockFieldTag.Difficulty, b.difficulty),
            (BlockFieldTag.GasLimit, b.gas_limit),
            (BlockFieldTag.ChainId, b.chain_id),
            (BlockFieldTag.BaseFee, b.base_fee),
        ]

    def _hash_rows(self):
        """256 (number, hash) pairs; unknown ancestors hash to 0 (the
        tracer's convention) and pad rows carry the never-valid `cur`."""
        cur = self.block.number
        prev = getattr(self.block, "prev_hashes", None) or {}
        nums = list(range(max(0, cur - N_HASH_ROWS), cur))
        rows = [(num, prev.get(num, 0)) for num in nums]
        rows += [(cur, 0)] * (N_HASH_ROWS - len(rows))
        return rows

    def fixed_columns(self, n: int):
        mont = F.mont_from_ints
        nf = len(self._fields())
        total = nf + N_HASH_ROWS
        assert n >= total, f"block table needs {total} rows, domain {n}"
        q = [1 if i < total else 0 for i in range(n)]
        tags = [int(t) for t, _ in self._fields()]
        tags += [int(BlockFieldTag.BlockHash)] * N_HASH_ROWS
        tags += [0] * (n - total)
        return {self.q_row: mont(q), self.f_tag: mont(tags)}

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        import numpy as np

        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        if phase == 0:
            idx = [0] * len(self._fields())
            idx += [num for num, _ in self._hash_rows()]
            return {self.c_index: mont(idx)}
        if phase != 1:
            return {}
        r_chal = challenges[self.r_word.index]
        r_int = F.to_int(F.from_mont(r_chal))
        vals = [
            word_rlc(v, r_int) if t in WORD_TAGS else v % R
            for t, v in self._fields()
        ]
        vals += [word_rlc(h, r_int) for _, h in self._hash_rows()]
        return {self.c_value: mont(vals)}
