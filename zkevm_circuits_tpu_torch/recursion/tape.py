"""Arithmetic tape — the in-circuit scalar VM behind the recursion layer.

The reference's snark-verifier re-implements the PLONK verifier's scalar
math with halo2 gates through a "Loader" abstraction
(aggregator/src/aggregation/circuit.rs:12-25).  The analogue here is
a TAPE: the verifier algorithm runs ONCE over symbolic handles, recording
one row per field operation (add / mul / inv / const / input); the
resulting fixed program becomes a uniform columnar circuit
(recursion/compression.py) where

    row i:  c[i] = a_op op b_op

with operands wired to earlier rows by plonk copy constraints — the
permutation argument does all routing, so gates stay degree-2 and fully
vectorized (one Evaluator pass over the whole column; no per-gadget
regions).  Concrete values are computed during the same walk, so witness
generation is a byproduct of recording.

Port of zkevm_circuits_tpu/recursion/tape.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.params import FR_MODULUS as R

OP_INPUT = 0  # c = witnessed input (proof element / instance / limb)
OP_CONST = 1  # c = program constant (fixed column)
OP_ADD = 2    # c = a + b
OP_MUL = 3    # c = a * b
OP_INV = 4    # c * a = 1  (a must be nonzero; honest witnesses are)


@dataclasses.dataclass(frozen=True)
class Sym:
    """Handle to a tape row."""

    idx: int


class Tape:
    def __init__(self):
        self.ops: list[tuple[int, int, int, int]] = []  # (op, ia, ib, const)
        self.values: list[int] = []  # concrete value per row
        self.exposed: list[int] = []  # row indices copied to the instance

    def _push(self, op, ia, ib, const, value) -> Sym:
        self.ops.append((op, ia, ib, const))
        self.values.append(value % R)
        return Sym(len(self.ops) - 1)

    # -- row constructors ---------------------------------------------------
    def input(self, value: int) -> Sym:
        return self._push(OP_INPUT, 0, 0, 0, value)

    def const(self, value: int) -> Sym:
        return self._push(OP_CONST, 0, 0, value % R, value)

    def add(self, x: Sym, y: Sym) -> Sym:
        v = (self.values[x.idx] + self.values[y.idx]) % R
        return self._push(OP_ADD, x.idx, y.idx, 0, v)

    def mul(self, x: Sym, y: Sym) -> Sym:
        v = self.values[x.idx] * self.values[y.idx] % R
        return self._push(OP_MUL, x.idx, y.idx, 0, v)

    def inv(self, x: Sym) -> Sym:
        a = self.values[x.idx]
        v = pow(a, -1, R) if a else 0  # a = 0 fails the gate, not witness gen
        return self._push(OP_INV, x.idx, 0, 0, v)

    # -- convenience ----------------------------------------------------------
    def sub(self, x: Sym, y: Sym) -> Sym:
        return self.add(x, self.mul(self.const(R - 1), y))

    def addc(self, x: Sym, c: int) -> Sym:
        return self.add(x, self.const(c))

    def mulc(self, x: Sym, c: int) -> Sym:
        return self.mul(x, self.const(c))

    def pow(self, x: Sym, e: int) -> Sym:
        """Square-and-multiply chain (e is a program constant)."""
        assert e >= 0
        if e == 0:
            return self.const(1)
        acc = None
        base = x
        while e:
            if e & 1:
                acc = base if acc is None else self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc

    def lincomb(self, terms: list[tuple[Sym, int]]) -> Sym:
        acc = None
        for s, c in terms:
            t = s if c == 1 else self.mulc(s, c)
            acc = t if acc is None else self.add(acc, t)
        return acc if acc is not None else self.const(0)

    def expose(self, s: Sym):
        self.exposed.append(s.idx)

    def value(self, s: Sym) -> int:
        return self.values[s.idx]
