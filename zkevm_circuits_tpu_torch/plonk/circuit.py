"""Constraint system + circuit protocol (port of
zkevm_circuits_tpu/plonk/circuit.py).

Plays the role of halo2's `ConstraintSystem`/`Circuit` pair that every
reference sub-circuit is written against (`SubCircuitConfig::new` calls
`meta.create_gate`/`lookup_any`, reference zkevm-circuits/src/util.rs:208-248,
SURVEY.md §2.2) — but witness assignment is COLUMNAR: a circuit hands back
whole (n, 32) Montgomery digit arrays per column instead of assigning cells
row by row through a layouter.

Phases: advice columns and challenges carry a phase index (0..2), mirroring
the reference's 3-phase challenge structure evm_word/keccak_input/
lookup_input (zkevm-circuits/src/util.rs:93-106, SURVEY.md A.13).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..crypto.field import fr
from .expression import Challenge, Expression

F = fr()

# Unusable tail rows (blinding + last-row gap), halo2-style: the last
# `BLINDING_FACTORS + 1` rows of every column are reserved.  The reference
# pins NUM_BLINDING_ROWS assumptions in its tests (SURVEY.md A.13).
BLINDING_FACTORS = 5


@dataclasses.dataclass
class Gate:
    name: str
    polys: list[Expression]


@dataclasses.dataclass
class Lookup:
    name: str
    inputs: list[Expression]
    tables: list[Expression]


@dataclasses.dataclass
class LogupLookup:
    """log-derivative lookup: every input TUPLE must appear in the table
    tuple's multiset.  One argument serves many inputs against one table —
    the TPU-first replacement for stacks of halo2 permuted-column lookups
    (no sorting, no permuted commits; witness = batch inverses + one
    running sum, both cheap device scans)."""

    name: str
    inputs: list[list[Expression]]  # each entry is one input tuple
    table: list[Expression]


@dataclasses.dataclass(frozen=True)
class Cell:
    kind: str  # 'advice' | 'fixed' | 'instance'
    col: int
    row: int


class ConstraintSystem:
    def __init__(self):
        self.num_fixed = 0
        self.num_instance = 0
        self.advice_phases: list[int] = []
        self.challenge_phases: list[int] = []
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        self.logups: list[LogupLookup] = []
        # columns participating in the permutation (equality) argument
        self.perm_columns: list[tuple[str, int]] = []

    # -- allocation ---------------------------------------------------------
    def fixed_column(self) -> int:
        self.num_fixed += 1
        return self.num_fixed - 1

    def advice_column(self, phase: int = 0) -> int:
        self.advice_phases.append(phase)
        return len(self.advice_phases) - 1

    def instance_column(self) -> int:
        self.num_instance += 1
        return self.num_instance - 1

    def challenge(self, phase: int) -> Challenge:
        """Challenge available AFTER committing phase `phase` advice."""
        self.challenge_phases.append(phase)
        return Challenge(len(self.challenge_phases) - 1)

    @property
    def num_advice(self) -> int:
        return len(self.advice_phases)

    @property
    def num_phases(self) -> int:
        return max([0, *self.advice_phases, *(p + 1 for p in self.challenge_phases)]) + 1

    # -- constraints ----------------------------------------------------------
    def create_gate(self, name: str, *polys: Expression):
        self.gates.append(Gate(name, list(polys)))

    def lookup(self, name: str, pairs: Sequence[tuple[Expression, Expression]]):
        self.lookups.append(
            Lookup(name, [p[0] for p in pairs], [p[1] for p in pairs])
        )

    def lookup_logup(
        self,
        name: str,
        inputs: Sequence[Sequence[Expression]],
        table: Sequence[Expression],
    ):
        """Declare a multi-input log-derivative lookup (see LogupLookup)."""
        self.logups.append(
            LogupLookup(name, [list(t) for t in inputs], list(table))
        )

    def enable_equality(self, kind: str, col: int):
        if (kind, col) not in self.perm_columns:
            self.perm_columns.append((kind, col))

    # -- analysis ---------------------------------------------------------------
    def max_gate_degree(self) -> int:
        d = 1
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        # lookup/permutation arguments contribute degree ~3 constraints on
        # top of input expression degrees
        for lk in self.lookups:
            for e in lk.inputs + lk.tables:
                d = max(d, e.degree() + 2)
        for lg in self.logups:
            for tup in lg.inputs:
                for e in tup:
                    d = max(d, e.degree() + 2)
            for e in lg.table:
                d = max(d, e.degree() + 2)
        if self.perm_columns:
            d = max(d, len(self.perm_columns) + 2)
        return d

    def all_queries(self) -> set:
        qs: set = set()
        for g in self.gates:
            for p in g.polys:
                p.queries(qs)
        for lk in self.lookups:
            for e in lk.inputs + lk.tables:
                e.queries(qs)
        for lg in self.logups:
            for tup in lg.inputs:
                for e in tup:
                    e.queries(qs)
            for e in lg.table:
                e.queries(qs)
        return qs


class Circuit:
    """Circuit protocol (columnar).  Subclasses implement:

    * configure(cs) -> None: declare columns/gates/lookups (static shape).
    * fixed_columns(n) -> (num_fixed, n, 32) uint8 Montgomery arrays.
    * copy_constraints(n) -> list[(Cell, Cell)] equality pairs.
    * synthesize(phase, n, challenges, instances) ->
        {col_index: (n, 32) uint8} advice columns whose phase == `phase`.
        Later phases see challenges squeezed after earlier phases.
    """

    def configure(self, cs: ConstraintSystem):
        raise NotImplementedError

    def fixed_columns(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def copy_constraints(self, n: int):
        return []

    def synthesize(self, phase: int, n: int, challenges: dict, instances) -> dict:
        raise NotImplementedError


def usable_rows(n: int) -> int:
    return n - (BLINDING_FACTORS + 1)


def assemble_fixed(circuit: Circuit, cs: ConstraintSystem, n: int):
    """Normalize Circuit.fixed_columns output to a (num_fixed, n, 32)
    numpy array.  Circuits may return either a positional stack (standalone
    layout) or a {column_index: (n, 32)} dict (composed layout)."""
    out = circuit.fixed_columns(n)
    if isinstance(out, dict):
        arr = np.zeros((max(cs.num_fixed, 1), n, 32), np.uint8)
        for ci, col in out.items():
            arr[ci] = np.asarray(col)
        return arr
    return np.asarray(out)
