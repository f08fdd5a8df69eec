"""Poseidon circuit (port of zkevm_circuits_tpu/circuits/poseidon.py):
proves Poseidon permutations and fills PoseidonTable.

Equivalent of the reference's `zkevm-circuits/src/poseidon_circuit.rs`
(SURVEY.md §2.2 "Poseidon"), which wraps the external `poseidon-circuit`
(hash-circuit) to prove the hashes consumed by the bytecode circuit
(poseidon-codehash) and the MPT circuit.

Layout: the domain is tiled into fixed-geometry permutation
blocks of ``ROWS_PER_BLOCK = 66`` rows (65 round rows + 1 output row).
Row r -> r+1 carries one Poseidon round: full rounds are degree-5 gates
``s'_i = Σ_j MDS[i][j] (s_j + rc_j)^5``, partial rounds apply the quintic
S-box to lane 0 only.  Round constants / round-kind flags / block
boundaries are FIXED columns with a static repeating pattern — the
geometry does not depend on the witness, so proofs stay variadic-safe.
Unused blocks hold the permutation of the all-zero state (a valid
witness), not disabled rows.

Exposed ``poseidon_table`` (reference table.rs:907 `PoseidonTable`):
tuple (enable, domain, input0, input1, output) gated on each block's
output row; inputs are carried to the output row by continuity columns.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..crypto.poseidon import ALPHA, R_FULL, T, round_states, spec
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed

F = fr()

ROWS_PER_BLOCK = 66  # 65 rounds + output row


@dataclasses.dataclass
class PoseidonEvent:
    """One proven permutation: state (domain, in0, in1) -> out."""

    domain: int
    in0: int
    in1: int


class PoseidonCircuit(Circuit):
    def __init__(self, events: list[PoseidonEvent]):
        self.events = events
        self.sp = spec()

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem):
        sp = self.sp
        self.q_round = cs.fixed_column()  # 1 on the 65 round rows of a block
        self.q_full = cs.fixed_column()  # 1 if that round is a full round
        self.q_first = cs.fixed_column()  # 1 on block row 0
        self.q_out = cs.fixed_column()  # 1 on block row 65
        self.f_rc = [cs.fixed_column() for _ in range(T)]

        self.c_s = [cs.advice_column() for _ in range(T)]
        # block inputs carried to the output row for the lookup tuple
        self.c_dom = cs.advice_column()
        self.c_in0 = cs.advice_column()
        self.c_in1 = cs.advice_column()

        q = Fixed(self.q_round)
        qf = Fixed(self.q_full)
        q1 = Fixed(self.q_first)
        qo = Fixed(self.q_out)
        rc = [Fixed(c) for c in self.f_rc]
        s = [Advice(c) for c in self.c_s]
        s_n = [Advice(c, 1) for c in self.c_s]

        def pow5(e):
            sq = e * e
            return sq * sq * e

        for i in range(T):
            full_i = None
            part_i = None
            for j in range(T):
                m = int(self.sp.mds[i][j])
                tf = pow5(s[j] + rc[j]) * m
                tp = (pow5(s[j] + rc[j]) if j == 0 else (s[j] + rc[j])) * m
                full_i = tf if full_i is None else full_i + tf
                part_i = tp if part_i is None else part_i + tp
            cs.create_gate(f"poseidon full round s{i}", q * qf * (s_n[i] - full_i))
            cs.create_gate(
                f"poseidon partial round s{i}", q * (1 - qf) * (s_n[i] - part_i)
            )

        # input carry columns: anchored at block row 0, constant over the block
        dom, in0, in1 = Advice(self.c_dom), Advice(self.c_in0), Advice(self.c_in1)
        cs.create_gate("poseidon dom anchor", q1 * (dom - s[0]))
        cs.create_gate("poseidon in0 anchor", q1 * (in0 - s[1]))
        cs.create_gate("poseidon in1 anchor", q1 * (in1 - s[2]))
        for name, col in (("dom", self.c_dom), ("in0", self.c_in0),
                          ("in1", self.c_in1)):
            cs.create_gate(
                f"poseidon {name} carry", q * (Advice(col, 1) - Advice(col))
            )

        qo_g = qo
        self.poseidon_table = [
            qo_g, qo_g * dom, qo_g * in0, qo_g * in1, qo_g * s[0],
        ]

    # ------------------------------------------------------------------
    def n_blocks(self, n: int) -> int:
        return usable_rows(n) // ROWS_PER_BLOCK

    def fixed_columns(self, n: int):
        sp = self.sp
        nb = self.n_blocks(n)
        assert len(self.events) <= nb, (
            f"{len(self.events)} poseidon events > {nb} blocks at n={n}"
        )
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        q_round, q_full, q_first, q_out = [], [], [], []
        rcs = [[] for _ in range(T)]
        for _ in range(nb):
            for r in range(ROWS_PER_BLOCK):
                is_round = r < sp.n_rounds
                q_round.append(int(is_round))
                q_full.append(int(is_round and sp.is_full_round(r)))
                q_first.append(int(r == 0))
                q_out.append(int(r == sp.n_rounds))
                for i in range(T):
                    rcs[i].append(sp.rc[r][i] if is_round else 0)
        out = {
            self.q_round: mont(q_round),
            self.q_full: mont(q_full),
            self.q_first: mont(q_first),
            self.q_out: mont(q_out),
        }
        for i in range(T):
            out[self.f_rc[i]] = mont(rcs[i])
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        if phase != 0:
            return {}
        nb = self.n_blocks(n)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        cols_s = [[] for _ in range(T)]
        dom, in0, in1 = [], [], []
        pad = PoseidonEvent(domain=0, in0=0, in1=0)
        for b in range(nb):
            ev = self.events[b] if b < len(self.events) else pad
            states = round_states([ev.domain, ev.in0, ev.in1], self.sp)
            assert len(states) == ROWS_PER_BLOCK
            for st in states:
                for i in range(T):
                    cols_s[i].append(st[i])
                dom.append(ev.domain)
                in0.append(ev.in0)
                in1.append(ev.in1)
        out = {self.c_dom: mont(dom), self.c_in0: mont(in0), self.c_in1: mont(in1)}
        for i in range(T):
            out[self.c_s[i]] = mont(cols_s[i])
        return out
