"""MockProver: row-wise constraint checker without KZG (port of
zkevm_circuits_tpu/plonk/mock.py).

The reference's central testing device (halo2 `MockProver`, used by every
circuit test, SURVEY.md §4.1-4.4).  It evaluates every gate columnwise over
the full witness with the host big-int evaluator (`IntEvaluator`), checks
lookup membership by comparing row tuples, and checks copy constraints by
direct value equality.  Like `verify`, it is a host-side checker: the
witness stays in numpy arrays and nothing runs on the card.

Mock challenges are fixed deterministic values (the reference uses
MockChallenges with mock randomness 0x100, SURVEY.md A.13); they are CPU
tensors, so circuits that read them back (`F.from_mont`) stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.field import fr
from .circuit import Circuit, ConstraintSystem, assemble_fixed, usable_rows
from .expression import IntEvaluator, _host

F = fr()

MOCK_CHALLENGE_BASE = 0x100


def mock_challenges(cs: ConstraintSystem) -> dict:
    """Deterministic distinct challenge values (Montgomery form, CPU)."""
    out = {}
    for i, _phase in enumerate(cs.challenge_phases):
        v = pow(MOCK_CHALLENGE_BASE + i, 3, F.modulus)  # arbitrary, distinct
        out[i] = torch.as_tensor(F.from_int(v * F.R % F.modulus))
    return out


class MockProver:
    def __init__(self, k: int, circuit: Circuit, instances: list[list[int]] | None = None):
        self.k = k
        self.n = 1 << k
        self.circuit = circuit
        self.cs = ConstraintSystem()
        circuit.configure(self.cs)
        self.instances = instances or [[] for _ in range(self.cs.num_instance)]

        n = self.n
        self.fixed = np.asarray(assemble_fixed(circuit, self.cs, n))
        assert self.fixed.shape == (max(self.cs.num_fixed, 1), n, 32) or self.cs.num_fixed == 0

        # instance columns -> Montgomery arrays padded to n
        inst_cols = []
        for col_vals in self.instances:
            vals = [v * F.R % F.modulus for v in col_vals] + [0] * (n - len(col_vals))
            inst_cols.append(F.from_ints(vals))
        if not inst_cols:
            inst_cols = [np.zeros((n, 32), np.uint8)]
        self.instance = np.stack(inst_cols)

        self.challenges = mock_challenges(self.cs)
        adv = np.zeros((max(self.cs.num_advice, 1), n, 32), np.uint8)
        for phase in range(self.cs.num_phases):
            cols = circuit.synthesize(phase, n, self.challenges, self.instances)
            for ci, arr in cols.items():
                assert self.cs.advice_phases[ci] == phase
                adv[ci] = _host(arr)
        self.advice = adv

    def _evaluator(self):
        return IntEvaluator(
            {"fixed": self.fixed, "advice": self.advice, "instance": self.instance},
            self.challenges,
        )

    def verify(self) -> list[str]:
        """Returns a list of human-readable failures; [] means satisfied."""
        failures: list[str] = []
        n, u = self.n, usable_rows(self.n)
        ev = self._evaluator()

        def rows_of(exprs):
            """Evaluate a tuple of expressions -> set of per-row int tuples
            over the usable region (scalars broadcast)."""
            cols = []
            for e in exprs:
                v = ev.eval(e)
                if isinstance(v, int):
                    cols.append([v] * u)
                else:
                    cols.append(v[:u].tolist())
            return set(zip(*cols))

        # gates must vanish on every row (selectors gate them off elsewhere;
        # blinding tail rows are exempt as in halo2)
        for gate in self.cs.gates:
            for pi, poly in enumerate(gate.polys):
                vals = ev.eval(poly)
                if isinstance(vals, int):
                    if vals != 0:
                        failures.append(
                            f"gate '{gate.name}' poly {pi} is the nonzero "
                            f"constant {vals}"
                        )
                    continue
                nz = vals[:u] != 0
                if nz.any():
                    rows = np.nonzero(nz)[0][:5].tolist()
                    failures.append(
                        f"gate '{gate.name}' poly {pi} not satisfied at rows {rows}"
                    )

        # lookups: every input row tuple must appear among table row tuples
        for lk in self.cs.lookups:
            missing = rows_of(lk.inputs) - rows_of(lk.tables)
            if missing:
                failures.append(
                    f"lookup '{lk.name}': {len(missing)} input row value(s) not in table"
                )

        # logup lookups: every input tuple must appear in the table multiset
        for lg in self.cs.logups:
            tab_rows = rows_of(lg.table)
            for ti, tup in enumerate(lg.inputs):
                missing = rows_of(tup) - tab_rows
                if missing:
                    failures.append(
                        f"logup '{lg.name}' input {ti}: "
                        f"{len(missing)} value(s) not in table"
                    )

        # copy constraints
        tabs = {"fixed": self.fixed, "advice": self.advice, "instance": self.instance}
        for a, b in self.circuit.copy_constraints(n):
            va = tabs[a.kind][a.col, a.row]
            vb = tabs[b.kind][b.col, b.row]
            if not (va == vb).all():
                failures.append(
                    f"copy constraint violated: {a} != {b}"
                )
        return failures

    def assert_satisfied(self):
        failures = self.verify()
        assert not failures, "\n".join(failures)

