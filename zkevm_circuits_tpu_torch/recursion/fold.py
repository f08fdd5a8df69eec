"""In-circuit KZG-accumulator aggregation (layer-3 fold).

Reference: the AggregationCircuit folds up to 15 chunk snarks' KZG
accumulators with in-circuit randomness so the final verifier runs ONE
pairing (aggregator/src/aggregation/circuit.rs:40, core.rs
`extract_proof_and_instances_with_pairing_check`).  Round-2 folded
host-side (recursion/aggregation.py `fold_and_verify_claims`); this
module moves the fold IN-CIRCUIT:

  AggregationFoldCircuit(accs) proves, for M accumulator pairs
  (LHS_i, W2_i) taken as public input limbs:

    c  = Poseidon(all accumulator limbs)       (in-circuit sponge rows)
    L  = sum_i c^i * LHS_i                     (EcMsm walk over MulMod)
    W  = sum_i c^i * W2_i                      (second EcMsm program)

  exposing (L, W) — valid iff e(W, [s]_2) * e(-L, [1]_2) == 1
  (`verify_fold`), which holds for random c iff every folded pair is
  individually valid (standard KZG accumulation).

The chunk pairs come from CompressionLayerCircuit instances
(recursion/layer.py); their snarks are verified separately (the
reference's `check_chunk_proofs` shape) — verifying THOSE snarks inside
this circuit is the remaining aggregation step (documented gap: the
layer-1 circuit's column count puts its in-circuit verification at
k≥20, the production scale).

Port of zkevm_circuits_tpu/recursion/fold.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Cell, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..plonk.keygen import ceil_log2
from ..circuits.mulmod import MulModCircuit, MulModParams
from ..circuits.poseidon import PoseidonCircuit
from .compression import TapeCircuit, _SymSponge
from .ecmsm import EcMsmCircuit, EcMsmParams, EcMsmProgram, EV_ROWS
from .tape import Tape

F = fr()
L128 = 1 << 128
M128 = L128 - 1


def _limbs(pt):
    x_, y_ = pt
    return (x_ & M128, x_ >> 128, y_ & M128, y_ >> 128)


def build_fold_tape(accs: list[tuple]):
    """accs: [(lhs_point, w2_point)] — returns (tape, perm_rows,
    power_positions): the sponge over all limbs, the challenge, and the
    exposed positions of c^1..c^{M-1} (c^0 = 1 is pinned const)."""
    t = Tape()
    sponge = _SymSponge(t)
    syms = []
    for lhs, w2 in accs:
        for pt in (lhs, w2):
            for v in _limbs(pt):
                s = t.input(v)
                t.expose(s)
                syms.append(s)
    sponge.absorb(*syms)
    c = sponge.squeeze()
    n_limbs = len(t.exposed)
    powers = []
    cur = c
    for i in range(1, len(accs)):
        t.expose(cur)
        powers.append(n_limbs + i - 1)
        cur = t.mul(cur, c)
    return t, sponge.perm_rows, powers


class AggregationFoldCircuit(TapeCircuit):
    """Fold M accumulator pairs with in-circuit randomness.

    Instance: [8M accumulator limbs ‖ c^1..c^{M-1} ‖ L limbs ‖ W limbs].
    """

    def __init__(self, accs: list[tuple]):
        assert len(accs) >= 1
        self.accs = list(accs)
        tape, perm_rows, self._power_pos = build_fold_tape(accs)
        super().__init__(tape, perm_rows)
        m = len(accs)
        c_val = (tape.values[tape.exposed[self._power_pos[0]]]
                 if m > 1 else 1)
        scalars = [pow(c_val, i, R) for i in range(m)]
        self.prog_l = EcMsmProgram(
            scalars=list(scalars), points=[a[0] for a in accs]
        )
        self.prog_w = EcMsmProgram(
            scalars=list(scalars), points=[a[1] for a in accs]
        )
        self.folded = (self.prog_l.result(), self.prog_w.result())
        self._mm_events = (self.prog_l.mulmod_events()
                           + self.prog_w.mulmod_events())
        self.n_exposed = len(tape.exposed)

    # ------------------------------------------------------------------
    def instances(self):
        tv = self.tape.values
        out = [tv[i] for i in self.tape.exposed]
        for pt in self.folded:
            out.extend(_limbs(pt))
        return [out]

    def min_k(self) -> int:
        rows = max(
            len(self.tape.ops),
            len(self._mm_events) + 1,
            self.prog_l.rows + self.prog_w.rows,
            66 * (len(self.perm_rows) + 1),
            len(self.instances()[0]),
            256,
        )
        return ceil_log2(rows + 12)

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem):
        self.mulmod = MulModCircuit(
            self._mm_events,
            MulModParams(target_rows=len(self._mm_events) + 1),
        )
        self.mulmod.configure(cs)
        self.poseidon = PoseidonCircuit(self.poseidon_events())
        self.poseidon.configure(cs)
        TapeCircuit.configure(
            self, cs, poseidon_table=self.poseidon.poseidon_table
        )
        self.ecmsm = EcMsmCircuit(
            [self.prog_l, self.prog_w], EcMsmParams()
        )
        self.ecmsm.configure(cs, mulmod_table=self.mulmod.mulmod_table)
        for name in ("s", "px", "py", "f1_rx", "f1_ry"):
            for col in self.ecmsm.pairs[name]:
                cs.enable_equality("advice", col)
        # scalar glue: c^i split into the walks' 128-bit halves; c^0 = 1
        # pinned (reference accumulation powers, aggregator/src/core.rs)
        self.q_glue = cs.fixed_column()
        self.f_cst = cs.fixed_column()
        self.c_cstv = cs.fixed_column()
        self.g_src = cs.advice_column()
        self.g_lo = cs.advice_column()
        self.g_hi = cs.advice_column()
        for col in (self.g_src, self.g_lo, self.g_hi):
            cs.enable_equality("advice", col)
        qg = Fixed(self.q_glue)
        fc_ = Fixed(self.f_cst)
        rec = Advice(self.g_lo) + L128 * Advice(self.g_hi)
        cs.create_gate(
            "fold glue split",
            qg * ((1 - fc_) * (rec - Advice(self.g_src))
                  + fc_ * (rec - Fixed(self.c_cstv))),
        )

    # ------------------------------------------------------------------
    def _glue_rows(self):
        """(prog_idx, term, kind, meta) per glue row; kind 'const' pins
        c^0 = 1, 'inst' copies c^i from its exposed tape cell."""
        rows = []
        m = len(self.accs)
        for pi in range(2):
            for i in range(m):
                if i == 0:
                    rows.append((pi, i, "const", 1))
                else:
                    rows.append((pi, i, "inst", self._power_pos[i - 1]))
        return rows

    def copy_constraints(self, n):
        out = list(TapeCircuit.copy_constraints(self, n))
        tape = self.tape

        def tape_cell(pos: int) -> Cell:
            return Cell("advice", self.c_val, tape.exposed[pos])

        for gi, (pi, term, kind, meta) in enumerate(self._glue_rows()):
            if kind == "inst":
                out.append((Cell("advice", self.g_src, gi),
                            tape_cell(meta)))
            lo_c, hi_c = self.ecmsm.scalar_cells(pi, term)
            out.append((Cell("advice", self.g_lo, gi), lo_c))
            out.append((Cell("advice", self.g_hi, gi), hi_c))
        # accumulator point limbs ride copies from the tape exposure
        for i in range(len(self.accs)):
            for pi, off in ((0, 0), (1, 4)):  # prog_l uses LHS, prog_w W2
                (xl, xh), (yl, yh) = self.ecmsm.point_cells(pi, i)
                for j, cell in enumerate((xl, xh, yl, yh)):
                    out.append((cell, tape_cell(8 * i + off + j)))
        # folded results become the instance tail
        for pi, off in ((0, 0), (1, 4)):
            (rxl, rxh), (ryl, ryh) = self.ecmsm.result_cells(pi)
            for j, cell in enumerate((rxl, rxh, ryl, ryh)):
                out.append((Cell("instance", self.inst,
                                 self.n_exposed + off + j), cell))
        return out

    # ------------------------------------------------------------------
    def fixed_columns(self, n):
        cols = {}
        cols.update(self.mulmod.fixed_columns(n))
        cols.update(self.poseidon.fixed_columns(n))
        cols.update(TapeCircuit.fixed_columns(self, n))
        cols.update(self.ecmsm.fixed_columns(n))
        rows = self._glue_rows()
        assert len(rows) <= usable_rows(n)
        mont = lambda vals: F.from_ints(
            [int(x) % R * F.R % R for x in vals] + [0] * (n - len(vals))
        )
        cols[self.q_glue] = mont([1] * len(rows))
        cols[self.f_cst] = mont(
            [int(k == "const") for _, _, k, _ in rows]
        )
        cols[self.c_cstv] = mont(
            [m if k == "const" else 0 for _, _, k, m in rows]
        )
        return cols

    def synthesize(self, phase, n, challenges, instances):
        cols = {}
        cols.update(self.mulmod.synthesize(phase, n, challenges, instances))
        cols.update(self.poseidon.synthesize(phase, n, challenges,
                                             instances))
        cols.update(TapeCircuit.synthesize(self, phase, n, challenges,
                                           instances))
        cols.update(self.ecmsm.synthesize(phase, n, challenges, instances))
        if phase == 0:
            mont = lambda vals: F.from_ints(
                [int(x) % R * F.R % R for x in vals]
                + [0] * (n - len(vals))
            )
            srcs, los, his = [], [], []
            tv = self.tape.values
            for pi, term, kind, meta in self._glue_rows():
                s_val = self.ecmsm.programs[pi].scalars[term]
                srcs.append(tv[self.tape.exposed[meta]]
                            if kind == "inst" else 0)
                los.append(s_val & M128)
                his.append(s_val >> 128)
            cols[self.g_src] = mont(srcs)
            cols[self.g_lo] = mont(los)
            cols[self.g_hi] = mont(his)
        return cols


def verify_fold(vk, instance_values: list[int], m: int) -> bool:
    """ONE pairing over the folded accumulator exposed by an
    AggregationFoldCircuit instance (the reference's final EVM-verifier
    check, prover/src/common/prover/evm.rs:11-46)."""
    from ..crypto import pairing as pr
    from ..crypto.params import FQ_MODULUS

    vals = instance_values
    lx = vals[-8] + (vals[-7] << 128)
    ly = vals[-6] + (vals[-5] << 128)
    wx = vals[-4] + (vals[-3] << 128)
    wy = vals[-2] + (vals[-1] << 128)
    lhs = None if (lx | ly) == 0 else (lx, ly)
    w = None if (wx | wy) == 0 else (wx, wy)
    neg = lambda p: None if p is None else (p[0], (-p[1]) % FQ_MODULUS)
    return pr.pairing_product_is_one([(w, vk.s_g2), (neg(lhs), vk.g2)])
