"""In-circuit BN254 G1 multi-scalar multiplication over MulMod rows.

The recursion-side replacement for halo2-ecc's non-native EC chips
(reference: the CompressionCircuit/AggregationCircuit verify KZG claims
with in-circuit G1 scalar muls via `snark-verifier`'s halo2-ecc loader,
aggregator/src/compression/circuit.rs:39, aggregation/circuit.rs:40;
halo2-base CRT big-int arithmetic, SURVEY.md §2.3 item 5).  This build
re-uses the Sig circuit's pattern instead (circuits/sig.py): every Fq
operation is ONE row of the shared MulMod circuit (circuits/mulmod.py),
and the EC structure is a fixed-geometry walk whose cells ride logUp
lookups into the MulModTable.

Statement: for each program `EcMsmProgram(scalars, points)` the circuit
proves   result = sum_k scalars[k] * points[k]   on BN254 G1, where

  * each point is proven canonical (x, y < p) and on-curve (y^2 = x^3+3),
  * each scalar mul is a 256-step double-and-add walk with the DUMMY-
    POINT offset trick: acc starts at D (= K_D * G, public known-dlog),
    each step adds T(b) in {D, P + D}, so no step ever needs the
    incomplete-addition special cases; the constant surplus
    (2^257 - 1) * D is cancelled on the fold row,
  * partial results fold into a running accumulator seeded with a second
    dummy D2, subtracted on the program's out row,
  * the walk's scalar-bit accumulators (hi/lo 128-bit halves) bind the
    bits to the claimed scalar cells.  Any 256-bit value congruent to s
    mod r yields the same point because |G1| = r exactly, so no extra
    range check is needed.

Completeness caveat (same as the Sig circuit): the affine add blocks
require distinct x-coordinates; a collision between the walk accumulator
and a table point would imply a discrete-log relation between the dummy
points (known dlog of G) and the input points — cryptographically
unreachable for honest inputs.  Zero scalars are the one degenerate case
reachable honestly (walk result = E exactly); callers must drop
zero-scalar terms deterministically (finish/verify sides agree).

Port of zkevm_circuits_tpu/recursion/ecmsm.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.curve import host_g1_add, host_g1_mul
from ..crypto.field import fr
from ..crypto.params import FQ_MODULUS as P_FQ, FR_MODULUS as R, G1_GEN
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..circuits.mulmod import MulModCircuit, MulModEvent, MulModParams

F = fr()

M128 = (1 << 128) - 1
N_WALK = 256
EV_ROWS = N_WALK + 2  # setup + walk + fold

# dummy offsets (public, known dlog — like the Sig circuit's D)
K_D = 0xD0642_0FF5E7_0BADD106
K_D2 = 0xACC_5EED_0D2
D_PT = host_g1_mul(G1_GEN, K_D)
D2_PT = host_g1_mul(G1_GEN, K_D2)
T_SURPLUS = (1 << (N_WALK + 1)) - 1
E_PT = host_g1_mul(D_PT, T_SURPLUS)
NEG_E_PT = (E_PT[0], (P_FQ - E_PT[1]) % P_FQ)
NEG_D2_PT = (D2_PT[0], (P_FQ - D2_PT[1]) % P_FQ)


def _h(v: int) -> tuple[int, int]:
    return (v & M128, v >> 128)


ONE = (1, 0)
THREE = (3, 0)
PH = _h(P_FQ)


def _inv_p(x: int) -> int:
    return pow(x, -1, P_FQ)


def _ev_mul(events, a, b, r):
    events.append(MulModEvent(a=a, b=b, n=P_FQ, r=r))


def _ev_add(events, a, b, r):
    events.append(MulModEvent(a=a, b=b, n=P_FQ, r=r, is_add=True))


# host-side block simulators (BN254 base field; same op order as the
# in-circuit blocks below — the cell names must line up exactly)
def _h_add_block(events, P, Q):
    """P + Q affine, requires x1 != x2.  Returns (cells, (x3, y3))."""
    p = P_FQ
    assert P[0] != Q[0], "ecmsm add block: x collision (see module doc)"
    ddx = (Q[0] - P[0]) % p
    dinv = _inv_p(ddx)
    dyd = (Q[1] - P[1]) % p
    lam = dyd * dinv % p
    s2 = lam * lam % p
    x3 = (s2 - P[0] - Q[0]) % p
    au = (x3 + P[0]) % p
    d3 = (P[0] - x3) % p
    t5 = lam * d3 % p
    y3 = (t5 - P[1]) % p
    _ev_add(events, ddx, P[0], Q[0])
    _ev_mul(events, dinv, ddx, 1)
    _ev_add(events, dyd, P[1], Q[1])
    _ev_mul(events, lam, ddx, dyd)
    _ev_mul(events, lam, lam, s2)
    _ev_add(events, x3, P[0], au)
    _ev_add(events, au, Q[0], s2)
    _ev_add(events, d3, x3, P[0])
    _ev_mul(events, lam, d3, t5)
    _ev_add(events, y3, P[1], t5)
    cells = dict(ddx=ddx, dinv=dinv, dyd=dyd, lama=lam, s2=s2, au=au,
                 d3=d3, t5=t5, rx=x3, ry=y3)
    return cells, (x3, y3)


def _h_dbl_block(events, P):
    p = P_FQ
    t1 = P[0] * P[0] % p
    t2 = 2 * t1 % p
    t3 = 3 * t1 % p
    w2 = 2 * P[1] % p
    lam = t3 * _inv_p(w2) % p
    s1 = lam * lam % p
    dx = (s1 - 2 * P[0]) % p
    du = (dx + P[0]) % p
    d2 = (P[0] - dx) % p
    t4 = lam * d2 % p
    dy = (t4 - P[1]) % p
    _ev_mul(events, P[0], P[0], t1)
    _ev_add(events, t1, t1, t2)
    _ev_add(events, t2, t1, t3)
    _ev_add(events, P[1], P[1], w2)
    _ev_mul(events, lam, w2, t3)
    _ev_mul(events, lam, lam, s1)
    _ev_add(events, dx, P[0], du)
    _ev_add(events, du, P[0], s1)
    _ev_add(events, d2, dx, P[0])
    _ev_mul(events, lam, d2, t4)
    _ev_add(events, dy, P[1], t4)
    cells = dict(t1=t1, t2=t2, t3=t3, w2=w2, lamd=lam, s1=s1, du=du,
                 d2=d2, t4=t4, dx=dx, dy=dy)
    return cells, (dx, dy)


@dataclasses.dataclass
class EcMsmProgram:
    """One MSM claim: result = sum scalars[k] * points[k] (affine ints).

    Scalars are taken mod r; zero (mod r) scalars are rejected (module
    doc).  Points must be affine non-infinity."""

    scalars: list
    points: list

    def __post_init__(self):
        self.scalars = [s % R for s in self.scalars]
        assert len(self.scalars) == len(self.points)
        assert self.scalars, "empty MSM program"
        for s in self.scalars:
            assert s != 0, "zero scalar (drop zero terms deterministically)"
        for pt in self.points:
            assert pt is not None, "infinity input point (drop it)"

    def result(self):
        acc = None
        for s, pt in zip(self.scalars, self.points):
            acc = host_g1_add(acc, host_g1_mul(pt, s))
        return acc

    def trace(self):
        """Simulate the walk; returns (term_rows, fold_rows, out_cells,
        events)."""
        events: list[MulModEvent] = []
        terms = []
        A = D2_PT
        folds = []
        for s, Pt in zip(self.scalars, self.points):
            # setup: canonicity + on-curve + T1 = P + D
            t6 = Pt[0] * Pt[0] % P_FQ
            t7 = t6 * Pt[0] % P_FQ
            t8 = (t7 + 3) % P_FQ
            assert Pt[1] * Pt[1] % P_FQ == t8, "point not on curve"
            _ev_mul(events, Pt[0], 1, Pt[0])
            _ev_mul(events, Pt[1], 1, Pt[1])
            _ev_mul(events, Pt[0], Pt[0], t6)
            _ev_mul(events, t6, Pt[0], t7)
            _ev_add(events, t7, 3, t8)
            _ev_mul(events, Pt[1], Pt[1], t8)
            a1, T1 = _h_add_block(events, Pt, D_PT)
            setup = dict(p=Pt, s=s, t6=t6, t7=t7, t8=t8, a1=a1, T1=T1)
            acc = D_PT
            walk = []
            for i in range(N_WALK):
                bit = (s >> (N_WALK - 1 - i)) & 1
                dcells, Dp = _h_dbl_block(events, acc)
                T = T1 if bit else D_PT
                acells, acc = _h_add_block(events, Dp, T)
                walk.append(dict(b=bit, tx=T[0], ty=T[1], acc=acc,
                                 dbl=dcells, add=acells))
            # fold row: W = acc + (-E);  A' = A + W
            f1, W = _h_add_block(events, acc, NEG_E_PT)
            f2, A = _h_add_block(events, A, W)
            folds.append(dict(f1=f1, f2=f2, A=A))
            terms.append(dict(setup=setup, walk=walk))
        # out row: result = A + (-D2)
        f3, Rr = _h_add_block(events, A, NEG_D2_PT)
        assert Rr == self.result(), "ecmsm trace mismatch"
        return terms, folds, dict(f3=f3, r=Rr), events

    def mulmod_events(self):
        return self.trace()[3]

    @property
    def rows(self) -> int:
        return len(self.scalars) * EV_ROWS + 1


@dataclasses.dataclass
class EcMsmParams:
    target_rows: int = 0  # 0 => exact


def _dummy_program() -> EcMsmProgram:
    return EcMsmProgram(scalars=[1], points=[G1_GEN])


class EcMsmCircuit(Circuit):
    """Fixed-geometry region proving a list of EcMsmPrograms.

    Per term: 1 setup row + 256 walk rows + 1 fold row; per program one
    trailing out row.  Exposes `ec_msm_table` (q_out, rx_lo, rx_hi,
    ry_lo, ry_hi) plus cell accessors for copy-constraint consumers
    (the CompressionCircuit binds scalars/points to its tape cells)."""

    DBL = ("t1", "t2", "t3", "w2", "lamd", "s1", "du", "d2", "t4", "dx", "dy")
    ADD = ("ddx", "dinv", "dyd", "lama", "s2", "au", "d3", "t5", "rx", "ry")

    def __init__(self, programs: list[EcMsmProgram],
                 params: EcMsmParams | None = None):
        self.programs = list(programs)
        self.params = params or EcMsmParams()
        self.mm: MulModCircuit | None = None

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, mulmod_table=None):
        self.standalone = mulmod_table is None
        if self.standalone:
            evs: list[MulModEvent] = []
            for pr in self.programs:
                evs.extend(pr.mulmod_events())
            self.mm = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.mm.configure(cs)
            mulmod_table = self.mm.mulmod_table

        self.q_setup = cs.fixed_column()
        self.q_walk = cs.fixed_column()
        self.q_walk_hi = cs.fixed_column()  # first 128 walk rows of a term
        self.q_fold = cs.fixed_column()
        self.q_fold0 = cs.fixed_column()  # first fold row of each program
        self.q_out = cs.fixed_column()

        pair = lambda: (cs.advice_column(), cs.advice_column())
        self.pairs: dict = {}
        for name in ("px", "py", "s", "t6", "t7", "t8", "t1x", "t1y",
                     "acc_x", "acc_y", "tx", "ty", "ax", "ay"):
            self.pairs[name] = pair()
        for name in self.DBL:
            self.pairs["d_" + name] = pair()
        for name in self.ADD:
            self.pairs["w_" + name] = pair()  # walk add block
        for name in self.ADD:
            self.pairs["a1_" + name] = pair()  # setup: P + D
        for name in self.ADD:
            self.pairs["f1_" + name] = pair()  # fold: acc + (-E); out row: A + (-D2)
        for name in self.ADD:
            self.pairs["f2_" + name] = pair()  # fold: A_prev + W
        self.c_b = cs.advice_column()
        self.saccs = {k: cs.advice_column() for k in ("sh", "sl")}

        qs, qw = Fixed(self.q_setup), Fixed(self.q_walk)
        qh = Fixed(self.q_walk_hi)
        qf, qf0, qo = Fixed(self.q_fold), Fixed(self.q_fold0), Fixed(self.q_out)

        def P(name, rot=0):
            lo, hi = self.pairs[name]
            return (Advice(lo, rot), Advice(hi, rot))

        mm_inputs: list = []

        def mm(gate, a, b, r, is_add=0):
            mm_inputs.append([
                gate, gate * is_add, gate * a[0], gate * a[1],
                gate * b[0], gate * b[1], gate * PH[0], gate * PH[1],
                gate * r[0], gate * r[1],
            ])

        def add_block(gate, prefix, Pp, Qp):
            c = lambda nm, rot=0: P(prefix + nm, rot)
            mm(gate, c("ddx"), Pp[0], Qp[0], is_add=1)
            mm(gate, c("dinv"), c("ddx"), ONE)
            mm(gate, c("dyd"), Pp[1], Qp[1], is_add=1)
            mm(gate, c("lama"), c("ddx"), c("dyd"))
            mm(gate, c("lama"), c("lama"), c("s2"))
            mm(gate, c("rx"), Pp[0], c("au"), is_add=1)
            mm(gate, c("au"), Qp[0], c("s2"), is_add=1)
            mm(gate, c("d3"), c("rx"), Pp[0], is_add=1)
            mm(gate, c("lama"), c("d3"), c("t5"))
            mm(gate, c("ry"), Pp[1], c("t5"), is_add=1)
            return c("rx"), c("ry")

        def dbl_block(gate, Pp):
            c = lambda nm: P("d_" + nm)
            mm(gate, Pp[0], Pp[0], c("t1"))
            mm(gate, c("t1"), c("t1"), c("t2"), is_add=1)
            mm(gate, c("t2"), c("t1"), c("t3"), is_add=1)
            mm(gate, Pp[1], Pp[1], c("w2"), is_add=1)
            mm(gate, c("lamd"), c("w2"), c("t3"))
            mm(gate, c("lamd"), c("lamd"), c("s1"))
            mm(gate, c("dx"), Pp[0], c("du"), is_add=1)
            mm(gate, c("du"), Pp[0], c("s1"), is_add=1)
            mm(gate, c("d2"), c("dx"), Pp[0], is_add=1)
            mm(gate, c("lamd"), c("d2"), c("t4"))
            mm(gate, c("dy"), Pp[1], c("t4"), is_add=1)
            return c("dx"), c("dy")

        # ---- setup row: canonicity, on-curve, T1 = P + D, seeds ----------
        mm(qs, P("px"), ONE, P("px"))
        mm(qs, P("py"), ONE, P("py"))
        mm(qs, P("px"), P("px"), P("t6"))
        mm(qs, P("t6"), P("px"), P("t7"))
        mm(qs, P("t7"), THREE, P("t8"), is_add=1)
        mm(qs, P("py"), P("py"), P("t8"))
        DXY = (_h(D_PT[0]), _h(D_PT[1]))
        rx1, ry1 = add_block(qs, "a1_", (P("px"), P("py")), DXY)
        for res, col in ((rx1, "t1x"), (ry1, "t1y")):
            cur = P(col)
            cs.create_gate(f"ecmsm {col} bind lo", qs * (cur[0] - res[0]))
            cs.create_gate(f"ecmsm {col} bind hi", qs * (cur[1] - res[1]))
        for col, const in (("acc_x", DXY[0]), ("acc_y", DXY[1])):
            cur = P(col)
            cs.create_gate(f"ecmsm {col} seed lo", qs * (cur[0] - const[0]))
            cs.create_gate(f"ecmsm {col} seed hi", qs * (cur[1] - const[1]))
        for k, colc in self.saccs.items():
            cs.create_gate(f"ecmsm sacc {k} seed", qs * Advice(colc))

        # ---- walk rows ----------------------------------------------------
        b = Advice(self.c_b)
        cs.create_gate("ecmsm b bool", qw * b * (b - 1))
        for col in ("t1x", "t1y"):
            cur, prev = P(col), P(col, -1)
            cs.create_gate(f"ecmsm {col} cont lo", qw * (cur[0] - prev[0]))
            cs.create_gate(f"ecmsm {col} cont hi", qw * (cur[1] - prev[1]))
        for half in (0, 1):
            tx_e = (1 - b) * DXY[0][half] + b * P("t1x")[half]
            ty_e = (1 - b) * DXY[1][half] + b * P("t1y")[half]
            cs.create_gate(f"ecmsm tx mux {half}", qw * (P("tx")[half] - tx_e))
            cs.create_gate(f"ecmsm ty mux {half}", qw * (P("ty")[half] - ty_e))
        dxy = dbl_block(qw, (P("acc_x", -1), P("acc_y", -1)))
        rxw, ryw = add_block(qw, "w_", dxy, (P("tx"), P("ty")))
        for res, col in ((rxw, "acc_x"), (ryw, "acc_y")):
            cur = P(col)
            cs.create_gate(f"ecmsm {col} step lo", qw * (cur[0] - res[0]))
            cs.create_gate(f"ecmsm {col} step hi", qw * (cur[1] - res[1]))
        hi_c, lo_c = self.saccs["sh"], self.saccs["sl"]
        hi, hi_p = Advice(hi_c), Advice(hi_c, -1)
        lo, lo_p = Advice(lo_c), Advice(lo_c, -1)
        cs.create_gate("ecmsm sh walk", qw * qh * (hi - 2 * hi_p - b))
        cs.create_gate("ecmsm sl hold", qw * qh * (lo - lo_p))
        cs.create_gate("ecmsm sl walk", qw * (1 - qh) * (lo - 2 * lo_p - b))
        cs.create_gate("ecmsm sh hold", qw * (1 - qh) * (hi - hi_p))

        # ---- fold row -----------------------------------------------------
        back = -(EV_ROWS - 1)  # fold -> its setup row
        NEX, NEY = _h(NEG_E_PT[0]), _h(NEG_E_PT[1])
        w_x, w_y = add_block(
            qf, "f1_", (P("acc_x", -1), P("acc_y", -1)), (NEX, NEY)
        )
        D2X, D2Y = _h(D2_PT[0]), _h(D2_PT[1])
        # A_prev: D2 on the program's first fold row, else A(-EV_ROWS)
        apx = tuple(
            Fixed(self.q_fold0) * D2X[h]
            + (1 - Fixed(self.q_fold0)) * P("ax", -EV_ROWS)[h]
            for h in (0, 1)
        )
        apy = tuple(
            Fixed(self.q_fold0) * D2Y[h]
            + (1 - Fixed(self.q_fold0)) * P("ay", -EV_ROWS)[h]
            for h in (0, 1)
        )
        a_x, a_y = add_block(qf, "f2_", (apx, apy), (w_x, w_y))
        for res, col in ((a_x, "ax"), (a_y, "ay")):
            cur = P(col)
            cs.create_gate(f"ecmsm {col} bind lo", qf * (cur[0] - res[0]))
            cs.create_gate(f"ecmsm {col} bind hi", qf * (cur[1] - res[1]))
        # scalar binding: accumulated bits == claimed scalar on setup row
        s_cells = P("s", back)
        cs.create_gate(
            "ecmsm s bind lo", qf * (Advice(self.saccs["sl"], -1) - s_cells[0])
        )
        cs.create_gate(
            "ecmsm s bind hi", qf * (Advice(self.saccs["sh"], -1) - s_cells[1])
        )

        # ---- out row: result = A(-1) + (-D2), in the f1_ columns ----------
        ND2 = (_h(NEG_D2_PT[0]), _h(NEG_D2_PT[1]))
        add_block(qo, "f1_", (P("ax", -1), P("ay", -1)), ND2)

        cs.lookup_logup("ecmsm mulmod ops", mm_inputs, mulmod_table)

        # exposed result table: (enable, rx_lo, rx_hi, ry_lo, ry_hi)
        self.ec_msm_table = [
            qo,
            qo * P("f1_rx")[0], qo * P("f1_rx")[1],
            qo * P("f1_ry")[0], qo * P("f1_ry")[1],
        ]

    # ------------------------------------------------------------------
    # cell accessors for copy-constraint consumers
    # ------------------------------------------------------------------
    def _program_base(self, prog_idx: int) -> int:
        base = 0
        for pr in self.programs[:prog_idx]:
            base += pr.rows
        return base

    def scalar_cells(self, prog_idx: int, term: int):
        """(lo_cell, hi_cell) of the claimed scalar for one term."""
        row = self._program_base(prog_idx) + term * EV_ROWS
        lo, hi = self.pairs["s"]
        return Cell("advice", lo, row), Cell("advice", hi, row)

    def point_cells(self, prog_idx: int, term: int):
        """((x_lo, x_hi), (y_lo, y_hi)) cells of one term's point."""
        row = self._program_base(prog_idx) + term * EV_ROWS
        xl, xh = self.pairs["px"]
        yl, yh = self.pairs["py"]
        return (
            (Cell("advice", xl, row), Cell("advice", xh, row)),
            (Cell("advice", yl, row), Cell("advice", yh, row)),
        )

    def result_cells(self, prog_idx: int):
        """((x_lo, x_hi), (y_lo, y_hi)) cells of the program result."""
        row = self._program_base(prog_idx) + self.programs[prog_idx].rows - 1
        xl, xh = self.pairs["f1_rx"]
        yl, yh = self.pairs["f1_ry"]
        return (
            (Cell("advice", xl, row), Cell("advice", xh, row)),
            (Cell("advice", yl, row), Cell("advice", yh, row)),
        )

    # ------------------------------------------------------------------
    def _rows_used(self) -> int:
        return sum(p.rows for p in self.programs)

    def fixed_columns(self, n: int):
        assert self._rows_used() <= usable_rows(n), "domain too small"
        mont = F.mont_from_ints
        qs = [0] * n
        qw = [0] * n
        qh = [0] * n
        qf = [0] * n
        qf0 = [0] * n
        qo = [0] * n
        row = 0
        for pr in self.programs:
            for t in range(len(pr.scalars)):
                qs[row] = 1
                for i in range(N_WALK):
                    qw[row + 1 + i] = 1
                    if i < 128:
                        qh[row + 1 + i] = 1
                qf[row + 1 + N_WALK] = 1
                if t == 0:
                    qf0[row + 1 + N_WALK] = 1
                row += EV_ROWS
            qo[row] = 1
            row += 1
        out = {
            self.q_setup: mont(qs), self.q_walk: mont(qw),
            self.q_walk_hi: mont(qh), self.q_fold: mont(qf),
            self.q_fold0: mont(qf0), self.q_out: mont(qo),
        }
        if self.mm is not None:
            out.update(self.mm.fixed_columns(n))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        out = {}
        if self.mm is not None:
            out.update(self.mm.synthesize(phase, n, challenges, instances))
        if phase != 0:
            return out
        nrows = self._rows_used()
        pairs_v = {k: [(0, 0)] * nrows for k in self.pairs}
        b_col = [0] * nrows
        sh_col = [0] * nrows
        sl_col = [0] * nrows

        row = 0
        for pr in self.programs:
            terms, folds, outc, _ = pr.trace()
            for t, (term, fold) in enumerate(zip(terms, folds)):
                setup = term["setup"]
                base = row
                pairs_v["px"][base] = _h(setup["p"][0])
                pairs_v["py"][base] = _h(setup["p"][1])
                pairs_v["s"][base] = _h(setup["s"])
                for nm in ("t6", "t7", "t8"):
                    pairs_v[nm][base] = _h(setup[nm])
                for nm in self.ADD:
                    pairs_v["a1_" + nm][base] = _h(setup["a1"][nm])
                pairs_v["t1x"][base] = _h(setup["T1"][0])
                pairs_v["t1y"][base] = _h(setup["T1"][1])
                pairs_v["acc_x"][base] = _h(D_PT[0])
                pairs_v["acc_y"][base] = _h(D_PT[1])
                sh = sl = 0
                for i, wrow in enumerate(term["walk"]):
                    rix = base + 1 + i
                    for nm in self.DBL:
                        pairs_v["d_" + nm][rix] = _h(wrow["dbl"][nm])
                    for nm in self.ADD:
                        pairs_v["w_" + nm][rix] = _h(wrow["add"][nm])
                    pairs_v["tx"][rix] = _h(wrow["tx"])
                    pairs_v["ty"][rix] = _h(wrow["ty"])
                    pairs_v["acc_x"][rix] = _h(wrow["acc"][0])
                    pairs_v["acc_y"][rix] = _h(wrow["acc"][1])
                    pairs_v["t1x"][rix] = _h(setup["T1"][0])
                    pairs_v["t1y"][rix] = _h(setup["T1"][1])
                    b_col[rix] = wrow["b"]
                    if i < 128:
                        sh = 2 * sh + wrow["b"]
                    else:
                        sl = 2 * sl + wrow["b"]
                    sh_col[rix] = sh
                    sl_col[rix] = sl
                frow = base + 1 + N_WALK
                for nm in self.ADD:
                    pairs_v["f1_" + nm][frow] = _h(fold["f1"][nm])
                    pairs_v["f2_" + nm][frow] = _h(fold["f2"][nm])
                pairs_v["ax"][frow] = _h(fold["A"][0])
                pairs_v["ay"][frow] = _h(fold["A"][1])
                row += EV_ROWS
            # out row
            for nm in self.ADD:
                pairs_v["f1_" + nm][row] = _h(outc["f3"][nm])
            row += 1

        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        for name, (clo, chi) in self.pairs.items():
            out[clo] = mont([v[0] for v in pairs_v[name]])
            out[chi] = mont([v[1] for v in pairs_v[name]])
        out[self.c_b] = mont(b_col)
        out[self.saccs["sh"]] = mont(sh_col)
        out[self.saccs["sl"]] = mont(sl_col)
        return out


# ===========================================================================
# Windowed Straus MSM (shared doubling chain) — the aggregation-scale
# variant.  The bit-walk EcMsmCircuit above costs ~5.4K MulMod rows PER
# TERM (256 dbl+add blocks); verifying a layer-1 snark in-circuit needs
# ~350 terms, pushing k past 21.  Straus interleaving shares ONE
# 4-bit-window doubling chain across every term of a program:
#
#     acc = D2
#     for step in 0..63:            # windows, MSB first
#         acc = 16*acc              # 4 shared dbl rows
#         for each term t:          # one add row per term
#             acc += T_t[w_t,step]  # table entry, logUp-bound
#
# with per-term tables T_t[w] = w*P_t + D (16 rows each, chain-built
# in-circuit).  Every add row adds one D, so the known-dlog surplus is
# 16^64*D2 + T*(16^64-1)/15 * D — cancelled on the program's out row via
# fixed-column constants.  Events per program drop from 5378*T to
# ~800*T + 2800 (6.7x at T=350), rows to 81*T + 257.
#
# Zero scalars are SOUND here (w=0 selects the dummy T[0]=D, which the
# surplus accounts for) — unlike the bit walk, no term dropping needed.
# Completeness caveat (x-collisions) is the same genericity argument.
# ===========================================================================

N_WINDOWS = 64
WIN_BITS = 4
K16 = ((1 << (4 * N_WINDOWS)) - 1) // 15  # sum 16^i, i < 64


def _straus_offsets(n_terms: int):
    """(E'_neg) for a program with n_terms terms."""
    c = ((1 << 256) % R) * ((K16 * n_terms) % R) % R  # unused; host math below
    del c
    e = host_g1_add(
        host_g1_mul(D2_PT, pow(16, N_WINDOWS, R)),
        host_g1_mul(D_PT, (K16 * n_terms) % R),
    )
    return (e[0], (P_FQ - e[1]) % P_FQ)


@dataclasses.dataclass
class EcStrausProgram:
    """One MSM claim: result = sum scalars[k] * points[k] (affine ints).

    Scalars mod r; zeros allowed.  Points must be affine non-infinity."""

    scalars: list
    points: list

    def __post_init__(self):
        self.scalars = [s % R for s in self.scalars]
        assert len(self.scalars) == len(self.points)
        assert self.scalars, "empty MSM program"
        for pt in self.points:
            assert pt is not None, "infinity input point (drop it)"

    @property
    def n_terms(self) -> int:
        return len(self.scalars)

    @property
    def rows(self) -> int:
        t = self.n_terms
        return 17 * t + N_WINDOWS * (4 + t) + 1

    def result(self):
        acc = None
        for s, pt in zip(self.scalars, self.points):
            if s:
                acc = host_g1_add(acc, host_g1_mul(pt, s))
        return acc

    def trace(self):
        """(setups, tables, steps, out_cells, events)."""
        events: list[MulModEvent] = []
        setups = []
        tables = []  # per term: list of 16 dicts
        for s, Pt in zip(self.scalars, self.points):
            t6 = Pt[0] * Pt[0] % P_FQ
            t7 = t6 * Pt[0] % P_FQ
            t8 = (t7 + 3) % P_FQ
            assert Pt[1] * Pt[1] % P_FQ == t8, "point not on curve"
            _ev_mul(events, Pt[0], 1, Pt[0])
            _ev_mul(events, Pt[1], 1, Pt[1])
            _ev_mul(events, Pt[0], Pt[0], t6)
            _ev_mul(events, t6, Pt[0], t7)
            _ev_add(events, t7, 3, t8)
            _ev_mul(events, Pt[1], Pt[1], t8)
            setups.append(dict(p=Pt, s=s))
            rows = [dict(w=0, T=D_PT, add=None)]
            cur = D_PT
            for w in range(1, 16):
                acells, cur = _h_add_block(events, cur, Pt)
                rows.append(dict(w=w, T=cur, add=acells))
            tables.append(rows)
        steps = []
        acc = D2_PT
        for i in range(N_WINDOWS):
            dbls = []
            for _ in range(4):
                dcells, acc = _h_dbl_block(events, acc)
                dbls.append(dict(dbl=dcells, acc=acc))
            adds = []
            for t, s in enumerate(self.scalars):
                w = (s >> (WIN_BITS * (N_WINDOWS - 1 - i))) & 15
                T = tables[t][w]["T"]
                acells, acc = _h_add_block(events, acc, T)
                adds.append(dict(w=w, T=T, add=acells, acc=acc))
            steps.append(dict(dbls=dbls, adds=adds))
        neg_e = _straus_offsets(self.n_terms)
        f3, Rr = _h_add_block(events, acc, neg_e)
        assert Rr == self.result(), "straus trace mismatch"
        return setups, tables, steps, dict(f3=f3, r=Rr, neg_e=neg_e), events

    def mulmod_events(self):
        return self.trace()[4]


class EcStrausCircuit(Circuit):
    """Fixed-geometry Straus MSM region over MulMod rows.

    Per program: [T setup+table groups (1 + 16 rows each)] then
    [64 steps x (4 dbl rows + T add rows)] then 1 out row.  Exposes the
    same accessor API as EcMsmCircuit (scalar_cells / point_cells /
    result_cells) so tape-circuit consumers can swap it in."""

    ADD = EcMsmCircuit.ADD
    DBL = EcMsmCircuit.DBL

    def __init__(self, programs: list[EcStrausProgram]):
        self.programs = list(programs)
        self.mm: MulModCircuit | None = None

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, mulmod_table=None):
        self.standalone = mulmod_table is None
        if self.standalone:
            evs: list[MulModEvent] = []
            for pr in self.programs:
                evs.extend(pr.mulmod_events())
            self.mm = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.mm.configure(cs)
            mulmod_table = self.mm.mulmod_table

        self.q_setup = cs.fixed_column()
        self.q_tab = cs.fixed_column()  # table rows (w >= 1: add block on)
        self.q_tab0 = cs.fixed_column()  # w = 0 table row (T = D pin)
        self.f_w = cs.fixed_column()  # window index on table rows
        self.f_term = cs.fixed_column()  # GLOBAL term id (tables + adds)
        self.q_dbl = cs.fixed_column()
        self.q_dbl0 = cs.fixed_column()  # first dbl row: acc seeds at D2
        self.q_add = cs.fixed_column()  # walk add rows
        self.f_add0 = cs.fixed_column()  # step-0 add rows: sacc seeds at 0
        self.f_whi = cs.fixed_column()  # 1 on add rows of steps < 32
        self.q_out = cs.fixed_column()
        self.f_ex = [cs.fixed_column(), cs.fixed_column()]  # -E' x limbs
        self.f_ey = [cs.fixed_column(), cs.fixed_column()]  # -E' y limbs

        pair = lambda: (cs.advice_column(), cs.advice_column())
        self.pairs: dict = {}
        for name in ("px", "py", "s", "t6", "t7", "t8", "tp_x", "tp_y",
                     "tb_x", "tb_y", "acc_x", "acc_y", "tx", "ty"):
            self.pairs[name] = pair()
        for name in self.DBL:
            self.pairs["d_" + name] = pair()
        for name in self.ADD:
            self.pairs["w_" + name] = pair()  # table build + walk adds
        for name in self.ADD:
            self.pairs["f1_" + name] = pair()  # out row: acc + (-E')
        self.c_w = cs.advice_column()  # selected window on add rows
        self.saccs = {k: cs.advice_column() for k in ("sh", "sl")}
        for name in ("s", "px", "py", "f1_rx", "f1_ry"):
            for col in self.pairs[name]:
                cs.enable_equality("advice", col)
        for col in self.saccs.values():
            cs.enable_equality("advice", col)

        qs = Fixed(self.q_setup)
        qt, qt0 = Fixed(self.q_tab), Fixed(self.q_tab0)
        qd, qa = Fixed(self.q_dbl), Fixed(self.q_add)
        qo = Fixed(self.q_out)
        whi = Fixed(self.f_whi)

        def P(name, rot=0):
            lo, hi = self.pairs[name]
            return (Advice(lo, rot), Advice(hi, rot))

        mm_inputs: list = []

        def mm(gate, a, b, r, is_add=0):
            mm_inputs.append([
                gate, gate * is_add, gate * a[0], gate * a[1],
                gate * b[0], gate * b[1], gate * PH[0], gate * PH[1],
                gate * r[0], gate * r[1],
            ])

        def add_block(gate, prefix, Pp, Qp):
            c = lambda nm, rot=0: P(prefix + nm, rot)
            mm(gate, c("ddx"), Pp[0], Qp[0], is_add=1)
            mm(gate, c("dinv"), c("ddx"), ONE)
            mm(gate, c("dyd"), Pp[1], Qp[1], is_add=1)
            mm(gate, c("lama"), c("ddx"), c("dyd"))
            mm(gate, c("lama"), c("lama"), c("s2"))
            mm(gate, c("rx"), Pp[0], c("au"), is_add=1)
            mm(gate, c("au"), Qp[0], c("s2"), is_add=1)
            mm(gate, c("d3"), c("rx"), Pp[0], is_add=1)
            mm(gate, c("lama"), c("d3"), c("t5"))
            mm(gate, c("ry"), Pp[1], c("t5"), is_add=1)
            return c("rx"), c("ry")

        def dbl_block(gate, Pp):
            c = lambda nm: P("d_" + nm)
            mm(gate, Pp[0], Pp[0], c("t1"))
            mm(gate, c("t1"), c("t1"), c("t2"), is_add=1)
            mm(gate, c("t2"), c("t1"), c("t3"), is_add=1)
            mm(gate, Pp[1], Pp[1], c("w2"), is_add=1)
            mm(gate, c("lamd"), c("w2"), c("t3"))
            mm(gate, c("lamd"), c("lamd"), c("s1"))
            mm(gate, c("dx"), Pp[0], c("du"), is_add=1)
            mm(gate, c("du"), Pp[0], c("s1"), is_add=1)
            mm(gate, c("d2"), c("dx"), Pp[0], is_add=1)
            mm(gate, c("lamd"), c("d2"), c("t4"))
            mm(gate, c("dy"), Pp[1], c("t4"), is_add=1)
            return c("dx"), c("dy")

        # ---- setup rows: canonicity + on-curve -------------------------
        mm(qs, P("px"), ONE, P("px"))
        mm(qs, P("py"), ONE, P("py"))
        mm(qs, P("px"), P("px"), P("t6"))
        mm(qs, P("t6"), P("px"), P("t7"))
        mm(qs, P("t7"), THREE, P("t8"), is_add=1)
        mm(qs, P("py"), P("py"), P("t8"))

        # ---- table rows ------------------------------------------------
        DXY = (_h(D_PT[0]), _h(D_PT[1]))
        # tp (the term's point) carried down the 16 table rows, seeded
        # from the setup row's px/py
        for colp, src in (("tp_x", "px"), ("tp_y", "py")):
            cur = P(colp)
            prev = P(colp, -1)
            seed = P(src, -1)
            for h in (0, 1):
                cs.create_gate(
                    f"straus {colp} seed {h}", qt0 * (cur[h] - seed[h])
                )
                cs.create_gate(
                    f"straus {colp} carry {h}", qt * (cur[h] - prev[h])
                )
        # w=0 row: T = D
        for colc, const in (("tb_x", DXY[0]), ("tb_y", DXY[1])):
            cur = P(colc)
            for h in (0, 1):
                cs.create_gate(
                    f"straus {colc} d pin {h}", qt0 * (cur[h] - const[h])
                )
        # w>=1 rows: T = T_prev + P (add block in the w_ columns)
        trx, try_ = add_block(
            qt, "w_", (P("tb_x", -1), P("tb_y", -1)), (P("tp_x"), P("tp_y"))
        )
        for res, colc in ((trx, "tb_x"), (try_, "tb_y")):
            cur = P(colc)
            for h in (0, 1):
                cs.create_gate(
                    f"straus {colc} chain {h}", qt * (cur[h] - res[h])
                )
        # w index increments down the table (fixed column, structural)

        # table exposure for the walk lookup: (enable, term, w, T limbs)
        tab_en = qt + qt0
        self.table_rows = [
            tab_en, tab_en * Fixed(self.f_term), tab_en * Fixed(self.f_w),
            tab_en * P("tb_x")[0], tab_en * P("tb_x")[1],
            tab_en * P("tb_y")[0], tab_en * P("tb_y")[1],
        ]

        # ---- walk: dbl rows --------------------------------------------
        # the program's first dbl row seeds acc = D2 (fixed-selected);
        # later dbl rows chain from the previous row's acc
        qd0 = Fixed(self.q_dbl0)
        D2XY = (_h(D2_PT[0]), _h(D2_PT[1]))
        acc_in = tuple(
            tuple(
                qd0 * D2XY[c][h] + (1 - qd0) * P(("acc_x", "acc_y")[c], -1)[h]
                for h in (0, 1)
            )
            for c in (0, 1)
        )
        ddx, ddy = dbl_block(qd, acc_in)
        for res, colc in ((ddx, "acc_x"), (ddy, "acc_y")):
            cur = P(colc)
            for h in (0, 1):
                cs.create_gate(
                    f"straus dbl {colc} {h}", qd * (cur[h] - res[h])
                )

        # ---- walk: add rows --------------------------------------------
        w_e = Advice(self.c_w)
        arx, ary = add_block(
            qa, "w_", (P("acc_x", -1), P("acc_y", -1)), (P("tx"), P("ty"))
        )
        for res, colc in ((arx, "acc_x"), (ary, "acc_y")):
            cur = P(colc)
            for h in (0, 1):
                cs.create_gate(
                    f"straus add {colc} {h}", qa * (cur[h] - res[h])
                )
        cs.lookup_logup(
            "straus table sel",
            [[qa, qa * Fixed(self.f_term), qa * w_e,
              qa * P("tx")[0], qa * P("tx")[1],
              qa * P("ty")[0], qa * P("ty")[1]]],
            self.table_rows,
        )
        cs.lookup_logup("straus mulmod ops", mm_inputs, mulmod_table)

        # scalar nibble accumulators: per-term rows are a fixed stride
        # apart; the stride is per-instance geometry, so the recurrence
        # rides copy constraints (see copy_constraints) on a carried pair
        # of columns: here only the per-row update gate lives.
        # sacc_new = 16*sacc_prev_cell + w, where sacc_prev_cell is THIS
        # row's carried-in value (bound by copy to the term's previous
        # add row), held in the same columns at rotation 0 via a second
        # pair of columns:
        self.c_sprev = {k: cs.advice_column() for k in ("sh", "sl")}
        for col in self.c_sprev.values():
            cs.enable_equality("advice", col)
        sh, sl = Advice(self.saccs["sh"]), Advice(self.saccs["sl"])
        shp = Advice(self.c_sprev["sh"])
        slp = Advice(self.c_sprev["sl"])
        a0 = Fixed(self.f_add0)
        cs.create_gate("straus sacc seed hi", qa * a0 * shp)
        cs.create_gate("straus sacc seed lo", qa * a0 * slp)
        cs.create_gate("straus sacc hi", qa * whi * (sh - 16 * shp - w_e))
        cs.create_gate("straus sacc hi hold", qa * (1 - whi) * (sh - shp))
        cs.create_gate("straus sacc lo", qa * (1 - whi) * (sl - 16 * slp - w_e))
        cs.create_gate("straus sacc lo hold", qa * whi * (sl - slp))

        # ---- out row: result = acc(-1) + (-E') -------------------------
        nex = (Fixed(self.f_ex[0]), Fixed(self.f_ex[1]))
        ney = (Fixed(self.f_ey[0]), Fixed(self.f_ey[1]))
        add_block(qo, "f1_", (P("acc_x", -1), P("acc_y", -1)), (nex, ney))

        self.ec_msm_table = [
            qo,
            qo * P("f1_rx")[0], qo * P("f1_rx")[1],
            qo * P("f1_ry")[0], qo * P("f1_ry")[1],
        ]

    # ------------------------------------------------------------------
    def _program_base(self, prog_idx: int) -> int:
        return sum(p.rows for p in self.programs[:prog_idx])

    def _term_setup_row(self, prog_idx: int, term: int) -> int:
        return self._program_base(prog_idx) + 17 * term

    def _add_row(self, prog_idx: int, step: int, term: int) -> int:
        pr = self.programs[prog_idx]
        t = pr.n_terms
        walk0 = self._program_base(prog_idx) + 17 * t
        return walk0 + step * (4 + t) + 4 + term

    def scalar_cells(self, prog_idx: int, term: int):
        row = self._term_setup_row(prog_idx, term)
        lo, hi = self.pairs["s"]
        return Cell("advice", lo, row), Cell("advice", hi, row)

    def point_cells(self, prog_idx: int, term: int):
        row = self._term_setup_row(prog_idx, term)
        xl, xh = self.pairs["px"]
        yl, yh = self.pairs["py"]
        return (
            (Cell("advice", xl, row), Cell("advice", xh, row)),
            (Cell("advice", yl, row), Cell("advice", yh, row)),
        )

    def result_cells(self, prog_idx: int):
        row = self._program_base(prog_idx) + self.programs[prog_idx].rows - 1
        xl, xh = self.pairs["f1_rx"]
        yl, yh = self.pairs["f1_ry"]
        return (
            (Cell("advice", xl, row), Cell("advice", xh, row)),
            (Cell("advice", yl, row), Cell("advice", yh, row)),
        )

    def copy_constraints(self, n: int):
        """sacc recurrence wiring: each add row's carried-in sprev cells
        equal the SAME term's previous-step sacc cells; the setup row's
        claimed scalar equals the final sacc."""
        out = []
        for pi_, pr in enumerate(self.programs):
            for t in range(pr.n_terms):
                for i in range(1, N_WINDOWS):
                    cur = self._add_row(pi_, i, t)
                    prev = self._add_row(pi_, i - 1, t)
                    for k in ("sh", "sl"):
                        out.append((
                            Cell("advice", self.c_sprev[k], cur),
                            Cell("advice", self.saccs[k], prev),
                        ))
                last = self._add_row(pi_, N_WINDOWS - 1, t)
                s_lo, s_hi = self.scalar_cells(pi_, t)
                out.append((s_hi, Cell("advice", self.saccs["sh"], last)))
                out.append((s_lo, Cell("advice", self.saccs["sl"], last)))
        return out

    def _rows_used(self) -> int:
        return sum(p.rows for p in self.programs)

    def fixed_columns(self, n: int):
        assert self._rows_used() <= usable_rows(n), "domain too small"
        mont = F.mont_from_ints
        z = lambda: [0] * n
        qs, qt, qt0, fw, fterm = z(), z(), z(), z(), z()
        qd, qd0, qa, fa0, fwhi, qo = z(), z(), z(), z(), z(), z()
        fex = [z(), z()]
        fey = [z(), z()]
        gterm = 0
        row = 0
        for pr in self.programs:
            t_count = pr.n_terms
            term_ids = []
            for t in range(t_count):
                qs[row] = 1
                term_ids.append(gterm)
                for w in range(16):
                    r_ = row + 1 + w
                    (qt0 if w == 0 else qt)[r_] = 1
                    fw[r_] = w
                    fterm[r_] = gterm
                gterm += 1
                row += 17
            for i in range(N_WINDOWS):
                for d in range(4):
                    qd[row] = 1
                    if i == 0 and d == 0:
                        qd0[row] = 1
                    row += 1
                for t in range(t_count):
                    qa[row] = 1
                    fterm[row] = term_ids[t]
                    if i == 0:
                        fa0[row] = 1
                    if i < 32:
                        fwhi[row] = 1
                    row += 1
            neg_e = _straus_offsets(t_count)
            ex, ey = _h(neg_e[0]), _h(neg_e[1])
            for h in (0, 1):
                fex[h][row] = ex[h]
                fey[h][row] = ey[h]
            qo[row] = 1
            row += 1
        out = {
            self.q_setup: mont(qs), self.q_tab: mont(qt),
            self.q_tab0: mont(qt0), self.f_w: mont(fw),
            self.f_term: mont(fterm), self.q_dbl: mont(qd),
            self.q_dbl0: mont(qd0), self.q_add: mont(qa),
            self.f_add0: mont(fa0), self.f_whi: mont(fwhi),
            self.q_out: mont(qo),
            self.f_ex[0]: mont(fex[0]), self.f_ex[1]: mont(fex[1]),
            self.f_ey[0]: mont(fey[0]), self.f_ey[1]: mont(fey[1]),
        }
        if self.mm is not None:
            out.update(self.mm.fixed_columns(n))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        out = {}
        if self.mm is not None:
            out.update(self.mm.synthesize(phase, n, challenges, instances))
        if phase != 0:
            return out
        nrows = self._rows_used()
        pairs_v = {k: [(0, 0)] * nrows for k in self.pairs}
        w_col = [0] * nrows
        sh_col = [0] * nrows
        sl_col = [0] * nrows
        shp_col = [0] * nrows
        slp_col = [0] * nrows

        row = 0
        for pr in self.programs:
            setups, tables, steps, outc, _ = pr.trace()
            t_count = pr.n_terms
            saccs = [(0, 0)] * t_count  # (hi, lo) running nibbles
            for t, setup in enumerate(setups):
                pairs_v["px"][row] = _h(setup["p"][0])
                pairs_v["py"][row] = _h(setup["p"][1])
                pairs_v["s"][row] = _h(setup["s"])
                x_ = setup["p"][0]
                t6 = x_ * x_ % P_FQ
                t7 = t6 * x_ % P_FQ
                pairs_v["t6"][row] = _h(t6)
                pairs_v["t7"][row] = _h(t7)
                pairs_v["t8"][row] = _h((t7 + 3) % P_FQ)
                for w in range(16):
                    r_ = row + 1 + w
                    trow = tables[t][w]
                    pairs_v["tp_x"][r_] = _h(setup["p"][0])
                    pairs_v["tp_y"][r_] = _h(setup["p"][1])
                    pairs_v["tb_x"][r_] = _h(trow["T"][0])
                    pairs_v["tb_y"][r_] = _h(trow["T"][1])
                    if trow["add"] is not None:
                        for nm in self.ADD:
                            pairs_v["w_" + nm][r_] = _h(trow["add"][nm])
                row += 17
            for i, st in enumerate(steps):
                for d in range(4):
                    dd = st["dbls"][d]
                    for nm in self.DBL:
                        pairs_v["d_" + nm][row] = _h(dd["dbl"][nm])
                    pairs_v["acc_x"][row] = _h(dd["acc"][0])
                    pairs_v["acc_y"][row] = _h(dd["acc"][1])
                    row += 1
                for t in range(t_count):
                    ad = st["adds"][t]
                    for nm in self.ADD:
                        pairs_v["w_" + nm][row] = _h(ad["add"][nm])
                    pairs_v["tx"][row] = _h(ad["T"][0])
                    pairs_v["ty"][row] = _h(ad["T"][1])
                    pairs_v["acc_x"][row] = _h(ad["acc"][0])
                    pairs_v["acc_y"][row] = _h(ad["acc"][1])
                    w_col[row] = ad["w"]
                    hi, lo = saccs[t]
                    shp_col[row], slp_col[row] = hi, lo
                    if i < 32:
                        hi = 16 * hi + ad["w"]
                    else:
                        lo = 16 * lo + ad["w"]
                    saccs[t] = (hi, lo)
                    sh_col[row], sl_col[row] = hi, lo
                    row += 1
            for nm in self.ADD:
                pairs_v["f1_" + nm][row] = _h(outc["f3"][nm])
            row += 1

        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        for name, (clo, chi) in self.pairs.items():
            out[clo] = mont([v[0] for v in pairs_v[name]])
            out[chi] = mont([v[1] for v in pairs_v[name]])
        out[self.c_w] = mont(w_col)
        out[self.saccs["sh"]] = mont(sh_col)
        out[self.saccs["sl"]] = mont(sl_col)
        out[self.c_sprev["sh"]] = mont(shp_col)
        out[self.c_sprev["sl"]] = mont(slp_col)
        return out
