"""ECC circuit — BN254 EcAdd / EcMul precompile proofs (0x06, 0x07).

Equivalent of the reference's `zkevm-circuits/src/ecc_circuit.rs`
(SURVEY.md §2.2 "ECC"), which proves the BN254 precompiles with
halo2-ecc's `EccChip`.  Like the Sig circuit, this build delegates
every modular operation to the shared MulMod circuit (mod the BN254
BASE field q — non-native to the proving field) and keeps only the
wiring here.

Layout: one domain region per op kind, fixed geometry.
  * EcAdd events: ONE row each, complete-addition case flags
    (P=O | Q=O | P=-Q | P=Q | generic) selecting gated op blocks.
  * EcMul events: 258 rows each (setup, 256-bit walk, final), the
    Sig circuit's dummy-offset scalar walk with a single scalar and a
    per-event base point; trivial events (P=O or k=0) run a fixed dummy
    walk (base G, scalar 1) and expose R=O.

Exposed EccTable (reference table.rs:2599): on each event's statement
row, (enable, op_tag, px_lo, px_hi, py_lo, py_hi, qx_lo, qx_hi, qy_lo,
qy_hi, rx_lo, rx_hi, ry_lo, ry_hi) — for EcMul the q slots carry the
scalar halves.  EcPairing lands with the Fq12 tower (documented gap).

Port of zkevm_circuits_tpu/circuits/ecc.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FQ_MODULUS as Q_BN, FR_MODULUS as R, G1_GEN
from ..crypto.curve import host_g1_add, host_g1_mul
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from .ecblocks import (
    ADD_CELLS, DBL_CELLS, MmCollector, ONE, emit_add_block, emit_dbl_block,
    halves, host_add_block, host_dbl_block,
)
from .mulmod import MulModCircuit, MulModEvent, MulModParams

F = fr()

QH = halves(Q_BN)
THREE = (3, 0)
EV_ROWS = 258
N_WALK = 256

K_D = 0xECC0FFEE0D15EA5E
D_PT = host_g1_mul(G1_GEN, K_D)
T1G_PT = host_g1_add(G1_GEN, D_PT)
E_PT = host_g1_mul(D_PT, (1 << 257) - 1)
NEG_E_PT = (E_PT[0], Q_BN - E_PT[1])

TAG_ADD, TAG_MUL = 1, 2


def _curve_check(events, P):
    """y^2 = x^3 + 3 rows (+ canonicity); host side."""
    from .ecblocks import _ev

    q = Q_BN
    t6 = P[0] * P[0] % q
    t7 = t6 * P[0] % q
    t8 = (t7 + 3) % q
    assert P[1] * P[1] % q == t8, "point not on curve"
    _ev(events, P[0], 1, q, P[0])
    _ev(events, P[1], 1, q, P[1])
    _ev(events, P[0], P[0], q, t6)
    _ev(events, t6, P[0], q, t7)
    _ev(events, t7, 3, q, t8, True)
    _ev(events, P[1], P[1], q, t8)
    return dict(t6=t6, t7=t7, t8=t8)


@dataclasses.dataclass
class EcAddEvent:
    """R = P + Q on BN254 G1; (0, 0) encodes infinity (EVM convention)."""

    p: tuple
    q: tuple
    r: tuple

    def _case(self) -> str:
        P, Q = self.p, self.q
        if P == (0, 0):
            return "pz"
        if Q == (0, 0):
            return "qz"
        if P[0] == Q[0]:
            return "dbl" if P[1] == Q[1] else "opp"
        return "gen"

    def trace(self):
        from .ecblocks import _ev

        events: list[MulModEvent] = []
        case = self._case()
        cells: dict = {}
        P, Q = self.p, self.q
        if case != "pz":
            cells["pcurve"] = _curve_check(events, P)
        if case not in ("pz", "qz"):
            cells["qcurve"] = _curve_check(events, Q)
        if case == "pz":
            assert self.r == Q
            if Q != (0, 0):
                cells["qcurve"] = _curve_check(events, Q)
        elif case == "qz":
            assert self.r == P
        elif case == "opp":
            assert self.r == (0, 0)
            _ev(events, P[1], Q[1], Q_BN, 0, True)
        elif case == "dbl":
            dcells, Rp = host_dbl_block(events, P, Q_BN)
            cells["dbl"] = dcells
            assert self.r == Rp
        else:
            acells, Rp = host_add_block(events, P, Q, Q_BN)
            cells["add"] = acells
            assert self.r == Rp
        return case, cells, events

    def mulmod_events(self):
        return self.trace()[2]


@dataclasses.dataclass
class EcMulEvent:
    """R = k * P on BN254 G1; (0, 0) encodes infinity."""

    p: tuple
    k: int
    r: tuple

    @property
    def trivial(self) -> bool:
        return self.p == (0, 0) or self.k == 0

    def trace(self):
        events: list[MulModEvent] = []
        if self.trivial:
            assert self.r == (0, 0)
            P, k = G1_GEN, 1
        else:
            P, k = self.p, self.k
        curve = _curve_check(events, P)
        a1, T1 = host_add_block(events, P, D_PT, Q_BN)
        setup = dict(curve=curve, a1=a1, T1=T1, wp=P, wk=k)
        acc = D_PT
        walk = []
        tbl = [D_PT, T1]
        for i in range(N_WALK):
            b = (k >> (N_WALK - 1 - i)) & 1
            dcells, Dp = host_dbl_block(events, acc, Q_BN)
            T = tbl[b]
            acells, acc = host_add_block(events, Dp, T, Q_BN)
            walk.append(dict(b=b, tx=T[0], ty=T[1], acc=acc,
                             dbl=dcells, add=acells, T1=T1))
        fcells, Rp = host_add_block(events, acc, NEG_E_PT, Q_BN)
        if not self.trivial:
            assert Rp == self.r, "scalar product mismatch"
        else:
            assert Rp == G1_GEN
        return setup, walk, dict(f=fcells, Rp=Rp), events

    def mulmod_events(self):
        return self.trace()[3]


@dataclasses.dataclass
class EccParams:
    target_adds: int = 0
    target_muls: int = 0


class EccCircuit(Circuit):
    ADD_FLAGS = ("pz", "qz", "opp", "dbl", "gen")

    def __init__(self, add_events: list[EcAddEvent] | None = None,
                 mul_events: list[EcMulEvent] | None = None,
                 params: EccParams | None = None):
        self.add_events = list(add_events or [])
        self.mul_events = list(mul_events or [])
        self.params = params or EccParams()
        self.mm: MulModCircuit | None = None

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, mulmod_table=None):
        self.standalone = mulmod_table is None
        if self.standalone:
            evs: list[MulModEvent] = []
            for ev in self.add_events:
                evs.extend(ev.mulmod_events())
            for ev in self.mul_events:
                evs.extend(ev.mulmod_events())
            self.mm = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.mm.configure(cs)
            mulmod_table = self.mm.mulmod_table

        self.q_add = cs.fixed_column()
        self.q_setup = cs.fixed_column()
        self.q_walk = cs.fixed_column()
        self.q_walk_hi = cs.fixed_column()
        self.q_final = cs.fixed_column()

        pair = lambda: (cs.advice_column(), cs.advice_column())
        self.pairs: dict = {}
        # EcAdd row cells
        for nm in ("apx", "apy", "aqx", "aqy", "arx", "ary"):
            self.pairs[nm] = pair()
        for nm in ADD_CELLS:
            self.pairs["aa_" + nm] = pair()
        for nm in DBL_CELLS:
            self.pairs["ad_" + nm] = pair()
        for nm in ("apc_t6", "apc_t7", "apc_t8", "aqc_t6", "aqc_t7",
                   "aqc_t8"):
            self.pairs[nm] = pair()
        self.add_flags = {f: cs.advice_column() for f in self.ADD_FLAGS}
        # EcMul cells: statement + walk
        for nm in ("mpx", "mpy", "mk", "mrx", "mry", "wpx", "wpy",
                   "t1x", "t1y", "acc_x", "acc_y", "tx", "ty",
                   "mc_t6", "mc_t7", "mc_t8"):
            self.pairs[nm] = pair()
        for nm in ADD_CELLS:
            self.pairs["m1_" + nm] = pair()  # setup: P + D
        for nm in DBL_CELLS:
            self.pairs["md_" + nm] = pair()  # walk double
        for nm in ADD_CELLS:
            self.pairs["mw_" + nm] = pair()  # walk add
        for nm in ADD_CELLS:
            self.pairs["mf_" + nm] = pair()  # final: acc + (-E)
        self.c_b = cs.advice_column()
        self.c_triv = cs.advice_column()
        self.c_tpz = cs.advice_column()  # trivial because P = O
        self.c_tkz = cs.advice_column()  # trivial because k = 0
        self.saccs = {k: cs.advice_column() for k in ("kh", "kl")}

        qa = Fixed(self.q_add)
        qs, qw = Fixed(self.q_setup), Fixed(self.q_walk)
        qh, qf = Fixed(self.q_walk_hi), Fixed(self.q_final)

        def P(name, rot=0):
            lo, hi = self.pairs[name]
            return (Advice(lo, rot), Advice(hi, rot))

        col = MmCollector()
        mm = col.mm

        def curve_rows(gate, Pp, prefix):
            c = lambda nm: P(prefix + nm)
            mm(gate, Pp[0], ONE, QH, Pp[0])
            mm(gate, Pp[1], ONE, QH, Pp[1])
            mm(gate, Pp[0], Pp[0], QH, c("t6"))
            mm(gate, c("t6"), Pp[0], QH, c("t7"))
            mm(gate, c("t7"), THREE, QH, c("t8"), is_add=1)
            mm(gate, Pp[1], Pp[1], QH, c("t8"))

        def pair_eq(gate, name, A, B):
            for half in (0, 1):
                cs.create_gate(
                    f"ecc {name} {half}", gate * (A[half] - B[half])
                )

        def pair_zero(gate, name, A):
            for half in (0, 1):
                cs.create_gate(f"ecc {name} z{half}", gate * A[half])

        # ================= EcAdd rows =====================================
        flags = {f: Advice(c) for f, c in self.add_flags.items()}
        fsum = None
        for f, e in flags.items():
            cs.create_gate(f"ecadd {f} bool", qa * e * (e - 1))
            fsum = e if fsum is None else fsum + e
        cs.create_gate("ecadd one-hot", qa * (fsum - 1))
        pz, qz = flags["pz"], flags["qz"]
        opp, dbl, gen = flags["opp"], flags["dbl"], flags["gen"]
        Pp = (P("apx"), P("apy"))
        Qp = (P("aqx"), P("aqy"))
        Rp = (P("arx"), P("ary"))
        # zero-operand bindings + curve checks for the live operands
        pair_zero(qa * pz, "P inf x", Pp[0])
        pair_zero(qa * pz, "P inf y", Pp[1])
        pair_zero(qa * qz, "Q inf x", Qp[0])
        pair_zero(qa * qz, "Q inf y", Qp[1])
        curve_rows(qa * (1 - pz), Pp, "apc_")
        curve_rows(qa * (1 - pz - qz), Qp, "aqc_")
        # case results
        pair_eq(qa * pz, "R=Q x", Rp[0], Qp[0])
        pair_eq(qa * pz, "R=Q y", Rp[1], Qp[1])
        pair_eq(qa * qz, "R=P x", Rp[0], Pp[0])
        pair_eq(qa * qz, "R=P y", Rp[1], Pp[1])
        # qz excludes pz (P=O, Q=O routes through pz with R=Q=O)
        cs.create_gate("ecadd qz excl", qa * qz * pz)
        g_opp = qa * opp
        pair_eq(g_opp, "opp x", Pp[0], Qp[0])
        mm(g_opp, Pp[1], Qp[1], QH, (0, 0), is_add=1)
        pair_zero(g_opp, "opp R x", Rp[0])
        pair_zero(g_opp, "opp R y", Rp[1])
        g_dbl = qa * dbl
        pair_eq(g_dbl, "dbl px", Pp[0], Qp[0])
        pair_eq(g_dbl, "dbl py", Pp[1], Qp[1])
        dr = emit_dbl_block(col, g_dbl, lambda nm: P("ad_" + nm), Pp, QH)
        pair_eq(g_dbl, "dbl R x", Rp[0], dr[0])
        pair_eq(g_dbl, "dbl R y", Rp[1], dr[1])
        g_gen = qa * gen
        ar = emit_add_block(
            col, g_gen, lambda nm: P("aa_" + nm), Pp, Qp, QH
        )
        pair_eq(g_gen, "gen R x", Rp[0], ar[0])
        pair_eq(g_gen, "gen R y", Rp[1], ar[1])

        # ================= EcMul rows =====================================
        triv = Advice(self.c_triv)
        tpz, tkz = Advice(self.c_tpz), Advice(self.c_tkz)
        cs.create_gate("ecmul triv bool", qs * triv * (triv - 1))
        cs.create_gate("ecmul tpz bool", qs * tpz * (tpz - 1))
        cs.create_gate("ecmul tkz bool", qs * tkz * (tkz - 1))
        # trivial: statement P = O (tpz) or k = 0 (tkz), and R = O.  The
        # walk runs the dummy program (G, k=1) via the wp/sacc muxes
        # below; honesty of the UNSET flags is forced the other way: a
        # non-trivial claim with P = O fails the curve check, k = 0 fails
        # the final add (acc = E would make ddx = 0 there).
        cs.create_gate(
            "ecmul triv or", qs * (triv - tpz - tkz + tpz * tkz)
        )
        GX, GY = halves(G1_GEN[0]), halves(G1_GEN[1])
        Mp = (P("mpx"), P("mpy"))
        Wp = (P("wpx"), P("wpy"))
        for half in (0, 1):
            cs.create_gate(
                f"ecmul wp x mux {half}",
                qs * (Wp[0][half] - triv * GX[half]
                      - (1 - triv) * Mp[0][half]),
            )
            cs.create_gate(
                f"ecmul wp y mux {half}",
                qs * (Wp[1][half] - triv * GY[half]
                      - (1 - triv) * Mp[1][half]),
            )
        g_triv = qs * triv
        pair_zero(qs * tpz, "tpz P x", Mp[0])
        pair_zero(qs * tpz, "tpz P y", Mp[1])
        pair_zero(qs * tkz, "tkz k", P("mk"))
        pair_zero(g_triv, "triv R x", P("mrx"))
        pair_zero(g_triv, "triv R y", P("mry"))
        curve_rows(qs, Wp, "mc_")
        m1 = emit_add_block(
            col, qs, lambda nm: P("m1_" + nm), Wp,
            (halves(D_PT[0]), halves(D_PT[1])), QH,
        )
        pair_eq(qs, "T1 x", P("t1x"), m1[0])
        pair_eq(qs, "T1 y", P("t1y"), m1[1])
        # accumulator + scalar accumulator seeds
        pair_eq(qs, "acc seed x", P("acc_x"),
                (halves(D_PT[0])[0], halves(D_PT[0])[1]))
        pair_eq(qs, "acc seed y", P("acc_y"),
                (halves(D_PT[1])[0], halves(D_PT[1])[1]))
        for c in self.saccs.values():
            cs.create_gate("ecmul sacc seed", qs * Advice(c))

        b = Advice(self.c_b)
        cs.create_gate("ecmul b bool", qw * b * (b - 1))
        for colnm in ("t1x", "t1y", "wpx", "wpy"):
            cur, prev = P(colnm), P(colnm, -1)
            pair_eq(qw, f"{colnm} cont", cur, prev)
        DX, DY = halves(D_PT[0]), halves(D_PT[1])
        for half in (0, 1):
            cs.create_gate(
                f"ecmul tx mux {half}",
                qw * (P("tx")[half] - (1 - b) * DX[half]
                      - b * P("t1x")[half]),
            )
            cs.create_gate(
                f"ecmul ty mux {half}",
                qw * (P("ty")[half] - (1 - b) * DY[half]
                      - b * P("t1y")[half]),
            )
        dxy = emit_dbl_block(
            col, qw, lambda nm: P("md_" + nm),
            (P("acc_x", -1), P("acc_y", -1)), QH,
        )
        wr = emit_add_block(
            col, qw, lambda nm: P("mw_" + nm), dxy, (P("tx"), P("ty")), QH
        )
        pair_eq(qw, "acc step x", P("acc_x"), wr[0])
        pair_eq(qw, "acc step y", P("acc_y"), wr[1])
        kh_c, kl_c = self.saccs["kh"], self.saccs["kl"]
        kh, kh_p = Advice(kh_c), Advice(kh_c, -1)
        kl, kl_p = Advice(kl_c), Advice(kl_c, -1)
        cs.create_gate("ecmul kh walk", qw * qh * (kh - 2 * kh_p - b))
        cs.create_gate("ecmul kl hold", qw * qh * (kl - kl_p))
        cs.create_gate("ecmul kl walk", qw * (1 - qh) * (kl - 2 * kl_p - b))
        cs.create_gate("ecmul kh hold", qw * (1 - qh) * (kh - kh_p))

        back = -(EV_ROWS - 1)
        fres = emit_add_block(
            col, qf, lambda nm: P("mf_" + nm),
            (P("acc_x", -1), P("acc_y", -1)),
            (halves(NEG_E_PT[0]), halves(NEG_E_PT[1])), QH,
        )
        triv_b = Advice(self.c_triv, back)
        # scalar binding: the walked bits equal k (or the dummy scalar 1)
        kstmt = P("mk", back)
        cs.create_gate(
            "ecmul k bind lo",
            qf * (Advice(kl_c, -1)
                  - (1 - triv_b) * kstmt[0] - triv_b * 1),
        )
        cs.create_gate(
            "ecmul k bind hi", qf * (Advice(kh_c, -1)
                                     - (1 - triv_b) * kstmt[1]),
        )
        # result binding (non-trivial): R = walk result
        for half in (0, 1):
            cs.create_gate(
                f"ecmul R x bind {half}",
                qf * (1 - triv_b) * (P("mrx", back)[half] - fres[0][half]),
            )
            cs.create_gate(
                f"ecmul R y bind {half}",
                qf * (1 - triv_b) * (P("mry", back)[half] - fres[1][half]),
            )

        cs.lookup_logup("ecc mulmod ops", col.inputs, mulmod_table)

        # ---- exposed EccTable -------------------------------------------
        self.ecc_table = [
            qa + qs,
            qa * TAG_ADD + qs * TAG_MUL,
        ]

        def stmt(add_name, mul_name):
            out = []
            for half in (0, 1):
                out.append(
                    qa * P(add_name)[half] + qs * P(mul_name)[half]
                )
            return out

        self.ecc_table += stmt("apx", "mpx")
        self.ecc_table += stmt("apy", "mpy")
        self.ecc_table += stmt("aqx", "mk")
        self.ecc_table += [qa * P("aqy")[0], qa * P("aqy")[1]]
        self.ecc_table += stmt("arx", "mrx")
        self.ecc_table += stmt("ary", "mry")

    # ------------------------------------------------------------------
    def _targets(self, n: int):
        ta = self.params.target_adds or len(self.add_events)
        tm = self.params.target_muls or len(self.mul_events)
        assert len(self.add_events) <= ta and len(self.mul_events) <= tm
        assert ta + tm * EV_ROWS <= usable_rows(n)
        return ta, tm

    def fixed_columns(self, n: int):
        ta, tm = self._targets(n)
        mont = F.mont_from_ints
        qa = [1 if i < ta else 0 for i in range(n)]
        qs = [0] * n
        qw = [0] * n
        qh = [0] * n
        qf = [0] * n
        for e in range(tm):
            base = ta + e * EV_ROWS
            qs[base] = 1
            for i in range(N_WALK):
                qw[base + 1 + i] = 1
                if i < 128:
                    qh[base + 1 + i] = 1
            qf[base + 1 + N_WALK] = 1
        out = {
            self.q_add: mont(qa), self.q_setup: mont(qs),
            self.q_walk: mont(qw), self.q_walk_hi: mont(qh),
            self.q_final: mont(qf),
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
        ta, tm = self._targets(n)
        nrows = ta + tm * EV_ROWS
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        pairs_v = {k: [(0, 0)] * nrows for k in self.pairs}
        singles = {c: [0] * nrows for c in (
            [self.c_b, self.c_triv, self.c_tpz, self.c_tkz]
            + list(self.saccs.values())
            + list(self.add_flags.values())
        )}
        # padding EcAdd rows: all-zero = the pz case with Q = R = O...
        # pz flag must then be 1: set flag defaults for pad rows
        for i in range(len(self.add_events), ta):
            singles[self.add_flags["pz"]][i] = 1
        add_evs = list(self.add_events)
        for i, ev in enumerate(add_evs):
            case, cells, _ = ev.trace()
            singles[self.add_flags[case]][i] = 1
            pairs_v["apx"][i] = halves(ev.p[0])
            pairs_v["apy"][i] = halves(ev.p[1])
            pairs_v["aqx"][i] = halves(ev.q[0])
            pairs_v["aqy"][i] = halves(ev.q[1])
            pairs_v["arx"][i] = halves(ev.r[0])
            pairs_v["ary"][i] = halves(ev.r[1])
            for key, pref in (("pcurve", "apc_"), ("qcurve", "aqc_")):
                if key in cells:
                    for nm in ("t6", "t7", "t8"):
                        pairs_v[pref + nm][i] = halves(cells[key][nm])
            if "dbl" in cells:
                for nm in DBL_CELLS:
                    pairs_v["ad_" + nm][i] = halves(cells["dbl"][nm])
            if "add" in cells:
                for nm in ADD_CELLS:
                    pairs_v["aa_" + nm][i] = halves(cells["add"][nm])

        mul_evs = list(self.mul_events)
        if len(mul_evs) < tm:
            mul_evs += [EcMulEvent(p=(0, 0), k=0, r=(0, 0))] * (
                tm - len(mul_evs)
            )
        for e, ev in enumerate(mul_evs):
            setup, walk, final, _ = ev.trace()
            base = ta + e * EV_ROWS
            pairs_v["mpx"][base] = halves(ev.p[0])
            pairs_v["mpy"][base] = halves(ev.p[1])
            pairs_v["mk"][base] = halves(ev.k)
            pairs_v["mrx"][base] = halves(ev.r[0])
            pairs_v["mry"][base] = halves(ev.r[1])
            singles[self.c_triv][base] = int(ev.trivial)
            singles[self.c_tpz][base] = int(ev.p == (0, 0))
            singles[self.c_tkz][base] = int(ev.k == 0)
            wp, wk = setup["wp"], setup["wk"]
            pairs_v["wpx"][base] = halves(wp[0])
            pairs_v["wpy"][base] = halves(wp[1])
            for nm in ("t6", "t7", "t8"):
                pairs_v["mc_" + nm][base] = halves(setup["curve"][nm])
            for nm in ADD_CELLS:
                pairs_v["m1_" + nm][base] = halves(setup["a1"][nm])
            pairs_v["t1x"][base] = halves(setup["T1"][0])
            pairs_v["t1y"][base] = halves(setup["T1"][1])
            pairs_v["acc_x"][base] = halves(D_PT[0])
            pairs_v["acc_y"][base] = halves(D_PT[1])
            kh = kl = 0
            for i, wrow in enumerate(walk):
                rix = base + 1 + i
                for nm in DBL_CELLS:
                    pairs_v["md_" + nm][rix] = halves(wrow["dbl"][nm])
                for nm in ADD_CELLS:
                    pairs_v["mw_" + nm][rix] = halves(wrow["add"][nm])
                pairs_v["tx"][rix] = halves(wrow["tx"])
                pairs_v["ty"][rix] = halves(wrow["ty"])
                pairs_v["acc_x"][rix] = halves(wrow["acc"][0])
                pairs_v["acc_y"][rix] = halves(wrow["acc"][1])
                pairs_v["t1x"][rix] = halves(setup["T1"][0])
                pairs_v["t1y"][rix] = halves(setup["T1"][1])
                pairs_v["wpx"][rix] = halves(wp[0])
                pairs_v["wpy"][rix] = halves(wp[1])
                singles[self.c_b][rix] = wrow["b"]
                if i < 128:
                    kh = 2 * kh + wrow["b"]
                else:
                    kl = 2 * kl + wrow["b"]
                singles[self.saccs["kh"]][rix] = kh
                singles[self.saccs["kl"]][rix] = kl
            frow = base + 1 + N_WALK
            for nm in ADD_CELLS:
                pairs_v["mf_" + nm][frow] = halves(final["f"][nm])

        for name, (clo, chi) in self.pairs.items():
            out[clo] = mont([v[0] for v in pairs_v[name]])
            out[chi] = mont([v[1] for v in pairs_v[name]])
        for c, vals in singles.items():
            out[c] = mont(vals)
        return out
