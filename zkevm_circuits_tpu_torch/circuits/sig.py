"""Sig circuit — ECDSA secp256k1 verification + address recovery.

Equivalent of the reference's `zkevm-circuits/src/sig_circuit.rs`
(SURVEY.md §2.2 "Sig"), which verifies tx signatures with halo2-ecc's
CRT big-int `EccChip`.  This build proves ECDSA with a different
decomposition: every modular operation (mod the secp256k1 base field p
AND group order n) is ONE row of the shared MulMod circuit
(circuits/mulmod.py), and the Sig circuit is a fixed-geometry
orchestrator whose gates wire those rows together:

    statement  (z, r, s, Q)  with  address = keccak(Qx ‖ Qy)[12:]
    verify     w = s^-1 mod n;  u1 = z*w mod n;  u2 = r*w mod n
               R' = u1*G + u2*Q;   R'.x mod n == r
    on-curve   Qy^2 = Qx^3 + 7 mod p  (plus canonicity Qx, Qy < p)

The double scalar multiplication runs Shamir's trick with a DUMMY-POINT
OFFSET so the accumulator never touches infinity and the program is
branch-free: with T0=D, T1=G+D, T2=Q+D, T3=G+Q+D and acc starting at D,

    acc_i+1 = 2*acc_i + T[2*u2_bit + u1_bit]        (bits MSB-first)
    acc_256 = u1*G + u2*Q + (2^257 - 1)*D
    R'      = acc_256 + (-(2^257 - 1)*D)            (constant point)

Affine add/double formulas use witnessed slopes lambda with an inverse
witness proving x1 != x2 (no unsound degenerate cases; coincidences
make the proof fail, never forge).  Event geometry is FIXED: 258 rows
(setup, 256 walk rows, final) so every role is a static fixed column
and witness fill is columnar.

Cites: reference sig_circuit.rs:32-44 (halo2-ecc CRT chips),
table.rs:2455 (SigTable), tx_circuit sign-hash binding.

Port of zkevm_circuits_tpu/circuits/sig.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..crypto.keccak import keccak256
from ..crypto.secp256k1 import G as G_PT, N as N_SECP, P as P_SECP, _add, _inv, _mul
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Expression, Fixed
from .mulmod import MulModCircuit, MulModEvent, MulModParams

F = fr()

M128 = (1 << 128) - 1
EV_ROWS = 258
N_WALK = 256

# dummy-point offset: D = k_D * G (k_D arbitrary public constant); the
# walk's constant surplus (2^257 - 1) * D is subtracted at the end.
K_D = 0xD00DFEED0BADF00D5EED
D_PT = _mul(G_PT, K_D)
T1_PT = _add(G_PT, D_PT)
E_PT = _mul(D_PT, (1 << 257) - 1)
NEG_E_PT = (E_PT[0], P_SECP - E_PT[1])


def _h(v: int) -> tuple[int, int]:
    return (v & M128, v >> 128)


ONE = (1, 0)
SEVEN = (7, 0)
PH = _h(P_SECP)
NH = _h(N_SECP)


# ---------------------------------------------------------------------------
# host-side block simulators: mirror the in-circuit op order, returning
# the cell values each block's constraints expect + the MulModEvents
# ---------------------------------------------------------------------------
def _ev_mul(events, a, b, n, r):
    events.append(MulModEvent(a=a, b=b, n=n, r=r))


def _ev_add(events, a, b, n, r):
    events.append(MulModEvent(a=a, b=b, n=n, r=r, is_add=True))


def _h_add_block(events, P, Q):
    """P + Q (affine, x1 != x2).  Returns (cells, (x3, y3))."""
    p = P_SECP
    ddx = (Q[0] - P[0]) % p
    dinv = _inv(ddx, p)
    dyd = (Q[1] - P[1]) % p
    lam = dyd * dinv % p
    s2 = lam * lam % p
    x3 = (s2 - P[0] - Q[0]) % p
    au = (x3 + P[0]) % p
    d3 = (P[0] - x3) % p
    t5 = lam * d3 % p
    y3 = (t5 - P[1]) % p
    _ev_add(events, ddx, P[0], p, Q[0])
    _ev_mul(events, dinv, ddx, p, 1)
    _ev_add(events, dyd, P[1], p, Q[1])
    _ev_mul(events, lam, ddx, p, dyd)
    _ev_mul(events, lam, lam, p, s2)
    _ev_add(events, x3, P[0], p, au)
    _ev_add(events, au, Q[0], p, s2)
    _ev_add(events, d3, x3, p, P[0])
    _ev_mul(events, lam, d3, p, t5)
    _ev_add(events, y3, P[1], p, t5)
    cells = dict(ddx=ddx, dinv=dinv, dyd=dyd, lama=lam, s2=s2, au=au,
                 d3=d3, t5=t5, rx=x3, ry=y3)
    return cells, (x3, y3)


def _h_dbl_block(events, P):
    p = P_SECP
    t1 = P[0] * P[0] % p
    t2 = 2 * t1 % p
    t3 = 3 * t1 % p
    w2 = 2 * P[1] % p
    lam = t3 * _inv(w2, p) % p
    s1 = lam * lam % p
    dx = (s1 - 2 * P[0]) % p
    du = (dx + P[0]) % p
    d2 = (P[0] - dx) % p
    t4 = lam * d2 % p
    dy = (t4 - P[1]) % p
    _ev_mul(events, P[0], P[0], p, t1)
    _ev_add(events, t1, t1, p, t2)
    _ev_add(events, t2, t1, p, t3)
    _ev_add(events, P[1], P[1], p, w2)
    _ev_mul(events, lam, w2, p, t3)
    _ev_mul(events, lam, lam, p, s1)
    _ev_add(events, dx, P[0], p, du)
    _ev_add(events, du, P[0], p, s1)
    _ev_add(events, d2, dx, p, P[0])
    _ev_mul(events, lam, d2, p, t4)
    _ev_add(events, dy, P[1], p, t4)
    cells = dict(t1=t1, t2=t2, t3=t3, w2=w2, lamd=lam, s1=s1, du=du,
                 d2=d2, t4=t4, dx=dx, dy=dy)
    return cells, (dx, dy)


@dataclasses.dataclass
class SigEvent:
    """One verified signature: (z, r, s) under pubkey Q."""

    msg_hash: int
    r: int
    s: int
    pubkey: tuple  # (x, y) affine ints

    @property
    def address(self) -> int:
        pb = self.pubkey[0].to_bytes(32, "big") \
            + self.pubkey[1].to_bytes(32, "big")
        return int.from_bytes(keccak256(pb)[12:], "big")

    def pubkey_bytes(self) -> bytes:
        return self.pubkey[0].to_bytes(32, "big") \
            + self.pubkey[1].to_bytes(32, "big")

    def trace(self):
        """Simulate; returns (setup_cells, walk_rows, final_cells,
        mulmod_events).  Raises if the signature is invalid."""
        p, n = P_SECP, N_SECP
        z, r, s, Q = self.msg_hash, self.r, self.s, self.pubkey
        events: list[MulModEvent] = []
        w = _inv(s, n)
        u1 = z * w % n
        u2 = r * w % n
        _ev_mul(events, w, s, n, 1)
        _ev_mul(events, z, w, n, u1)
        _ev_mul(events, r, w, n, u2)
        # Q canonicity + on-curve
        t6 = Q[0] * Q[0] % p
        t7 = t6 * Q[0] % p
        t8 = (t7 + 7) % p
        assert Q[1] * Q[1] % p == t8, "pubkey not on curve"
        _ev_mul(events, Q[0], 1, p, Q[0])
        _ev_mul(events, Q[1], 1, p, Q[1])
        _ev_mul(events, Q[0], Q[0], p, t6)
        _ev_mul(events, t6, Q[0], p, t7)
        _ev_add(events, t7, 7, p, t8)
        _ev_mul(events, Q[1], Q[1], p, t8)
        a1, T2 = _h_add_block(events, Q, D_PT)
        a2, T3 = _h_add_block(events, G_PT, T2)
        setup = dict(z=z, rr=r, ss=s, w=w, u1=u1, u2=u2, qx=Q[0], qy=Q[1],
                     t6=t6, t7=t7, t8=t8, T2=T2, T3=T3, a1=a1, a2=a2)
        tbl = [D_PT, T1_PT, T2, T3]
        acc = D_PT
        walk = []
        for i in range(N_WALK):
            bit = N_WALK - 1 - i
            b1 = (u1 >> bit) & 1
            b2 = (u2 >> bit) & 1
            dcells, Dp = _h_dbl_block(events, acc)
            T = tbl[b1 + 2 * b2]
            acells, acc = _h_add_block(events, Dp, T)
            walk.append(dict(b1=b1, b2=b2, tx=T[0], ty=T[1], acc=acc,
                             dbl=dcells, add=acells, T2=T2, T3=T3))
        fcells, Rp = _h_add_block(events, acc, NEG_E_PT)
        assert Rp[0] % n == r, "signature does not verify"
        _ev_mul(events, Rp[0], 1, n, r)
        final = dict(f=fcells)
        return setup, walk, final, events

    def mulmod_events(self) -> list[MulModEvent]:
        return self.trace()[3]


@dataclasses.dataclass
class SigParams:
    target_events: int = 0  # 0 => exact event count


class SigCircuit(Circuit):
    # cell-pair names by role
    DBL = ("t1", "t2", "t3", "w2", "lamd", "s1", "du", "d2", "t4", "dx", "dy")
    ADD = ("ddx", "dinv", "dyd", "lama", "s2", "au", "d3", "t5", "rx", "ry")
    SETUP = ("z", "rr", "ss", "w", "u1", "u2", "qx", "qy", "t6", "t7", "t8")

    def __init__(self, events: list[SigEvent],
                 params: SigParams | None = None):
        self.events = list(events)
        self.params = params or SigParams()
        self.mm: MulModCircuit | None = None
        self.kc = None  # standalone-mode internal keccak

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, mulmod_table=None,
                  keccak_table=None, challenge=None, byte_table=None):
        self.r_word = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )
        self.standalone = mulmod_table is None
        if self.standalone:
            evs: list[MulModEvent] = []
            for ev in self.events:
                evs.extend(ev.mulmod_events())
            self.mm = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.mm.configure(cs)
            mulmod_table = self.mm.mulmod_table
            byte_table = [Fixed(self.mm.tbl_byte)]
            if keccak_table is None:
                from .keccak import KeccakCircuit

                self.kc = KeccakCircuit(
                    [ev.pubkey_bytes() for ev in self.events]
                )
                self.kc.configure(cs, challenge=self.r_word)
                keccak_table = self.kc.keccak_table_exprs()
        assert byte_table is not None

        self.q_setup = cs.fixed_column()
        self.q_walk = cs.fixed_column()
        self.q_walk_hi = cs.fixed_column()  # first 128 walk rows
        self.q_final = cs.fixed_column()

        pair = lambda: (cs.advice_column(), cs.advice_column())
        self.pairs: dict = {}
        for name in self.SETUP:
            self.pairs[name] = pair()
        for name in self.DBL:
            self.pairs["d_" + name] = pair()
        for name in self.ADD:
            self.pairs["w_" + name] = pair()  # walk add block
        for name in self.ADD:
            self.pairs["a1_" + name] = pair()  # setup: Q + D
        for name in self.ADD:
            self.pairs["a2_" + name] = pair()  # setup: G + T2
        for name in self.ADD:
            self.pairs["f_" + name] = pair()  # final: acc + (-E)
        for name in ("acc_x", "acc_y", "tx", "ty", "t2x", "t2y",
                     "t3x", "t3y"):
            self.pairs[name] = pair()
        self.c_b1 = cs.advice_column()
        self.c_b2 = cs.advice_column()
        self.saccs = {
            k: cs.advice_column() for k in ("u1h", "u1l", "u2h", "u2l")
        }
        self.c_pb = [cs.advice_column() for _ in range(64)]  # pubkey bytes
        self.c_db = [cs.advice_column() for _ in range(32)]  # digest bytes
        # statement bytes (BE) for the SigTable's RLC encodings
        self.c_zb = [cs.advice_column() for _ in range(32)]
        self.c_rb = [cs.advice_column() for _ in range(32)]
        self.c_sb = [cs.advice_column() for _ in range(32)]
        self.c_rp = [cs.advice_column(phase=1) for _ in range(10)]

        qs, qw = Fixed(self.q_setup), Fixed(self.q_walk)
        qh, qf = Fixed(self.q_walk_hi), Fixed(self.q_final)

        def P(name, rot=0):
            lo, hi = self.pairs[name]
            return (Advice(lo, rot), Advice(hi, rot))

        mm_inputs: list = []

        def mm(gate, a, b, n, r, is_add=0):
            mm_inputs.append([
                gate, gate * is_add, gate * a[0], gate * a[1],
                gate * b[0], gate * b[1], gate * n[0], gate * n[1],
                gate * r[0], gate * r[1],
            ])

        def add_block(gate, prefix, Pp, Qp):
            """Emit the 10 ops of P + Q -> (rx, ry) cells."""
            c = lambda nm, rot=0: P(prefix + nm, rot)
            mm(gate, c("ddx"), Pp[0], PH, Qp[0], is_add=1)
            mm(gate, c("dinv"), c("ddx"), PH, ONE)
            mm(gate, c("dyd"), Pp[1], PH, Qp[1], is_add=1)
            mm(gate, c("lama"), c("ddx"), PH, c("dyd"))
            mm(gate, c("lama"), c("lama"), PH, c("s2"))
            mm(gate, c("rx"), Pp[0], PH, c("au"), is_add=1)
            mm(gate, c("au"), Qp[0], PH, c("s2"), is_add=1)
            mm(gate, c("d3"), c("rx"), PH, Pp[0], is_add=1)
            mm(gate, c("lama"), c("d3"), PH, c("t5"))
            mm(gate, c("ry"), Pp[1], PH, c("t5"), is_add=1)
            return c("rx"), c("ry")

        def dbl_block(gate, Pp):
            c = lambda nm: P("d_" + nm)
            mm(gate, Pp[0], Pp[0], PH, c("t1"))
            mm(gate, c("t1"), c("t1"), PH, c("t2"), is_add=1)
            mm(gate, c("t2"), c("t1"), PH, c("t3"), is_add=1)
            mm(gate, Pp[1], Pp[1], PH, c("w2"), is_add=1)
            mm(gate, c("lamd"), c("w2"), PH, c("t3"))
            mm(gate, c("lamd"), c("lamd"), PH, c("s1"))
            mm(gate, c("dx"), Pp[0], PH, c("du"), is_add=1)
            mm(gate, c("du"), Pp[0], PH, c("s1"), is_add=1)
            mm(gate, c("d2"), c("dx"), PH, Pp[0], is_add=1)
            mm(gate, c("lamd"), c("d2"), PH, c("t4"))
            mm(gate, c("dy"), Pp[1], PH, c("t4"), is_add=1)
            return c("dx"), c("dy")

        # ---- setup row ----------------------------------------------------
        mm(qs, P("w"), P("ss"), NH, ONE)
        mm(qs, P("z"), P("w"), NH, P("u1"))
        mm(qs, P("rr"), P("w"), NH, P("u2"))
        mm(qs, P("qx"), ONE, PH, P("qx"))  # canonicity qx < p
        mm(qs, P("qy"), ONE, PH, P("qy"))
        mm(qs, P("qx"), P("qx"), PH, P("t6"))
        mm(qs, P("t6"), P("qx"), PH, P("t7"))
        mm(qs, P("t7"), SEVEN, PH, P("t8"), is_add=1)
        mm(qs, P("qy"), P("qy"), PH, P("t8"))
        rx1, ry1 = add_block(qs, "a1_", (P("qx"), P("qy")), (_h(D_PT[0]), _h(D_PT[1])))
        # T2 column holds the block result on the setup row
        for (res, col) in ((rx1, "t2x"), (ry1, "t2y")):
            cur = P(col)
            cs.create_gate(f"sig {col} bind lo", qs * (cur[0] - res[0]))
            cs.create_gate(f"sig {col} bind hi", qs * (cur[1] - res[1]))
        rx2, ry2 = add_block(
            qs, "a2_", (_h(G_PT[0]), _h(G_PT[1])), (P("t2x"), P("t2y"))
        )
        for (res, col) in ((rx2, "t3x"), (ry2, "t3y")):
            cur = P(col)
            cs.create_gate(f"sig {col} bind lo", qs * (cur[0] - res[0]))
            cs.create_gate(f"sig {col} bind hi", qs * (cur[1] - res[1]))
        # accumulator boundary: acc = D, scalar accumulators = 0
        for col, const in (("acc_x", _h(D_PT[0])), ("acc_y", _h(D_PT[1]))):
            cur = P(col)
            cs.create_gate(f"sig {col} seed lo", qs * (cur[0] - const[0]))
            cs.create_gate(f"sig {col} seed hi", qs * (cur[1] - const[1]))
        for k, colc in self.saccs.items():
            cs.create_gate(f"sig sacc {k} seed", qs * Advice(colc))

        # ---- walk rows ----------------------------------------------------
        b1, b2 = Advice(self.c_b1), Advice(self.c_b2)
        cs.create_gate("sig b1 bool", qw * b1 * (b1 - 1))
        cs.create_gate("sig b2 bool", qw * b2 * (b2 - 1))
        # T2/T3 continuity down the walk
        for col in ("t2x", "t2y", "t3x", "t3y"):
            cur, prev = P(col), P(col, -1)
            cs.create_gate(f"sig {col} cont lo", qw * (cur[0] - prev[0]))
            cs.create_gate(f"sig {col} cont hi", qw * (cur[1] - prev[1]))
        # multiplexed table point
        f0 = (1 - b1) * (1 - b2)
        f1 = b1 * (1 - b2)
        f2 = (1 - b1) * b2
        f3 = b1 * b2
        DX, DY = _h(D_PT[0]), _h(D_PT[1])
        T1X, T1Y = _h(T1_PT[0]), _h(T1_PT[1])
        for half in (0, 1):
            tx_e = (f0 * DX[half] + f1 * T1X[half]
                    + f2 * P("t2x")[half] + f3 * P("t3x")[half])
            ty_e = (f0 * DY[half] + f1 * T1Y[half]
                    + f2 * P("t2y")[half] + f3 * P("t3y")[half])
            cs.create_gate(f"sig tx mux {half}", qw * (P("tx")[half] - tx_e))
            cs.create_gate(f"sig ty mux {half}", qw * (P("ty")[half] - ty_e))
        # double the previous accumulator, add the table point
        dxy = dbl_block(qw, (P("acc_x", -1), P("acc_y", -1)))
        rxw, ryw = add_block(qw, "w_", dxy, (P("tx"), P("ty")))
        for (res, col) in ((rxw, "acc_x"), (ryw, "acc_y")):
            cur = P(col)
            cs.create_gate(f"sig {col} step lo", qw * (cur[0] - res[0]))
            cs.create_gate(f"sig {col} step hi", qw * (cur[1] - res[1]))
        # scalar-bit accumulators (hi half first)
        for bit_e, hi_k, lo_k in ((b1, "u1h", "u1l"), (b2, "u2h", "u2l")):
            hi_c, lo_c = self.saccs[hi_k], self.saccs[lo_k]
            hi, hi_p = Advice(hi_c), Advice(hi_c, -1)
            lo, lo_p = Advice(lo_c), Advice(lo_c, -1)
            cs.create_gate(
                f"sig {hi_k} walk", qw * qh * (hi - 2 * hi_p - bit_e)
            )
            cs.create_gate(f"sig {lo_k} hold", qw * qh * (lo - lo_p))
            cs.create_gate(
                f"sig {lo_k} walk", qw * (1 - qh) * (lo - 2 * lo_p - bit_e)
            )
            cs.create_gate(f"sig {hi_k} hold", qw * (1 - qh) * (hi - hi_p))

        # ---- final row ----------------------------------------------------
        back = -(EV_ROWS - 1)  # rotation from the final row to its setup row
        fr_, fy = add_block(
            qf, "f_", (P("acc_x", -1), P("acc_y", -1)),
            (_h(NEG_E_PT[0]), _h(NEG_E_PT[1])),
        )
        # R'.x mod n == statement r
        mm(qf, fr_, ONE, NH, P("rr", back))
        # scalar accumulators equal u1/u2
        for hi_k, lo_k, name in (("u1h", "u1l", "u1"), ("u2h", "u2l", "u2")):
            u = P(name, back)
            cs.create_gate(
                f"sig {name} bind lo",
                qf * (Advice(self.saccs[lo_k], -1) - u[0]),
            )
            cs.create_gate(
                f"sig {name} bind hi",
                qf * (Advice(self.saccs[hi_k], -1) - u[1]),
            )
        # pubkey byte decomposition (BE): bytes 0..31 = Qx, 32..63 = Qy
        pb = [Advice(c) for c in self.c_pb]
        for name, base in (("qx", 0), ("qy", 32)):
            u = P(name, back)
            for half, off in ((1, 0), (0, 16)):
                e = None
                for i in range(16):
                    term = pb[base + off + i] * (1 << (8 * (15 - i)))
                    e = term if e is None else e + term
                cs.create_gate(
                    f"sig {name} bytes {half}", qf * (u[half] - e)
                )
        # statement byte decompositions (z, r, s) for the RLC exposures
        stmt_bytes = {}
        for name, cols in (("z", self.c_zb), ("rr", self.c_rb),
                           ("ss", self.c_sb)):
            bs = [Advice(c) for c in cols]
            stmt_bytes[name] = bs
            u = P(name, back)
            for half, off in ((1, 0), (0, 16)):
                e = None
                for i in range(16):
                    term = bs[off + i] * (1 << (8 * (15 - i)))
                    e = term if e is None else e + term
                cs.create_gate(
                    f"sig stmt {name} bytes {half}", qf * (u[half] - e)
                )
        # challenge-power chain: r^2,4,8,16,32,64 then r^68, r^70, r^71,
        # r^72 — the keccak pad bridge for the fixed 64-byte message
        rp = [Advice(c) for c in self.c_rp]
        r_ = self.r_word
        chain = [
            (rp[0], r_ * r_), (rp[1], rp[0] * rp[0]),
            (rp[2], rp[1] * rp[1]), (rp[3], rp[2] * rp[2]),
            (rp[4], rp[3] * rp[3]), (rp[5], rp[4] * rp[4]),
            (rp[6], rp[5] * rp[1]), (rp[7], rp[6] * rp[0]),
            (rp[8], rp[7] * r_), (rp[9], rp[8] * r_),
        ]
        for i, (cell, expr) in enumerate(chain):
            cs.create_gate(f"sig rp {i}", qf * (cell - expr))
        acc64 = None
        for j in range(64):
            acc64 = pb[j] if acc64 is None else acc64 * r_ + pb[j]
        acc_pad = acc64 * rp[9] + rp[8] + 128  # pad_rlc(72) = r^71 + 0x80
        db = [Advice(c) for c in self.c_db]
        out_rlc = None
        rpow = None
        for i in range(32):
            term = db[i] if i == 0 else db[i] * rpow
            out_rlc = term if out_rlc is None else out_rlc + term
            rpow = r_ if rpow is None else rpow * r_
        cs.lookup_logup(
            "sig keccak address",
            [[qf, qf * acc_pad, qf * out_rlc]],
            keccak_table,
        )
        all_bytes = pb + db + [b for bs in stmt_bytes.values() for b in bs]
        cs.lookup_logup(
            "sig byte ranges", [[qf * c] for c in all_bytes], byte_table
        )
        addr_e = None
        for j in range(20):
            term = db[12 + j] * (1 << (8 * (19 - j)))
            addr_e = term if addr_e is None else addr_e + term
        self._addr_expr = addr_e

        cs.lookup_logup("sig mulmod ops", mm_inputs, mulmod_table)

        # ---- exposed SigTable (on setup rows; reference table.rs:2455):
        # (enable, msg_hash_rlc [digest fold, matching the RlpCircuit's
        # sign-hash convention], sig_r_rlc, sig_s_rlc [word RLCs, matching
        # the TxTable SigR/SigS values], recovered address raw) ----------
        fwd = EV_ROWS - 1  # setup -> final rotation
        addr_fwd = None
        for j in range(20):
            term = Advice(self.c_db[12 + j], fwd) * (1 << (8 * (19 - j)))
            addr_fwd = term if addr_fwd is None else addr_fwd + term
        z_rlc = None
        rpow = None
        for i in range(32):  # digest fold: BE byte i takes r^i
            b_ = Advice(self.c_zb[i], fwd)
            term = b_ if i == 0 else b_ * rpow
            z_rlc = term if z_rlc is None else z_rlc + term
            rpow = r_ if rpow is None else rpow * r_
        def word_fold(cols):  # word RLC: LE byte j (= BE byte 31-j) * r^j
            e = None
            rp_ = None
            for j in range(32):
                b_ = Advice(cols[31 - j], fwd)
                term = b_ if j == 0 else b_ * rp_
                e = term if e is None else e + term
                rp_ = r_ if rp_ is None else rp_ * r_
            return e
        self.sig_table = [
            qs, qs * z_rlc,
            qs * word_fold(self.c_rb), qs * word_fold(self.c_sb),
            qs * addr_fwd,
        ]

    # ------------------------------------------------------------------
    def _target(self, n: int) -> int:
        t = self.params.target_events or len(self.events)
        assert len(self.events) <= t
        assert t * EV_ROWS <= usable_rows(n), "domain too small for events"
        return t

    def fixed_columns(self, n: int):
        t = self._target(n)
        mont = F.mont_from_ints
        qs = [0] * n
        qw = [0] * n
        qh = [0] * n
        qf = [0] * n
        for e in range(t):
            base = e * EV_ROWS
            qs[base] = 1
            for i in range(N_WALK):
                qw[base + 1 + i] = 1
                if i < 128:
                    qh[base + 1 + i] = 1
            qf[base + 1 + N_WALK] = 1
        out = {
            self.q_setup: mont(qs), self.q_walk: mont(qw),
            self.q_walk_hi: mont(qh), self.q_final: mont(qf),
        }
        if self.mm is not None:
            out.update(self.mm.fixed_columns(n))
        if self.kc is not None:
            out.update(self.kc.fixed_columns(n))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        out = {}
        if self.mm is not None:
            out.update(self.mm.synthesize(phase, n, challenges, instances))
        if self.kc is not None:
            out.update(self.kc.synthesize(phase, n, challenges, instances))
        t = self._target(n)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        if phase != 0:
            # challenge-power chain on final rows
            r_chal = challenges[self.r_word.index]
            r_int = F.to_int(F.from_mont(r_chal))
            exps = [2, 4, 8, 16, 32, 64, 68, 70, 71, 72]
            cols = {c: [0] * (t * EV_ROWS) for c in self.c_rp}
            for e in range(t):
                frow = e * EV_ROWS + 1 + N_WALK
                for ci, c in enumerate(self.c_rp):
                    cols[c][frow] = pow(r_int, exps[ci], R)
            out.update({c: mont(v) for c, v in cols.items()})
            return out

        nrows = t * EV_ROWS
        pairs_v = {k: [(0, 0)] * nrows for k in self.pairs}
        singles = {
            self.c_b1: [0] * nrows, self.c_b2: [0] * nrows,
        }
        for c in (list(self.saccs.values()) + self.c_pb + self.c_db
                  + self.c_zb + self.c_rb + self.c_sb):
            singles[c] = [0] * nrows

        # padding events keep every role row all-zero: zero rows satisfy
        # the walk/setup/final gates?  They do NOT (seeds/mux reference
        # curve constants), so pad events replay a FIXED dummy signature.
        events = list(self.events)
        if len(events) < t:
            events = events + [_dummy_event()] * (t - len(events))

        for e, ev in enumerate(events):
            setup, walk, final, _ = ev.trace()
            base = e * EV_ROWS
            for name in self.SETUP:
                pairs_v[name][base] = _h(setup[name])
            for name in self.ADD:
                pairs_v["a1_" + name][base] = _h(setup["a1"][name])
                pairs_v["a2_" + name][base] = _h(setup["a2"][name])
            pairs_v["t2x"][base] = _h(setup["T2"][0])
            pairs_v["t2y"][base] = _h(setup["T2"][1])
            pairs_v["t3x"][base] = _h(setup["T3"][0])
            pairs_v["t3y"][base] = _h(setup["T3"][1])
            pairs_v["acc_x"][base] = _h(D_PT[0])
            pairs_v["acc_y"][base] = _h(D_PT[1])
            u1h = u1l = u2h = u2l = 0
            for i, wrow in enumerate(walk):
                rix = base + 1 + i
                for name in self.DBL:
                    pairs_v["d_" + name][rix] = _h(wrow["dbl"][name])
                for name in self.ADD:
                    pairs_v["w_" + name][rix] = _h(wrow["add"][name])
                pairs_v["tx"][rix] = _h(wrow["tx"])
                pairs_v["ty"][rix] = _h(wrow["ty"])
                pairs_v["acc_x"][rix] = _h(wrow["acc"][0])
                pairs_v["acc_y"][rix] = _h(wrow["acc"][1])
                pairs_v["t2x"][rix] = _h(setup["T2"][0])
                pairs_v["t2y"][rix] = _h(setup["T2"][1])
                pairs_v["t3x"][rix] = _h(setup["T3"][0])
                pairs_v["t3y"][rix] = _h(setup["T3"][1])
                singles[self.c_b1][rix] = wrow["b1"]
                singles[self.c_b2][rix] = wrow["b2"]
                if i < 128:
                    u1h = 2 * u1h + wrow["b1"]
                    u2h = 2 * u2h + wrow["b2"]
                else:
                    u1l = 2 * u1l + wrow["b1"]
                    u2l = 2 * u2l + wrow["b2"]
                singles[self.saccs["u1h"]][rix] = u1h
                singles[self.saccs["u1l"]][rix] = u1l
                singles[self.saccs["u2h"]][rix] = u2h
                singles[self.saccs["u2l"]][rix] = u2l
            frow = base + 1 + N_WALK
            for name in self.ADD:
                pairs_v["f_" + name][frow] = _h(final["f"][name])
            pb = ev.pubkey_bytes()
            for j in range(64):
                singles[self.c_pb[j]][frow] = pb[j]
            dig = keccak256(pb)
            for j in range(32):
                singles[self.c_db[j]][frow] = dig[j]
            for cols, v in ((self.c_zb, ev.msg_hash), (self.c_rb, ev.r),
                            (self.c_sb, ev.s)):
                be = v.to_bytes(32, "big")
                for j in range(32):
                    singles[cols[j]][frow] = be[j]

        for name, (clo, chi) in self.pairs.items():
            out[clo] = mont([v[0] for v in pairs_v[name]])
            out[chi] = mont([v[1] for v in pairs_v[name]])
        for c, vals in singles.items():
            out[c] = mont(vals)
        return out


_DUMMY: SigEvent | None = None


def _dummy_event() -> SigEvent:
    """Fixed valid signature used for padding events (host-generated
    once; standalone mode must include its mulmod events + pubkey)."""
    global _DUMMY
    if _DUMMY is None:
        from ..crypto import secp256k1 as secp

        sk = 0x1CEB00DA
        z = 0x5EED
        r, s, _v = secp.sign(sk, z.to_bytes(32, "big"))
        _DUMMY = SigEvent(
            msg_hash=z, r=r, s=s, pubkey=secp.pubkey(sk)
        )
    return _DUMMY
