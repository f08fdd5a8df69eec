"""MulMod circuit — proves 256-bit modular mul/add rows.

Backs the EVM MULMOD / ADDMOD opcode gadgets and the ModExp precompile
circuit.  The reference proves MULMOD with an in-step
`MulAddWords512Gadget` pair (`zkevm-circuits/src/evm_circuit/execution/
mulmod.rs`, math_gadget/mul_add_words_512.rs) and ADDMOD likewise
(`execution/addmod.rs`); modexp delegates to the external
`misc-precompiled-circuit` crate (SURVEY.md §2.2 "ModExp").  This
build centralizes all of them into ONE fixed-geometry row shape — a
dedicated sub-circuit whose rows each prove

    r = (a * b) mod n      (is_add = 0)
    r = (a + b) mod n      (is_add = 1)
    r = 0 when n == 0      (EVM semantics for both opcodes)

so witness assembly is a columnar numpy pass and consumers just look the
tuple up (the same table-delegation pattern as the Exp circuit).

Statement decomposition (the reference's two-step reduction, which keeps
every intermediate inside 512 bits):

    a            = q1 * n + a_red          (a_red < n when n != 0)
    d (512-bit)  = a_red * b               (mul rows)
                 = a_red + b               (add rows)
    d            = k * n + r               (r < n when n != 0)

All words are 32 little-endian byte columns; 64-bit limbs are linear
expressions over them; the three identities ride 128-bit sections with
9-byte carry banks (same shape as the Exp circuit's MulAdd).

Exposed MulModTable: (enable, is_add, a_lo, a_hi, b_lo, b_hi, n_lo,
n_hi, r_lo, r_hi) on every active row.

Port of zkevm_circuits_tpu/circuits/mulmod.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed

F = fr()

LO = 1 << 128
L64 = 1 << 64
M128 = LO - 1
M256 = 1 << 256


def _le(v: int, n: int) -> list[int]:
    return list(v.to_bytes(n, "little"))


@dataclasses.dataclass
class MulModEvent:
    """One modular operation: r = (a op b) mod n (r == 0 when n == 0)."""

    a: int
    b: int
    n: int
    r: int
    is_add: bool = False


@dataclasses.dataclass
class MulModParams:
    target_rows: int = 0  # 0 => exact event count


def _limbs4(v: int) -> list[int]:
    return [(v >> (64 * k)) & (L64 - 1) for k in range(4)]


def _mul_t(lx: list, ly: list) -> list:
    """7 convolution limbs of a 4x4 64-bit limb product (ints or exprs)."""
    out = []
    for m in range(7):
        acc = None
        for i in range(4):
            j = m - i
            if 0 <= j < 4:
                term = lx[i] * ly[j]
                acc = term if acc is None else acc + term
        out.append(acc)
    return out


class MulModCircuit(Circuit):
    def __init__(self, events: list[MulModEvent],
                 params: MulModParams | None = None):
        self.events = list(events)
        self.params = params or MulModParams()

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, byte_table=None):
        """`byte_table`: optional shared byte range table (SuperCircuit);
        standalone mode allocates its own."""
        self.standalone = byte_table is None
        self.q_row = cs.fixed_column()
        if self.standalone:
            self.tbl_byte = cs.fixed_column()
            byte_table = [Fixed(self.tbl_byte)]

        self.c_is_add = cs.advice_column()
        self.c_n_inv = cs.advice_column()  # inverse of sum(n bytes)
        word = lambda: [cs.advice_column() for _ in range(32)]
        self.c_a = word()
        self.c_b = word()
        self.c_n = word()
        self.c_r = word()
        self.c_ared = word()
        self.c_q1 = word()
        self.c_k = word()
        self.c_d0 = word()  # low 256 bits of d
        self.c_d1 = word()  # high 256 bits of d
        self.c_diff1 = word()  # a_red - n + 2^256
        self.c_diff2 = word()  # r - n + 2^256
        bank = lambda: [cs.advice_column() for _ in range(9)]
        self.c_cq = [bank() for _ in range(2)]  # identity 1 carries
        self.c_cd = [bank() for _ in range(3)]  # identity 2 carries
        self.c_ce = [bank() for _ in range(3)]  # identity 3 carries
        self.c_bor1 = cs.advice_column()
        self.c_bor2 = cs.advice_column()

        q = Fixed(self.q_row)
        is_add = Advice(self.c_is_add)

        def half(cols, lo_half: bool):
            base = 0 if lo_half else 16
            expr = None
            for i in range(16):
                term = Advice(cols[base + i]) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def limb64(cols, k: int):
            expr = None
            for i in range(8):
                term = Advice(cols[8 * k + i]) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def acc(cols):
            expr = None
            for i, c in enumerate(cols):
                term = Advice(c) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        a_lo, a_hi = half(self.c_a, True), half(self.c_a, False)
        b_lo, b_hi = half(self.c_b, True), half(self.c_b, False)
        n_lo, n_hi = half(self.c_n, True), half(self.c_n, False)
        r_lo, r_hi = half(self.c_r, True), half(self.c_r, False)
        ar_lo, ar_hi = half(self.c_ared, True), half(self.c_ared, False)
        d0_lo, d0_hi = half(self.c_d0, True), half(self.c_d0, False)
        d1_lo, d1_hi = half(self.c_d1, True), half(self.c_d1, False)

        # n != 0 flag via the byte-sum inverse witness (sum < 8160 << p,
        # so it vanishes iff every byte does)
        n_sum = None
        for c in self.c_n:
            n_sum = Advice(c) if n_sum is None else n_sum + Advice(c)
        nz = n_sum * Advice(self.c_n_inv)
        cs.create_gate("mulmod nz kill", q * n_sum * (1 - nz))
        cs.create_gate("mulmod is_add bool", q * is_add * (is_add - 1))

        # ---- identity 1: q1 * n + a_red = a (n == 0 gives a_red = a) ----
        tq = _mul_t([limb64(self.c_q1, k) for k in range(4)],
                    [limb64(self.c_n, k) for k in range(4)])
        cq0, cq1 = acc(self.c_cq[0]), acc(self.c_cq[1])
        cs.create_gate(
            "mulmod red lo", q * (tq[0] + tq[1] * L64 + ar_lo - a_lo - cq0 * LO)
        )
        cs.create_gate(
            "mulmod red hi",
            q * (tq[2] + tq[3] * L64 + ar_hi + cq0 - a_hi - cq1 * LO),
        )
        cs.create_gate(
            "mulmod red no overflow", q * (cq1 + tq[4] + tq[5] + tq[6])
        )

        # ---- identity 2: d = a_red * b (mul) / a_red + b (add) ----------
        gm = q * (1 - is_add) * nz
        ga = q * is_add * nz
        tl = _mul_t([limb64(self.c_ared, k) for k in range(4)],
                    [limb64(self.c_b, k) for k in range(4)])
        cd0, cd1, cd2 = (acc(bk) for bk in self.c_cd)
        cs.create_gate("mulmod d lo", gm * (tl[0] + tl[1] * L64 - d0_lo - cd0 * LO))
        cs.create_gate(
            "mulmod d mid", gm * (tl[2] + tl[3] * L64 + cd0 - d0_hi - cd1 * LO)
        )
        cs.create_gate(
            "mulmod d hi", gm * (tl[4] + tl[5] * L64 + cd1 - d1_lo - cd2 * LO)
        )
        cs.create_gate("mulmod d top", gm * (tl[6] + cd2 - d1_hi))
        # add rows: d = a_red + b, so d1 is just the 1-bit carry
        cs.create_gate("mulmod sum lo", ga * (ar_lo + b_lo - d0_lo - cd0 * LO))
        cs.create_gate("mulmod sum hi", ga * (ar_hi + b_hi + cd0 - d0_hi - cd1 * LO))
        cs.create_gate("mulmod sum top lo", ga * (d1_lo - cd1))
        cs.create_gate("mulmod sum top hi", ga * d1_hi)

        # ---- identity 3: k * n + r = d ----------------------------------
        gz = q * nz
        tr = _mul_t([limb64(self.c_k, k) for k in range(4)],
                    [limb64(self.c_n, k) for k in range(4)])
        ce0, ce1, ce2 = (acc(bk) for bk in self.c_ce)
        cs.create_gate(
            "mulmod out lo", gz * (tr[0] + tr[1] * L64 + r_lo - d0_lo - ce0 * LO)
        )
        cs.create_gate(
            "mulmod out mid",
            gz * (tr[2] + tr[3] * L64 + r_hi + ce0 - d0_hi - ce1 * LO),
        )
        cs.create_gate(
            "mulmod out hi", gz * (tr[4] + tr[5] * L64 + ce1 - d1_lo - ce2 * LO)
        )
        cs.create_gate("mulmod out top", gz * (tr[6] + ce2 - d1_hi))
        # n == 0: the result is 0 by EVM semantics
        gnz = q * (1 - nz)
        cs.create_gate("mulmod zero-mod r lo", gnz * r_lo)
        cs.create_gate("mulmod zero-mod r hi", gnz * r_hi)

        # ---- range compares: a_red < n and r < n when n != 0 ------------
        # borrow style (same as the EVM DIVMOD gadget): x - n + 2^256 held
        # in a 32-byte diff bank with the borrow bit keeping sections exact
        for nm, x_lo, x_hi, diffc, borc in (
            ("ared", ar_lo, ar_hi, self.c_diff1, self.c_bor1),
            ("r", r_lo, r_hi, self.c_diff2, self.c_bor2),
        ):
            dl, dh = half(diffc, True), half(diffc, False)
            bor = Advice(borc)
            cs.create_gate(f"mulmod {nm} borrow bool", q * bor * (bor - 1))
            cs.create_gate(
                f"mulmod {nm}<n lo", gz * (x_lo - n_lo + bor * LO - dl)
            )
            cs.create_gate(
                f"mulmod {nm}<n hi", gz * (x_hi - n_hi - bor + LO - dh)
            )

        # ---- byte range checks ------------------------------------------
        byte_cols = (
            self.c_a + self.c_b + self.c_n + self.c_r + self.c_ared
            + self.c_q1 + self.c_k + self.c_d0 + self.c_d1 + self.c_diff1
            + self.c_diff2
        )
        for banks in (self.c_cq, self.c_cd, self.c_ce):
            for bk in banks:
                byte_cols = byte_cols + bk
        cs.lookup_logup(
            "mulmod byte ranges",
            [[q * Advice(c)] for c in byte_cols], byte_table,
        )

        # ---- exposed MulModTable ------------------------------------------
        self.mulmod_table = [
            q, q * is_add, q * a_lo, q * a_hi, q * b_lo, q * b_hi,
            q * n_lo, q * n_hi, q * r_lo, q * r_hi,
        ]

    # ------------------------------------------------------------------
    def _target(self, n: int) -> int:
        t = self.params.target_rows or len(self.events)
        assert len(self.events) <= t <= usable_rows(n)
        return t

    def fixed_columns(self, n: int):
        t = self._target(n)
        mont = F.mont_from_ints
        out = {self.q_row: mont([1 if i < t else 0 for i in range(n)])}
        if self.standalone:
            assert n >= 256, "domain must fit the byte range table"
            out[self.tbl_byte] = mont([i if i < 256 else 0 for i in range(n)])
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        if phase != 0:
            return {}
        t = self._target(n)
        # padding rows are (0 op 0) mod 0 = 0: identity 1 degenerates to
        # a_red = a = 0 and everything else is gated off by nz = 0
        evs = self.events + [MulModEvent(0, 0, 0, 0)] * (t - len(self.events))
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        rows = []
        for ev in evs:
            a, b, nn, r = ev.a, ev.b, ev.n, ev.r
            if nn == 0:
                assert r == 0, "n == 0 events must claim r == 0"
                rows.append(dict(a=a, b=b, n=0, r=0, ared=a, q1=0, k=0, d=0,
                                 diff1=0, diff2=0, bor1=0, bor2=0,
                                 cq=(0, 0), cd=(0, 0, 0), ce=(0, 0, 0),
                                 is_add=int(ev.is_add), n_inv=0))
                continue
            q1, ared = divmod(a, nn)
            d = (ared + b) if ev.is_add else (ared * b)
            k, r_chk = divmod(d, nn)
            assert r_chk == r, f"event claims r={r}, actual {r_chk}"
            assert k < M256
            # identity 1 carries
            tq = _mul_t(_limbs4(q1), _limbs4(nn))
            cq0 = (tq[0] + tq[1] * L64 + (ared & M128) - (a & M128)) >> 128
            cq1 = (tq[2] + tq[3] * L64 + (ared >> 128) + cq0
                   - (a >> 128)) >> 128
            assert cq1 + tq[4] + tq[5] + tq[6] == 0
            d0, d1 = d & (M256 - 1), d >> 256
            if ev.is_add:
                cd0 = ((ared & M128) + (b & M128) - (d0 & M128)) >> 128
                cd1 = ((ared >> 128) + (b >> 128) + cd0 - (d0 >> 128)) >> 128
                cd2 = 0
            else:
                tlb = _mul_t(_limbs4(ared), _limbs4(b))
                cd0 = (tlb[0] + tlb[1] * L64 - (d0 & M128)) >> 128
                cd1 = (tlb[2] + tlb[3] * L64 + cd0 - (d0 >> 128)) >> 128
                cd2 = (tlb[4] + tlb[5] * L64 + cd1 - (d1 & M128)) >> 128
                assert tlb[6] + cd2 == d1 >> 128
            trb = _mul_t(_limbs4(k), _limbs4(nn))
            ce0 = (trb[0] + trb[1] * L64 + (r & M128) - (d0 & M128)) >> 128
            ce1 = (trb[2] + trb[3] * L64 + (r >> 128) + ce0
                   - (d0 >> 128)) >> 128
            ce2 = (trb[4] + trb[5] * L64 + ce1 - (d1 & M128)) >> 128
            assert trb[6] + ce2 == d1 >> 128
            rows.append(dict(
                a=a, b=b, n=nn, r=r, ared=ared, q1=q1, k=k, d=d,
                diff1=(ared - nn + M256) % M256,
                diff2=(r - nn + M256) % M256,
                bor1=int((ared & M128) < (nn & M128)),
                bor2=int((r & M128) < (nn & M128)),
                cq=(cq0, cq1), cd=(cd0, cd1, cd2), ce=(ce0, ce1, ce2),
                is_add=int(ev.is_add),
                n_inv=pow(sum(_le(nn, 32)), -1, R),
            ))
        cols = {
            self.c_is_add: mont([rw["is_add"] for rw in rows]),
            self.c_n_inv: mont([rw["n_inv"] for rw in rows]),
            self.c_bor1: mont([rw["bor1"] for rw in rows]),
            self.c_bor2: mont([rw["bor2"] for rw in rows]),
        }
        for cset, key in (
            (self.c_a, "a"), (self.c_b, "b"), (self.c_n, "n"),
            (self.c_r, "r"), (self.c_ared, "ared"), (self.c_q1, "q1"),
            (self.c_k, "k"), (self.c_diff1, "diff1"), (self.c_diff2, "diff2"),
        ):
            for i in range(32):
                cols[cset[i]] = mont([_le(rw[key], 32)[i] for rw in rows])
        for i in range(32):
            cols[self.c_d0[i]] = mont(
                [_le(rw["d"] & (M256 - 1), 32)[i] for rw in rows]
            )
            cols[self.c_d1[i]] = mont(
                [_le(rw["d"] >> 256, 32)[i] for rw in rows]
            )
        for banks, key in ((self.c_cq, "cq"), (self.c_cd, "cd"),
                           (self.c_ce, "ce")):
            for bi, bk in enumerate(banks):
                for i in range(9):
                    cols[bk[i]] = mont(
                        [_le(rw[key][bi], 9)[i] for rw in rows]
                    )
        return cols
