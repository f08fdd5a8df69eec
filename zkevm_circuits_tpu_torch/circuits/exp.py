"""Exp circuit — proves EXP opcode exponentiation-by-squaring traces.

Equivalent of the reference's `zkevm-circuits/src/exp_circuit.rs` (SURVEY.md
§2.2 "Exp"): each multiplication step of square-and-multiply is verified by
a 256x256->256-bit multiplication gadget (the reference's `MulAddChip`,
gadgets/src/mul_add.rs, with c=0), steps chain via a::cur == d::next, the
intermediate exponent walks down by `-1` (odd, multiply-by-base) or `/2`
(even, squaring) with a parity decomposition, and the last step pins
exponent == 2 with a == b == base (exp_circuit.rs:120-300).

Layout: ONE row per multiplication step (the reference spends
`OFFSET_INCREMENT = 8` rows per step to fit the MulAddChip); every word
lives as 32 dedicated little-endian byte columns on that row, range-checked
by a single logUp argument into the byte table, and 64-bit limbs are linear
expressions over those byte columns.  Witness assembly is one columnar
numpy pass over all events (no layouter, no region assignment).

The exposed ExpTable (reference table.rs:2085 `ExpTable`) here is the tuple
(enable, base_lo, base_hi, exponent_lo, exponent_hi, result_lo, result_hi)
gated on each event's FIRST row — what the EVM circuit's EXP gadget looks
up (reference evm_circuit/execution/exp.rs).

Port of zkevm_circuits_tpu/circuits/exp.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..witness.builder import ExpEvent

F = fr()

LO = 1 << 128
L64 = 1 << 64


def _le_bytes(v: int, n: int) -> list[int]:
    return list(v.to_bytes(n, "little"))


@dataclasses.dataclass
class ExpParams:
    target_rows: int = 0  # 0 => exact step count


class ExpCircuit(Circuit):
    def __init__(self, events: list[ExpEvent], params: ExpParams | None = None):
        self.events = events
        self.params = params or ExpParams()

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, byte_table=None):
        """`byte_table`: optional 1-expression byte range table (the
        SuperCircuit shares one); standalone mode allocates its own."""
        self.standalone = byte_table is None
        self.q_exp = cs.fixed_column()
        self.q_first_row = cs.fixed_column()
        if self.standalone:
            self.tbl_byte = cs.fixed_column()
            byte_table = [Fixed(self.tbl_byte)]

        self.c_is_first = cs.advice_column()
        self.c_is_last = cs.advice_column()
        self.c_ident = cs.advice_column()
        self.c_base_lo = cs.advice_column()
        self.c_base_hi = cs.advice_column()
        self.c_parity = cs.advice_column()  # exponent & 1
        self.c_c0 = cs.advice_column()  # parity-split carry (= exp_hi & 1)
        self.c_a = [cs.advice_column() for _ in range(32)]
        self.c_b = [cs.advice_column() for _ in range(32)]
        self.c_d = [cs.advice_column() for _ in range(32)]
        self.c_exp = [cs.advice_column() for _ in range(32)]
        self.c_q = [cs.advice_column() for _ in range(32)]  # exponent >> 1
        self.c_cl = [cs.advice_column() for _ in range(9)]  # mul carry lo
        self.c_ch = [cs.advice_column() for _ in range(9)]  # mul carry hi

        q = Fixed(self.q_exp)
        q_n = Fixed(self.q_exp, 1)
        qf = Fixed(self.q_first_row)
        first, first_n = Advice(self.c_is_first), Advice(self.c_is_first, 1)
        last = Advice(self.c_is_last)
        ident, ident_n = Advice(self.c_ident), Advice(self.c_ident, 1)
        blo, blo_n = Advice(self.c_base_lo), Advice(self.c_base_lo, 1)
        bhi, bhi_n = Advice(self.c_base_hi), Advice(self.c_base_hi, 1)
        r_par = Advice(self.c_parity)
        c0 = Advice(self.c_c0)

        def half(cols, lo_half: bool, rot: int = 0):
            """128-bit lo/hi half of a 32-byte column set, as a linear
            expression (little-endian)."""
            base = 0 if lo_half else 16
            expr = None
            for i in range(16):
                term = Advice(cols[base + i], rot) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def limb64(cols, k: int, rot: int = 0):
            expr = None
            for i in range(8):
                term = Advice(cols[8 * k + i], rot) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def acc(cols, nbytes: int):
            expr = None
            for i in range(nbytes):
                term = Advice(cols[i]) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        # booleans
        for name, e in (("is_first", first), ("is_last", last),
                        ("parity", r_par), ("c0", c0)):
            cs.create_gate(f"exp {name} bool", q * e * (e - 1))
        # the first active row opens an event
        cs.create_gate("exp first row", q * qf * (first - 1))
        # the last active row closes its event
        cs.create_gate("exp trailing last", q * (1 - q_n) * (1 - last))
        # adjacent active rows: next row opens an event iff this one closed
        cs.create_gate("exp boundary", q * q_n * (first_n - last))
        # within an event: identifier and base are constant
        intra = q * q_n * (1 - last)
        cs.create_gate("exp ident cont", intra * (ident_n - ident))
        cs.create_gate("exp base lo cont", intra * (blo_n - blo))
        cs.create_gate("exp base hi cont", intra * (bhi_n - bhi))

        # ---- 256x256 -> 256-bit multiplication (a * b = d mod 2^256) ----
        a = [limb64(self.c_a, k) for k in range(4)]
        b = [limb64(self.c_b, k) for k in range(4)]
        t0 = a[0] * b[0]
        t1 = a[0] * b[1] + a[1] * b[0]
        t2 = a[0] * b[2] + a[1] * b[1] + a[2] * b[0]
        t3 = a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0]
        d_lo, d_hi = half(self.c_d, True), half(self.c_d, False)
        cl, ch = acc(self.c_cl, 9), acc(self.c_ch, 9)
        cs.create_gate("exp mul lo", q * (t0 + t1 * L64 - d_lo - cl * LO))
        cs.create_gate("exp mul hi", q * (t2 + t3 * L64 + cl - d_hi - ch * LO))

        # ---- parity split: exponent = 2*q + r over 128-bit halves -------
        exp_lo, exp_hi = half(self.c_exp, True), half(self.c_exp, False)
        q_lo, q_hi = half(self.c_q, True), half(self.c_q, False)
        cs.create_gate("exp parity lo", q * (2 * q_lo + r_par - exp_lo - c0 * LO))
        cs.create_gate("exp parity hi", q * (2 * q_hi + c0 - exp_hi))

        # ---- chaining: a::cur == d::next (steps stored in reverse) ------
        d_lo_n, d_hi_n = half(self.c_d, True, 1), half(self.c_d, False, 1)
        a_lo, a_hi = half(self.c_a, True), half(self.c_a, False)
        b_lo, b_hi = half(self.c_b, True), half(self.c_b, False)
        cs.create_gate("exp chain lo", intra * (a_lo - d_lo_n))
        cs.create_gate("exp chain hi", intra * (a_hi - d_hi_n))

        # ---- exponent transitions ---------------------------------------
        exp_lo_n = half(self.c_exp, True, 1)
        exp_hi_n = half(self.c_exp, False, 1)
        odd, even = intra * r_par, intra * (1 - r_par)
        cs.create_gate("exp odd -1 lo", odd * (exp_lo_n - exp_lo + 1))
        cs.create_gate("exp odd -1 hi", odd * (exp_hi_n - exp_hi))
        cs.create_gate("exp odd mul base lo", odd * (b_lo - blo))
        cs.create_gate("exp odd mul base hi", odd * (b_hi - bhi))
        cs.create_gate("exp even /2 lo", even * (exp_lo_n - q_lo))
        cs.create_gate("exp even /2 hi", even * (exp_hi_n - q_hi))
        cs.create_gate("exp even square lo", even * (a_lo - b_lo))
        cs.create_gate("exp even square hi", even * (a_hi - b_hi))

        # ---- last step: exponent == 2, a == b == base -------------------
        gl = q * last
        cs.create_gate("exp last exp lo", gl * (exp_lo - 2))
        cs.create_gate("exp last exp hi", gl * exp_hi)
        cs.create_gate("exp last a lo", gl * (a_lo - blo))
        cs.create_gate("exp last a hi", gl * (a_hi - bhi))
        cs.create_gate("exp last b lo", gl * (b_lo - blo))
        cs.create_gate("exp last b hi", gl * (b_hi - bhi))

        # ---- byte range checks (one logUp) -------------------------------
        byte_cols = (
            self.c_a + self.c_b + self.c_d + self.c_exp + self.c_q
            + self.c_cl + self.c_ch
        )
        cs.lookup_logup(
            "exp byte ranges", [[q * Advice(c)] for c in byte_cols], byte_table
        )

        # ---- exposed ExpTable (first rows carry the event statement) ----
        gt = q * first
        self.exp_table = [
            gt, gt * blo, gt * bhi, gt * exp_lo, gt * exp_hi,
            gt * d_lo, gt * d_hi,
        ]

    # ------------------------------------------------------------------
    def _rows(self):
        """Flatten events into per-row tuples
        (is_first, is_last, ident, base, exp, a, b, d)."""
        rows = []
        for ev in self.events:
            steps = list(reversed(ev.steps))
            assert steps, "events with exponent < 2 are not circuit rows"
            exp = ev.exponent
            for i, (a, b, d) in enumerate(steps):
                rows.append((
                    int(i == 0), int(i + 1 == len(steps)), ev.identifier,
                    ev.base, exp, a, b, d,
                ))
                exp = exp - 1 if exp & 1 else exp >> 1
        return rows

    def _target(self, n: int) -> int:
        t = self.params.target_rows or len(self._rows())
        assert len(self._rows()) <= t <= usable_rows(n)
        return t

    def fixed_columns(self, n: int):
        t = self._target(n)
        mont = F.mont_from_ints
        out = {
            self.q_exp: mont([1 if i < t else 0 for i in range(n)]),
            self.q_first_row: mont([1 if i == 0 else 0 for i in range(n)]),
        }
        if self.standalone:
            assert n >= 256, "domain must fit the byte range table"
            out[self.tbl_byte] = mont([i if i < 256 else 0 for i in range(n)])
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        if phase != 0:
            return {}
        rows = self._rows()
        t = self._target(n)
        # padding rows are degenerate single-step events proving 0*0=0 with
        # exponent 2... that would violate `exponent == 2 => a==b==base`
        # unless base==0: use base=0, exp=2, a=b=d=0 (0^2 == 0).  They are
        # complete events (is_first = is_last = 1) so chaining stays sound.
        pad = (1, 1, 0, 0, 2, 0, 0, 0)
        rows = rows + [pad] * (t - len(rows))
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        cols = {
            self.c_is_first: mont([r[0] for r in rows]),
            self.c_is_last: mont([r[1] for r in rows]),
            self.c_ident: mont([r[2] for r in rows]),
            self.c_base_lo: mont([r[3] % LO for r in rows]),
            self.c_base_hi: mont([r[3] >> 128 for r in rows]),
            self.c_parity: mont([r[4] & 1 for r in rows]),
            self.c_c0: mont([(r[4] >> 128) & 1 for r in rows]),
        }
        for cset, key in ((self.c_a, 5), (self.c_b, 6), (self.c_d, 7),
                          (self.c_exp, 4)):
            for i in range(32):
                cols[cset[i]] = mont([_le_bytes(r[key], 32)[i] for r in rows])
        for i in range(32):
            cols[self.c_q[i]] = mont([_le_bytes(r[4] >> 1, 32)[i] for r in rows])
        # mul carries
        cls, chs = [], []
        for r_ in rows:
            a, b, d = r_[5], r_[6], r_[7]
            al = [(a >> (64 * k)) & (L64 - 1) for k in range(4)]
            bl = [(b >> (64 * k)) & (L64 - 1) for k in range(4)]
            t0 = al[0] * bl[0]
            t1 = al[0] * bl[1] + al[1] * bl[0]
            t2 = al[0] * bl[2] + al[1] * bl[1] + al[2] * bl[0]
            t3 = al[0] * bl[3] + al[1] * bl[2] + al[2] * bl[1] + al[3] * bl[0]
            cl = (t0 + t1 * L64 - (d % LO)) >> 128
            ch = (t2 + t3 * L64 + cl - (d >> 128)) >> 128
            assert 0 <= cl < (1 << 72) and 0 <= ch < (1 << 72)
            cls.append(cl)
            chs.append(ch)
        for i in range(9):
            cols[self.c_cl[i]] = mont([_le_bytes(v, 9)[i] for v in cls])
            cols[self.c_ch[i]] = mont([_le_bytes(v, 9)[i] for v in chs])
        return cols
