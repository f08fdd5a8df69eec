"""ModExp circuit — proves base^exponent mod modulus (0x05 precompile).

Equivalent of the reference's `zkevm-circuits/src/modexp_circuit.rs`
(SURVEY.md §2.2 "ModExp"), which wraps the external
`misc-precompiled-circuit` crate.  This build proves it natively:
square-and-multiply over the exponent bits, with every modular
multiplication DELEGATED to the MulMod circuit's table (circuits/
mulmod.py) — the same table-delegation pattern the EVM MULMOD/ADDMOD
gadgets use, so one fixed-geometry modmul row shape serves all three
consumers.

Row walk (mirrors the Exp circuit, circuits/exp.py, which proves the
same recursion mod 2^256): steps are stored REVERSED (final
multiplication first), chaining a::cur == d::next, the intermediate
exponent walks down by -1 (odd rows, multiply-by-base) or /2 (even
rows, squaring with a == b), and the last row pins exponent == 2 with
a == b == base.  Two extra single-row event shapes cover the small
exponents the recursion cannot express:

    exponent == 0:  1 * 1 mod n          (result = 1 mod n)
    exponent == 1:  base * 1 mod n       (result = base mod n)

Unlike the Exp circuit, the (a, b, d) words live as 128-bit HALF cells,
not byte columns: their range is enforced transitively by MulModTable
membership (the MulMod circuit range-checks its own rows), so only the
exponent/quotient columns need byte decompositions here.

Exposed ModExpTable: (enable, base_lo, base_hi, exp_lo, exp_hi,
mod_lo, mod_hi, res_lo, res_hi) gated on each event's first row —
what the modexp precompile call gadget looks up (reference
evm_circuit/execution/precompiles/modexp.rs consumes ModExpTable,
table.rs:2798).

Port of zkevm_circuits_tpu/circuits/modexp.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from .mulmod import MulModCircuit, MulModEvent, MulModParams

F = fr()

LO = 1 << 128
M256 = 1 << 256


def _le_bytes(v: int, n: int) -> list[int]:
    return list(v.to_bytes(n, "little"))


def modexp_steps(base: int, exponent: int, modulus: int):
    """Square-and-multiply (a, b, d) steps mod `modulus`, computation
    order, matching witness.builder.exp_by_squaring's recursion shape.
    Returns (steps, result).  exponent < 2 yields one synthetic step."""
    n = modulus
    red = (lambda x: x % n) if n else (lambda x: 0)
    if exponent == 0:
        return [(1, 1, red(1))], red(1)
    if exponent == 1:
        return [(base, 1, red(base))], red(base)

    steps: list[tuple[int, int, int]] = []

    def rec(e: int) -> int:
        if e == 1:
            return base
        q, odd = divmod(e, 2)
        x = rec(q)
        sq = red(x * x)
        steps.append((x, x, sq))
        if not odd:
            return sq
        out = red(sq * base)
        steps.append((sq, base, out))
        return out

    result = rec(exponent)
    return steps, result


@dataclasses.dataclass
class ModExpEvent:
    """One modexp precompile call (256-bit operands, the reference's
    misc-precompiled-circuit scope)."""

    base: int
    exponent: int
    modulus: int
    result: int

    def steps(self):
        steps, result = modexp_steps(self.base, self.exponent, self.modulus)
        assert result == self.result, (
            f"event claims {self.result}, actual {result}"
        )
        return steps

    def mulmod_events(self) -> list[MulModEvent]:
        return [
            MulModEvent(a=a, b=b, n=self.modulus, r=d)
            for a, b, d in self.steps()
        ]


@dataclasses.dataclass
class ModExpParams:
    target_rows: int = 0  # 0 => exact step count


class ModExpCircuit(Circuit):
    def __init__(self, events: list[ModExpEvent],
                 params: ModExpParams | None = None):
        self.events = list(events)
        self.params = params or ModExpParams()
        self.mm: MulModCircuit | None = None  # standalone-mode inner circuit

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, mulmod_table=None,
                  byte_table=None):
        """`mulmod_table`: the MulMod circuit's exposed table (SuperCircuit
        mode; its event list must then include every event's
        `mulmod_events()` plus one all-zero padding row).  Standalone mode
        instantiates an internal MulMod circuit.
        `byte_table`: optional shared byte range table."""
        self.standalone = mulmod_table is None
        if self.standalone:
            evs: list[MulModEvent] = []
            for ev in self.events:
                evs.extend(ev.mulmod_events())
            # +1 zero row backs the padding rows' (0*0 mod 0 = 0) lookups
            self.mm = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.mm.configure(cs, byte_table=byte_table)
            mulmod_table = self.mm.mulmod_table
            byte_table = [Fixed(self.mm.tbl_byte)] if byte_table is None \
                else byte_table
        assert byte_table is not None, (
            "composed mode needs the shared byte table"
        )

        self.q_row = cs.fixed_column()
        self.q_first_row = cs.fixed_column()

        self.c_is_first = cs.advice_column()
        self.c_is_last = cs.advice_column()
        self.c_e0 = cs.advice_column()  # single-row exponent==0 event
        self.c_e1 = cs.advice_column()  # single-row exponent==1 event
        self.c_parity = cs.advice_column()
        self.c_c0 = cs.advice_column()  # parity-split carry (exp_hi & 1)
        self.c_base_lo = cs.advice_column()
        self.c_base_hi = cs.advice_column()
        self.c_mod_lo = cs.advice_column()
        self.c_mod_hi = cs.advice_column()
        self.c_a_lo = cs.advice_column()
        self.c_a_hi = cs.advice_column()
        self.c_b_lo = cs.advice_column()
        self.c_b_hi = cs.advice_column()
        self.c_d_lo = cs.advice_column()
        self.c_d_hi = cs.advice_column()
        self.c_exp = [cs.advice_column() for _ in range(32)]
        self.c_q = [cs.advice_column() for _ in range(32)]  # exponent >> 1

        q = Fixed(self.q_row)
        q_n = Fixed(self.q_row, 1)
        qf = Fixed(self.q_first_row)
        first, first_n = Advice(self.c_is_first), Advice(self.c_is_first, 1)
        last = Advice(self.c_is_last)
        e0, e1 = Advice(self.c_e0), Advice(self.c_e1)
        r_par, c0 = Advice(self.c_parity), Advice(self.c_c0)
        blo, bhi = Advice(self.c_base_lo), Advice(self.c_base_hi)
        blo_n, bhi_n = Advice(self.c_base_lo, 1), Advice(self.c_base_hi, 1)
        mlo, mhi = Advice(self.c_mod_lo), Advice(self.c_mod_hi)
        mlo_n, mhi_n = Advice(self.c_mod_lo, 1), Advice(self.c_mod_hi, 1)
        alo, ahi = Advice(self.c_a_lo), Advice(self.c_a_hi)
        vblo, vbhi = Advice(self.c_b_lo), Advice(self.c_b_hi)
        dlo, dhi = Advice(self.c_d_lo), Advice(self.c_d_hi)
        dlo_n, dhi_n = Advice(self.c_d_lo, 1), Advice(self.c_d_hi, 1)

        def half(cols, lo_half: bool, rot: int = 0):
            base = 0 if lo_half else 16
            expr = None
            for i in range(16):
                term = Advice(cols[base + i], rot) * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        # booleans
        for name, e in (("is_first", first), ("is_last", last), ("e0", e0),
                        ("e1", e1), ("parity", r_par), ("c0", c0)):
            cs.create_gate(f"modexp {name} bool", q * e * (e - 1))
        # e0/e1 rows are complete single-row events
        for name, e in (("e0", e0), ("e1", e1)):
            cs.create_gate(f"modexp {name} first", q * e * (first - 1))
            cs.create_gate(f"modexp {name} last", q * e * (last - 1))
        # event boundaries (same scheme as the Exp circuit)
        cs.create_gate("modexp first row", q * qf * (first - 1))
        cs.create_gate("modexp trailing last", q * (1 - q_n) * (1 - last))
        cs.create_gate("modexp boundary", q * q_n * (first_n - last))
        # within an event: base and modulus are constant
        intra = q * q_n * (1 - last)
        cs.create_gate("modexp base lo cont", intra * (blo_n - blo))
        cs.create_gate("modexp base hi cont", intra * (bhi_n - bhi))
        cs.create_gate("modexp mod lo cont", intra * (mlo_n - mlo))
        cs.create_gate("modexp mod hi cont", intra * (mhi_n - mhi))

        # ---- parity split: exponent = 2*q + parity over 128-bit halves --
        exp_lo, exp_hi = half(self.c_exp, True), half(self.c_exp, False)
        q_lo, q_hi = half(self.c_q, True), half(self.c_q, False)
        cs.create_gate(
            "modexp parity lo", q * (2 * q_lo + r_par - exp_lo - c0 * LO)
        )
        cs.create_gate("modexp parity hi", q * (2 * q_hi + c0 - exp_hi))

        # ---- chaining: a::cur == d::next (steps stored reversed) --------
        cs.create_gate("modexp chain lo", intra * (alo - dlo_n))
        cs.create_gate("modexp chain hi", intra * (ahi - dhi_n))

        # ---- exponent transitions ---------------------------------------
        exp_lo_n = half(self.c_exp, True, 1)
        exp_hi_n = half(self.c_exp, False, 1)
        odd, even = intra * r_par, intra * (1 - r_par)
        cs.create_gate("modexp odd -1 lo", odd * (exp_lo_n - exp_lo + 1))
        cs.create_gate("modexp odd -1 hi", odd * (exp_hi_n - exp_hi))
        cs.create_gate("modexp odd mul base lo", odd * (vblo - blo))
        cs.create_gate("modexp odd mul base hi", odd * (vbhi - bhi))
        cs.create_gate("modexp even /2 lo", even * (exp_lo_n - q_lo))
        cs.create_gate("modexp even /2 hi", even * (exp_hi_n - q_hi))
        cs.create_gate("modexp even square lo", even * (alo - vblo))
        cs.create_gate("modexp even square hi", even * (ahi - vbhi))

        # ---- last step (recursion base): exponent == 2, a == b == base;
        # bypassed for the single-row exponent 0/1 event shapes ----------
        gl = q * last * (1 - e0 - e1)
        cs.create_gate("modexp last exp lo", gl * (exp_lo - 2))
        cs.create_gate("modexp last exp hi", gl * exp_hi)
        cs.create_gate("modexp last a lo", gl * (alo - blo))
        cs.create_gate("modexp last a hi", gl * (ahi - bhi))
        cs.create_gate("modexp last b lo", gl * (vblo - blo))
        cs.create_gate("modexp last b hi", gl * (vbhi - bhi))
        # exponent == 0: 1 * 1 mod n
        g0 = q * e0
        cs.create_gate("modexp e0 exp lo", g0 * exp_lo)
        cs.create_gate("modexp e0 exp hi", g0 * exp_hi)
        cs.create_gate("modexp e0 a lo", g0 * (alo - 1))
        cs.create_gate("modexp e0 a hi", g0 * ahi)
        cs.create_gate("modexp e0 b lo", g0 * (vblo - 1))
        cs.create_gate("modexp e0 b hi", g0 * vbhi)
        # exponent == 1: base * 1 mod n
        g1 = q * e1
        cs.create_gate("modexp e1 exp lo", g1 * (exp_lo - 1))
        cs.create_gate("modexp e1 exp hi", g1 * exp_hi)
        cs.create_gate("modexp e1 a lo", g1 * (alo - blo))
        cs.create_gate("modexp e1 a hi", g1 * (ahi - bhi))
        cs.create_gate("modexp e1 b lo", g1 * (vblo - 1))
        cs.create_gate("modexp e1 b hi", g1 * vbhi)

        # ---- every row is one modular multiplication: delegate ----------
        cs.lookup_logup(
            "modexp mulmod rows",
            [[q, q * 0, q * alo, q * ahi, q * vblo, q * vbhi,
              q * mlo, q * mhi, q * dlo, q * dhi]],
            mulmod_table,
        )

        # ---- byte range checks for the exponent walk --------------------
        cs.lookup_logup(
            "modexp byte ranges",
            [[q * Advice(c)] for c in self.c_exp + self.c_q],
            byte_table,
        )

        # ---- exposed ModExpTable ----------------------------------------
        gt = q * first
        self.modexp_table = [
            gt, gt * blo, gt * bhi, gt * exp_lo, gt * exp_hi,
            gt * mlo, gt * mhi, gt * dlo, gt * dhi,
        ]

    # ------------------------------------------------------------------
    def _rows(self):
        """Flatten events into per-row dicts."""
        rows = []
        for ev in self.events:
            steps = list(reversed(ev.steps()))
            exp = ev.exponent
            e0, e1 = int(ev.exponent == 0), int(ev.exponent == 1)
            for i, (a, b, d) in enumerate(steps):
                rows.append(dict(
                    first=int(i == 0), last=int(i + 1 == len(steps)),
                    e0=e0, e1=e1, base=ev.base, mod=ev.modulus,
                    exp=exp, a=a, b=b, d=d,
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
            self.q_row: mont([1 if i < t else 0 for i in range(n)]),
            self.q_first_row: mont([1 if i == 0 else 0 for i in range(n)]),
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
        rows = self._rows()
        t = self._target(n)
        # padding: complete one-row events proving 0^2 mod 0 = 0 (their
        # mulmod lookup hits the MulMod circuit's all-zero padding row)
        pad = dict(first=1, last=1, e0=0, e1=0, base=0, mod=0, exp=2,
                   a=0, b=0, d=0)
        rows = rows + [pad] * (t - len(rows))
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        out.update({
            self.c_is_first: mont([r["first"] for r in rows]),
            self.c_is_last: mont([r["last"] for r in rows]),
            self.c_e0: mont([r["e0"] for r in rows]),
            self.c_e1: mont([r["e1"] for r in rows]),
            self.c_parity: mont([r["exp"] & 1 for r in rows]),
            self.c_c0: mont([(r["exp"] >> 128) & 1 for r in rows]),
            self.c_base_lo: mont([r["base"] % LO for r in rows]),
            self.c_base_hi: mont([r["base"] >> 128 for r in rows]),
            self.c_mod_lo: mont([r["mod"] % LO for r in rows]),
            self.c_mod_hi: mont([r["mod"] >> 128 for r in rows]),
            self.c_a_lo: mont([r["a"] % LO for r in rows]),
            self.c_a_hi: mont([r["a"] >> 128 for r in rows]),
            self.c_b_lo: mont([r["b"] % LO for r in rows]),
            self.c_b_hi: mont([r["b"] >> 128 for r in rows]),
            self.c_d_lo: mont([r["d"] % LO for r in rows]),
            self.c_d_hi: mont([r["d"] >> 128 for r in rows]),
        })
        for i in range(32):
            out[self.c_exp[i]] = mont(
                [_le_bytes(r["exp"], 32)[i] for r in rows]
            )
            out[self.c_q[i]] = mont(
                [_le_bytes(r["exp"] >> 1, 32)[i] for r in rows]
            )
        return out
