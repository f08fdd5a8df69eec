"""SHA-256 circuit — bit-plane rows, one row per compression round.

Equivalent of the reference's `zkevm-circuits/src/sha256_circuit/`
(SURVEY.md §2.2 "SHA256", the 0x02 precompile's table), which wraps a
table16-style implementation.  Redesign: the classic
"only a and e change per round" structure becomes a ROTATION scheme —
each round row stores the new a and e as 32 bit columns, and the round's
inputs b,c,d / f,g,h are the same columns at rotations -1..-4.  All
Ch/Maj/Sigma logic is bitwise degree-<=3 polynomials; the mod-2^32
additions are single integer identities with small bit-decomposed
carries.  Block layout (72 rows):

    rows 0..3    init: row 3-j holds (h_j, h_{4+j}) in the (a, e) columns
    rows 4..67   round t = row-4; W column carries the message schedule
    rows 68..71  digest: word = init(-68) + final(-4), same layout as
                 init rows so the next block chains via a -4 rotation

The SHA256Table (is_enabled, input_rlc, output_rlc) is exposed on each
message's last digest row; input_rlc folds the PADDED message bytes
(matching the Keccak table convention).

Port of zkevm_circuits_tpu/circuits/sha256.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..crypto.sha256 import H_INIT, K, pad, sha256_trace
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Expression, Fixed

F = fr()

ROWS_PER_BLOCK = 72


def _xor(x, y):
    return x + y - 2 * x * y


def _xor3(x, y, z):
    return _xor(_xor(x, y), z)


class Sha256Circuit(Circuit):
    def __init__(self, messages: list[bytes]):
        self.messages = messages
        self.traces = [sha256_trace(m) for m in messages]

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, challenge=None):
        self.q_round = cs.fixed_column()
        self.q_sched = cs.fixed_column()  # round rows with t >= 16
        self.q_msg = cs.fixed_column()  # round rows with t < 16
        self.q_dig = cs.fixed_column()
        self.q_first_init = cs.fixed_column()  # message block-0 init rows
        self.q_chain = cs.fixed_column()  # later blocks' init rows
        self.q_acc_carry = cs.fixed_column()  # rows where acc copies down
        self.q_final = cs.fixed_column()  # last digest row per message
        self.f_k = cs.fixed_column()
        self.f_ha = cs.fixed_column()  # expected init word, a column
        self.f_he = cs.fixed_column()  # expected init word, e column

        self.c_a = [cs.advice_column() for _ in range(32)]
        self.c_e = [cs.advice_column() for _ in range(32)]
        self.c_w = [cs.advice_column() for _ in range(32)]
        self.c_ce = [cs.advice_column() for _ in range(3)]
        self.c_ca = [cs.advice_column() for _ in range(3)]
        self.c_cw = [cs.advice_column() for _ in range(2)]
        self.c_cda = cs.advice_column()
        self.c_cde = cs.advice_column()
        self.c_acc = cs.advice_column(phase=1)  # padded-message input RLC
        self.c_out = cs.advice_column(phase=1)  # digest RLC (table col)
        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        qr = Fixed(self.q_round)
        qs = Fixed(self.q_sched)
        qm = Fixed(self.q_msg)
        qd = Fixed(self.q_dig)
        qi = Fixed(self.q_first_init)
        qc = Fixed(self.q_chain)
        qac = Fixed(self.q_acc_carry)
        qf = Fixed(self.q_final)

        a = [Advice(c) for c in self.c_a]
        e = [Advice(c) for c in self.c_e]
        w = [Advice(c) for c in self.c_w]

        def rot(cols, r_):
            return [Advice(c, -r_) for c in cols]

        def word(bits) -> Expression:
            expr = None
            for i, b in enumerate(bits):
                term = b if i == 0 else b * (1 << i)
                expr = term if expr is None else expr + term
            return expr

        any_q = qr + qd + qi + qc
        for name, bits in (("a", a), ("e", e)):
            for i, b in enumerate(bits):
                cs.create_gate(f"sha {name}{i} bool", any_q * b * (b - 1))
        for i, b in enumerate(w):
            cs.create_gate(f"sha w{i} bool", qr * b * (b - 1))
        for c in self.c_ce + self.c_ca + self.c_cw + [self.c_cda, self.c_cde]:
            b = Advice(c)
            cs.create_gate("sha carry bool", (qr + qd) * b * (b - 1))

        # init rows: first blocks pinned to fixed words; chained blocks
        # copy the previous block's digest rows (same layout, -4)
        cs.create_gate("sha init a", qi * (word(a) - Fixed(self.f_ha)))
        cs.create_gate("sha init e", qi * (word(e) - Fixed(self.f_he)))
        for i in range(32):
            cs.create_gate(f"sha chain a{i}", qc * (a[i] - Advice(self.c_a[i], -4)))
            cs.create_gate(f"sha chain e{i}", qc * (e[i] - Advice(self.c_e[i], -4)))

        # round rows: e_new = d + h + Sigma1(e_prev) + Ch + K + W
        a1, a2, a3, a4 = rot(self.c_a, 1), rot(self.c_a, 2), rot(self.c_a, 3), rot(self.c_a, 4)
        e1, e2, e3, e4 = rot(self.c_e, 1), rot(self.c_e, 2), rot(self.c_e, 3), rot(self.c_e, 4)
        sigma1 = [
            _xor3(e1[(i + 6) % 32], e1[(i + 11) % 32], e1[(i + 25) % 32])
            for i in range(32)
        ]
        ch = [e1[i] * e2[i] + (1 - e1[i]) * e3[i] for i in range(32)]
        ce = (Advice(self.c_ce[0]) + Advice(self.c_ce[1]) * 2
              + Advice(self.c_ce[2]) * 4)
        cs.create_gate(
            "sha round e",
            qr * (word(e) + ce * (1 << 32)
                  - word(a4) - word(e4) - word(sigma1) - word(ch)
                  - Fixed(self.f_k) - word(w)),
        )
        # a_new = t1 + t2 where t1 = e_new_int + 2^32 ce - d
        sigma0 = [
            _xor3(a1[(i + 2) % 32], a1[(i + 13) % 32], a1[(i + 22) % 32])
            for i in range(32)
        ]
        maj = [
            a1[i] * a2[i] + a1[i] * a3[i] + a2[i] * a3[i]
            - 2 * a1[i] * a2[i] * a3[i]
            for i in range(32)
        ]
        ca = (Advice(self.c_ca[0]) + Advice(self.c_ca[1]) * 2
              + Advice(self.c_ca[2]) * 4)
        cs.create_gate(
            "sha round a",
            qr * (word(a) + ca * (1 << 32)
                  - word(e) - ce * (1 << 32) + word(a4)
                  - word(sigma0) - word(maj)),
        )
        # schedule: W_t = sigma1s(W_{t-2}) + W_{t-7} + sigma0s(W_{t-15}) + W_{t-16}
        w2, w7, w15, w16 = rot(self.c_w, 2), rot(self.c_w, 7), rot(self.c_w, 15), rot(self.c_w, 16)
        sig0s = [
            _xor3(w15[(i + 7) % 32], w15[(i + 18) % 32],
                  w15[i + 3] if i + 3 < 32 else 0 * w15[0])
            for i in range(32)
        ]
        sig1s = [
            _xor3(w2[(i + 17) % 32], w2[(i + 19) % 32],
                  w2[i + 10] if i + 10 < 32 else 0 * w2[0])
            for i in range(32)
        ]
        cw = Advice(self.c_cw[0]) + Advice(self.c_cw[1]) * 2
        cs.create_gate(
            "sha schedule",
            qs * (word(w) + cw * (1 << 32)
                  - word(sig1s) - word(w7) - word(sig0s) - word(w16)),
        )
        # digest rows: word = init(-68) + final(-4) per column
        a68, e68 = rot(self.c_a, 68), rot(self.c_e, 68)
        cs.create_gate(
            "sha digest a",
            qd * (word(a) + Advice(self.c_cda) * (1 << 32)
                  - word(a68) - word(a4)),
        )
        cs.create_gate(
            "sha digest e",
            qd * (word(e) + Advice(self.c_cde) * (1 << 32)
                  - word(e68) - word(e4)),
        )

        # input RLC: fold the 4 big-endian message bytes on each t<16 row
        acc, acc_p = Advice(self.c_acc), Advice(self.c_acc, -1)

        def byte_of(bits, k):  # big-endian byte k of the word
            hi = 31 - 8 * k
            expr = None
            for j in range(8):
                b = bits[hi - j]
                term = b * (1 << (7 - j))
                expr = term if expr is None else expr + term
            return expr

        r_ = self.r
        fold4 = ((acc_p * r_ * r_ * r_ * r_)
                 + byte_of(w, 0) * r_ * r_ * r_
                 + byte_of(w, 1) * r_ * r_
                 + byte_of(w, 2) * r_ + byte_of(w, 3))
        cs.create_gate("sha acc fold", qm * (acc - fold4))
        cs.create_gate("sha acc start", qi * acc)  # 0 on first-init rows
        cs.create_gate("sha acc carry", qac * (acc - acc_p))

        # digest RLC on the final row: 32 bytes from digest rows (-3..0),
        # H'_0 first (it lives on the LAST digest row, a column)
        out = Advice(self.c_out)
        dig_words = []
        for j in range(8):  # H'_j: row 71 - (j % 4), col a for j<4 else e
            cols = self.c_a if j < 4 else self.c_e
            dig_words.append(rot(cols, j % 4))
        out_rlc = None
        rpow: Expression | None = None
        for j in range(8):
            for k in range(4):
                byte = byte_of(dig_words[j], k)
                term = byte if rpow is None else byte * rpow
                out_rlc = term if out_rlc is None else out_rlc + term
                rpow = r_ if rpow is None else rpow * r_
        cs.create_gate("sha out rlc", qf * (out - out_rlc))
        self.sha256_table = [qf, qf * Advice(self.c_acc, -52), qf * out]

    # ------------------------------------------------------------------
    def _layout(self):
        """(message index, block trace) per block, consecutive rows."""
        out = []
        for mi, trs in enumerate(self.traces):
            for bi, tr in enumerate(trs):
                out.append((mi, bi, tr))
        return out

    def fixed_columns(self, n: int):
        blocks = self._layout()
        assert len(blocks) * ROWS_PER_BLOCK <= usable_rows(n)
        mont = F.mont_from_ints
        cols = {c: [0] * n for c in (
            self.q_round, self.q_sched, self.q_msg, self.q_dig,
            self.q_first_init, self.q_chain, self.q_acc_carry, self.q_final,
            self.f_k, self.f_ha, self.f_he,
        )}
        for b, (mi, bi, tr) in enumerate(blocks):
            base = b * ROWS_PER_BLOCK
            last_block = bi == len(self.traces[mi]) - 1
            for j in range(4):
                row = base + j
                (cols[self.q_first_init] if bi == 0 else cols[self.q_chain])[row] = 1
                if bi == 0:
                    cols[self.f_ha][row] = H_INIT[3 - j]
                    cols[self.f_he][row] = H_INIT[7 - j]
                if bi > 0:
                    cols[self.q_acc_carry][row] = 1
            for t in range(64):
                row = base + 4 + t
                cols[self.q_round][row] = 1
                cols[self.f_k][row] = K[t]
                (cols[self.q_msg] if t < 16 else cols[self.q_sched])[row] = 1
                if t >= 16:
                    cols[self.q_acc_carry][row] = 1
            for j in range(4):
                cols[self.q_acc_carry][base + 68 + j] = 1
            if last_block:
                cols[self.q_final][base + 71] = 1
        return {c: mont(v) for c, v in cols.items()}

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        blocks = self._layout()
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        rows = len(blocks) * ROWS_PER_BLOCK
        if phase == 0:
            ab = [[0] * rows for _ in range(32)]
            eb = [[0] * rows for _ in range(32)]
            wb = [[0] * rows for _ in range(32)]
            ce = [[0] * rows for _ in range(3)]
            ca = [[0] * rows for _ in range(3)]
            cw = [[0] * rows for _ in range(2)]
            cda = [0] * rows
            cde = [0] * rows

            def put(bits, row, val):
                for i in range(32):
                    bits[i][row] = (val >> i) & 1

            for b, (mi, bi, tr) in enumerate(blocks):
                base = b * ROWS_PER_BLOCK
                for j in range(4):
                    put(ab, base + j, tr.h_in[3 - j])
                    put(eb, base + j, tr.h_in[7 - j])
                for t in range(64):
                    row = base + 4 + t
                    put(ab, row, tr.a_rounds[t])
                    put(eb, row, tr.e_rounds[t])
                    put(wb, row, tr.w[t])
                    for i in range(3):
                        ce[i][row] = (tr.carries_e[t] >> i) & 1
                        ca[i][row] = (tr.carries_a[t] >> i) & 1
                    for i in range(2):
                        cw[i][row] = (tr.carries_w[t] >> i) & 1
                for j in range(4):
                    row = base + 68 + j
                    put(ab, row, tr.h_out[3 - j])
                    put(eb, row, tr.h_out[7 - j])
                    cda[row] = tr.carries_h[3 - j]
                    cde[row] = tr.carries_h[7 - j]
            cols = {}
            for i in range(32):
                cols[self.c_a[i]] = mont(ab[i])
                cols[self.c_e[i]] = mont(eb[i])
                cols[self.c_w[i]] = mont(wb[i])
            for i in range(3):
                cols[self.c_ce[i]] = mont(ce[i])
                cols[self.c_ca[i]] = mont(ca[i])
            for i in range(2):
                cols[self.c_cw[i]] = mont(cw[i])
            cols[self.c_cda] = mont(cda)
            cols[self.c_cde] = mont(cde)
            return cols
        # phase 1: RLC accumulators
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        accs = [0] * rows
        outs = [0] * rows
        for b, (mi, bi, tr) in enumerate(blocks):
            base = b * ROWS_PER_BLOCK
            acc = accs[base - 1] if bi > 0 else 0
            for j in range(4):
                accs[base + j] = acc
            for t in range(64):
                row = base + 4 + t
                if t < 16:
                    wv = tr.w[t]
                    for k in range(4):
                        acc = (acc * r_int + ((wv >> (8 * (3 - k))) & 0xFF)) % R
                accs[row] = acc
            for j in range(4):
                accs[base + 68 + j] = acc
            if bi == len(self.traces[mi]) - 1:
                digest = b"".join(x.to_bytes(4, "big") for x in tr.h_out)
                out = 0
                for k in reversed(range(32)):
                    out = (out * r_int + digest[k]) % R
                outs[base + 71] = out
        return {self.c_acc: mont(accs), self.c_out: mont(outs)}
