"""Keccak-f[1600] permutation and sponge circuits, packed bit-plane layout
(port of zkevm_circuits_tpu/circuits/keccak.py).

The core of the reference's Keccak circuit (`zkevm-circuits/src/
keccak_circuit/`, SURVEY.md §2.2 "Keccak").  The layout is bit-oriented
and packs Z = `Z_PER_ROW` z-slices of every lane into one row:

  * ROWS are z-groups: one (64/Z)-row block per round; 24 round blocks
    + 1 output block per permutation = 25*(64/Z) rows (Z=8: 200
    rows/permutation).
  * COLUMNS are (lane, z mod Z) bit planes: 25*Z state-bit columns `a`,
    5*Z theta-parity columns `c` (+2*5*Z binary-sum helpers), 25*Z
    rho/pi output columns `b`, 17*Z absorb-data columns.
  * theta lives on same-row constraints (z-aligned planes); a rotation
    by r in z becomes a COLUMN remap (i -> (i-r) mod Z) plus a constant
    ROW offset, with per-threshold row selectors `f_rowlt[t]` for the
    mod-64 wrap; chi/iota connect round block b to b+1 via a
    +(64/Z)-row rotation.  Every constraint is degree <= 4.

Columns, phases, the challenge, gate names and polynomial order are the
reference's.  The witness is the reference's too, computed with numpy
over all permutations at once: the round states of every permutation are
(P, 5, 5) uint64 lane arrays, and each column is a reshape of their bits.

Z_PER_ROW = 1 reproduces the bit-per-row layout and is kept as the
differential-testing oracle.
"""

from __future__ import annotations

import numpy as np

from ..crypto.field import fr
from ..crypto.keccak import RC, ROTC, keccak_f
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Expression, Fixed

F = fr()

Z_PER_ROW = 8  # default packing: 8 z-slices/row -> 200 rows/permutation
ROWS_PER_PERM = 25 * (64 // Z_PER_ROW)

_RC64 = np.array(RC, np.uint64)
_Z64 = np.arange(64, dtype=np.uint64)


def _xor(a: Expression, b: Expression) -> Expression:
    return a + b - 2 * a * b


def _mont_bits(bits: np.ndarray) -> np.ndarray:
    """0/1 array (..., n) -> (..., n, 32) Montgomery digits (0 or R)."""
    return np.where(bits[..., None] != 0, F.ONE_MONT, F.ZERO).astype(np.uint8)


def _bits(v: np.ndarray) -> np.ndarray:
    """uint64 lanes (...) -> their 64 bits (..., 64), bit z at index z."""
    return ((v[..., None] >> _Z64) & np.uint64(1)).astype(np.uint8)


def _rotl(v: np.ndarray, s: int) -> np.ndarray:
    s %= 64
    if s == 0:
        return v
    return (v << np.uint64(s)) | (v >> np.uint64(64 - s))


def _rows(planes: np.ndarray, z: int, rpb: int, n: int) -> np.ndarray:
    """Bit planes (P, blocks, *lanes, 64) of round blocks -> (*lanes, z, n)
    columns: bit zz of block b of permutation p sits at row
    p * 25 * rpb + b * rpb + zz // z of plane zz % z."""
    p, blocks = planes.shape[:2]
    lanes = planes.shape[2:-1]
    x = planes.reshape(p, blocks, *lanes, rpb, z)
    nl = len(lanes)
    # -> (*lanes, z, P, blocks, rpb)
    x = x.transpose(*range(2, 2 + nl), 3 + nl, 0, 1, 2 + nl)
    full = np.zeros((*lanes, z, p, 25, rpb), np.uint8)
    full[..., :blocks, :] = x
    out = np.zeros((*lanes, z, n), np.uint8)
    out[..., : p * 25 * rpb] = full.reshape(*lanes, z, p * 25 * rpb)
    return out


class KeccakFCircuit(Circuit):
    """Proves `states[i] -> keccak_f(states[i])` for each input state.

    states: list of 5x5 lane matrices (ints), as crypto/keccak.keccak_f.
    `z_per_row` in {1, 2, 4, 8, 16}: bit planes packed per row.
    """

    def __init__(self, states: list[list[list[int]]],
                 z_per_row: int = Z_PER_ROW):
        assert 64 % z_per_row == 0
        self.states = states
        self.z = z_per_row
        self.rpb = 64 // z_per_row  # rows per round block
        self.rows_per_perm = 25 * self.rpb

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem):
        Z, rpb = self.z, self.rpb
        self.q_round = cs.fixed_column()  # 1 on round-block rows (not output)
        # iota round-constant bit planes: f_rc[i] at block-row u holds
        # bit (Z*u + i) of RC[round]
        self.f_rc = [cs.fixed_column() for _ in range(Z)]
        # row-threshold selectors: f_rowlt[t] == 1 iff row-in-block < t
        # (t = 1..rpb); they express every per-column wrap condition
        # z < r  <=>  row < ceil((r - i) / Z)
        self.f_rowlt = {t: cs.fixed_column() for t in range(1, rpb + 1)}

        adv = cs.advice_column
        self.c_a = [[[adv() for _ in range(Z)] for _ in range(5)]
                    for _ in range(5)]
        self.c_c = [[adv() for _ in range(Z)] for _ in range(5)]
        self.c_q = [[adv() for _ in range(Z)] for _ in range(5)]
        self.c_w = [[adv() for _ in range(Z)] for _ in range(5)]
        self.c_b = [[[adv() for _ in range(Z)] for _ in range(5)]
                    for _ in range(5)]

        q = Fixed(self.q_round)

        def a(x, y, i, rot=0):
            return Advice(self.c_a[x][y][i], rot)

        def b(x, y, i, rot=0):
            return Advice(self.c_b[x][y][i], rot)

        # booleanity
        flat = (
            [c for xx in self.c_a for yy in xx for c in yy]
            + [c for xx in self.c_c for c in xx]
            + [c for xx in self.c_q for c in xx]
            + [c for xx in self.c_w for c in xx]
            + [c for xx in self.c_b for yy in xx for c in yy]
        )
        for col in flat:
            e = Advice(col)
            cs.create_gate("keccak bit bool", q * e * (e - 1))

        # theta parity per (x, i): sum_y a[x][y][i] = c + 2 q + 4 w
        for x in range(5):
            for i in range(Z):
                s = a(x, 0, i)
                for y in range(1, 5):
                    s = s + a(x, y, i)
                cs.create_gate(
                    f"theta sum {x},{i}",
                    q * (s - Advice(self.c_c[x][i])
                         - 2 * Advice(self.c_q[x][i])
                         - 4 * Advice(self.c_w[x][i])),
                )

        # rho/pi: b[pi(x,y)] bit z = (a[x][y] xor d[x]) bit (z - r mod 64)
        # where d[x] bit z' = c[x-1] bit z' xor c[x+1] bit (z'-1 mod 64)
        for x in range(5):
            for y in range(5):
                r = ROTC[x][y]
                tx, ty = y, (2 * x + 3 * y) % 5
                for i in range(Z):  # target plane column
                    ip = (i - r) % Z  # source plane column
                    for wrap in (False, True):
                        # source z' = Z*row + i - r (+64 if wrap); wrap
                        # active iff row < t
                        t = max(0, -(-(r - i) // Z))  # ceil((r-i)/Z)
                        if wrap and t == 0:
                            continue
                        off = (i - r - ip) // Z + (64 // Z if wrap else 0)
                        if t == 0:
                            gate = q
                        else:
                            sel = Fixed(self.f_rowlt[t])
                            gate = q * (sel if wrap else (1 - sel))
                        src_a = Advice(self.c_a[x][y][ip], off)
                        cm1 = Advice(self.c_c[(x - 1) % 5][ip], off)
                        tgt = b(tx, ty, i)
                        if ip != 0:
                            # z'-1 stays in the same row: plane ip-1
                            cp1 = Advice(self.c_c[(x + 1) % 5][ip - 1], off)
                            theta = _xor(src_a, _xor(cm1, cp1))
                            cs.create_gate(
                                f"rho/pi {x},{y},{i} w={wrap}",
                                gate * (tgt - theta),
                            )
                        else:
                            # z' - 1 crosses a row: plane Z-1, row' - 1 —
                            # wrapping to the block's last row iff the
                            # SOURCE row is block-row 0
                            src_row0 = Fixed(self.f_rowlt[1], off)
                            cp1_main = Advice(
                                self.c_c[(x + 1) % 5][Z - 1], off - 1
                            )
                            cp1_wrap = Advice(
                                self.c_c[(x + 1) % 5][Z - 1], off + rpb - 1
                            )
                            th_main = _xor(src_a, _xor(cm1, cp1_main))
                            th_wrap = _xor(src_a, _xor(cm1, cp1_wrap))
                            cs.create_gate(
                                f"rho/pi {x},{y},{i} w={wrap} inner",
                                gate * src_row0 * (tgt - th_wrap),
                            )
                            cs.create_gate(
                                f"rho/pi {x},{y},{i} w={wrap} main",
                                gate * (1 - src_row0) * (tgt - th_main),
                            )

        # chi + iota: a_next[x][y] = b[x][y] xor ((1-b[x+1][y]) b[x+2][y])
        # (+ rc bit on lane (0,0)); next round block is +rpb rows
        for x in range(5):
            for y in range(5):
                for i in range(Z):
                    nxt = Advice(self.c_a[x][y][i], rpb)
                    u = (1 - b((x + 1) % 5, y, i)) * b((x + 2) % 5, y, i)
                    chi = _xor(b(x, y, i), u)
                    if x == 0 and y == 0:
                        chi = _xor(chi, Fixed(self.f_rc[i]))
                    cs.create_gate(f"chi {x},{y},{i}", q * (nxt - chi))

    # ------------------------------------------------------------------
    def _blocks(self, n: int) -> int:
        need = len(self.states) * self.rows_per_perm
        assert need <= usable_rows(n) - self.rpb, (need, n)
        return len(self.states)

    def fixed_columns(self, n: int):
        Z, rpb = self.z, self.rpb
        nperm = self._blocks(n)
        u = np.arange(rpb)
        # per permutation: 24 round blocks then the output block
        q_round = np.zeros((nperm, 25, rpb), np.uint8)
        q_round[:, :24] = 1
        rc_bits = _bits(_RC64).reshape(24, rpb, Z)  # [rnd, u, i]
        f_rc = np.zeros((Z, nperm, 25, rpb), np.uint8)
        f_rc[:, :, :24] = rc_bits.transpose(2, 0, 1)[:, None]
        # output block: selectors stay zero, the row pattern is kept
        rowlt = {t: np.broadcast_to((u < t).astype(np.uint8), (nperm, 25, rpb))
                 for t in self.f_rowlt}

        def col(v):
            out = np.zeros(n, np.uint8)
            out[: nperm * self.rows_per_perm] = v.reshape(-1)
            return _mont_bits(out)

        out = {self.q_round: col(q_round)}
        for i in range(Z):
            out[self.f_rc[i]] = col(f_rc[i])
        for t, c in self.f_rowlt.items():
            out[c] = col(rowlt[t])
        return out

    def _round_planes(self):
        """Bits of every round of every permutation: the state a entering
        each round block (and the output block), theta's column sums
        s = c + 2 q + 4 w, and rho/pi's b, all as (P, blocks, ..., 64)."""
        st = np.array(self.states, dtype=np.uint64).reshape(-1, 5, 5)
        nperm = st.shape[0]
        a_all = np.zeros((nperm, 25, 5, 5), np.uint64)
        b_all = np.zeros((nperm, 24, 5, 5), np.uint64)
        s_all = np.zeros((nperm, 24, 5, 64), np.uint8)
        a = st
        for rnd in range(24):
            a_all[:, rnd] = a
            s_all[:, rnd] = _bits(a).sum(axis=2, dtype=np.uint8)
            c = np.bitwise_xor.reduce(a, axis=2)  # (P, 5)
            d = np.stack([c[:, (x - 1) % 5] ^ _rotl(c[:, (x + 1) % 5], 1)
                          for x in range(5)], axis=1)
            bmat = np.zeros_like(a)
            for x in range(5):
                for y in range(5):
                    bmat[:, y, (2 * x + 3 * y) % 5] = _rotl(
                        a[:, x, y] ^ d[:, x], ROTC[x][y])
            b_all[:, rnd] = bmat
            a = bmat ^ (~np.roll(bmat, -1, axis=1) & np.roll(bmat, -2, axis=1))
            a[:, 0, 0] ^= _RC64[rnd]
        a_all[:, 24] = a
        return a_all, s_all, b_all

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        if phase != 0:
            return {}
        Z, rpb = self.z, self.rpb
        self._blocks(n)
        a_all, s_all, b_all = self._round_planes()
        self._final_states = {
            p: [[int(v) for v in row] for row in a_all[p, 24]]
            for p in range(a_all.shape[0])
        }
        a_cols = _mont_bits(_rows(_bits(a_all), Z, rpb, n))  # (5, 5, Z, n, 32)
        b_cols = _mont_bits(_rows(_bits(b_all), Z, rpb, n))
        c_cols = _mont_bits(_rows(s_all & 1, Z, rpb, n))  # (5, Z, n, 32)
        q_cols = _mont_bits(_rows((s_all >> 1) & 1, Z, rpb, n))
        w_cols = _mont_bits(_rows((s_all >> 2) & 1, Z, rpb, n))
        cols = {}
        for x in range(5):
            for y in range(5):
                for i in range(Z):
                    cols[self.c_a[x][y][i]] = a_cols[x, y, i]
                    cols[self.c_b[x][y][i]] = b_cols[x, y, i]
            for i in range(Z):
                cols[self.c_c[x][i]] = c_cols[x, i]
                cols[self.c_q[x][i]] = q_cols[x, i]
                cols[self.c_w[x][i]] = w_cols[x, i]
        return cols


RATE_LANES = 17  # 136-byte rate


def _pad_blocks(msg: bytes) -> list[bytes]:
    padded = bytearray(msg)
    pad_len = 136 - (len(padded) % 136)
    padded += b"\x00" * pad_len
    padded[len(msg)] |= 0x01
    padded[-1] |= 0x80
    return [bytes(padded[i : i + 136]) for i in range(0, len(padded), 136)]


class KeccakCircuit(KeccakFCircuit):
    """Full sponge: absorb + chained permutations + KeccakTable exposure.

    The reference's `multi_keccak` witness + KeccakTable (input_rlc, len,
    output_rlc) — SURVEY.md §2.2 "Keccak".  Messages are padded host-side
    (pad10*1); permutations of one message are laid out consecutively, so
    the chain constraint `state_in = state_out_prev XOR data` is a
    -(64/Z)-row rotation.  Table columns: running input-RLC accumulator
    (updated at each absorb row-0 via a shared-power RLC mega-expression),
    output RLC bound to the digest bits at each final-output row.

    Scope note (as in the reference): pad-pattern VALIDATION against a
    length column is witness-side; everything else is constrained.
    """

    def __init__(self, messages: list[bytes], z_per_row: int = Z_PER_ROW):
        self.messages = messages
        self.blocks = [_pad_blocks(m) for m in messages]
        # chained permutation input states, per message
        states = []
        self._msg_perm_spans = []  # (first perm index, count) per message
        idx = 0
        for blks in self.blocks:
            st = [[0] * 5 for _ in range(5)]
            first = idx
            for blk in blks:
                st = [row[:] for row in st]
                for lane in range(RATE_LANES):
                    x, y = lane % 5, lane // 5
                    st[x][y] ^= int.from_bytes(
                        blk[8 * lane : 8 * lane + 8], "little"
                    )
                states.append([row[:] for row in st])
                st = keccak_f(st)
                idx += 1
            self._msg_perm_spans.append((first, len(blks)))
        super().__init__(states, z_per_row)

    def configure(self, cs: ConstraintSystem, challenge=None):
        super().configure(cs)
        Z, rpb = self.z, self.rpb
        self.q_first = cs.fixed_column()  # block-0 rows of a msg's 1st perm
        self.q_chain = cs.fixed_column()  # block-0 rows of later perms
        self.q_acc0 = cs.fixed_column()  # row 0 of each absorb block
        self.q_final = cs.fixed_column()  # row 0 of each final output block
        self.c_d = [[cs.advice_column() for _ in range(Z)]
                    for _ in range(RATE_LANES)]
        self.c_in_rlc = cs.advice_column(phase=1)  # running input RLC
        self.c_out_rlc = cs.advice_column(phase=1)  # digest RLC (table col)
        self.r = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )

        qf, qc = Fixed(self.q_first), Fixed(self.q_chain)
        for lane in range(RATE_LANES):
            for i in range(Z):
                d = Advice(self.c_d[lane][i])
                cs.create_gate("absorb data bool", (qf + qc) * d * (d - 1))
        for lane in range(25):
            x, y = lane % 5, lane // 5
            for i in range(Z):
                cur = Advice(self.c_a[x][y][i])
                prev_out = Advice(self.c_a[x][y][i], -rpb)
                if lane < RATE_LANES:
                    d = Advice(self.c_d[lane][i])
                    cs.create_gate(
                        f"absorb first {lane},{i}", qf * (cur - d)
                    )
                    cs.create_gate(
                        f"absorb chain {lane},{i}",
                        qc * (cur - _xor(prev_out, d)),
                    )
                else:
                    cs.create_gate(f"capacity first {lane},{i}", qf * cur)
                    cs.create_gate(
                        f"capacity chain {lane},{i}", qc * (cur - prev_out)
                    )

        # shared challenge powers (node-shared => evaluator-memoized)
        rpow: list[Expression] = [None] * 137  # type: ignore
        rpow[1] = self.r
        for k in range(2, 137):
            rpow[k] = rpow[k - 1] * self.r

        def bit_expr(cols, z: int) -> Expression:
            """Plane read of bit z (of a lane) from an absorb/output row 0."""
            return Advice(cols[z % Z], z // Z)

        def block_rlc() -> Expression:
            """RLC of this absorb block's 136 bytes (msb-first fold):
            sum_j byte_j * r^(135-j), bits read from the data planes
            (evaluated on an absorb row 0)."""
            expr = None
            for j in range(136):
                lane, byte_in_lane = j // 8, j % 8
                byte = None
                for i in range(8):
                    bit = bit_expr(self.c_d[lane], 8 * byte_in_lane + i)
                    term = bit if i == 0 else bit * (1 << i)
                    byte = term if byte is None else byte + term
                term = byte if j == 135 else byte * rpow[135 - j]
                expr = term if expr is None else expr + term
            return expr

        acc0 = Fixed(self.q_acc0)
        in_rlc = Advice(self.c_in_rlc)
        in_rlc_prev = Advice(self.c_in_rlc, -self.rows_per_perm)
        # first absorb: acc = block_rlc; later: acc = prev*r^136 + block_rlc
        qf0 = acc0 * Fixed(self.q_first)
        qc0 = acc0 * Fixed(self.q_chain)
        brlc = block_rlc()
        cs.create_gate("input rlc first", qf0 * (in_rlc - brlc))
        cs.create_gate(
            "input rlc chain",
            qc0 * (in_rlc - in_rlc_prev * rpow[136] - brlc),
        )

        # digest: first 32 bytes of the output state = lanes 0..3, bound at
        # the final-output row 0
        def digest_rlc() -> Expression:
            expr = None
            for k in range(32):
                lane = k // 8
                x, y = lane % 5, lane // 5
                byte = None
                for i in range(8):
                    bit = bit_expr(self.c_a[x][y], 8 * (k % 8) + i)
                    term = bit if i == 0 else bit * (1 << i)
                    byte = term if byte is None else byte + term
                term = byte if k == 0 else byte * rpow[k]
                expr = term if expr is None else expr + term
            return expr

        qfin = Fixed(self.q_final)
        out_rlc = Advice(self.c_out_rlc)
        cs.create_gate("output rlc", qfin * (out_rlc - digest_rlc()))

    def keccak_table_exprs(self) -> list:
        """(is_enabled, input_rlc, output_rlc) — the KeccakTable the
        Bytecode/Tx circuits look hashes up in (input_rlc convention:
        msb-first byte fold acc = acc*r + byte, matching bytecode's
        value_rlc)."""
        q = Fixed(self.q_final)
        # the running input-RLC lives on absorb row 0 of the same (last)
        # permutation — a static -(24*rpb) rotation from the final-output
        # row
        return [
            q,
            q * Advice(self.c_in_rlc, -24 * self.rpb),
            q * Advice(self.c_out_rlc),
        ]

    # ------------------------------------------------------------------
    def fixed_columns(self, n: int):
        out = super().fixed_columns(n)
        rpb = self.rpb
        q_first = np.zeros(n, np.uint8)
        q_chain = np.zeros(n, np.uint8)
        q_acc0 = np.zeros(n, np.uint8)
        q_final = np.zeros(n, np.uint8)
        for first, count in self._msg_perm_spans:
            for pi in range(count):
                base = (first + pi) * self.rows_per_perm
                (q_first if pi == 0 else q_chain)[base : base + rpb] = 1
                q_acc0[base] = 1
            q_final[(first + count - 1) * self.rows_per_perm + 24 * rpb] = 1
        out[self.q_first] = _mont_bits(q_first)
        out[self.q_chain] = _mont_bits(q_chain)
        out[self.q_acc0] = _mont_bits(q_acc0)
        out[self.q_final] = _mont_bits(q_final)
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        Z, rpb = self.z, self.rpb
        if phase == 0:
            cols = super().synthesize(phase, n, challenges, instances)
            nperm = len(self.states)
            lanes = np.zeros((nperm, RATE_LANES), np.uint64)
            for (first, count), blks in zip(self._msg_perm_spans, self.blocks):
                for pi, blk in enumerate(blks):
                    lanes[first + pi] = np.frombuffer(blk, "<u8")
            # data bits sit in block 0 of their permutation
            dcols = _mont_bits(_rows(_bits(lanes)[:, None], Z, rpb, n))
            for lane in range(RATE_LANES):
                for i in range(Z):
                    cols[self.c_d[lane][i]] = dcols[lane, i]
            return cols
        # phase 1: RLC accumulators
        mont = lambda vals: F.mont_from_ints_padded(vals, n)  # noqa: E731
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        in_rlc = [0] * n
        out_rlc = [0] * n
        for (first, count), blks in zip(self._msg_perm_spans, self.blocks):
            acc = 0
            for pi, blk in enumerate(blks):
                for byte in blk:
                    acc = (acc * r_int + byte) % R
                base = (first + pi) * self.rows_per_perm
                in_rlc[base] = acc
            final_perm = first + count - 1
            st = self._final_states[final_perm]
            digest = b"".join(
                st[k % 5][k // 5].to_bytes(8, "little") for k in range(4)
            )[:32]
            dr = 0
            for i, byte in enumerate(digest):
                dr = (dr + byte * pow(r_int, i, R)) % R
            out_rlc[final_perm * self.rows_per_perm + 24 * rpb] = dr
        return {self.c_in_rlc: mont(in_rlc), self.c_out_rlc: mont(out_rlc)}
