"""PI (public input) circuit (port of zkevm_circuits_tpu/circuits/pi.py):
commits the chunk statement to the proof instance via an in-circuit keccak
binding.

Equivalent of the reference's `zkevm-circuits/src/pi_circuit.rs` (SURVEY.md
§2.2 "PI"): the public statement is a fixed-layout byte string hashed with
keccak; the 32-byte digest is exposed as TWO instance values (hi/lo
128-bit), and the byte string's hash is constrained by a lookup into the
KeccakTable.  The byte layout here is the production CHUNK HEADER of the
Scroll stack (reference aggregator/src/chunk.rs:18 `ChunkHash`):

    chain_id (8, BE) || prev_state_root (32) || post_state_root (32) ||
    withdraw_root (32) || data_hash (32)        = 136 bytes (1 keccak block)

Layout: one row per PI byte INCLUDING the keccak pad10*1 bytes
(the KeccakTable's input_rlc folds over the padded message, so the
statement rows are followed by 136 pad rows whose bytes are pinned by a
fixed column), a running msb-first RLC accumulator column, digest byte
cells + hi/lo recomposition on row 0, instance binding via two copy
constraints.  Standalone mode carries its own keccak-table witness
columns; the SuperCircuit passes the Keccak circuit's actual table.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.keccak import keccak256
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed

F = fr()

N_PI_BYTES = 136
N_PADDED = 272  # pi_bytes || pad10*1 fills exactly two keccak blocks
KECCAK_RATE = 136


def padded_pi_bytes(pi: bytes) -> bytes:
    assert len(pi) == N_PI_BYTES
    pad = bytearray(136)
    pad[0] = 0x01
    pad[-1] |= 0x80
    return pi + bytes(pad)


@dataclasses.dataclass
class PublicData:
    """The chunk statement (reference ChunkHash fields).

    When `block` (a tracer BlockEnv) and `tx_hashes` are given, the
    data_hash is DERIVED: data_hash = keccak(data_bytes()) where
    data_bytes = number(8) || timestamp(8) || base_fee(32) ||
    gas_limit(8) || num_txs(2) || tx_hash_1(32) || ... — the chunk-data
    commitment the reference derives in-circuit from the block/tx tables
    (pi_circuit.rs:140-217).  `data_hash` is then ignored/overwritten."""

    chain_id: int
    prev_state_root: bytes
    post_state_root: bytes
    withdraw_root: bytes
    data_hash: bytes = b"\x00" * 32
    block: object = None
    tx_hashes: list = None

    def data_bytes(self) -> bytes:
        assert self.block is not None
        b = self.block
        out = b.number.to_bytes(8, "big")
        out += b.timestamp.to_bytes(8, "big")
        out += b.base_fee.to_bytes(32, "big")
        out += b.gas_limit.to_bytes(8, "big")
        out += len(self.tx_hashes or []).to_bytes(2, "big")
        for h in self.tx_hashes or []:
            assert len(h) == 32
            out += h
        return out

    def derived_data_hash(self) -> bytes:
        return keccak256(self.data_bytes()) if self.block is not None \
            else self.data_hash

    def pi_bytes(self) -> bytes:
        out = self.chain_id.to_bytes(8, "big")
        for fld in (self.prev_state_root, self.post_state_root,
                    self.withdraw_root, self.derived_data_hash()):
            assert len(fld) == 32
            out += fld
        assert len(out) == N_PI_BYTES
        return out

    def digest(self) -> bytes:
        return keccak256(self.pi_bytes())

    def instance(self) -> list[int]:
        d = self.digest()
        return [int.from_bytes(d[:16], "big"), int.from_bytes(d[16:], "big")]


ROOT_PREV_OFF = 8  # byte offset of prev_state_root in pi_bytes
ROOT_POST_OFF = 40


# data region geometry: starts right after the chunk-header block
DATA_OFF = N_PADDED
# (BlockFieldTag value, byte width) in data_bytes order; num_txs follows
_DATA_BLOCK_FIELDS = [(3, 8), (2, 8), (7, 32), (5, 8)]  # Num, Ts, Fee, GL


class PiCircuit(Circuit):
    def __init__(self, public_data: PublicData):
        self.pd = public_data
        self.derive = public_data.block is not None

    def _data_geometry(self):
        n_tx = len(self.pd.tx_hashes or [])
        data_len = 58 + 32 * n_tx
        pad = KECCAK_RATE - data_len % KECCAK_RATE
        return n_tx, data_len, data_len + pad

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, keccak_table=None,
                  byte_table=None, challenge=None, block_table=None,
                  tx_hash_table=None):
        """keccak_table: (is_enabled, input_rlc, output_rlc) exprs from the
        Keccak circuit; standalone mode allocates witness columns.

        block_table + tx_hash_table (SuperCircuit mode): activate the
        DATA REGION — data_bytes rows whose block-context fields are
        looked up in the BlockTable, whose tx hashes are looked up in the
        RLP circuit's tx_hash_table (keccak of each signed envelope), and
        whose keccak digest is constrained to equal the chunk header's
        data_hash bytes — the reference's in-circuit data_hash derivation
        (pi_circuit.rs:140-217)."""
        self.standalone = keccak_table is None
        self.q_pi = cs.fixed_column()  # 1 on the N_PADDED byte rows
        self.q_one = cs.fixed_column()  # 1 on row 0 only
        self.q_pad = cs.fixed_column()  # 1 on the 136 keccak-pad rows
        self.f_pad = cs.fixed_column()  # expected pad byte on pad rows
        if byte_table is None:
            self.tbl_byte = cs.fixed_column()
            byte_table = [Fixed(self.tbl_byte)]

        self.c_byte = cs.advice_column()
        self.c_acc = cs.advice_column(phase=1)  # running msb-first RLC
        self.c_total = cs.advice_column(phase=1)  # final RLC, on row 0
        self.c_dig = [cs.advice_column() for _ in range(32)]
        self.c_hi = cs.advice_column()
        self.c_lo = cs.advice_column()
        self.inst = cs.instance_column()

        if self.standalone:
            self.t_en = cs.fixed_column()
            self.t_in = cs.advice_column(phase=1)
            self.t_out = cs.advice_column(phase=1)
            keccak_table = [
                Fixed(self.t_en), Advice(self.t_in), Advice(self.t_out)
            ]

        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        q = Fixed(self.q_pi)
        q1 = Fixed(self.q_one)
        byte = Advice(self.c_byte)
        acc, acc_prev = Advice(self.c_acc), Advice(self.c_acc, -1)
        total = Advice(self.c_total)

        # running accumulator: acc_0 = byte_0; acc_i = acc_{i-1}*r + byte_i
        cs.create_gate("pi acc first", q1 * (acc - byte))
        cs.create_gate(
            "pi acc step", q * (1 - q1) * (acc - acc_prev * self.r - byte)
        )
        # keccak pad rows carry the fixed pad10*1 pattern
        cs.create_gate(
            "pi pad bytes", Fixed(self.q_pad) * (byte - Fixed(self.f_pad))
        )
        # total (row 0) = acc at the last padded row
        cs.create_gate(
            "pi total", q1 * (total - Advice(self.c_acc, N_PADDED - 1))
        )

        # digest cells: hi/lo recomposition (big-endian halves)
        dig = [Advice(c) for c in self.c_dig]
        hi, lo = Advice(self.c_hi), Advice(self.c_lo)

        def be_fold(cells):
            expr = None
            for c in cells:
                expr = c if expr is None else expr * 256 + c
            return expr

        cs.create_gate("pi digest hi", q1 * (be_fold(dig[:16]) - hi))
        cs.create_gate("pi digest lo", q1 * (be_fold(dig[16:]) - lo))

        # digest RLC in the KeccakTable's output convention:
        # sum_k digest_byte[k] * r^k (k ascending from byte 0)
        out_rlc = None
        rpow = None
        for k in range(32):
            term = dig[k] if k == 0 else dig[k] * rpow
            out_rlc = term if out_rlc is None else out_rlc + term
            rpow = self.r if rpow is None else rpow * self.r

        # the statement: keccak(pi_bytes) == digest
        cs.lookup_logup(
            "pi keccak", [[q1, q1 * total, q1 * out_rlc]], keccak_table
        )
        # byte ranges: pi bytes on all rows + digest bytes on row 0
        inputs = [[q * byte]] + [[q1 * d_] for d_ in dig]
        cs.lookup_logup("pi byte ranges", inputs, byte_table)

        # state-root byte folds: a running big-endian fold column over the
        # prev_state_root (rows 8..39) and post_state_root (rows 40..71)
        # byte rows; the cells at rows 39/71 equal the root FIELD values
        # and are exposed for copy-binding to the account-trie MPT
        # circuit's root cells (reference super_circuit.rs:698-707 state
        # root imports).  Mod-R encoding note: fold(bytes) == root mod R;
        # a non-canonical byte encoding (root + R) would satisfy the fold
        # but change the keccak digest, which the L1-side chunk-hash
        # recomputation rejects — the digest, not the fold, carries the
        # statement (documented divergence from the reference's hi/lo
        # split).
        self.q_rstart = cs.fixed_column()  # rows 8 and 40
        self.q_rstep = cs.fixed_column()  # rows 9..39 and 41..71
        self.c_rfold = cs.advice_column()
        rf, rf_prev = Advice(self.c_rfold), Advice(self.c_rfold, -1)
        cs.create_gate("pi root fold start", Fixed(self.q_rstart) * (rf - byte))
        cs.create_gate(
            "pi root fold step",
            Fixed(self.q_rstep) * (rf - rf_prev * 256 - byte),
        )
        # ---- data region: in-circuit data_hash derivation ----------------
        self.has_data_region = (
            self.derive and block_table is not None
            and tx_hash_table is not None
        )
        if self.has_data_region:
            n_tx, data_len, padded_len = self._data_geometry()
            self.q_dstart = cs.fixed_column()  # first data row
            self.q_dstep = cs.fixed_column()  # all later data+pad rows
            self.q_dpad = cs.fixed_column()
            self.f_dpad = cs.fixed_column()
            self.q_drows = cs.fixed_column()  # data byte rows (no pads)
            self.f_fstart = cs.fixed_column()  # block-field fold anchors
            self.f_fstep = cs.fixed_column()
            self.f_flast = cs.fixed_column()
            self.f_ftag = cs.fixed_column()
            self.f_hlast = cs.fixed_column()  # tx-hash reverse-fold anchor
            self.f_hstep = cs.fixed_column()
            self.f_hfirst = cs.fixed_column()
            self.f_hidx = cs.fixed_column()
            self.f_ntxlast = cs.fixed_column()
            self.f_ntxv = cs.fixed_column()
            self.c_dacc = cs.advice_column(phase=1)  # keccak input RLC
            self.c_bfold = cs.advice_column(phase=1)  # per-field folds

            dacc, dacc_p = Advice(self.c_dacc), Advice(self.c_dacc, -1)
            bf = Advice(self.c_bfold)
            bf_p, bf_n = Advice(self.c_bfold, -1), Advice(self.c_bfold, 1)
            cs.create_gate(
                "pi data pad", Fixed(self.q_dpad) * (byte - Fixed(self.f_dpad))
            )
            cs.create_gate(
                "pi dacc start", Fixed(self.q_dstart) * (dacc - byte)
            )
            cs.create_gate(
                "pi dacc step",
                Fixed(self.q_dstep) * (dacc - dacc_p * self.r - byte),
            )
            # block-context fields fold big-endian to their raw values
            cs.create_gate(
                "pi bfold start", Fixed(self.f_fstart) * (bf - byte)
            )
            cs.create_gate(
                "pi bfold step",
                Fixed(self.f_fstep) * (bf - bf_p * 256 - byte),
            )
            # tx hashes fold in REVERSE row order with the challenge so
            # the first-row cell equals the KeccakTable's output-RLC
            # convention (sum byte_k * r^k, k ascending)
            cs.create_gate("pi hfold last", Fixed(self.f_hlast) * (bf - byte))
            cs.create_gate(
                "pi hfold step",
                Fixed(self.f_hstep) * (bf - bf_n * self.r - byte),
            )
            # num_txs bytes fold to the witnessed tx count (layout const)
            cs.create_gate(
                "pi numtx",
                Fixed(self.f_ntxlast) * (bf - Fixed(self.f_ntxv)),
            )
            gl_ = Fixed(self.f_flast)
            cs.lookup_logup(
                "pi block fields",
                [[gl_, gl_ * Fixed(self.f_ftag), gl_ * 0, gl_ * bf]],
                block_table,
            )
            gh_ = Fixed(self.f_hfirst)
            cs.lookup_logup(
                "pi tx hashes",
                [[gh_, gh_ * Fixed(self.f_hidx), gh_ * bf]],
                tx_hash_table,
            )
            # data digest == the chunk header's data_hash bytes: lookup
            # (padded data RLC, digest RLC over header rows 104..135)
            total2 = Advice(self.c_dacc, DATA_OFF + padded_len - 1)
            out2 = None
            rpow2 = None
            for k in range(32):
                cell = Advice(self.c_byte, 104 + k)
                term = cell if k == 0 else cell * rpow2
                out2 = term if out2 is None else out2 + term
                rpow2 = self.r if rpow2 is None else rpow2 * self.r
            cs.lookup_logup(
                "pi data keccak", [[q1, q1 * total2, q1 * out2]],
                keccak_table,
            )
            # data bytes ride the byte-range table too
            cs.lookup_logup(
                "pi data byte range",
                [[Fixed(self.q_drows) * byte]], byte_table,
            )

        cs.enable_equality("advice", self.c_rfold)
        cs.enable_equality("advice", self.c_hi)
        cs.enable_equality("advice", self.c_lo)
        cs.enable_equality("instance", self.inst)

    def state_root_cells(self):
        """(prev_root, post_root) fold cells — copy these to the account
        MPT circuit's first old_root / last new_root cells."""
        return (
            Cell("advice", self.c_rfold, ROOT_PREV_OFF + 31),
            Cell("advice", self.c_rfold, ROOT_POST_OFF + 31),
        )

    def copy_constraints(self, n: int):
        return [
            (Cell("instance", self.inst, 0), Cell("advice", self.c_hi, 0)),
            (Cell("instance", self.inst, 1), Cell("advice", self.c_lo, 0)),
        ]

    # ------------------------------------------------------------------
    def _data_spans(self):
        """[(kind, meta, off, width)] in data_bytes order; off relative
        to DATA_OFF.  kind: 'blk' (meta = BlockFieldTag), 'ntx', 'hash'
        (meta = tx index, 1-based)."""
        spans = []
        off = 0
        for tag, w in _DATA_BLOCK_FIELDS:
            spans.append(("blk", tag, off, w))
            off += w
        spans.append(("ntx", 0, off, 2))
        off += 2
        for t in range(len(self.pd.tx_hashes or [])):
            spans.append(("hash", t + 1, off, 32))
            off += 32
        return spans

    def _padded_data(self) -> bytes:
        data = self.pd.data_bytes()
        pad_len = KECCAK_RATE - len(data) % KECCAK_RATE
        pad = bytearray(pad_len)
        pad[0] |= 0x01
        pad[-1] |= 0x80
        return data + bytes(pad)

    def fixed_columns(self, n: int):
        end = DATA_OFF + (self._data_geometry()[2]
                          if getattr(self, "has_data_region", False) else 0)
        assert usable_rows(n) >= max(N_PADDED, 256, end)
        mont = F.mont_from_ints
        padded = padded_pi_bytes(self.pd.pi_bytes())
        out = {
            self.q_pi: mont([1 if i < N_PADDED else 0 for i in range(n)]),
            self.q_one: mont([1 if i == 0 else 0 for i in range(n)]),
            self.q_pad: mont(
                [1 if N_PI_BYTES <= i < N_PADDED else 0 for i in range(n)]
            ),
            self.f_pad: mont(
                [padded[i] if N_PI_BYTES <= i < N_PADDED else 0
                 for i in range(n)]
            ),
            self.q_rstart: mont(
                [1 if i in (ROOT_PREV_OFF, ROOT_POST_OFF) else 0
                 for i in range(n)]
            ),
            self.q_rstep: mont(
                [1 if (ROOT_PREV_OFF < i < ROOT_PREV_OFF + 32
                       or ROOT_POST_OFF < i < ROOT_POST_OFF + 32) else 0
                 for i in range(n)]
            ),
        }
        if hasattr(self, "tbl_byte"):
            out[self.tbl_byte] = mont([i if i < 256 else 0 for i in range(n)])
        if self.standalone:
            out[self.t_en] = mont([1 if i == 0 else 0 for i in range(n)])
        if getattr(self, "has_data_region", False):
            n_tx, data_len, padded_len = self._data_geometry()
            pdata = self._padded_data()
            z = lambda: [0] * n
            q_dstart, q_dstep, q_dpad, f_dpad, q_drows = (
                z(), z(), z(), z(), z()
            )
            f_fstart, f_fstep, f_flast, f_ftag = z(), z(), z(), z()
            f_hlast, f_hstep, f_hfirst, f_hidx = z(), z(), z(), z()
            f_ntxlast, f_ntxv = z(), z()
            q_dstart[DATA_OFF] = 1
            for i in range(1, padded_len):
                q_dstep[DATA_OFF + i] = 1
            for i in range(data_len, padded_len):
                q_dpad[DATA_OFF + i] = 1
                f_dpad[DATA_OFF + i] = pdata[i]
            for i in range(data_len):
                q_drows[DATA_OFF + i] = 1
            for kind, meta, off, w in self._data_spans():
                first = DATA_OFF + off
                last = first + w - 1
                if kind in ("blk", "ntx"):
                    f_fstart[first] = 1
                    for i in range(first + 1, last + 1):
                        f_fstep[i] = 1
                    if kind == "blk":
                        f_flast[last] = 1
                        f_ftag[last] = meta
                    else:
                        f_ntxlast[last] = 1
                        f_ntxv[last] = n_tx
                else:
                    f_hlast[last] = 1
                    f_hfirst[first] = 1
                    f_hidx[first] = meta
                    for i in range(first, last):
                        f_hstep[i] = 1
            out.update({
                self.q_dstart: mont(q_dstart), self.q_dstep: mont(q_dstep),
                self.q_dpad: mont(q_dpad), self.f_dpad: mont(f_dpad),
                self.q_drows: mont(q_drows),
                self.f_fstart: mont(f_fstart), self.f_fstep: mont(f_fstep),
                self.f_flast: mont(f_flast), self.f_ftag: mont(f_ftag),
                self.f_hlast: mont(f_hlast), self.f_hstep: mont(f_hstep),
                self.f_hfirst: mont(f_hfirst), self.f_hidx: mont(f_hidx),
                self.f_ntxlast: mont(f_ntxlast), self.f_ntxv: mont(f_ntxv),
            })
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        pi = padded_pi_bytes(self.pd.pi_bytes())
        dig = self.pd.digest()
        if phase == 0:
            byte_vals = list(pi)
            if getattr(self, "has_data_region", False):
                byte_vals += list(self._padded_data())
            cols = {self.c_byte: mont(byte_vals)}
            for k in range(32):
                cols[self.c_dig[k]] = mont([dig[k]])
            hi, lo = self.pd.instance()
            cols[self.c_hi] = mont([hi])
            cols[self.c_lo] = mont([lo])
            rfold = [0] * N_PADDED
            for off in (ROOT_PREV_OFF, ROOT_POST_OFF):
                acc = 0
                for j in range(32):
                    acc = (acc * 256 + pi[off + j]) % R
                    rfold[off + j] = acc
            cols[self.c_rfold] = mont(rfold)
            return cols
        # phase 1: RLC accumulators under the keccak challenge
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        accs = []
        acc = 0
        for b in pi:
            acc = (acc * r_int + b) % R
            accs.append(acc)
        out_rlc = 0
        for k in reversed(range(32)):
            out_rlc = (out_rlc * r_int + dig[k]) % R
        cols = {
            self.c_acc: mont(accs),
            self.c_total: mont([accs[-1]]),
        }
        if self.standalone:
            cols[self.t_in] = mont([accs[-1]])
            cols[self.t_out] = mont([out_rlc])
        if getattr(self, "has_data_region", False):
            n_tx, data_len, padded_len = self._data_geometry()
            pdata = self._padded_data()
            dacc_vals = [0] * (DATA_OFF + padded_len)
            acc = 0
            for i, b in enumerate(pdata):
                acc = (acc * r_int + b) % R if i else b % R
                dacc_vals[DATA_OFF + i] = acc
            bfold = [0] * (DATA_OFF + padded_len)
            for kind, meta, off, w in self._data_spans():
                first = DATA_OFF + off
                if kind in ("blk", "ntx"):
                    a = 0
                    for j in range(w):
                        a = (a * 256 + pdata[off + j]) % R
                        bfold[first + j] = a
                else:
                    a = 0
                    for j in reversed(range(w)):
                        a = (a * r_int + pdata[off + j]) % R
                        bfold[first + j] = a
            cols[self.c_dacc] = mont(dacc_vals)
            cols[self.c_bfold] = mont(bfold)
        return cols
