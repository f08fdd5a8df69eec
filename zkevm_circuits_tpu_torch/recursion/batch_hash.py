"""In-circuit ChunkHash / BatchHash derivation (VERDICT r4 missing #6 /
next-step #10).

The reference AggregationCircuit re-computes every chunk pi-hash and the
batch hash INSIDE the circuit and enforces chunk continuity
(aggregator/src/core.rs:223-250 `extract_hash_cells`, src/batch.rs:19-33,
src/chunk.rs:18); prior rounds kept this chain host-side
(recursion/aggregation.py ChunkHash/BatchHash).  This module closes that
link: `BatchHashCircuit` proves, for M <= 15 chunks,

    pi_hash_i  = keccak(chain_id_8 || prev_root_i || post_root_i ||
                        withdraw_root_i || data_hash_i)       (136 bytes)
    post_root_i == prev_root_{i+1}, chain_id_i == chain_id_{i+1}
    batch_hash = keccak(pi_hash_1 || ... || pi_hash_M)

entirely from byte cells, with every keccak bound through the
KeccakTable convention used by the PI circuit (circuits/pi.py): a
running msb-first input RLC under the phase-0 challenge, digest bytes
folded ascending.  The chunk digests are never free witnesses: they ARE
the batch-preimage byte rows, bound by the per-chunk keccak lookups.

Row layout (SEG = 272 = one 136-byte preimage + its full pad block):

    [chunk 0: 136 preimage + 136 pad]  rows 0..272
    ...
    [chunk M-1]                        rows (M-1)*272..M*272
    [batch: 32*M digest bytes + pad]   rows M*272..M*272+BP

Instance: (batch_hi, batch_lo, chain_id, prev_root_hi/lo of chunk 0,
post_root_hi/lo of chunk M-1) — the binding points an outer aggregation
statement pins against the folded accumulator / PI circuit roots.

Standalone mode fills a witness KeccakTable (same dev convention as the
PI circuit); composed mode takes the packed Keccak circuit's table.

Port of zkevm_circuits_tpu/recursion/batch_hash.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

from ..crypto.field import fr
from ..crypto.keccak import keccak256
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from .aggregation import BatchHash

F = fr()

SEG = 272          # 136-byte chunk preimage + 136 pad rows
PRE = 136
KECCAK_RATE = 136


def _padded(data: bytes) -> bytes:
    pad_len = KECCAK_RATE - len(data) % KECCAK_RATE
    pad = bytearray(pad_len)
    pad[0] |= 0x01
    pad[-1] |= 0x80
    return data + bytes(pad)


class BatchHashCircuit(Circuit):
    def __init__(self, batch: BatchHash):
        self.batch = batch
        self.m = len(batch.chunks)
        self.bp = len(_padded(b"\x00" * (32 * self.m)))  # padded batch len
        self.rows = self.m * SEG + self.bp

    # ------------------------------------------------------------------
    def instance(self) -> list[int]:
        b = self.batch
        h = b.pi_hash()
        c0, cl = b.chunks[0], b.chunks[-1]
        return [
            h >> 128, h & ((1 << 128) - 1),
            c0.chain_id,
            c0.prev_state_root >> 128,
            c0.prev_state_root & ((1 << 128) - 1),
            cl.post_state_root >> 128,
            cl.post_state_root & ((1 << 128) - 1),
        ]

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, challenge=None,
                  keccak_table=None, byte_table=None):
        m, bp = self.m, self.bp
        self.standalone = keccak_table is None
        self.q_act = cs.fixed_column()    # all active byte rows
        self.q_seg0 = cs.fixed_column()   # first row of every segment
        self.q_c0 = cs.fixed_column()     # first row of each CHUNK segment
        self.q_b0 = cs.fixed_column()     # first row of the batch segment
        self.q_one = cs.fixed_column()    # absolute row 0
        self.q_pad = cs.fixed_column()
        self.f_pad = cs.fixed_column()
        self.q_cont = cs.fixed_column()   # prev-root rows of chunks >= 1
        self.q_cid = cs.fixed_column()    # chain-id rows of chunks >= 1
        if byte_table is None:
            self.tbl_byte = cs.fixed_column()
            byte_table = [Fixed(self.tbl_byte)]

        self.c_byte = cs.advice_column()
        self.c_dig = [cs.advice_column() for _ in range(32)]
        self.c_exp = [cs.advice_column() for _ in range(7)]
        self.c_acc = cs.advice_column(phase=1)
        self.c_tot = cs.advice_column(phase=1)
        self.inst = cs.instance_column()
        if self.standalone:
            self.t_en = cs.fixed_column()
            self.t_in = cs.advice_column(phase=1)
            self.t_out = cs.advice_column(phase=1)
            keccak_table = [
                Fixed(self.t_en), Advice(self.t_in), Advice(self.t_out)
            ]
        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        q = Fixed(self.q_act)
        s0 = Fixed(self.q_seg0)
        c0 = Fixed(self.q_c0)
        b0 = Fixed(self.q_b0)
        one = Fixed(self.q_one)
        byte = Advice(self.c_byte)
        acc, acc_p = Advice(self.c_acc), Advice(self.c_acc, -1)
        tot = Advice(self.c_tot)

        # running msb-first RLC, reset at every segment start
        cs.create_gate("bh acc first", s0 * (acc - byte))
        cs.create_gate(
            "bh acc step", (q - s0) * (acc - acc_p * self.r - byte)
        )
        cs.create_gate(
            "bh pad bytes", Fixed(self.q_pad) * (byte - Fixed(self.f_pad))
        )
        # per-segment totals at the segment's first row
        cs.create_gate("bh chunk total", c0 * (tot - Advice(self.c_acc, SEG - 1)))
        cs.create_gate("bh batch total", b0 * (tot - Advice(self.c_acc, bp - 1)))
        # chunk continuity: prev_root_i == post_root_{i-1} (same offset
        # delta for every i: -SEG + 32 rows back), chain ids equal
        cs.create_gate(
            "bh root chain", Fixed(self.q_cont) * (byte - Advice(self.c_byte, 32 - SEG))
        )
        cs.create_gate(
            "bh chain id", Fixed(self.q_cid) * (byte - Advice(self.c_byte, -SEG))
        )

        # chunk keccak lookups, all anchored at the batch segment's first
        # row: input = that chunk's total (c_tot lives at its seg start),
        # output = ascending-fold of the 32 batch-preimage bytes that ARE
        # its digest.  The digests are therefore never free witnesses.
        kec_inputs = []
        for i in range(m):
            t_i = Advice(self.c_tot, -(m - i) * SEG)
            out_i = None
            rp = None
            for k in range(32):
                term = (Advice(self.c_byte, 32 * i + k) if k == 0
                        else Advice(self.c_byte, 32 * i + k) * rp)
                out_i = term if out_i is None else out_i + term
                rp = self.r if rp is None else rp * self.r
            kec_inputs.append([b0, b0 * t_i, b0 * out_i])
        # batch keccak: input = batch total, output = c_dig fold
        dig = [Advice(c) for c in self.c_dig]
        out_b = None
        rp = None
        for k in range(32):
            term = dig[k] if k == 0 else dig[k] * rp
            out_b = term if out_b is None else out_b + term
            rp = self.r if rp is None else rp * self.r
        kec_inputs.append([b0, b0 * tot, b0 * out_b])
        cs.lookup_logup("bh keccak", kec_inputs, keccak_table)

        # exposed cells (c_exp, row 0): batch hi/lo, chain id, chunk-0
        # prev root hi/lo, last-chunk post root hi/lo — all recomposed
        # from the SAME byte cells the keccak statements consume
        def be_fold(cells):
            e = None
            for c_ in cells:
                e = c_ if e is None else e * 256 + c_
            return e

        exp = [Advice(c) for c in self.c_exp]
        # batch digest hi/lo live on the batch row; bind through a
        # rotation from row 0 (distance m*SEG)
        cs.create_gate(
            "bh exp hi",
            one * (be_fold([Advice(c, m * SEG) for c in self.c_dig[:16]])
                   - exp[0]),
        )
        cs.create_gate(
            "bh exp lo",
            one * (be_fold([Advice(c, m * SEG) for c in self.c_dig[16:]])
                   - exp[1]),
        )
        cs.create_gate(
            "bh exp chain",
            one * (be_fold([Advice(self.c_byte, j) for j in range(8)])
                   - exp[2]),
        )
        cs.create_gate(
            "bh exp prev hi",
            one * (be_fold([Advice(self.c_byte, 8 + j) for j in range(16)])
                   - exp[3]),
        )
        cs.create_gate(
            "bh exp prev lo",
            one * (be_fold([Advice(self.c_byte, 24 + j) for j in range(16)])
                   - exp[4]),
        )
        last = (m - 1) * SEG + 40
        cs.create_gate(
            "bh exp post hi",
            one * (be_fold([Advice(self.c_byte, last + j) for j in range(16)])
                   - exp[5]),
        )
        cs.create_gate(
            "bh exp post lo",
            one * (be_fold([Advice(self.c_byte, last + 16 + j)
                            for j in range(16)]) - exp[6]),
        )

        # byte ranges
        cs.lookup_logup(
            "bh byte range",
            [[q * byte]] + [[b0 * d] for d in dig],
            byte_table,
        )
        for c in self.c_exp:
            cs.enable_equality("advice", c)
        cs.enable_equality("instance", self.inst)

    def copy_constraints(self, n: int):
        return [
            (Cell("instance", self.inst, k), Cell("advice", self.c_exp[k], 0))
            for k in range(7)
        ]

    # ------------------------------------------------------------------
    def _byte_rows(self) -> bytes:
        out = b""
        for c in self.batch.chunks:
            out += _padded(c.bytes_preimage())
        out += _padded(
            b"".join(c.pi_hash().to_bytes(32, "big")
                     for c in self.batch.chunks)
        )
        assert len(out) == self.rows
        return out

    def fixed_columns(self, n: int):
        m, bp = self.m, self.bp
        assert usable_rows(n) >= self.rows
        mont = F.mont_from_ints
        rows = self._byte_rows()
        z = lambda: [0] * n
        q_act, q_seg0, q_c0, q_b0 = z(), z(), z(), z()
        q_pad, f_pad, q_cont, q_cid = z(), z(), z(), z()
        for i in range(self.rows):
            q_act[i] = 1
        for i in range(m):
            q_seg0[i * SEG] = 1
            q_c0[i * SEG] = 1
            for j in range(PRE, SEG):
                q_pad[i * SEG + j] = 1
                f_pad[i * SEG + j] = rows[i * SEG + j]
            if i >= 1:
                for j in range(32):
                    q_cont[i * SEG + 8 + j] = 1
                for j in range(8):
                    q_cid[i * SEG + j] = 1
        q_seg0[m * SEG] = 1
        q_b0[m * SEG] = 1
        for j in range(32 * m, bp):
            q_pad[m * SEG + j] = 1
            f_pad[m * SEG + j] = rows[m * SEG + j]
        out = {
            self.q_act: mont(q_act), self.q_seg0: mont(q_seg0),
            self.q_c0: mont(q_c0), self.q_b0: mont(q_b0),
            self.q_one: mont([1] + [0] * (n - 1)),
            self.q_pad: mont(q_pad), self.f_pad: mont(f_pad),
            self.q_cont: mont(q_cont), self.q_cid: mont(q_cid),
        }
        if hasattr(self, "tbl_byte"):
            out[self.tbl_byte] = mont([i if i < 256 else 0 for i in range(n)])
        if self.standalone:
            t_en = z()
            for i in range(m + 1):
                t_en[i] = 1
            out[self.t_en] = mont(t_en)
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        m, bp = self.m, self.bp
        rows = self._byte_rows()
        bdig = self.batch.pi_hash().to_bytes(32, "big")
        if phase == 0:
            cols = {self.c_byte: mont(list(rows))}
            for k in range(32):
                # digest cells ride the batch segment's first row
                col = [0] * (m * SEG + 1)
                col[m * SEG] = bdig[k]
                cols[self.c_dig[k]] = mont(col)
            for k, v in enumerate(self.instance()):
                cols[self.c_exp[k]] = mont([v])
            return cols
        # phase 1: per-segment RLC accumulators + totals
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        accs = [0] * self.rows
        tots = [0] * (m * SEG + 1)
        segs = [(i * SEG, SEG) for i in range(m)] + [(m * SEG, bp)]
        t_ins, t_outs = [], []
        for start, ln in segs:
            a = 0
            for j in range(ln):
                a = (a * r_int + rows[start + j]) % R
                accs[start + j] = a
            tots[start] = a
            t_ins.append(a)
        cols = {self.c_acc: mont(accs), self.c_tot: mont(tots)}
        if self.standalone:
            for c in self.batch.chunks:
                d = c.pi_hash().to_bytes(32, "big")
                o = 0
                for k in reversed(range(32)):
                    o = (o * r_int + d[k]) % R
                t_outs.append(o)
            o = 0
            for k in reversed(range(32)):
                o = (o * r_int + bdig[k]) % R
            t_outs.append(o)
            cols[self.t_in] = mont(t_ins)
            cols[self.t_out] = mont(t_outs)
        return cols
