"""Copy circuit — byte-accurate copy proofs between data sources.

Equivalent of the reference's `zkevm-circuits/src/copy_circuit.rs`
(SURVEY.md §2.2 "Copy"): one row per copied byte with source/destination
continuity and bus bindings — the source byte must appear in the source
table (TxTable calldata rows for CALLDATACOPY) and the destination write
must appear in the RW table (Memory rows).

Flat one-row-per-byte layout, both bindings on logUp
arguments; in the SuperCircuit both table sides are the other circuits'
actual columns.

Copy kinds:
  * calldata -> memory (CALLDATACOPY): source byte in the TxTable
    calldata rows, destination write in the RW table.
  * memory -> RLC (SHA3): source byte READ from the RW table, bytes
    accumulated msb-first (acc = acc*r + byte) into a running RLC whose
    final value is exposed through the CopyTable — the EVM SHA3 gadget
    extends it over the keccak pad10*1 suffix and looks the padded RLC
    up in the KeccakTable (reference copy_circuit's RlcAcc destination).

`is_pad` (out-of-range source bytes, zero-filled) is witness-driven with
byte=0 enforced — the LT gadget binding is_pad to src_addr >=
calldata_length lands with the word gadget family (documented gap,
mirrors the reference's copy pad logic).

Port of zkevm_circuits_tpu/circuits/copy.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..witness.builder import CopyEvent
from ..witness.rw import RwTag
from .tx import TxFieldTag

F = fr()


@dataclasses.dataclass
class CopyParams:
    target_rows: int = 0


class CopyCircuit(Circuit):
    def __init__(self, events: list[CopyEvent], params: CopyParams | None = None,
                 rw_rows=None, tx_rows=None):
        """Standalone mode: `rw_rows` (list of Rw) and `tx_rows`
        (list of (tx_id, index, byte)) back the in-circuit tables."""
        self.events = events
        self.params = params or CopyParams()
        self.rw_rows = rw_rows
        self.tx_rows = tx_rows

    def configure(self, cs: ConstraintSystem, rw_table=None, tx_table=None,
                  challenge=None, bytecode_table=None):
        self.standalone = rw_table is None
        self.q_copy = cs.fixed_column()

        self.c_active = cs.advice_column()
        self.c_cont = cs.advice_column()  # next row continues this event
        self.c_pad = cs.advice_column()  # source out of range (byte = 0)
        self.c_src_end = cs.advice_column()  # first OOR source address
        self.c_src_id = cs.advice_column()
        self.c_src_addr = cs.advice_column()
        self.c_dst_id = cs.advice_column()
        self.c_dst_addr = cs.advice_column()
        self.c_byte = cs.advice_column()
        self.c_rwc = cs.advice_column()
        self.c_left = cs.advice_column()  # bytes left incl. this row
        self.c_is_rlc = cs.advice_column()  # memory -> RLC event kind
        self.c_is_mm = cs.advice_column()  # memory -> memory event kind
        self.c_is_log = cs.advice_column()  # memory -> TxLog event kind
        self.c_is_code = cs.advice_column()  # bytecode -> memory event kind
        self.c_is_wrlc = cs.advice_column()  # RLC-bound memory WRITE kind
        self.c_src_hash = cs.advice_column(phase=1)  # code-hash RLC (code)
        self.c_acc = cs.advice_column(phase=1)  # running byte RLC

        if self.standalone:
            self.t_rwc = cs.advice_column()
            self.t_isw = cs.advice_column()
            self.t_tag = cs.advice_column()
            self.t_id = cs.advice_column()
            self.t_addr = cs.advice_column()
            self.t_byte = cs.advice_column()
            self.x_txid = cs.advice_column()
            self.x_idx = cs.advice_column()
            self.x_byte = cs.advice_column()
            self.q_trw = cs.fixed_column()
            self.q_ttx = cs.fixed_column()
        self.r_word = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )

        q = Fixed(self.q_copy)
        act = Advice(self.c_active)
        cont, cont_n = Advice(self.c_cont), Advice(self.c_cont, 1)
        pad = Advice(self.c_pad)
        sid, sid_n = Advice(self.c_src_id), Advice(self.c_src_id, 1)
        sad, sad_n = Advice(self.c_src_addr), Advice(self.c_src_addr, 1)
        did, did_n = Advice(self.c_dst_id), Advice(self.c_dst_id, 1)
        dad, dad_n = Advice(self.c_dst_addr), Advice(self.c_dst_addr, 1)
        byte = Advice(self.c_byte)
        rwc, rwc_n = Advice(self.c_rwc), Advice(self.c_rwc, 1)

        for name, e in (("active", act), ("cont", cont), ("pad", pad)):
            cs.create_gate(f"{name} bool", q * e * (e - 1))
        cs.create_gate("cont implies active", q * cont * (1 - act))
        cs.create_gate("pad byte zero", q * pad * byte)
        # pad boundary binding: src_end (constant per event, exported in
        # the CopyTable so the EVM gadgets pin it to a context-read value)
        # is the first out-of-range source address.  pad is MONOTONE
        # within the event and flips exactly at sad == src_end; with sad
        # incrementing by 1 per row this makes pad == (sad >= src_end) —
        # sound both ways (the r1-r4 witness-driven pad let a prover
        # claim pad on an in-range byte, forcing byte = 0).  Events with
        # src_end == 0 declare "no pads" (pad forced 0).
        send, send_n = Advice(self.c_src_end), Advice(self.c_src_end, 1)
        pad_n = Advice(self.c_pad, 1)
        cs.create_gate("copy cont src_end", q * cont * (send_n - send))
        cs.create_gate("pad monotone", q * cont * pad * (pad_n - 1))
        cs.create_gate(
            "pad flip at boundary",
            q * cont * (1 - pad) * pad_n * (sad_n - send),
        )
        gf0 = q * act * (1 - Advice(self.c_cont, -1))
        cs.create_gate("pad first row boundary", gf0 * pad * (sad - send))
        # unbounded sources declare src_end = 2^40 — unreachable by any
        # u32-ranged source address, so pad can never flip on (both pad
        # entry points above require sad == send exactly)
        imm, imm_n = Advice(self.c_is_mm), Advice(self.c_is_mm, 1)
        for name, cur, nxt, d in (
            ("src_addr", sad, sad_n, 1), ("dst_addr", dad, dad_n, 1),
        ):
            cs.create_gate(f"copy cont {name}", q * cont * (nxt - cur - d))
        # memory->memory and memory->TxLog rows consume TWO rw counters
        # (read + write) — except PADDED memory-source rows, whose read
        # is skipped (the write of 0 is the only rw)
        ilog_f = Advice(self.c_is_log)
        cs.create_gate(
            "copy cont rwc",
            q * cont * (rwc_n - rwc - 1 - imm * (1 - pad) - ilog_f),
        )
        cs.create_gate("copy cont src_id", q * cont * (sid_n - sid))
        cs.create_gate("copy cont dst_id", q * cont * (did_n - did))
        # length countdown: first row holds the event length, decrements to
        # 1 on the last row — makes `length` a sound first-row value for
        # the exposed CopyTable (reference copy_circuit's bytes_left)
        left, left_n = Advice(self.c_left), Advice(self.c_left, 1)
        cs.create_gate("copy left countdown", q * cont * (left_n - left + 1))
        cs.create_gate("copy left last", q * act * (1 - cont) * (left - 1))

        # memory -> RLC kind: flag constant within the event, running
        # accumulator acc = acc_prev * r + byte (msb-first, the KeccakTable
        # input convention), first row seeds acc = byte
        irlc, irlc_n = Advice(self.c_is_rlc), Advice(self.c_is_rlc, 1)
        acc, acc_n = Advice(self.c_acc), Advice(self.c_acc, 1)
        cs.create_gate("is_rlc bool", q * irlc * (irlc - 1))
        cs.create_gate("is_rlc implies active", q * irlc * (1 - act))
        cs.create_gate("copy cont is_rlc", q * cont * (irlc_n - irlc))
        cs.create_gate("is_mm bool", q * imm * (imm - 1))
        cs.create_gate("is_mm implies active", q * imm * (1 - act))
        cs.create_gate("is_mm xor is_rlc", q * imm * irlc)
        cs.create_gate("copy cont is_mm", q * cont * (imm_n - imm))
        ilog, ilog_n = Advice(self.c_is_log), Advice(self.c_is_log, 1)
        cs.create_gate("is_log bool", q * ilog * (ilog - 1))
        cs.create_gate("is_log implies active", q * ilog * (1 - act))
        cs.create_gate("is_log excl", q * ilog * (irlc + imm))
        cs.create_gate("copy cont is_log", q * cont * (ilog_n - ilog))
        iwr, iwr_n = Advice(self.c_is_wrlc), Advice(self.c_is_wrlc, 1)
        cs.create_gate("is_wrlc bool", q * iwr * (iwr - 1))
        cs.create_gate("is_wrlc implies active", q * iwr * (1 - act))
        cs.create_gate("copy cont is_wrlc", q * cont * (iwr_n - iwr))
        icode, icode_n = Advice(self.c_is_code), Advice(self.c_is_code, 1)
        shash, shash_n = Advice(self.c_src_hash), Advice(self.c_src_hash, 1)
        cs.create_gate("is_code bool", q * icode * (icode - 1))
        cs.create_gate("is_code implies active", q * icode * (1 - act))
        cs.create_gate("is_code excl", q * icode * (irlc + imm + ilog))
        cs.create_gate("is_wrlc excl", q * iwr * (irlc + imm + ilog + icode))
        cs.create_gate("copy cont is_code", q * cont * (icode_n - icode))
        cs.create_gate("copy cont src_hash", q * cont * (shash_n - shash))
        gf = q * act * (1 - Advice(self.c_cont, -1))
        rlc_kind = irlc + iwr
        cs.create_gate("acc seed", gf * rlc_kind * (acc - byte))
        cs.create_gate(
            "acc chain",
            q * cont * rlc_kind
            * (acc_n - acc * self.r_word - Advice(self.c_byte, 1)),
        )

        # exposed CopyTable, gated on each event's first row (the previous
        # row's cont is 0 there; advice is zero-padded so row -1 wraps to
        # 0).  The acc element carries the event's FINAL running RLC for
        # memory->RLC events (claimed on the first row by c_acc_last, which
        # propagates forward and must equal acc on the last row).
        self.c_acc_last = cs.advice_column(phase=1)
        accl, accl_n = Advice(self.c_acc_last), Advice(self.c_acc_last, 1)
        cs.create_gate("acc_last cont", q * cont * (accl_n - accl))
        cs.create_gate(
            "acc_last pins acc",
            q * act * (1 - cont) * rlc_kind * (accl - acc),
        )
        # code events carry their source id in the phase-1 hash column
        sid_out = sid + icode * (shash - sid)
        self.copy_table = [
            gf, gf * irlc, gf * imm, gf * ilog, gf * icode, gf * iwr,
            gf * sid_out, gf * sad, gf * did, gf * dad, gf * left,
            gf * rwc, gf * accl,
        ]
        # narrow side table binding each event's pad boundary: consumers
        # that produce paddable events (CALLDATACOPY root+nested) pin
        # src_end here, keyed by the event identity (dst_id, dst_addr,
        # rwc — unique per event).  Events without a consumer-side pin
        # keep a witness-chosen boundary (CODECOPY/EXTCODECOPY v1 gap,
        # documented) — pad placement is still internally consistent.
        self.copy_bound_table = [gf, gf * did, gf * dad, gf * rwc, gf * send]

        if self.standalone:
            trw = Fixed(self.q_trw)
            # (rwc, is_write, tag, id, addr, field_tag, key_rlc, value)
            rw_table = [
                trw * Advice(self.t_rwc), trw * Advice(self.t_isw),
                trw * Advice(self.t_tag),
                trw * Advice(self.t_id), trw * Advice(self.t_addr),
                trw * 0, trw * 0, trw * Advice(self.t_byte),
            ]
            ttx = Fixed(self.q_ttx)
            tx_table = [
                ttx * Advice(self.x_txid), ttx * int(TxFieldTag.CallData),
                ttx * Advice(self.x_idx), ttx * Advice(self.x_byte),
            ]

        g = q * act
        gw = g * (1 - irlc)
        gr = g * (irlc + imm + ilog) * (1 - pad)
        # destination tag: Memory, except TxLog for log-data events
        dst_tag = int(RwTag.Memory) + ilog * (
            int(RwTag.TxLog) - int(RwTag.Memory)
        )
        cs.lookup_logup(
            "copy rw bus",
            [
                # destination WRITE (calldata->memory at rwc; memory->
                # memory / memory->TxLog at rwc+1 after the paired read;
                # padded memory-source rows write directly at rwc)
                [gw * (rwc + imm * (1 - pad) + ilog), gw, gw * dst_tag,
                 gw * did, gw * dad, gw * 0, gw * 0, gw * byte],
                # source READ (memory->RLC / ->memory / ->TxLog; skipped
                # on pad rows)
                [gr * rwc, gr * 0, gr * int(RwTag.Memory), gr * sid,
                 gr * sad, gr * 0, gr * 0, gr * byte],
            ],
            rw_table,
        )
        gs = g * (1 - pad) * (1 - irlc - imm - ilog - icode - iwr)
        cs.lookup_logup(
            "copy tx source",
            [[gs * sid, gs * int(TxFieldTag.CallData), gs * sad, gs * byte]],
            tx_table,
        )
        if bytecode_table is not None:
            # bytecode source: (is_enabled, code_hash_rlc, index, value,
            # is_code) — the is_code flag of the fetched byte is free
            # (CODECOPY copies data and code bytes alike), carried in a
            # witness cell so the tuple matches exactly
            self.c_src_iscode = cs.advice_column()
            sic = Advice(self.c_src_iscode)
            gc_ = g * (1 - pad) * icode
            cs.create_gate("src iscode bool", q * sic * (sic - 1))
            cs.lookup_logup(
                "copy bytecode source",
                [[gc_, gc_ * shash, gc_ * sad, gc_ * byte, gc_ * sic]],
                bytecode_table,
            )
        else:
            self.c_src_iscode = None

    # ------------------------------------------------------------------
    def _target(self, n: int) -> int:
        t = self.params.target_rows or usable_rows(n)
        need = sum(ev.length for ev in self.events)
        assert need <= t <= usable_rows(n)
        return t

    def _mem_rws(self):
        # standalone dev table: Memory rows plus TxLog rows (LOG-data
        # destinations); composed mode uses the State circuit's table
        return [r for r in (self.rw_rows or [])
                if r.tag in (RwTag.Memory, RwTag.TxLog)]

    def fixed_columns(self, n: int):
        t = self._target(n)
        mont = F.mont_from_ints
        out = {self.q_copy: mont([1 if i < t else 0 for i in range(n)])}
        if self.standalone:
            nrw = len(self._mem_rws())
            ntx = len(self.tx_rows or [])
            out[self.q_trw] = mont([1 if i < nrw else 0 for i in range(n)])
            out[self.q_ttx] = mont([1 if i < ntx else 0 for i in range(n)])
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        rows = []  # (act, cont, pad, sid, sad, did, dad, byte, rwc, left,
        # rlc, mm)
        for ev in self.events:
            is_rlc = int(ev.dst_type == "rlc")
            is_mm = int(ev.src_type == "memory" and ev.dst_type == "memory")
            is_log = int(ev.dst_type == "txlog")
            is_code = int(ev.src_type == "bytecode")
            is_wr = int(ev.src_type == "rlc")  # RLC-bound memory write
            plain = not (is_rlc or is_mm or is_log or is_code or is_wr)
            # src_len (first out-of-range source address, same units as
            # src_addr; -1 = unbounded) drives padding for every kind
            src_end = ev.src_len if ev.src_len >= 0 else (1 << 40)
            rwc = ev.rw_counter_start
            for j in range(ev.length):
                src = ev.src_addr + j
                is_pad = int(ev.src_len >= 0 and src >= ev.src_len)
                if plain and self.tx_rows is not None and ev.src_len < 0:
                    in_range = any(
                        t[0] == ev.src_id and t[1] == src for t in self.tx_rows
                    )
                    is_pad = 0 if in_range else 1
                rows.append((
                    1, int(j + 1 < ev.length), is_pad,
                    0 if is_code else ev.src_id, src, ev.dst_id,
                    ev.dst_addr + j, ev.bytes_[j],
                    rwc,
                    ev.length - j, is_rlc, is_mm, is_log, is_code,
                    ev.src_id if is_code else 0,
                    (ev.code_marks[j] if is_code and j < len(ev.code_marks)
                     else 0),
                    is_wr, src_end,
                ))
                rwc += 1 + is_mm * (1 - is_pad) + is_log
        if phase != 0:
            # running byte RLC + per-event final-acc claim, walking
            # explicit event boundaries
            r_chal = challenges[self.r_word.index]
            r_int = F.to_int(F.from_mont(r_chal))
            accs, lasts = [], []
            i = 0
            while i < len(rows):
                j = i
                acc = 0
                ev_accs = []
                is_acc_kind = rows[i][10] or rows[i][16]
                while True:
                    acc = ((acc * r_int + rows[j][7]) % R
                           if is_acc_kind else 0)
                    ev_accs.append(acc)
                    if not rows[j][1]:
                        break
                    j += 1
                final = ev_accs[-1] if is_acc_kind else 0
                accs.extend(ev_accs)
                lasts.extend([final] * len(ev_accs))
                i = j + 1
            hashes = []
            rpows = [pow(r_int, i, R) for i in range(32)]
            for row in rows:
                h = row[14]
                hashes.append(
                    sum(b * rpows[i] for i, b in
                        enumerate(h.to_bytes(32, "big"))) % R if h else 0
                )
            return {
                self.c_acc: mont(accs),
                self.c_acc_last: mont(lasts),
                self.c_src_hash: mont(hashes),
            }
        cols = {}
        for ci, k in (
            (self.c_active, 0), (self.c_cont, 1), (self.c_pad, 2),
            (self.c_src_id, 3), (self.c_src_addr, 4), (self.c_dst_id, 5),
            (self.c_dst_addr, 6), (self.c_byte, 7), (self.c_rwc, 8),
            (self.c_left, 9), (self.c_is_rlc, 10), (self.c_is_mm, 11),
            (self.c_is_log, 12), (self.c_is_code, 13), (self.c_is_wrlc, 16),
            (self.c_src_end, 17),
        ):
            cols[ci] = mont([r[k] for r in rows])
        if self.c_src_iscode is not None:
            cols[self.c_src_iscode] = mont([r[15] for r in rows])
        if self.standalone:
            rws = self._mem_rws()
            cols[self.t_rwc] = mont([r.rw_counter for r in rws])
            cols[self.t_isw] = mont([int(r.is_write) for r in rws])
            cols[self.t_tag] = mont([int(r.tag) for r in rws])
            cols[self.t_id] = mont([r.id for r in rws])
            cols[self.t_addr] = mont([r.address for r in rws])
            cols[self.t_byte] = mont([r.value for r in rws])
            cols[self.x_txid] = mont([t[0] for t in (self.tx_rows or [])])
            cols[self.x_idx] = mont([t[1] for t in (self.tx_rows or [])])
            cols[self.x_byte] = mont([t[2] for t in (self.tx_rows or [])])
        return cols
