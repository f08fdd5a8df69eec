"""RLP circuit — proves RLP decoding of legacy tx signing payloads.

Equivalent of the reference's `zkevm-circuits/src/rlp_circuit_fsm.rs`
(SURVEY.md §2.2 "RLP"): a byte-per-row finite-state machine over the
RLP-encoded tx payload whose tag transitions are constrained by a ROM
lookup, producing the RlpTable (tx_id, field tag, value) that the Tx
circuit consumes.

Layout: ONE row per RLP byte with columnar state — one-hot tag
indicators, a remaining-bytes countdown, a prefix flag, a list-payload
countdown, and a value accumulator.  Like the reference's per-tag
`TagValueAcc` multiplier (rlp_circuit_fsm.rs byte_value accumulation),
the Horner fold multiplier is PER-TAG:
  * integer tags (Nonce, Gas, To, ChainId) fold with 256 — acc equals
    the raw integer, matching the TxTable's raw-value convention;
  * word/byte-string tags (GasPrice, Value, Data) fold with the word
    challenge r — acc = sum le_byte[i] * r^i, matching the TxTable /
    EVM word-RLC convention (state.py word_rlc).

Sign-hash binding: every tx's payload is followed by keccak pad10*1 rows
(constrained pattern, as in bytecode.py's code-hash binding) and a
running payload byte-RLC; the last pad row looks up
(payload_rlc, sign_hash_rlc) in the KeccakTable — so the circuit binds
keccak(rlp(signing payload)), the message the Sig circuit verifies.

Scope (documented): legacy EIP-155 signing payloads
rlp([nonce, gas_price, gas, to, value, data, chain_id, 0, 0]) with
data <= 55 bytes (short-form strings); both short lists (0xc0+len) and
56..255-byte long lists (0xf8 + one length byte).  Canonical-minimality
of integer fields is witness-side: a non-canonical encoding changes the
keccak digest and is caught by the signature binding.

Port of zkevm_circuits_tpu/circuits/rlp.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..types import rlp as rlp_host
from ..types.transaction import Transaction

F = fr()


class RlpTag(enum.IntEnum):
    List = 0  # the 0xf8 long-list prefix byte
    ListLen = 1  # the list's single length byte
    Nonce = 2
    GasPrice = 3  # legacy gas price / EIP-1559 max_fee_per_gas
    Gas = 4
    To = 5
    Value = 6
    Data = 7
    ChainId = 8
    Zero1 = 9
    Zero2 = 10
    Pad = 11  # keccak pad10*1 rows after the payload
    TxTypeB = 12  # EIP-2718 envelope type byte (0x01 / 0x02)
    Prio = 13  # EIP-1559 max_priority_fee_per_gas
    AlPfx = 14  # access-list structural prefixes (list/item/key-list)
    AlAddr = 15  # access-list address (21-byte string segment)
    AlKey = 16  # access-list storage key (33-byte string segment)
    SigV = 17  # hash-side only: v (legacy EIP-155) / y-parity (typed)
    SigR = 18  # hash-side only
    SigS = 19  # hash-side only


TAGS = list(RlpTag)
FIELD_TAGS = [
    RlpTag.Nonce, RlpTag.GasPrice, RlpTag.Gas, RlpTag.To, RlpTag.Value,
    RlpTag.Data, RlpTag.ChainId, RlpTag.Zero1, RlpTag.Zero2,
]
SIG_TAGS = [RlpTag.SigV, RlpTag.SigR, RlpTag.SigS]
# tags that carry values through the prefix/export machinery
VALUE_TAGS = FIELD_TAGS + [RlpTag.Prio, RlpTag.AlAddr, RlpTag.AlKey] \
    + SIG_TAGS
# per-tag Horner multiplier: integers fold with 256 (acc == raw value),
# words/byte-strings with the challenge r (acc == word RLC)
INT_TAGS = {RlpTag.Nonce, RlpTag.Gas, RlpTag.To, RlpTag.ChainId,
            RlpTag.AlAddr, RlpTag.SigV}
WORD_TAGS = {RlpTag.GasPrice, RlpTag.Value, RlpTag.Data, RlpTag.Prio,
             RlpTag.AlKey, RlpTag.SigR, RlpTag.SigS}

# tag-order ROM, TYPE-AWARE: (side*3 + tx_type, tag, next_tag) triples
# (reference rlp_circuit_fsm.rs ROM covers Legacy/2930/1559 in BOTH the
# TxSign and TxHash formats).  Side 0 = signing payload, side 1 = signed
# envelope (tx-hash preimage, the same fields with a v/r/s tail instead
# of the EIP-155 chain_id/0/0 suffix).  The Pad -> next-segment
# transition is keyed by the NEW row's (side, type).
T = RlpTag
_LEGACY_ORDER = [(a, b) for a, b in zip(FIELD_TAGS, FIELD_TAGS[1:])]
_LEGACY_HASH = (
    [(a, b) for a, b in zip(FIELD_TAGS[:6], FIELD_TAGS[1:6])]
    + [(T.Data, T.SigV)]
)
_SIG_TAIL = [(T.SigV, T.SigR), (T.SigR, T.SigS), (T.SigS, T.Pad)]
_TYPED_COMMON = [
    (T.TxTypeB, T.List), (T.List, T.ListLen), (T.List, T.ChainId),
    (T.ListLen, T.ChainId), (T.ChainId, T.Nonce),
    (T.GasPrice, T.Gas), (T.Gas, T.To), (T.To, T.Value),
    (T.Value, T.Data), (T.Data, T.AlPfx),
    (T.AlPfx, T.AlPfx), (T.AlPfx, T.AlAddr), (T.AlPfx, T.AlKey),
    (T.AlAddr, T.AlPfx),
    (T.AlKey, T.AlKey), (T.AlKey, T.AlPfx),
]
_LIST_START = [(0, int(T.List), int(T.ListLen)),
               (0, int(T.List), int(T.Nonce)),
               (0, int(T.ListLen), int(T.Nonce))]
ROM = (
    _LIST_START
    + [(0, int(a), int(b)) for a, b in _LEGACY_ORDER]
    + [(0, int(T.Zero2), int(T.Pad)), (0, int(T.Pad), int(T.List))]
    + [(1, int(a), int(b)) for a, b in
       _TYPED_COMMON + [(T.Nonce, T.GasPrice), (T.AlPfx, T.Pad),
                        (T.AlKey, T.Pad)]]
    + [(2, int(a), int(b)) for a, b in
       _TYPED_COMMON + [(T.Nonce, T.Prio), (T.Prio, T.GasPrice),
                        (T.AlPfx, T.Pad), (T.AlKey, T.Pad)]]
    + [(t, int(T.Pad), int(T.TxTypeB)) for t in (1, 2)]
    # hash side (key = 3 + type): legacy signed layout
    + [(3, int(T.List), int(T.ListLen)), (3, int(T.List), int(T.Nonce)),
       (3, int(T.ListLen), int(T.Nonce))]
    + [(3, int(a), int(b)) for a, b in _LEGACY_HASH + _SIG_TAIL]
    + [(3, int(T.Pad), int(T.List))]  # into legacy hash side
    # typed hash sides: same field walk, sig tail after the access list
    + [(4, int(a), int(b)) for a, b in
       _TYPED_COMMON + [(T.Nonce, T.GasPrice), (T.AlPfx, T.SigV),
                        (T.AlKey, T.SigV)] + _SIG_TAIL]
    + [(5, int(a), int(b)) for a, b in
       _TYPED_COMMON + [(T.Nonce, T.Prio), (T.Prio, T.GasPrice),
                        (T.AlPfx, T.SigV), (T.AlKey, T.SigV)] + _SIG_TAIL]
    + [(3 + t, int(T.Pad), int(T.TxTypeB)) for t in (1, 2)]
)

KECCAK_RATE = 136


@dataclasses.dataclass
class RlpParams:
    pass  # geometry is exactly the witness rows (no padding yet)


def _list_prefix_len(enc: bytes) -> int:
    assert enc[0] >= 0xC0
    if enc[0] <= 0xF7:
        return 1
    return 1 + (enc[0] - 0xF7)


def _field_rows(rows, tx_id, tag, val, ty, side):
    enc = rlp_host.encode(val)
    if len(enc) == 1 and enc[0] < 0x80:
        rows.append((tx_id, int(tag), 1, 0, enc[0], ty, side))
    else:
        plen = enc[0] - 0x80
        assert 0 <= plen <= 55, "long-form strings not in scope"
        rows.append((tx_id, int(tag), plen + 1, 1, enc[0], ty, side))
        for j in range(plen):
            rows.append((tx_id, int(tag), plen - j, 0, enc[1 + j], ty, side))
    return len(enc)


def _tx_rows(tx: Transaction, tx_id: int, side: int):
    """(tx_id, tag, rem, is_pfx, byte, tx_type, side) rows for one
    payload — side 0: the signing payload; side 1: the SIGNED envelope
    (tx-hash preimage) whose list ends with the v/r/s tail (reference
    rlp_circuit_fsm.rs TxSign vs TxHash formats).  EIP-155 legacy or
    EIP-2718 typed (2930/1559) with the access list walked structurally;
    keccak pad10*1 rows follow."""
    from ..types.transaction import TxType

    ty = int(tx.tx_type)
    payload = tx.sign_payload() if side == 0 else tx.rlp_signed()
    rows = []
    body = payload
    if ty:
        rows.append((tx_id, int(RlpTag.TxTypeB), 1, 0, payload[0], ty, side))
        body = payload[1:]
    rows.append((tx_id, int(RlpTag.List), 1, 1, body[0], ty, side))
    if body[0] == 0xF8:  # long list, one length byte
        rows.append((tx_id, int(RlpTag.ListLen), 1, 0, body[1], ty, side))
        pos = 2
    else:
        assert 0xC0 <= body[0] <= 0xF7, "list of this size not in scope"
        pos = 1
    to_f = b"" if tx.to is None else tx.to.to_bytes(20, "big")
    if ty == 0:
        if side == 0:
            fields = [tx.nonce, tx.gas_price, tx.gas, to_f, tx.value,
                      tx.data, tx.chain_id, 0, 0]
            order = FIELD_TAGS
        else:
            fields = [tx.nonce, tx.gas_price, tx.gas, to_f, tx.value,
                      tx.data, tx.v, tx.r, tx.s]
            order = FIELD_TAGS[:6] + SIG_TAGS
    elif ty == int(TxType.Eip2930):
        fields = [tx.chain_id, tx.nonce, tx.gas_price, tx.gas, to_f,
                  tx.value, tx.data]
        order = [RlpTag.ChainId, RlpTag.Nonce, RlpTag.GasPrice, RlpTag.Gas,
                 RlpTag.To, RlpTag.Value, RlpTag.Data]
    else:
        fields = [tx.chain_id, tx.nonce, tx.max_priority_fee_per_gas,
                  tx.max_fee_per_gas, tx.gas, to_f, tx.value, tx.data]
        order = [RlpTag.ChainId, RlpTag.Nonce, RlpTag.Prio,
                 RlpTag.GasPrice, RlpTag.Gas, RlpTag.To, RlpTag.Value,
                 RlpTag.Data]
    for tag, val in zip(order, fields):
        pos += _field_rows(rows, tx_id, tag, val, ty, side)
    if ty:
        # access list: structural prefixes (AlPfx segments) + per-item
        # address and storage-key string segments
        al_enc = rlp_host.encode(tx._al_field())
        p = _list_prefix_len(al_enc)
        for j in range(p):
            rows.append((tx_id, int(RlpTag.AlPfx), p - j, 0,
                         body[pos + j], ty, side))
        pos += p
        for addr, keys in tx.access_list:
            item_enc = rlp_host.encode(
                [addr.to_bytes(20, "big"),
                 [k.to_bytes(32, "big") for k in keys]]
            )
            p = _list_prefix_len(item_enc)
            for j in range(p):
                rows.append((tx_id, int(RlpTag.AlPfx), p - j, 0,
                             body[pos + j], ty, side))
            pos += p
            pos += _field_rows(rows, tx_id, RlpTag.AlAddr,
                               addr.to_bytes(20, "big"), ty, side)
            keys_enc = rlp_host.encode(
                [k.to_bytes(32, "big") for k in keys]
            )
            p = _list_prefix_len(keys_enc)
            for j in range(p):
                rows.append((tx_id, int(RlpTag.AlPfx), p - j, 0,
                             body[pos + j], ty, side))
            pos += p
            for k in keys:
                pos += _field_rows(rows, tx_id, RlpTag.AlKey,
                                   k.to_bytes(32, "big"), ty, side)
        if side == 1:
            # typed signed envelope: y-parity (= tx.v as stored), r, s
            # after the access list; encode tx.v verbatim so corrupt
            # witnesses reach the circuit instead of crashing here
            for tag, val in zip(SIG_TAGS, (tx.v, tx.r, tx.s)):
                pos += _field_rows(rows, tx_id, tag, val, ty, side)
    assert pos == len(body), (pos, len(body))
    # keccak pad10*1 rows: first byte 0x01, last 0x80 (0x81 if single)
    pad_len = KECCAK_RATE - len(payload) % KECCAK_RATE
    for j in range(pad_len):
        b = (1 if j == 0 else 0) + (128 if j == pad_len - 1 else 0)
        rows.append((tx_id, int(RlpTag.Pad), pad_len - j, 0, b, ty, side))
    return rows, payload


class RlpCircuit(Circuit):
    def __init__(self, txs: list[Transaction], params: RlpParams | None = None):
        self.txs = txs
        self.params = params or RlpParams()
        self.rows = []
        self.payloads = []
        self.signed_payloads = []
        for i, tx in enumerate(txs):
            rows, payload = _tx_rows(tx, i + 1, 0)
            rows_h, signed = _tx_rows(tx, i + 1, 1)
            self.rows += rows + rows_h
            self.payloads.append(payload)
            self.signed_payloads.append(signed)

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, challenge=None,
                  keccak_table=None):
        """`keccak_table`: optional (is_enabled, input_rlc, output_rlc)
        exprs from KeccakCircuit.keccak_table_exprs(); when given, each
        tx's padded payload RLC + sign-hash RLC is looked up there."""
        self.has_hash_binding = keccak_table is not None
        self.q_rlp = cs.fixed_column()
        self.q_row0 = cs.fixed_column()
        self.tbl_byte = cs.fixed_column()  # 0..255
        self.tbl_b7 = cs.fixed_column()  # 0..127
        self.tbl_56 = cs.fixed_column()  # 0..55
        self.q_rom = cs.fixed_column()
        self.rom_t = cs.fixed_column()
        self.rom_a = cs.fixed_column()
        self.rom_b = cs.fixed_column()

        self.c_ind = {t: cs.advice_column() for t in TAGS}
        self.c_tx_id = cs.advice_column()
        self.c_rem = cs.advice_column()  # bytes left in segment incl. this
        self.c_pfx = cs.advice_column()
        self.c_byte = cs.advice_column()
        self.c_entry = cs.advice_column()  # first row of a segment
        self.c_inv = cs.advice_column()  # iszero witness for rem_prev - 1
        self.c_tot = cs.advice_column()  # list-payload countdown
        self.c_long = cs.advice_column()  # List rows: 0xf8 long form flag
        self.c_type = cs.advice_column()  # EIP-2718 tx type (0/1/2, carried)
        self.c_side = cs.advice_column()  # 0 = sign payload, 1 = signed env
        self.c_alidx = cs.advice_column()  # access-list entry counter
        self.c_acc = cs.advice_column(phase=1)  # per-tag value accumulator
        self.c_prlc = cs.advice_column(phase=1)  # payload byte-RLC fold
        self.c_hash = cs.advice_column(phase=1)  # sign-hash RLC (last pad)
        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        q = Fixed(self.q_rlp)
        q_n = Fixed(self.q_rlp, 1)
        qz = Fixed(self.q_row0)
        ind = {t: Advice(c) for t, c in self.c_ind.items()}
        txid, txid_p = Advice(self.c_tx_id), Advice(self.c_tx_id, -1)
        rem, rem_p = Advice(self.c_rem), Advice(self.c_rem, -1)
        pfx = Advice(self.c_pfx)
        byte = Advice(self.c_byte)
        ent, ent_n = Advice(self.c_entry), Advice(self.c_entry, 1)
        inv = Advice(self.c_inv)
        tot, tot_p = Advice(self.c_tot), Advice(self.c_tot, -1)
        acc, acc_p = Advice(self.c_acc), Advice(self.c_acc, -1)
        prlc, prlc_p = Advice(self.c_prlc), Advice(self.c_prlc, -1)

        # one-hot tags
        ind_sum = None
        for t, e in ind.items():
            cs.create_gate(f"rlp ind {t.name} bool", q * e * (e - 1))
            ind_sum = e if ind_sum is None else ind_sum + e
        cs.create_gate("rlp one tag", q * (ind_sum - 1))
        tag_val = None
        for t, e in ind.items():
            term = e * int(t)
            tag_val = term if tag_val is None else tag_val + term
        tag_val_p = None
        for t, c in self.c_ind.items():
            term = Advice(c, -1) * int(t)
            tag_val_p = term if tag_val_p is None else tag_val_p + term
        fld = None  # sum of value-carrying tag indicators
        for t in VALUE_TAGS:
            fld = ind[t] if fld is None else fld + ind[t]
        typ, typ_p = Advice(self.c_type), Advice(self.c_type, -1)
        # tx start: the envelope type byte, or a legacy List straight
        # after the previous tx's padding (or on row 0)
        prev_pad = Advice(self.c_ind[RlpTag.Pad], -1)
        st = ind[RlpTag.TxTypeB] + ind[RlpTag.List] * (qz + prev_pad)

        cs.create_gate("rlp pfx bool", q * pfx * (pfx - 1))
        cs.create_gate("rlp entry bool", q * ent * (ent - 1))
        # entry <=> rem_prev == 1 (IsZero via inverse witness); row 0 entry
        nz = (rem_p - 1) * inv
        cs.create_gate("rlp entry iff a", q * (1 - qz) * ent * (rem_p - 1))
        cs.create_gate("rlp entry iff b", q * (1 - qz) * (1 - ent) * (1 - nz))
        cs.create_gate("rlp row0 entry", q * qz * (ent - 1))

        # non-entry rows: same tag/tx, countdown, never a prefix
        cont = q * (1 - ent)
        for t, c in self.c_ind.items():
            cs.create_gate(
                f"rlp cont tag {t.name}", cont * (ind[t] - Advice(c, -1))
            )
        cs.create_gate("rlp cont tx", cont * (txid - txid_p))
        cs.create_gate("rlp cont rem", cont * (rem - rem_p + 1))
        cs.create_gate("rlp cont not pfx", cont * pfx)

        # side flag: bool, toggles on each segment start (sign -> hash ->
        # next tx's sign: the alternation is FORCED, so a tx cannot skip
        # its signed-envelope segment), carried elsewhere, 0 on row 0
        side, side_p = Advice(self.c_side), Advice(self.c_side, -1)
        cs.create_gate("rlp side bool", q * side * (side - 1))
        cs.create_gate("rlp row0 side", q * qz * side)
        cs.create_gate(
            "rlp side toggle",
            q * (1 - qz) * ent * st * (side - 1 + side_p),
        )
        cs.create_gate(
            "rlp side carry",
            q * (1 - qz) * (1 - ent * st) * (side - side_p),
        )

        # access-list entry counter: number of COMPLETED
        # AlAddr/AlKey segments strictly before this row, per (tx, side).
        # Including it in the cross-side lookup tuples makes the binding
        # positional (the reference binds the exact byte stream); the
        # sign->hash reverse lookup below pins the per-side counts equal.
        alidx, alidx_p = Advice(self.c_alidx), Advice(self.c_alidx, -1)
        al_e = ind[RlpTag.AlAddr] + ind[RlpTag.AlKey]
        al_e_p = (Advice(self.c_ind[RlpTag.AlAddr], -1)
                  + Advice(self.c_ind[RlpTag.AlKey], -1))
        cs.create_gate("rlp alidx start", q * ent * st * alidx)
        cs.create_gate("rlp alidx carry", q * (1 - ent) * (alidx - alidx_p))
        cs.create_gate(
            "rlp alidx step",
            q * ent * (1 - st) * (alidx - alidx_p - al_e_p),
        )

        # entry tag order from the TYPE-AWARE, SIDE-AWARE ROM (key =
        # 3*side + type; row 0 pinned below)
        g_ent = q * ent * (1 - qz)
        rom_key = typ + side * 3
        cs.lookup_logup(
            "rlp rom",
            [[g_ent, g_ent * rom_key, g_ent * tag_val_p, g_ent * tag_val]],
            [Fixed(self.q_rom), Fixed(self.rom_t), Fixed(self.rom_a),
             Fixed(self.rom_b)],
        )
        cs.create_gate(
            "rlp row0 start",
            q * qz * (1 - ind[RlpTag.List] - ind[RlpTag.TxTypeB]),
        )
        # tx id: sign-side starts increment, hash-side starts carry (same
        # tx), all other rows carry
        cs.create_gate(
            "rlp tx id inc", q * ent * st * (1 - side) * (txid - txid_p - 1)
        )
        cs.create_gate(
            "rlp tx id hash keep", q * ent * st * side * (txid - txid_p)
        )
        cs.create_gate(
            "rlp tx id keep", q * ent * (1 - st) * (txid - txid_p)
        )
        # tx type: the envelope byte on TxTypeB starts (byte in {1, 2}),
        # zero on legacy starts, carried everywhere else
        g_tb = q * ind[RlpTag.TxTypeB]
        cs.create_gate("rlp type byte", g_tb * (byte - 1) * (byte - 2))
        cs.create_gate("rlp type pin", g_tb * (typ - byte))
        cs.create_gate("rlp typeb rem", g_tb * (rem - 1))
        cs.create_gate("rlp typeb pfx", g_tb * pfx)
        cs.create_gate(
            "rlp legacy type",
            q * ind[RlpTag.List] * (qz + prev_pad) * typ,
        )
        cs.create_gate("rlp type carry", q * (1 - st) * (typ - typ_p))

        # List prefix row: 0xf8 (long, ListLen follows) or 0xc0+len
        # (short, the length lands in tot directly); single-row segment
        long = Advice(self.c_long)
        g_list = q * ind[RlpTag.List]
        cs.create_gate("rlp long bool", g_list * long * (long - 1))
        cs.create_gate("rlp list long byte", g_list * long * (byte - 0xF8))
        cs.create_gate(
            "rlp list short byte", g_list * (1 - long) * (byte - 0xC0 - tot)
        )
        cs.create_gate(
            "rlp list form", q * q_n * ind[RlpTag.List]
            * (Advice(self.c_ind[RlpTag.ListLen], 1) - long)
        )
        cs.create_gate("rlp list rem", g_list * (rem - 1))
        cs.create_gate("rlp list pfx", g_list * (pfx - 1))
        # ListLen row: single row, not a prefix, sets the payload countdown
        g_ll = q * ind[RlpTag.ListLen]
        cs.create_gate("rlp listlen rem", g_ll * (rem - 1))
        cs.create_gate("rlp listlen pfx", g_ll * pfx)
        cs.create_gate("rlp listlen tot", g_ll * (tot - byte))
        # countdown over the list body; exhausted exactly at Zero2
        g_body = q * fld
        cs.create_gate("rlp tot countdown", g_body * (tot - tot_p + 1))
        cs.create_gate("rlp tot exhausted", q * ind[RlpTag.Zero2] * tot)

        # field prefix rows: byte = 0x80 + payload_len, acc restarts at 0
        g_pfx = q * pfx * fld
        cs.create_gate("rlp prefix len", g_pfx * (byte - 0x80 - rem + 1))
        cs.create_gate("rlp prefix acc", q * pfx * acc)
        # single-byte fields: entry without prefix, byte < 0x80, rem 1
        g_single = q * ent * (1 - pfx) * fld
        cs.create_gate("rlp single rem", g_single * (rem - 1))
        cs.create_gate("rlp single acc", g_single * (acc - byte))
        # payload continuation: Horner fold with the PER-TAG multiplier
        mult = None
        for t in TAGS:
            if t in INT_TAGS:
                m = 256
            elif t in WORD_TAGS:
                m = self.r
            else:
                continue  # single-row segments / pad rows: no fold
            term = ind[t] * m
            mult = term if mult is None else mult + term
        cs.create_gate(
            "rlp acc fold",
            q * (1 - ent) * (acc - acc_p * mult - byte),
        )
        # zero fields of the EIP-155 suffix must hold value 0
        cs.create_gate(
            "rlp zeros", q * (ind[RlpTag.Zero1] + ind[RlpTag.Zero2]) * acc
        )

        # ---- keccak pad10*1 rows + payload byte-RLC --------------------
        # is_last(row) = successor is an entry row, or the region ends
        is_last = q_n * ent_n + (1 - q_n)
        g_pad = q * ind[RlpTag.Pad]
        cs.create_gate("rlp pad not pfx", g_pad * pfx)
        cs.create_gate(
            "rlp pad pattern", g_pad * (byte - ent - 128 * is_last)
        )
        # payload RLC: restarts at the tx's FIRST byte (the envelope type
        # byte or the legacy List prefix), folds every byte after
        # (including pad rows) with the challenge r
        cs.create_gate("rlp prlc start", q * st * (prlc - byte))
        cs.create_gate(
            "rlp prlc fold",
            q * (1 - st) * (prlc - prlc_p * self.r - byte),
        )
        g_lastpad = g_pad * is_last
        if self.has_hash_binding:
            # (1, padded-payload RLC, hash RLC) is a KeccakTable row —
            # sign-side rows bind the sign hash, hash-side rows the
            # TX HASH (keccak of the signed envelope)
            cs.lookup_logup(
                "rlp sign hash keccak",
                [[g_lastpad, g_lastpad * prlc,
                  g_lastpad * Advice(self.c_hash)]],
                keccak_table,
            )

        # byte range splits
        cs.lookup_logup("rlp bytes", [[q * byte]], [Fixed(self.tbl_byte)])
        cs.lookup_logup(
            "rlp single byte7", [[g_single * byte]], [Fixed(self.tbl_b7)]
        )
        cs.lookup_logup(
            "rlp prefix len55", [[g_pfx * (byte - 0x80)]], [Fixed(self.tbl_56)]
        )
        cs.lookup_logup(
            "rlp short list len55",
            [[g_list * (1 - long) * (byte - 0xC0)]],
            [Fixed(self.tbl_56)],
        )

        # exposed RlpTable (reference table.rs:2288), side-tagged: each
        # field segment's last row (the next row is an entry, or the
        # region ends); prefix rows of empty fields carry acc = 0
        g_out = q * fld * is_last
        self.rlp_table = [g_out, g_out * txid, g_out * side,
                          g_out * tag_val, g_out * acc]
        # cross-side consistency: every hash-side field value (except the
        # v/r/s tail, which has no sign-side counterpart and binds via
        # the TxTable's SigV/R/S) must appear as the SAME (tx_id, tag,
        # value) on the sign side — the signed envelope re-encodes
        # exactly the signed-over fields, so tx_hash commits to them
        sig_ind = (ind[RlpTag.SigV] + ind[RlpTag.SigR] + ind[RlpTag.SigS])
        g_x = g_out * side * (fld - sig_ind)
        g_0 = g_out * (1 - side)
        # the per-tx AL entry index rides the tuple, so repeated AlAddr /
        # AlKey tags bind POSITIONALLY, not just by inclusion
        cs.lookup_logup(
            "rlp hash side fields",
            [[g_x, g_x * txid, g_x * tag_val, g_x * acc, g_x * alidx]],
            [g_0, g_0 * txid, g_0 * tag_val, g_0 * acc, g_0 * alidx],
        )
        # reverse direction for AL rows only: every SIGN-side AL entry must
        # appear on the hash side at the same index — together with the
        # forward lookup this pins the two sides' AL sequences equal
        # (count + order + values), closing the duplicate/drop gap
        al_last = q * al_e * is_last
        g_as = al_last * (1 - side)
        g_ah = al_last * side
        cs.lookup_logup(
            "rlp al sign side fields",
            [[g_as, g_as * txid, g_as * tag_val, g_as * acc, g_as * alidx]],
            [g_ah, g_ah * txid, g_ah * tag_val, g_ah * acc, g_ah * alidx],
        )
        # data-length table: the Data segment's ENTRY row (sign side);
        # value is the payload length (prefix rows: rem-1; single: 1)
        g_dl = q * ind[RlpTag.Data] * ent * (1 - side)
        self.data_len_table = [
            g_dl, g_dl * txid, g_dl * (pfx * (rem - 1) + (1 - pfx)),
        ]
        # sign-hash table for the Sig circuit binding: (tx_id, hash RLC)
        g_sp = g_lastpad * (1 - side)
        self.sign_hash_table = [
            g_sp, g_sp * txid, g_sp * Advice(self.c_hash),
        ]
        # tx-hash table (keccak of the signed envelope) for the PI
        # circuit's data_hash derivation (reference pi_circuit.rs tx
        # hashes): (enable, tx_id, tx_hash RLC)
        g_hp = g_lastpad * side
        self.tx_hash_table = [
            g_hp, g_hp * txid, g_hp * Advice(self.c_hash),
        ]
        # per-tx envelope type on sign-side tx-start rows (reference
        # tx_type, witness/tx.rs:45-90): (enable, tx_id, type)
        g_st = q * st * (1 - side)
        self.tx_type_table = [g_st, g_st * txid, g_st * typ]

    # ------------------------------------------------------------------
    def fixed_columns(self, n: int):
        t = len(self.rows)
        assert t <= usable_rows(n) and n >= 256 + len(ROM)
        mont = F.mont_from_ints
        rom_t = [t_ for t_, _, _ in ROM]
        rom_a = [a for _, a, _ in ROM]
        rom_b = [b for _, _, b in ROM]
        return {
            self.q_rlp: mont([1 if i < t else 0 for i in range(n)]),
            self.q_row0: mont([1 if i == 0 else 0 for i in range(n)]),
            self.tbl_byte: mont([i if i < 256 else 0 for i in range(n)]),
            self.tbl_b7: mont([i if i < 128 else 0 for i in range(n)]),
            self.tbl_56: mont([i if i < 56 else 0 for i in range(n)]),
            self.q_rom: mont([1 if i < len(ROM) else 0 for i in range(n)]),
            self.rom_t: mont(rom_t + [0] * (n - len(rom_t))),
            self.rom_a: mont(rom_a + [0] * (n - len(rom_a))),
            self.rom_b: mont(rom_b + [0] * (n - len(rom_b))),
        }

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        rows = self.rows
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        ents = [
            1 if i == 0 else int(rows[i - 1][2] == 1)
            for i in range(len(rows))
        ]
        if phase == 0:
            cols = {
                self.c_tx_id: mont([r[0] for r in rows]),
                self.c_rem: mont([r[2] for r in rows]),
                self.c_pfx: mont([r[3] for r in rows]),
                self.c_byte: mont([r[4] for r in rows]),
                self.c_entry: mont(ents),
            }
            for t in TAGS:
                cols[self.c_ind[t]] = mont(
                    [int(r[1] == int(t)) for r in rows]
                )
            invs, tots = [], []
            tot = 0
            for i, r_ in enumerate(rows):
                if i == 0:
                    invs.append(0)
                else:
                    d = (rows[i - 1][2] - 1) % R
                    invs.append(pow(d, -1, R) if d else 0)
                if r_[1] == int(RlpTag.ListLen):
                    tot = r_[4]
                elif r_[1] == int(RlpTag.List):
                    tot = r_[4] - 0xC0 if r_[4] != 0xF8 else 0
                elif r_[1] == int(RlpTag.Pad):
                    pass  # unconstrained on pad rows
                else:
                    tot -= 1
                tots.append(tot)
            cols[self.c_inv] = mont(invs)
            cols[self.c_tot] = mont(tots)
            cols[self.c_long] = mont(
                [int(r[1] == int(RlpTag.List) and r[4] == 0xF8) for r in rows]
            )
            cols[self.c_type] = mont([r[5] for r in rows])
            cols[self.c_side] = mont([r[6] for r in rows])
            al_tags = (int(RlpTag.AlAddr), int(RlpTag.AlKey))
            alidxs, cnt = [], 0
            for i, r_ in enumerate(rows):
                tag = RlpTag(r_[1])
                is_start = ents[i] and (
                    tag == RlpTag.TxTypeB or (
                        tag == RlpTag.List
                        and (i == 0
                             or RlpTag(rows[i - 1][1]) == RlpTag.Pad)
                    )
                )
                if is_start:
                    cnt = 0
                elif ents[i] and rows[i - 1][1] in al_tags:
                    cnt += 1
                alidxs.append(cnt)
            cols[self.c_alidx] = mont(alidxs)
            return cols
        # phase 1: value accumulators + payload RLC + sign hashes
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        accs, prlcs, hashes = [], [], []
        acc = prlc = 0
        for i, r_ in enumerate(rows):
            tag = RlpTag(r_[1])
            m = 256 if tag in INT_TAGS else r_int if tag in WORD_TAGS else 0
            if r_[3]:
                acc = 0
            elif ents[i]:
                acc = r_[4] % R
            else:
                acc = (acc * m + r_[4]) % R
            accs.append(acc)
            is_start = tag == RlpTag.TxTypeB or (
                tag == RlpTag.List
                and (i == 0 or RlpTag(rows[i - 1][1]) == RlpTag.Pad)
            )
            prlc = (
                r_[4] % R if is_start
                else (prlc * r_int + r_[4]) % R
            )
            prlcs.append(prlc)
            is_last = (i + 1 == len(rows)) or rows[i][2] == 1
            if tag == RlpTag.Pad and is_last:
                tx = self.txs[r_[0] - 1]
                digest = tx.sign_hash() if r_[6] == 0 else tx.tx_hash()
                hashes.append(
                    sum(b * pow(r_int, j, R) for j, b in enumerate(digest)) % R
                )
            else:
                hashes.append(0)
        return {
            self.c_acc: mont(accs),
            self.c_prlc: mont(prlcs),
            self.c_hash: mont(hashes),
        }
