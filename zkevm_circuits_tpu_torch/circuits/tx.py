"""Tx circuit — proves the TxTable layout, bound to the RLP circuit.

Equivalent of the reference's `zkevm-circuits/src/tx_circuit.rs`
(SURVEY.md §2.2 "Tx"): one fixed-layout block of rows per transaction
carrying (tag, value) pairs for the context fields the EVM circuit reads
(nonce, gas, gas_price, callee, caller, value, calldata length/RLC),
followed by per-byte calldata rows with index continuity.

Value conventions (matching the RlpTable's per-tag accumulators):
  * raw integers: Nonce, Gas, CalleeAddress, CallDataLength,
    CallDataGasCost, IsCreate, SigV, CallerAddress;
  * word RLCs (state.py word_rlc under the shared challenge):
    GasPrice, Value, SigR, SigS.

RLP bindings (when `rlp_table`/`data_len_table` given — the reference
ties tx_circuit to the RlpTable the same way, tx_circuit.rs lookups):
  * Nonce/GasPrice/Gas/CalleeAddress/Value rows look up
    (tx_id, rlp_tag, value) in the RlpTable — the values the sender
    SIGNED are the values the EVM executes with;
  * the CallDataLength row looks up (tx_id, len) in the DataLen table,
    and the last calldata row binds both its running byte-RLC to the
    RLP Data value and its index+1 to the RLP data length;
  * the SigV row proves v = 35 + 2*chain_id + rec (EIP-155) with
    chain_id looked up from the RlpTable.

Remaining with the Sig circuit (SURVEY.md §2.2 "Sig"): in-circuit ECDSA
over (sign_hash, r, s, v) and sender recovery; until then sender
recovery is checked host-side at witness construction.

Port of zkevm_circuits_tpu/circuits/tx.py: the same names, signatures and
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
from ..types.transaction import Transaction
from .rlp import RlpTag
from .state import word_rlc

F = fr()


class TxFieldTag(enum.IntEnum):
    Null = 0
    Nonce = 1
    GasPrice = 2
    Gas = 3
    CalleeAddress = 4
    CallerAddress = 5
    IsCreate = 6
    Value = 7
    CallDataLength = 8
    CallDataGasCost = 9
    SigV = 10
    SigR = 11
    SigS = 12
    CallData = 13  # per-byte rows
    # EIP-2930 access-list commitments (reference tx.rs
    # AccessListAddressesLen / AccessListStorageKeysLen / intrinsic gas)
    AccessListGasCost = 14  # 2400/addr + 1900/key
    AccessListRows = 15  # addresses + storage keys (BeginTx prewarm rows)


FIXED_TAGS = [
    TxFieldTag.Nonce, TxFieldTag.GasPrice, TxFieldTag.Gas,
    TxFieldTag.CalleeAddress, TxFieldTag.CallerAddress, TxFieldTag.IsCreate,
    TxFieldTag.Value, TxFieldTag.CallDataLength, TxFieldTag.CallDataGasCost,
    TxFieldTag.SigV, TxFieldTag.SigR, TxFieldTag.SigS,
    TxFieldTag.AccessListGasCost, TxFieldTag.AccessListRows,
]

# word-RLC-valued tags (the rest are raw integers)
WORD_TAGS = {
    TxFieldTag.GasPrice, TxFieldTag.Value, TxFieldTag.SigR, TxFieldTag.SigS,
}

# TxFieldTag -> RlpTag for the signed-field bindings
RLP_BOUND = {
    TxFieldTag.Nonce: RlpTag.Nonce,
    TxFieldTag.GasPrice: RlpTag.GasPrice,
    TxFieldTag.Gas: RlpTag.Gas,
    TxFieldTag.CalleeAddress: RlpTag.To,
    TxFieldTag.Value: RlpTag.Value,
}
# hash-side (signed envelope) bindings: the TxTable's signature values
# must be the ones the tx-hash preimage encodes, so keccak(signed rlp)
# in the RLP circuit is the hash of THIS tx (v conventions match: legacy
# envelope carries 35+2*chain_id+parity, typed carries the y-parity —
# exactly the TxTable SigV rule)
RLP_HASH_BOUND = {
    TxFieldTag.SigV: RlpTag.SigV,
    TxFieldTag.SigR: RlpTag.SigR,
    TxFieldTag.SigS: RlpTag.SigS,
}


@dataclasses.dataclass
class TxParams:
    max_txs: int = 4
    max_calldata: int = 64


class TxCircuit(Circuit):
    def __init__(self, txs: list[Transaction], params: TxParams | None = None):
        self.txs = txs
        self.params = params or TxParams()
        for tx in txs:
            sender = tx.recover_sender()
            assert sender is not None, "unsigned tx in witness"
            tx._sender = sender

    def configure(self, cs: ConstraintSystem, challenge=None,
                  rlp_table=None, data_len_table=None, sig_table=None,
                  tx_type_table=None,
                  sign_hash_table=None):
        """`rlp_table`: RlpCircuit.rlp_table exprs (g, tx_id, tag, value);
        `data_len_table`: RlpCircuit.data_len_table exprs (g, tx_id, len).
        When given, the signed-field / calldata / chain-id bindings above
        are wired; standalone mode proves the layout only.
        `sig_table` + `sign_hash_table`: the Sig circuit's table and the
        RLP circuit's (tx_id, sign_hash_rlc) rows — when both are given,
        each tx's SigV row binds (sign_hash, SigR, SigS, CallerAddress)
        to an ECDSA-verified SigTable entry: the sender IS the recovered
        signer (reference tx_circuit sig lookups)."""
        p = self.params
        self.has_rlp = rlp_table is not None
        self.has_sig = sig_table is not None and sign_hash_table is not None
        self.q_fixed = cs.fixed_column()  # fixed-field region rows
        self.q_data = cs.fixed_column()  # calldata region rows
        self.f_tag = cs.fixed_column()  # expected tag sequence (fixed layout)
        self.f_rlptag = cs.fixed_column()  # RlpTag on RLP-bound rows
        self.f_isbound = cs.fixed_column()  # 1 on RLP-bound field rows
        self.f_ishash = cs.fixed_column()  # 1 on hash-side-bound sig rows
        self.f_isdlen = cs.fixed_column()  # 1 on the CallDataLength row
        self.f_issigv = cs.fixed_column()  # 1 on the SigV row
        self.tbl_byte = cs.fixed_column()

        self.c_tx_id = cs.advice_column()
        self.c_tag = cs.advice_column()
        self.c_index = cs.advice_column()  # calldata byte index
        self.c_value = cs.advice_column(phase=1)  # field value or byte
        self.c_is_final = cs.advice_column()  # last byte of a tx's calldata
        self.c_is_real = cs.advice_column()  # tx_id != 0
        self.c_inv_tid = cs.advice_column()  # inverse witness for tx_id
        self.c_rec = cs.advice_column()  # SigV row: recovery bit
        self.c_chain = cs.advice_column()  # SigV row: chain id
        self.c_txtype = cs.advice_column()  # SigV row: EIP-2718 type
        self.c_inv_type = cs.advice_column()  # IsZero inverse for type
        self.c_cd_rlc = cs.advice_column(phase=1)  # calldata running RLC
        self.c_sign_hash = cs.advice_column(phase=1)  # SigV row: hash RLC
        self.r = challenge if challenge is not None else cs.challenge(phase=0)

        qf, qd = Fixed(self.q_fixed), Fixed(self.q_data)
        qd_p = Fixed(self.q_data, -1)
        tag, ftag = Advice(self.c_tag), Fixed(self.f_tag)
        txid, txid_n = Advice(self.c_tx_id), Advice(self.c_tx_id, 1)
        idx, idx_n = Advice(self.c_index), Advice(self.c_index, 1)
        fin, fin_p = Advice(self.c_is_final), Advice(self.c_is_final, -1)
        val = Advice(self.c_value)
        ir = Advice(self.c_is_real)
        itid = Advice(self.c_inv_tid)
        rec = Advice(self.c_rec)
        chain = Advice(self.c_chain)
        cdr, cdr_p = Advice(self.c_cd_rlc), Advice(self.c_cd_rlc, -1)

        # fixed region: tag follows the static layout
        cs.create_gate("fixed tag layout", qf * (tag - ftag))
        # calldata region: tag is CallData
        cs.create_gate("calldata tag", qd * (tag - int(TxFieldTag.CallData)))
        cs.create_gate("is_final bool", qd * fin * (fin - 1))
        # byte index continuity: same tx => idx+1, is_final=0
        qd_n = Fixed(self.q_data, 1)
        cs.create_gate(
            "calldata continuity idx",
            qd * qd_n * (1 - fin) * (idx_n - idx - 1),
        )
        cs.create_gate(
            "calldata continuity tx",
            qd * qd_n * (1 - fin) * (txid_n - txid),
        )
        # calldata bytes range-checked
        cs.lookup_logup("calldata bytes", [[qd * val]], [Fixed(self.tbl_byte)])

        # is_real = (tx_id != 0), via inverse witness
        g_any = qf + qd
        cs.create_gate("is_real def", g_any * (ir - txid * itid))
        cs.create_gate("is_real kill", g_any * txid * (1 - ir))

        # calldata running byte-RLC: restarts where a tx's bytes begin
        # (previous row is outside the region or final), Horner-folds along
        # the segment; first byte has index 0
        start = 1 - qd_p * (1 - fin_p)
        cs.create_gate("calldata rlc start", qd * start * (cdr - val))
        cs.create_gate("calldata idx start", qd * start * idx)
        cs.create_gate(
            "calldata rlc fold",
            qd * qd_p * (1 - fin_p) * (cdr - cdr_p * self.r - val),
        )

        # SigV row: legacy v = 35 + 2*chain_id + rec (EIP-155); typed
        # envelopes carry the raw y-parity v = rec (EIP-2718/2930/1559)
        g_sv = qf * Fixed(self.f_issigv) * ir
        ttype = Advice(self.c_txtype)
        tinv = Advice(self.c_inv_type)
        is_leg = 1 - ttype * tinv  # IsZero(type), complete both ways
        cs.create_gate("sigv type kill", g_sv * (1 - ttype * tinv) * ttype)
        cs.create_gate("sigv rec bool", g_sv * rec * (rec - 1))
        cs.create_gate(
            "sigv rule",
            g_sv * (is_leg * (val - 35 - rec - 2 * chain)
                    + (1 - is_leg) * (val - rec)),
        )

        if self.has_rlp:
            g_b = qf * Fixed(self.f_isbound) * ir
            g_fin = qd * fin * ir
            g_hb = qf * Fixed(self.f_ishash) * ir
            cs.lookup_logup(
                "tx rlp binding",
                [
                    # signed fields: (tx_id, side=0, rlp_tag, value)
                    [g_b, g_b * txid, g_b * 0, g_b * Fixed(self.f_rlptag),
                     g_b * val],
                    # chain id from the SigV decomposition
                    [g_sv, g_sv * txid, g_sv * 0,
                     g_sv * int(RlpTag.ChainId), g_sv * chain],
                    # last calldata row: running RLC == RLP Data value
                    [g_fin, g_fin * txid, g_fin * 0,
                     g_fin * int(RlpTag.Data), g_fin * cdr],
                    # signature values against the HASH-SIDE (signed
                    # envelope) rows: closes the tx_hash chain
                    [g_hb, g_hb * txid, g_hb * 1,
                     g_hb * Fixed(self.f_rlptag), g_hb * val],
                ],
                rlp_table,
            )
            if tx_type_table is not None:
                cs.lookup_logup(
                    "tx type binding",
                    [[g_sv, g_sv * txid, g_sv * ttype]],
                    tx_type_table,
                )
            g_dl = qf * Fixed(self.f_isdlen) * ir
            cs.lookup_logup(
                "tx data len binding",
                [
                    [g_dl, g_dl * txid, g_dl * val],
                    # last calldata row: index+1 == RLP data length
                    [g_fin, g_fin * txid, g_fin * (idx + 1)],
                ],
                data_len_table,
            )

        if self.has_sig:
            # the SigV row joins three tables on this tx: its sign-hash
            # RLC comes from the RLP circuit, and the (hash, r, s,
            # caller) tuple must be an ECDSA-verified SigTable entry.
            # Fixed layout offsets from SigV: SigR at +1, SigS at +2,
            # CallerAddress at -5 (FIXED_TAGS order).
            g_sv2 = qf * Fixed(self.f_issigv) * ir
            sh = Advice(self.c_sign_hash)
            cs.lookup_logup(
                "tx sign hash",
                [[g_sv2, g_sv2 * txid, g_sv2 * sh]],
                sign_hash_table,
            )
            cs.lookup_logup(
                "tx sig binding",
                [[
                    g_sv2, g_sv2 * sh, g_sv2 * Advice(self.c_value, 1),
                    g_sv2 * Advice(self.c_value, 2),
                    g_sv2 * Advice(self.c_value, -5),
                ]],
                sig_table,
            )

    def tx_table_exprs(self) -> list:
        """(tx_id, tag, index, value) TxTable exprs for other circuits'
        lookups (reference table.rs:207 `TxTable`; the Copy circuit's
        calldata source rides this)."""
        g = Fixed(self.q_fixed) + Fixed(self.q_data)
        return [
            g * Advice(self.c_tx_id), g * Advice(self.c_tag),
            g * Advice(self.c_index), g * Advice(self.c_value),
        ]

    def _layout(self, n: int):
        p = self.params
        n_fixed = p.max_txs * len(FIXED_TAGS)
        total = n_fixed + p.max_calldata
        assert total <= usable_rows(n)
        return n_fixed, total

    def fixed_columns(self, n: int):
        p = self.params
        n_fixed, total = self._layout(n)
        mont = F.mont_from_ints
        q_fixed = [1 if i < n_fixed else 0 for i in range(n)]
        q_data = [1 if n_fixed <= i < total else 0 for i in range(n)]
        nt = len(FIXED_TAGS)
        ftag = [
            int(FIXED_TAGS[i % nt]) if i < n_fixed else 0 for i in range(n)
        ]
        rlptag, isbound, isdlen, issigv, ishash = [], [], [], [], []
        for i in range(n):
            t = FIXED_TAGS[i % nt] if i < n_fixed else None
            tag = RLP_BOUND.get(t) or RLP_HASH_BOUND.get(t) or RlpTag.List
            rlptag.append(int(tag) if t else 0)
            isbound.append(int(t in RLP_BOUND) if t else 0)
            isdlen.append(int(t == TxFieldTag.CallDataLength) if t else 0)
            issigv.append(int(t == TxFieldTag.SigV) if t else 0)
            ishash.append(int(t in RLP_HASH_BOUND) if t else 0)
        tbl = [i if i < 256 else 0 for i in range(n)]
        assert n >= 256
        return {
            self.q_fixed: mont(q_fixed),
            self.q_data: mont(q_data),
            self.f_tag: mont(ftag),
            self.f_rlptag: mont(rlptag),
            self.f_isbound: mont(isbound),
            self.f_isdlen: mont(isdlen),
            self.f_issigv: mont(issigv),
            self.f_ishash: mont(ishash),
            self.tbl_byte: mont(tbl),
        }

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        p = self.params
        n_fixed, total = self._layout(n)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        # build rows
        tx_ids, tags, idxs, fins = [], [], [], []
        raw_vals: list = []  # (tag, int) pairs; word tags RLC'd in phase 1
        for ti in range(p.max_txs):
            tx = self.txs[ti] if ti < len(self.txs) else Transaction(v=0)
            tid = ti + 1 if ti < len(self.txs) else 0
            fields = {
                TxFieldTag.Nonce: tx.nonce,
                # typed txs: the GasPrice slot carries the RLP-bound fee
                # field (max_fee_per_gas for 1559) — reference tx.rs keeps
                # max_fee separately; the EVM-side effective-price
                # anchoring is per-type (BEGIN_TX)
                TxFieldTag.GasPrice: (
                    tx.max_fee_per_gas if int(tx.tx_type) == 2
                    else tx.gas_price
                ),
                TxFieldTag.Gas: tx.gas,
                TxFieldTag.CalleeAddress: tx.to or 0,
                TxFieldTag.CallerAddress: getattr(tx, "_sender", 0),
                TxFieldTag.IsCreate: int(tx.to is None),
                TxFieldTag.Value: tx.value,
                TxFieldTag.CallDataLength: len(tx.data),
                TxFieldTag.CallDataGasCost: sum(
                    4 if b == 0 else 16 for b in tx.data
                ),
                TxFieldTag.SigV: tx.v,
                TxFieldTag.SigR: tx.r,
                TxFieldTag.SigS: tx.s,
                TxFieldTag.AccessListGasCost:
                    tx.intrinsic_access_list_gas(),
                TxFieldTag.AccessListRows: sum(
                    1 + len(keys) for _, keys in tx.access_list
                ),
            }
            for tg in FIXED_TAGS:
                tx_ids.append(tid)
                tags.append(int(tg))
                idxs.append(0)
                fins.append(0)
                raw_vals.append((tg, fields[tg] if tid else 0))
        # calldata rows
        for ti, tx in enumerate(self.txs):
            for bi, byte in enumerate(tx.data):
                tx_ids.append(ti + 1)
                tags.append(int(TxFieldTag.CallData))
                idxs.append(bi)
                fins.append(int(bi == len(tx.data) - 1))
                raw_vals.append((TxFieldTag.CallData, byte))
        # pad calldata region: zero rows marked final (no continuity)
        while len(tx_ids) < total:
            tx_ids.append(0)
            tags.append(int(TxFieldTag.CallData))
            idxs.append(0)
            fins.append(1)
            raw_vals.append((TxFieldTag.CallData, 0))
        if phase == 0:
            recs, chains = [], []
            types_, tinvs = [], []
            for i, tid in enumerate(tx_ids):
                tg = FIXED_TAGS[i % len(FIXED_TAGS)] if i < n_fixed else None
                if tg == TxFieldTag.SigV and tid:
                    tx = self.txs[tid - 1]
                    ty_ = int(tx.tx_type)
                    recs.append(
                        tx.v & 1 if ty_
                        else (tx.v - 35 - 2 * tx.chain_id) & 1
                    )
                    chains.append(tx.chain_id)
                    types_.append(ty_)
                    tinvs.append(pow(ty_, -1, R) if ty_ else 0)
                else:
                    recs.append(0)
                    chains.append(0)
                    types_.append(0)
                    tinvs.append(0)
            return {
                self.c_tx_id: mont(tx_ids),
                self.c_tag: mont(tags),
                self.c_index: mont(idxs),
                self.c_is_final: mont(fins),
                self.c_is_real: mont([int(t != 0) for t in tx_ids]),
                self.c_inv_tid: mont(
                    [pow(t, -1, R) if t else 0 for t in tx_ids]
                ),
                self.c_rec: mont(recs),
                self.c_chain: mont(chains),
                self.c_txtype: mont(types_),
                self.c_inv_type: mont(tinvs),
            }
        # phase 1: values (word tags RLC'd) + calldata running RLC
        r_chal = challenges[self.r.index]
        r_int = F.to_int(F.from_mont(r_chal))
        vals = [
            word_rlc(v, r_int) if tg in WORD_TAGS else v % R
            for tg, v in raw_vals
        ]
        cdrs, acc = [], 0
        for i in range(len(tx_ids)):
            if i < n_fixed:
                cdrs.append(0)
                continue
            v = raw_vals[i][1]
            acc = v % R if idxs[i] == 0 else (acc * r_int + v) % R
            cdrs.append(acc)
        # SigV rows: sign-hash digest fold (RlpCircuit c_hash convention)
        shs = []
        for i, tid in enumerate(tx_ids):
            tg = FIXED_TAGS[i % len(FIXED_TAGS)] if i < n_fixed else None
            if tg == TxFieldTag.SigV and tid:
                digest = self.txs[tid - 1].sign_hash()
                shs.append(
                    sum(b * pow(r_int, j, R) for j, b in enumerate(digest))
                    % R
                )
            else:
                shs.append(0)
        return {
            self.c_value: mont(vals), self.c_cd_rlc: mont(cdrs),
            self.c_sign_hash: mont(shs),
        }
