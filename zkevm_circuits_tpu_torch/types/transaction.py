"""Ethereum transaction types: RLP payloads, signing, sender recovery.

Equivalent of the reference's `eth-types/src/geth_types.rs::Transaction`
+ ethers-core signing (SURVEY.md §2.1 item 1).  Covers Legacy/EIP-155,
EIP-2930 (type 1, access lists) and EIP-1559 (type 2, fee market) —
the typed envelope is `type_byte || rlp(payload)` and the y-parity v.
Circuit-side, the RLP FSM decodes legacy payloads today; the typed-
payload FSM states are the next extension (reference
rlp_circuit_fsm.rs handles all four tx types).

Port of zkevm_circuits_tpu/types/transaction.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import enum

from ..crypto import secp256k1
from ..crypto.keccak import keccak256
from . import rlp


class TxType(enum.IntEnum):
    Legacy = 0       # incl. EIP-155
    Eip2930 = 1      # access list
    Eip1559 = 2      # fee market


@dataclasses.dataclass
class Transaction:
    nonce: int = 0
    gas_price: int = 10
    gas: int = 1_000_000
    to: int | None = None  # None => create
    value: int = 0
    data: bytes = b""
    chain_id: int = 1
    v: int = 0
    r: int = 0
    s: int = 0
    tx_type: TxType = TxType.Legacy
    # EIP-2930/1559: [(address, [storage_key, ...]), ...]
    access_list: list = dataclasses.field(default_factory=list)
    # EIP-1559 fee market
    max_fee_per_gas: int = 0
    max_priority_fee_per_gas: int = 0

    # -- signing ------------------------------------------------------------
    def _to_field(self):
        return b"" if self.to is None else self.to.to_bytes(20, "big")

    def _al_field(self):
        return [
            [addr.to_bytes(20, "big"),
             [k.to_bytes(32, "big") for k in keys]]
            for addr, keys in self.access_list
        ]

    def sign_payload(self) -> bytes:
        """Signing payload: EIP-155 for legacy; typed envelope
        `type || rlp(...)` for 2930/1559 (EIP-2718)."""
        if self.tx_type == TxType.Legacy:
            return rlp.encode([
                self.nonce, self.gas_price, self.gas, self._to_field(),
                self.value, self.data, self.chain_id, 0, 0,
            ])
        if self.tx_type == TxType.Eip2930:
            return b"\x01" + rlp.encode([
                self.chain_id, self.nonce, self.gas_price, self.gas,
                self._to_field(), self.value, self.data, self._al_field(),
            ])
        if self.tx_type == TxType.Eip1559:
            return b"\x02" + rlp.encode([
                self.chain_id, self.nonce, self.max_priority_fee_per_gas,
                self.max_fee_per_gas, self.gas, self._to_field(),
                self.value, self.data, self._al_field(),
            ])
        raise ValueError(self.tx_type)

    def sign_hash(self) -> bytes:
        return keccak256(self.sign_payload())

    def sign(self, sk: int) -> "Transaction":
        r, s, rec = secp256k1.sign(sk, self.sign_hash())
        self.r, self.s = r, s
        if self.tx_type == TxType.Legacy:
            self.v = 35 + 2 * self.chain_id + rec
        else:
            self.v = rec  # typed txs carry the raw y-parity
        return self

    def rlp_signed(self) -> bytes:
        if self.tx_type == TxType.Legacy:
            return rlp.encode([
                self.nonce, self.gas_price, self.gas, self._to_field(),
                self.value, self.data, self.v, self.r, self.s,
            ])
        if self.tx_type == TxType.Eip2930:
            return b"\x01" + rlp.encode([
                self.chain_id, self.nonce, self.gas_price, self.gas,
                self._to_field(), self.value, self.data, self._al_field(),
                self.v, self.r, self.s,
            ])
        if self.tx_type == TxType.Eip1559:
            return b"\x02" + rlp.encode([
                self.chain_id, self.nonce, self.max_priority_fee_per_gas,
                self.max_fee_per_gas, self.gas, self._to_field(),
                self.value, self.data, self._al_field(),
                self.v, self.r, self.s,
            ])
        raise ValueError(self.tx_type)

    def tx_hash(self) -> bytes:
        return keccak256(self.rlp_signed())

    def effective_gas_price(self, base_fee: int) -> int:
        """EIP-1559 effective price; legacy/2930 pay gas_price."""
        if self.tx_type != TxType.Eip1559:
            return self.gas_price
        return min(self.max_fee_per_gas,
                   base_fee + self.max_priority_fee_per_gas)

    def intrinsic_access_list_gas(self) -> int:
        """EIP-2930: 2400 per address + 1900 per storage key."""
        return sum(2400 + 1900 * len(keys) for _, keys in self.access_list)

    def recover_sender(self) -> int | None:
        if self.tx_type == TxType.Legacy:
            rec = (self.v - 35 - 2 * self.chain_id) & 1 if self.v >= 35 \
                else ((self.v - 27) & 1)
        else:
            rec = self.v & 1
        pub = secp256k1.recover(self.sign_hash(), self.r, self.s, rec)
        if pub is None:
            return None
        raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
        return int.from_bytes(keccak256(raw)[12:], "big")
