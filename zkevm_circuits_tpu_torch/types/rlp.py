"""Minimal RLP encode/decode (host).

Needed for CREATE address derivation, tx hashing/signing payloads and the
RLP circuit witness (reference uses ethers-core; re-derived from the
Ethereum yellow-paper spec).

Port of zkevm_circuits_tpu/types/rlp.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations


def encode(item) -> bytes:
    """item: bytes | int | list (recursively)."""
    if isinstance(item, int):
        if item == 0:
            payload = b""
        else:
            payload = item.to_bytes((item.bit_length() + 7) // 8, "big")
        return encode(payload)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    raise TypeError(type(item))


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def decode(data: bytes):
    item, rest = _decode_one(memoryview(data))
    if rest:
        raise ValueError("trailing bytes")
    return item


def _decode_one(v):
    if not v:
        raise ValueError("empty")
    b0 = v[0]
    if b0 < 0x80:
        return bytes(v[:1]), v[1:]
    if b0 < 0xB8:
        ln = b0 - 0x80
        return bytes(v[1 : 1 + ln]), v[1 + ln :]
    if b0 < 0xC0:
        lnln = b0 - 0xB7
        ln = int.from_bytes(v[1 : 1 + lnln], "big")
        return bytes(v[1 + lnln : 1 + lnln + ln]), v[1 + lnln + ln :]
    if b0 < 0xF8:
        ln = b0 - 0xC0
        payload = v[1 : 1 + ln]
        rest = v[1 + ln :]
    else:
        lnln = b0 - 0xF7
        ln = int.from_bytes(v[1 : 1 + lnln], "big")
        payload = v[1 + lnln : 1 + lnln + ln]
        rest = v[1 + lnln + ln :]
    items = []
    while payload:
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
