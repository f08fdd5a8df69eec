"""secp256k1 ECDSA — host-side signing/recovery for witness generation.

Equivalent of the reference's `eth-types/src/sign_types.rs` (SignData,
sign/recover helpers; SURVEY.md §2.1 item 1) which wraps libsecp256k1.
Witness-side only — in-circuit verification is the Sig circuit's job.
Deterministic RFC-6979-style nonces (HMAC-SHA256) so tests are stable.

Port of zkevm_circuits_tpu/crypto/secp256k1.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import hashlib
import hmac

from .keccak import keccak256

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p == q:
        lam = 3 * x1 * x1 * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _mul(p, k: int):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, p)
        p = _add(p, p)
        k >>= 1
    return acc


def pubkey(sk: int):
    return _mul(G, sk % N)


def eth_address(sk: int) -> int:
    x, y = pubkey(sk)
    raw = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return int.from_bytes(keccak256(raw)[12:], "big")


def _rfc6979_k(sk: int, msg_hash: bytes) -> int:
    v = b"\x01" * 32
    key = b"\x00" * 32
    x = sk.to_bytes(32, "big")
    key = hmac.new(key, v + b"\x00" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    key = hmac.new(key, v + b"\x01" + x + msg_hash, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(key, v, hashlib.sha256).digest()
        k = int.from_bytes(v, "big")
        if 1 <= k < N:
            return k
        key = hmac.new(key, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(key, v, hashlib.sha256).digest()


def sign(sk: int, msg_hash: bytes) -> tuple[int, int, int]:
    """-> (r, s, recovery_id) with low-s normalization (EIP-2)."""
    z = int.from_bytes(msg_hash, "big") % N
    while True:
        k = _rfc6979_k(sk, msg_hash)
        R_pt = _mul(G, k)
        r = R_pt[0] % N
        if r == 0:
            continue
        s = _inv(k, N) * (z + r * sk) % N
        if s == 0:
            continue
        rec = (R_pt[1] & 1) | (2 if R_pt[0] >= N else 0)
        if s > N // 2:
            s = N - s
            rec ^= 1
        return r, s, rec


def recover(msg_hash: bytes, r: int, s: int, rec: int):
    """-> pubkey point or None (the ecrecover precompile semantics)."""
    if not (1 <= r < N and 1 <= s < N and rec < 4):
        return None
    x = r + (N if rec & 2 else 0)
    if x >= P:
        return None
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if (y & 1) != (rec & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big") % N
    rinv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    q = _add(_mul((x, y), s * rinv % N), _mul(G, (-z * rinv) % N))
    return q


def verify(pub, msg_hash: bytes, r: int, s: int) -> bool:
    if pub is None or not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(msg_hash, "big") % N
    w = _inv(s, N)
    u1, u2 = z * w % N, r * w % N
    pt = _add(_mul(G, u1), _mul(pub, u2))
    return pt is not None and pt[0] % N == r
