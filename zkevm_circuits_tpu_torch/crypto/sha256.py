"""SHA-256 host implementation with per-round state capture.

Witness source for the SHA256 circuit (the reference wraps a table16-style
implementation, zkevm-circuits/src/sha256_circuit/, SURVEY.md §2.2
"SHA256"); digests themselves come from hashlib — this mirror exists to
expose every round's (a, e, W) values for the bit-plane witness and is
asserted against hashlib in tests.

Port of zkevm_circuits_tpu/crypto/sha256.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import hashlib

M32 = (1 << 32) - 1

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def pad(msg: bytes) -> bytes:
    ml = len(msg) * 8
    out = msg + b"\x80"
    out += b"\x00" * ((-len(out) - 8) % 64)
    return out + ml.to_bytes(8, "big")


@dataclasses.dataclass
class BlockTrace:
    """One compression: init state, schedule, per-round (a, e), digest."""

    h_in: list[int]  # 8 words
    w: list[int]  # 64 words
    a_rounds: list[int]  # 64 new-a values
    e_rounds: list[int]  # 64 new-e values
    h_out: list[int]  # 8 words
    carries_e: list[int]  # per-round carry of the e-addition
    carries_a: list[int]
    carries_w: list[int]  # schedule carries (t >= 16; 0 otherwise)
    carries_h: list[int]  # 8 output-addition carries


def compress_trace(h_in: list[int], block: bytes) -> BlockTrace:
    w = [int.from_bytes(block[4 * t : 4 * t + 4], "big") for t in range(16)]
    cw = [0] * 16
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        tot = w[t - 16] + s0 + w[t - 7] + s1
        w.append(tot & M32)
        cw.append(tot >> 32)
    a, b, c, d, e, f, g, h = h_in
    a_rounds, e_rounds, ce, ca = [], [], [], []
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + K[t] + w[t]
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        e_tot = d + t1
        a_tot = t1 + t2
        h, g, f = g, f, e
        e = e_tot & M32
        ce.append(e_tot >> 32)
        d, c, b = c, b, a
        a = a_tot & M32
        ca.append(a_tot >> 32)
        a_rounds.append(a)
        e_rounds.append(e)
    h_tot = [x + y for x, y in zip(h_in, [a, b, c, d, e, f, g, h])]
    return BlockTrace(
        h_in=list(h_in), w=w, a_rounds=a_rounds, e_rounds=e_rounds,
        h_out=[x & M32 for x in h_tot], carries_e=ce, carries_a=ca,
        carries_w=cw, carries_h=[x >> 32 for x in h_tot],
    )


def sha256_trace(msg: bytes) -> list[BlockTrace]:
    padded = pad(msg)
    h = list(H_INIT)
    out = []
    for i in range(0, len(padded), 64):
        tr = compress_trace(h, padded[i : i + 64])
        out.append(tr)
        h = tr.h_out
    digest = b"".join(x.to_bytes(4, "big") for x in h)
    assert digest == hashlib.sha256(msg).digest()
    return out
