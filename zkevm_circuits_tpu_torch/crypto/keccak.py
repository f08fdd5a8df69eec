"""Plain (non-circuit) Keccak-f[1600] and keccak256 (port of
zkevm_circuits_tpu/crypto/keccak.py, pure-Python path only).

The spec oracle for the Keccak circuit's witness and test vectors.
Host-side pure Python: witness hashing is off the device's critical path.

Note python's hashlib.sha3_256 is NIST SHA-3 (different padding byte);
Ethereum uses original Keccak with 0x01 domain padding, implemented here.
"""

from __future__ import annotations

ROUNDS = 24

# round constants for iota
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets for rho, indexed [x][y]
ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

MASK64 = (1 << 64) - 1


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & MASK64


def keccak_f(state: list[list[int]]) -> list[list[int]]:
    """One Keccak-f[1600] permutation over a 5x5 lane matrix state[x][y]."""
    a = [row[:] for row in state]
    for rnd in range(ROUNDS):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= RC[rnd]
    return a


RATE_BYTES = 136  # 1088-bit rate for keccak256


def keccak256(data: bytes) -> bytes:
    """Ethereum keccak256 (original Keccak padding 0x01 ... 0x80)."""
    state = [[0] * 5 for _ in range(5)]
    # pad10*1 with domain byte 0x01
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += b"\x00" * pad_len
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        state = keccak_f(state)
    out = b""
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out


def keccak256_batch(inputs: list[bytes]) -> list[bytes]:
    """keccak256 of each input (block-wide witness collection)."""
    return [keccak256(m) for m in inputs]


def keccak256_int(data: bytes) -> int:
    """Digest as big-endian integer (the form circuit tables use)."""
    return int.from_bytes(keccak256(data), "big")


EMPTY_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
)
