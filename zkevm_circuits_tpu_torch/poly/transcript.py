"""Fiat-Shamir transcripts (host side), port of
zkevm_circuits_tpu/poly/transcript.py: the Blake2b transcript and the
Poseidon transcript of the production prover.

Mirrors the reference backend's transcript layer (external halo2_proofs
Blake2b transcript, used by the benches `circuit-benchmarks/src/
evm_circuit.rs:82-93`, and the Poseidon transcript used by the production
prover via snark-verifier, `prover/src/common/prover/utils.rs:24`).

The byte-level protocol follows halo2's Blake2bWrite conventions:
  * blake2b with digest_size=64, personalization b"Halo2-Transcript",
  * absorbing a domain prefix byte before each item:
      0 = challenge squeeze, 1 = EC point, 2 = scalar,
  * points absorbed as 32-byte LE x then y affine coordinates,
  * challenges = 64-byte running hash reduced mod r (uniform 512-bit
    reduction), and the squeezed hash is fed back into the state.

Transcript work is a negligible, latency-bound part of proving, so it runs
on the host between device phases.  The Poseidon sponge hashes with the
host permutation of crypto/poseidon.py.
"""

from __future__ import annotations

import hashlib

from ..crypto.params import FR_MODULUS

PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"
PERSONAL = b"Halo2-Transcript"


class Blake2bTranscript:
    """Prover-side (write) transcript; also usable for verification by
    replaying absorbs and comparing squeezed challenges."""

    def __init__(self):
        self._state = hashlib.blake2b(digest_size=64, person=PERSONAL)
        self.proof = bytearray()

    # -- absorb ------------------------------------------------------------
    def common_scalar(self, s: int):
        self._state.update(PREFIX_SCALAR)
        self._state.update(int(s).to_bytes(32, "little"))

    def common_point(self, xy):
        """xy: (x, y) affine ints or None for infinity (absorbed as 0,0)."""
        self._state.update(PREFIX_POINT)
        if xy is None:
            self._state.update(b"\x00" * 64)
        else:
            self._state.update(int(xy[0]).to_bytes(32, "little"))
            self._state.update(int(xy[1]).to_bytes(32, "little"))

    # -- write = absorb + append to proof -----------------------------------
    def write_scalar(self, s: int):
        self.common_scalar(s)
        self.proof += int(s).to_bytes(32, "little")

    def write_point(self, xy):
        self.common_point(xy)
        if xy is None:
            self.proof += b"\x00" * 64
        else:
            self.proof += int(xy[0]).to_bytes(32, "little")
            self.proof += int(xy[1]).to_bytes(32, "little")

    # -- squeeze -------------------------------------------------------------
    def squeeze_challenge(self) -> int:
        self._state.update(PREFIX_CHALLENGE)
        digest = self._state.copy().digest()
        self._state.update(digest)
        return int.from_bytes(digest, "little") % FR_MODULUS


class Blake2bReader:
    """Verifier-side (read) transcript over proof bytes."""

    def __init__(self, proof: bytes):
        self._t = Blake2bTranscript()
        self._buf = memoryview(bytes(proof))
        self._pos = 0

    def read_scalar(self) -> int:
        s = int.from_bytes(self._buf[self._pos : self._pos + 32], "little")
        self._pos += 32
        self._t.common_scalar(s)
        return s

    def read_point(self):
        x = int.from_bytes(self._buf[self._pos : self._pos + 32], "little")
        y = int.from_bytes(self._buf[self._pos + 32 : self._pos + 64], "little")
        self._pos += 64
        xy = None if (x == 0 and y == 0) else (x, y)
        self._t.common_point(xy)
        return xy

    def common_scalar(self, s: int):
        self._t.common_scalar(s)

    def common_point(self, xy):
        self._t.common_point(xy)

    def squeeze_challenge(self) -> int:
        return self._t.squeeze_challenge()

    @property
    def exhausted(self) -> bool:
        return self._pos == len(self._buf)


# ---------------------------------------------------------------------------
# Poseidon transcript — the recursion-path Fiat-Shamir (reference: the
# production prover hashes with Poseidon via snark-verifier-sdk,
# prover/src/common/prover/utils.rs:24, so the CompressionCircuit can
# re-derive challenges with cheap in-circuit Poseidon rows instead of
# bit-decomposed Blake2b).
#
# Chain convention (self-consistent; ONE PoseidonTable row per step when
# replayed in-circuit — the table proves out = permute([domain, a, b])[0],
# circuits/poseidon.py):
#   * running state starts at 0 and rides the DOMAIN slot:
#       step(a, b): state = permute([state, a, b])[0]
#   * scalars absorb as one Fr element each; points absorb as 4 Fr
#     elements (each Fq coordinate split LE into a 128-bit low limb and
#     the high limb); infinity absorbs (0, 0, 0, 0)
#   * buffered absorbs flush in pairs (odd tail zero-padded)
#   * squeeze: flush, then state = permute([state, total_absorbed,
#     SQUEEZE_TAG])[0]; the challenge IS the new state.  The absorb count
#     disambiguates zero-padding; the tag separates squeezes from absorbs
#     (consecutive squeezes chain, so they always differ).
# ---------------------------------------------------------------------------
_LIMB = (1 << 128) - 1
SQUEEZE_TAG = int.from_bytes(b"zkevm-tpu-fiat-shamir", "big") % FR_MODULUS


class PoseidonSponge:
    """Hash chain with a (domain, a, b, out) trace for in-circuit replay."""

    def __init__(self):
        from ..crypto.poseidon import permute, spec

        self._permute = permute
        self._sp = spec()
        self.state = 0
        self._buf: list[int] = []
        self._count = 0  # total absorbed elements
        self.trace: list[tuple[int, int, int, int]] = []

    def _step(self, a: int, b: int):
        out = self._permute([self.state, a, b], self._sp)[0]
        self.trace.append((self.state, a, b, out))
        self.state = out

    def absorb(self, *vals: int):
        for v in vals:
            self._buf.append(int(v) % FR_MODULUS)
            self._count += 1

    def _flush(self):
        for i in range(0, len(self._buf), 2):
            a = self._buf[i]
            b = self._buf[i + 1] if i + 1 < len(self._buf) else 0
            self._step(a, b)
        self._buf = []

    def squeeze(self) -> int:
        self._flush()
        self._step(self._count, SQUEEZE_TAG)
        return self.state


def _point_limbs(xy) -> list[int]:
    if xy is None:
        return [0, 0, 0, 0]
    x, y = int(xy[0]), int(xy[1])
    return [x & _LIMB, x >> 128, y & _LIMB, y >> 128]


class PoseidonTranscript:
    """Prover-side (write) Poseidon transcript; same interface as
    Blake2bTranscript so prove() takes either."""

    def __init__(self):
        self._sponge = PoseidonSponge()
        self.proof = bytearray()

    def common_scalar(self, s: int):
        self._sponge.absorb(int(s))

    def common_point(self, xy):
        self._sponge.absorb(*_point_limbs(xy))

    def write_scalar(self, s: int):
        self.common_scalar(s)
        self.proof += int(s).to_bytes(32, "little")

    def write_point(self, xy):
        self.common_point(xy)
        if xy is None:
            self.proof += b"\x00" * 64
        else:
            self.proof += int(xy[0]).to_bytes(32, "little")
            self.proof += int(xy[1]).to_bytes(32, "little")

    def squeeze_challenge(self) -> int:
        return self._sponge.squeeze()


class PoseidonReader:
    """Verifier-side (read) Poseidon transcript over proof bytes."""

    def __init__(self, proof: bytes):
        self._t = PoseidonTranscript()
        self._buf = memoryview(bytes(proof))
        self._off = 0
        # absorb/squeeze trace mirrors for the in-circuit verifier: every
        # (state_in, state_out) permutation pair is replayable from here
        self.sponge = self._t._sponge

    def read_scalar(self) -> int:
        s = int.from_bytes(self._buf[self._off : self._off + 32], "little")
        self._off += 32
        self._t.common_scalar(s)
        return s

    def read_point(self):
        x = int.from_bytes(self._buf[self._off : self._off + 32], "little")
        y = int.from_bytes(self._buf[self._off + 32 : self._off + 64], "little")
        self._off += 64
        xy = None if (x == 0 and y == 0) else (x, y)
        self._t.common_point(xy)
        return xy

    def common_scalar(self, s: int):
        self._t.common_scalar(s)

    def common_point(self, xy):
        self._t.common_point(xy)

    def squeeze_challenge(self) -> int:
        return self._t.squeeze_challenge()

    def exhausted(self) -> bool:
        return self._off >= len(self._buf)
