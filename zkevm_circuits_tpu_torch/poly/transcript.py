"""Fiat-Shamir transcripts (host side), the Blake2b half of
zkevm_circuits_tpu/poly/transcript.py.

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
on the host between device phases.
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
