"""Aggregation layer — fold many deferred KZG claims into ONE pairing,
plus the chunk/batch hash statements.

Equivalent of the reference's `AggregationCircuit` accumulator folding +
`ChunkHash`/`BatchHash` (aggregator/src/aggregation/circuit.rs:40,
src/chunk.rs:18, src/batch.rs:19, src/constants.rs:51 MAX_AGG_SNARKS=15)
and snark-verifier's KZG accumulation
(extract_proof_and_instances_with_pairing_check, aggregator/src/lib.rs:22).

v0 scope (documented): the fold runs host-side over the CompressionCircuit
layer's exposed claims; the in-circuit variant (verifying <=15 compression
proofs inside one circuit) reuses the same tape machinery next.  Soundness
of the fold: each deferred claim i reduces to the pairing identity
    e(W2_i, [s]_2) * e(-L_i, [1]_2) = 1,   L_i = u_i*W2_i + C_L_i,
and bilinearity gives, for Fiat-Shamir weights r_i,
    e(sum r_i W2_i, [s]_2) * e(-sum r_i L_i, [1]_2) = 1
which fails with overwhelming probability if any single claim fails.

Port of zkevm_circuits_tpu/recursion/aggregation.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.  A claim's sides come from
compression.deferred_sides, one host MSM.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..crypto.params import FQ_MODULUS, FR_MODULUS as R
from ..crypto.curve import host_g1_add, host_g1_mul
from ..crypto import pairing as pr
from ..poly.transcript import PoseidonSponge
from .compression import DeferredClaim, claim_points, deferred_sides

MAX_AGG_SNARKS = 15  # reference aggregator/src/constants.rs:51


def _claim_sides(vk_inner, claim: DeferredClaim, vals: list[int]):
    """Resolve one deferred claim to its pairing sides (W2, L)."""
    for pt in claim_points(claim, vals):
        if pt is not None:
            x_, y_ = pt
            if (y_ * y_ - (x_ ** 3 + 3)) % FQ_MODULUS != 0:
                raise ValueError("witnessed commitment not on BN254")
    return deferred_sides(vk_inner, claim, vals)


def fold_and_verify_claims(items: list[tuple]) -> bool:
    """items: [(vk_inner, DeferredClaim, instance_values), ...] (<= 15).
    One 2-pairing check for all claims, with Poseidon-derived weights."""
    assert 1 <= len(items) <= MAX_AGG_SNARKS
    sponge = PoseidonSponge()
    sides = []
    for vk_inner, claim, vals in items:
        try:
            w2, lhs = _claim_sides(vk_inner, claim, vals)
        except ValueError:
            return False  # off-curve witnessed point: reject, don't crash
        for pt in (w2, lhs):
            if pt is None:
                sponge.absorb(0, 0)
            else:
                sponge.absorb(pt[0] % R, pt[1] % R)
        sides.append((w2, lhs))
    g2 = items[0][0].g2
    s_g2 = items[0][0].s_g2
    assert all(vk.g2 == g2 and vk.s_g2 == s_g2 for vk, _, _ in items), (
        "claims must share one SRS"
    )
    w2_acc = None
    lhs_acc = None
    for w2, lhs in sides:
        r_i = sponge.squeeze()
        w2_acc = host_g1_add(w2_acc, host_g1_mul(w2, r_i))
        lhs_acc = host_g1_add(lhs_acc, host_g1_mul(lhs, r_i))
    neg = lambda p: None if p is None else (p[0], (-p[1]) % FQ_MODULUS)
    return pr.pairing_product_is_one([(w2_acc, s_g2), (neg(lhs_acc), g2)])


# ---------------------------------------------------------------------------
# chunk / batch hash statements (reference aggregator/src/{chunk,batch}.rs)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChunkHash:
    """chunk_pi_hash preimage (reference chunk.rs:18 and the PI circuit's
    chunk statement, circuits/pi.py): keccak(chain_id ||
    prev_state_root || post_state_root || withdraw_root || data_hash)."""

    chain_id: int
    prev_state_root: int
    post_state_root: int
    withdraw_root: int
    data_hash: int

    def bytes_preimage(self) -> bytes:
        return (
            self.chain_id.to_bytes(8, "big")
            + self.prev_state_root.to_bytes(32, "big")
            + self.post_state_root.to_bytes(32, "big")
            + self.withdraw_root.to_bytes(32, "big")
            + self.data_hash.to_bytes(32, "big")
        )

    def pi_hash(self) -> int:
        return int.from_bytes(keccak256(self.bytes_preimage()), "big")


@dataclasses.dataclass
class BatchHash:
    """Batch statement over <= 15 chunks (reference batch.rs:19,33):
    continuity (state roots chain, one chain id, equal data paths) +
    keccak over the concatenated chunk pi hashes."""

    chunks: list[ChunkHash]

    def __post_init__(self):
        assert 1 <= len(self.chunks) <= MAX_AGG_SNARKS
        for a, b in zip(self.chunks, self.chunks[1:]):
            assert a.post_state_root == b.prev_state_root, (
                "chunk state roots must chain"
            )
            assert a.chain_id == b.chain_id

    def pi_hash(self) -> int:
        pre = b"".join(
            c.pi_hash().to_bytes(32, "big") for c in self.chunks
        )
        return int.from_bytes(keccak256(pre), "big")
