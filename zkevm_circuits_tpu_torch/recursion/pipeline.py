"""5-layer proving pipeline — Inner -> L1 -> L2 -> L3 (agg) -> L4 + artifact.

The reference's production shape (prover/src/config.rs:36-48):

    Inner   chunk SuperCircuit proof        (Poseidon transcript)
    Layer1  wide compression of the inner   (CompressionCircuit)
    Layer2  thin compression of layer 1
    Layer3  AggregationCircuit over <= MAX_AGG_SNARKS layer-2 snarks
    Layer4  thin compression of layer 3  -> EVM-verifiable proof

Here every compression/aggregation layer is one mechanism —
`AggregationSnarksCircuit` (recursion/aggregation_snarks.py) with m = 1
for compressions and m = M for the batch layer: each layer verifies its
inner snark(s) fully in-circuit (Poseidon transcript replay + scalar
verification on tape rows + window-shared Straus MSM for the deferred
KZG claims) and exposes ONE folded accumulator (L, W), so the layer
verifier — and ultimately the standalone artifact — finishes with a
single pairing (`recursion.fold.verify_fold`).

`LayerProver` memoizes per-layer SRS/keys the way the reference's
`common::Prover` caches ParamsKZG/pk by id
(prover/src/common/prover/utils.rs:13-25).

Port of zkevm_circuits_tpu/recursion/pipeline.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..plonk.keygen import VerifyingKey, keygen
from ..plonk.prover import prove
from ..plonk.verifier import verify
from ..poly.kzg import Srs, srs_file
from ..poly.transcript import Blake2bReader, PoseidonReader, PoseidonTranscript
from .aggregation_snarks import AggregationSnarksCircuit
from .fold import verify_fold


@dataclasses.dataclass
class LayerSnark:
    """One layer's output: proof + instances + the vk that verifies it.

    `inner_g2` = (g2, s_g2) of the INNER layer's SRS: the exposed
    accumulator is a KZG claim over the inner proof's commitments, so
    the one-pairing check pairs against the inner SRS, not this
    layer's."""

    name: str
    k: int
    vk: VerifyingKey
    proof: bytes
    instances: list[list[int]]
    m: int  # inner snarks folded (accumulator arity for verify_fold)
    inner_g2: tuple  # ((g2), (s_g2)) of the inner layer's SRS

    def verify_plonk(self, blake2b: bool = False) -> bool:
        rd = (Blake2bReader(self.proof) if blake2b
              else PoseidonReader(self.proof))
        return verify(self.vk, self.instances, self.proof, transcript=rd)

    def verify_accumulator(self) -> bool:
        from types import SimpleNamespace

        srs_like = SimpleNamespace(g2=self.inner_g2[0],
                                   s_g2=self.inner_g2[1])
        return verify_fold(srs_like, self.instances[-1], self.m)


class LayerProver:
    """Builds the recursion ladder over any inner (Poseidon-transcript)
    snark.  `srs_dir` caches SRS per degree (reference params_dir);
    `device` None proves on the card."""

    def __init__(self, srs_dir: str | None = None, max_k: int | None = None,
                 device=None):
        self.srs_dir = srs_dir
        self.device = device  # None: the card
        self._srs: dict[int, Srs] = {}
        self._keys: dict[str, tuple] = {}
        self.max_k = max_k

    def srs(self, k: int) -> Srs:
        """The SRS of degree k, kept in `srs_dir` as host arrays that load
        onto this prover's device (poly/kzg.srs_file)."""
        if k not in self._srs:
            path = (os.path.join(self.srs_dir, f"srs_k{k}.pkl")
                    if self.srs_dir else None)
            self._srs[k] = srs_file(path, k, self.device)
        return self._srs[k]

    # ------------------------------------------------------------------
    def _prove_layer(self, name: str, circuit: AggregationSnarksCircuit,
                     vk_inner: VerifyingKey,
                     final_blake2b: bool = False,
                     rng: np.random.Generator | None = None,
                     timings: dict | None = None) -> LayerSnark:
        """`timings`, when a dict, gets the seconds of the SRS, keygen
        (with its phases, "keygen_phases", unless the key was cached),
        prove (with "prove_phases") and the two self-checks ("verify")."""
        marks = timings if timings is not None else {}
        # the prover and keygen get a dict only when the caller asked
        phases = (lambda name: {"timings": marks.setdefault(name, {})}
                  if timings is not None else {})
        k = circuit.min_k()
        if self.max_k is not None:
            assert k <= self.max_k, (
                f"layer '{name}' needs k={k} > max_k={self.max_k}"
            )
        t0 = time.perf_counter()
        srs = self.srs(k)
        marks["srs"] = time.perf_counter() - t0
        cache_key = f"{name}:k{k}"
        t0 = time.perf_counter()
        if cache_key in self._keys:
            pk, vk = self._keys[cache_key]
        else:
            pk, vk = keygen(circuit, k, srs, device=self.device,
                            **phases("keygen_phases"))
            self._keys[cache_key] = (pk, vk)
        marks["keygen"] = time.perf_counter() - t0
        tr = None if final_blake2b else PoseidonTranscript()
        t0 = time.perf_counter()
        proof = prove(pk, circuit, circuit.instances(), srs, transcript=tr,
                      rng=rng or np.random.default_rng(0xA66),
                      device=self.device, **phases("prove_phases"))
        marks["prove"] = time.perf_counter() - t0
        snark = LayerSnark(
            name=name, k=k, vk=vk, proof=proof,
            instances=circuit.instances(), m=circuit.m,
            inner_g2=(vk_inner.g2, vk_inner.s_g2),
        )
        t0 = time.perf_counter()
        assert snark.verify_plonk(blake2b=final_blake2b), (
            f"layer '{name}' proof failed self-verification"
        )
        assert snark.verify_accumulator(), (
            f"layer '{name}' accumulator pairing failed"
        )
        marks["verify"] = time.perf_counter() - t0
        return snark

    def compress(self, vk_inner: VerifyingKey, proof: bytes,
                 inner_instances: list[list[int]], name: str,
                 final_blake2b: bool = False,
                 timings: dict | None = None) -> LayerSnark:
        """One thin-compression layer: verify ONE snark in-circuit, fold
        (trivially) and re-prove (reference CompressionCircuit,
        aggregator/src/compression/circuit.rs:39).  `timings`, when a
        dict, gets the circuit's host seconds ("circuit") and those of
        `_prove_layer`."""
        t0 = time.perf_counter()
        circ = AggregationSnarksCircuit(vk_inner, [proof], [inner_instances])
        if timings is not None:
            timings["circuit"] = time.perf_counter() - t0
        return self._prove_layer(name, circ, vk_inner, final_blake2b,
                                 timings=timings)

    def aggregate(self, vk_inner: VerifyingKey, proofs: list[bytes],
                  instances: list[list[list[int]]],
                  name: str = "layer3") -> LayerSnark:
        """The batch layer: verify M chunk snarks in-circuit and fold
        their accumulators (reference AggregationCircuit,
        aggregator/src/aggregation/circuit.rs:40)."""
        circ = AggregationSnarksCircuit(vk_inner, proofs, instances)
        return self._prove_layer(name, circ, vk_inner)

    # ------------------------------------------------------------------
    def prove_batch(self, vk_inner: VerifyingKey,
                    chunk_proofs: list[bytes],
                    chunk_instances: list[list[list[int]]],
                    artifact_path: str | None = None) -> dict:
        """Full ladder over M inner chunk snarks.  Returns every layer's
        snark + (optionally) the standalone verifier artifact for the
        final layer-4 proof."""
        l1 = [
            self.compress(vk_inner, p, insts, f"layer1_{i}")
            for i, (p, insts) in enumerate(zip(chunk_proofs, chunk_instances))
        ]
        l2 = [
            self.compress(s.vk, s.proof, s.instances, f"layer2_{i}")
            for i, s in enumerate(l1)
        ]
        vk2 = l2[0].vk
        l3 = self.aggregate(vk2, [s.proof for s in l2],
                            [s.instances for s in l2])
        l4 = self.compress(l3.vk, l3.proof, l3.instances, "layer4",
                           final_blake2b=True)
        out = {"layer1": l1, "layer2": l2, "layer3": l3, "layer4": l4}
        if artifact_path:
            from .evm_verifier import gen_verifier_artifact

            g2i, s_g2i = l4.inner_g2
            gen_verifier_artifact(
                l4.vk, artifact_path,
                accumulator={
                    "g2": [list(g2i[0]), list(g2i[1])],
                    "s_g2": [list(s_g2i[0]), list(s_g2i[1])],
                },
            )
            out["artifact"] = artifact_path
        return out
