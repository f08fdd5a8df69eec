"""Production proving API — chunk prover and recursion layers with
file-memoized artifacts (port of zkevm_circuits_tpu/service/prover.py).

Equivalent of the reference's `prover` crate (SURVEY.md §2.1 item 11):
  * `Proof` — JSON+base64 proof/vk serialization (prover/src/proof.rs:34)
  * `ChunkProver.gen_chunk_proof` — trace -> witness -> SuperCircuit ->
    proof (prover/src/zkevm/prover.rs:42), with every artifact
    load-or-gen cached to `output_dir` the way each reference layer does
    (prover/src/common/prover/{inner,compression,...}.rs:31-38)
  * SRS cached per degree in `params_dir` (utils.rs:27), as host arrays
    that load back onto the prover's device
  * `CircuitCapacityChecker` — row-usage estimation for block packing
    (prover/src/zkevm/capacity_checker.rs:116)
  * `LayerProver` — layer-1 compression of an inner proof
    (recursion/compression.py), keys per degree, proofs cached by the
    inner proof's digest
  * `BatchProver` — the batch statement over the chunks' deferred claims,
    folded host-side or in-circuit (recursion/aggregation.py, fold.py)
Every entry point takes `device`; None means the card.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import time

from ..circuits.super_circuit import SuperCircuit, SuperParams
from ..plonk.circuit import usable_rows
from ..plonk.keygen import keygen
from ..plonk.prover import prove
from ..plonk.verifier import verify
from ..poly.kzg import Srs, srs_file
from ..types.bytecode import Bytecode
from ..utils.stats import timer
from ..witness.builder import CircuitInputBuilder


@dataclasses.dataclass
class Proof:
    proof: bytes
    instances: list[list[int]]
    k: int

    def to_json(self) -> str:
        return json.dumps({
            "proof": base64.b64encode(self.proof).decode(),
            "instances": [[hex(v) for v in col] for col in self.instances],
            "k": self.k,
        })

    @classmethod
    def from_json(cls, s: str) -> "Proof":
        d = json.loads(s)
        return cls(
            proof=base64.b64decode(d["proof"]),
            instances=[[int(v, 16) for v in col] for col in d["instances"]],
            k=d["k"],
        )


class ChunkProver:
    def __init__(self, params_dir: str, output_dir: str | None = None,
                 params: SuperParams | None = None, k: int = 9, device=None):
        self.params_dir = params_dir
        self.output_dir = output_dir
        self.k = k
        self.super_params = params or SuperParams()
        self.device = device  # None: the card (resolved where it is used)
        os.makedirs(params_dir, exist_ok=True)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        self._srs: Srs | None = None
        self._keys = None

    # ---- cached SRS per degree (reference params_dir behavior) -----------
    def srs(self) -> Srs:
        """The SRS of degree k: loaded from params_dir, or set up and
        stored there.  The file holds host arrays (the G1 powers' digit
        planes and the G2 points), so it loads onto whichever device this
        prover runs on."""
        if self._srs is None:
            self._srs = srs_file(os.path.join(self.params_dir, f"srs_k{self.k}.pkl"),
                                 self.k, self.device)
        return self._srs

    def keys(self, circuit: SuperCircuit):
        if self._keys is None:
            with timer("keygen"):
                self._keys = keygen(circuit, self.k, self.srs(),
                                    device=self.device)
        return self._keys

    # ---- chunk proving ------------------------------------------------------
    def gen_chunk_proof(self, builder: CircuitInputBuilder,
                        bytecodes: list[Bytecode], txs,
                        name: str = "chunk", timings: dict | None = None) -> Proof:
        """load_or_gen: the reference memoizes every layer's snark to
        output_dir; identical behavior keyed by a witness digest.
        `timings`, when a dict, gets the seconds of each prover phase (a
        cache hit leaves it as it is)."""
        digest = hashlib.sha256(
            repr([
                [(r.rw_counter, int(r.tag), r.value) for r in builder.rws.rws],
                [bc.to_bytes() for bc in bytecodes],
            ]).encode()
        ).hexdigest()[:16]
        cache = (
            os.path.join(self.output_dir, f"proof_{name}_{digest}.json")
            if self.output_dir else None
        )
        if cache and os.path.exists(cache):
            with open(cache) as f:
                return Proof.from_json(f.read())
        circuit = SuperCircuit(builder, bytecodes, txs, self.super_params)
        pk, vk = self.keys(circuit)
        with timer("prove chunk"):
            # Poseidon transcript: chunk proofs feed the recursion layers
            # (reference inner proofs hash with Poseidon via
            # snark-verifier-sdk, prover/src/common/prover/utils.rs:24)
            from ..poly.transcript import PoseidonTranscript

            proof = prove(pk, circuit, [], self.srs(),
                          transcript=PoseidonTranscript(), device=self.device,
                          timings=timings)
        out = Proof(proof=proof, instances=[], k=self.k)
        if cache:
            with open(cache, "w") as f:
                f.write(out.to_json())
        return out

    def verify_chunk_proof(self, proof: Proof) -> bool:
        assert self._keys is not None, "keys not generated yet"
        _, vk = self._keys
        from ..poly.transcript import PoseidonReader

        return verify(vk, proof.instances, proof.proof,
                      transcript=PoseidonReader(proof.proof))


class CircuitCapacityChecker:
    """Estimates per-circuit row usage for a block, to pack chunks below
    circuit capacity (reference capacity_checker.rs:116,159)."""

    def __init__(self, params: SuperParams, k: int):
        self.params = params
        self.k = k

    def estimate(self, builder: CircuitInputBuilder,
                 bytecodes: list[Bytecode],
                 n_pi_messages: int = 1) -> dict:
        """Per-sub-circuit row estimates (reference per-tx row-usage
        accounting, capacity_checker.rs:159).  Keccak counts one padded
        permutation per 136-byte block of every hashed message (bytecodes
        + the PI statement).  Like the JAX package's, it leaves out the
        two messages each transaction adds to the SuperCircuit's Keccak
        input (its sign payload and signed envelope)."""
        from ..circuits.keccak import ROWS_PER_PERM

        keccak_msgs = [len(bc.to_bytes()) for bc in bytecodes]
        keccak_msgs += [136] * n_pi_messages
        keccak_rows = sum(
            (ln // 136 + 1) * ROWS_PER_PERM for ln in keccak_msgs
        )
        n_sigs = len(builder.sig_events)
        sig_rows = n_sigs * 258
        ecc_rows = (len(builder.ecadd_events)
                    + len(builder.ecmul_events) * 258)
        mulmod_rows = len(builder.mulmod_events)
        for ev in (builder.sig_events + builder.ecadd_events
                   + builder.ecmul_events + builder.modexp_events):
            mulmod_rows += len(ev.mulmod_events())
        modexp_rows = sum(
            len(ev.steps()) for ev in builder.modexp_events
        )
        sha256_blocks = sum(
            (ln + 8) // 64 + 1
            for ln in map(len, builder.sha256_inputs)
        )
        keccak_rows += sum(
            (len(m) // 136 + 1) * ROWS_PER_PERM
            for m in builder.sha3_inputs
        ) + n_sigs * ROWS_PER_PERM  # pubkey hashes
        rows = {
            "state": len(builder.rws.rws),
            "evm": len(builder.steps),
            "bytecode": sum(1 + len(bc) for bc in bytecodes),
            "copy": sum(ev.length for ev in builder.copy_events),
            "exp": sum(len(ev.steps) for ev in builder.exp_events),
            "keccak": keccak_rows,
            "tx": (self.params.tx.max_txs * 12 + self.params.tx.max_calldata),
            "pi": max(136, 256),
            "sig": sig_rows,
            "ecc": ecc_rows,
            "mulmod": mulmod_rows,
            "modexp": modexp_rows,
            "sha256": sha256_blocks * 72,
        }
        cap = usable_rows(1 << self.k)
        rows["fits"] = all(
            v <= cap for key, v in rows.items() if key != "fits"
        )
        return rows


def _on(device) -> dict:
    """keygen/prove keywords for `device` (None, the card, is their
    default)."""
    return {} if device is None else {"device": device}


class LayerProver:
    """Recursion layers over inner proofs (reference 5-layer pipeline
    Inner -> Layer1/2 (compression) -> Layer3 (aggregation) -> Layer4,
    prover/src/config.rs:36-48; common/prover/compression.rs).

    Layer1 here: CompressionCircuit — the inner proof's scalar
    verification proven in-circuit, elliptic claim deferred
    (recursion/compression.py).  Artifacts are load-or-gen cached like
    every reference layer."""

    def __init__(self, params_dir: str, output_dir: str | None = None,
                 device=None):
        self.params_dir = params_dir
        self.output_dir = output_dir
        self.device = device  # None: the card (resolved where it is used)
        os.makedirs(params_dir, exist_ok=True)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        self._srs: dict[int, Srs] = {}
        self._keys: dict[str, tuple] = {}

    def srs(self, k: int) -> Srs:
        """The SRS of degree k, kept in params_dir as host arrays."""
        if k not in self._srs:
            self._srs[k] = srs_file(os.path.join(self.params_dir, f"srs_k{k}.pkl"),
                                    k, self.device)
        return self._srs[k]

    def gen_compression_proof(self, vk_inner, inner: Proof,
                              name: str = "layer1", timings: dict | None = None):
        """Inner proof (PoseidonTranscript) -> compression proof +
        (claim, instances) for the aggregation layer.  Returns
        (Proof, CompressionCircuit).  `timings`, when a dict, gets the
        seconds of the circuit's host witness ("circuit"), and, unless the
        proof comes from the cache, of the SRS, keygen and prove, and the
        keygen's and prover's phases ("keygen_phases", "prove_phases")."""
        from ..recursion.compression import CompressionCircuit

        marks = timings if timings is not None else {}
        t0 = time.perf_counter()
        comp = CompressionCircuit(vk_inner, inner.proof, inner.instances)
        kc = comp.min_k()
        insts = comp.instances()
        marks["circuit"] = time.perf_counter() - t0
        digest = hashlib.sha256(inner.proof).hexdigest()[:16]
        cache = (
            os.path.join(self.output_dir, f"proof_{name}_{digest}.json")
            if self.output_dir else None
        )
        if cache and os.path.exists(cache):
            with open(cache) as f:
                return Proof.from_json(f.read()), comp
        t0 = time.perf_counter()
        srs = self.srs(kc)
        marks["srs"] = time.perf_counter() - t0
        key = f"{name}_k{kc}"
        t0 = time.perf_counter()
        if key not in self._keys:
            kw = _on(self.device)
            if timings is not None:
                kw["timings"] = marks["keygen_phases"] = {}
            with timer(f"keygen {key}"):
                self._keys[key] = keygen(comp, kc, srs, **kw)
        pk, vk_c = self._keys[key]
        marks["keygen"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kw = _on(self.device)
        if timings is not None:
            kw["timings"] = marks["prove_phases"] = {}
        with timer(f"prove {name}"):
            proof = prove(pk, comp, insts, srs, **kw)
        marks["prove"] = time.perf_counter() - t0
        out = Proof(proof=proof, instances=insts, k=kc)
        if cache:
            with open(cache, "w") as f:
                f.write(out.to_json())
        return out, comp

    def verify_compression_proof(self, name_k: str, proof: Proof) -> bool:
        _, vk_c = self._keys[name_k]
        return verify(vk_c, proof.instances, proof.proof)


class BatchProver:
    """Layer3 batching (reference aggregator::Prover::gen_agg_evm_proof,
    prover/src/aggregator/prover.rs:69): check the chunks' deferred
    claims with ONE folded pairing and commit the batch statement
    (BatchHash over the chunk pi hashes).  `gen_batch_in_circuit` proves
    the fold itself on `layers`' device."""

    def gen_batch(self, items, chunk_hashes) -> dict:
        """items: [(vk_inner, DeferredClaim, instance_values)];
        chunk_hashes: [recursion.aggregation.ChunkHash]."""
        from ..recursion.aggregation import (
            BatchHash, fold_and_verify_claims,
        )

        assert fold_and_verify_claims(items), "deferred claim fold failed"
        batch = BatchHash(chunk_hashes)
        return {
            "batch_pi_hash": hex(batch.pi_hash()),
            "n_chunks": len(chunk_hashes),
            "chunk_pi_hashes": [hex(c.pi_hash()) for c in chunk_hashes],
        }

    def gen_batch_in_circuit(self, layers: LayerProver, layer_items,
                             chunk_hashes, srs_vk, timings: dict | None = None) -> dict:
        """In-circuit aggregation fold (reference
        aggregator/src/aggregation/circuit.rs:40 accumulation step):
        `layer_items` = [(claim, instance_values)] from
        CompressionLayerCircuit proofs; the fold circuit computes the
        accumulation challenge and both folded points in-circuit
        (recursion/fold.py), is PROVEN, and the returned record carries
        the folded accumulator — valid iff verify_fold's ONE pairing
        accepts (checked here).  `timings`, when a dict, gets the seconds
        of the circuit's host work ("circuit"), the SRS, keygen (with
        "keygen_phases", unless the key was cached), prove (with
        "prove_phases") and the two checks ("verify")."""
        from ..plonk.verifier import verify as plonk_verify
        from ..recursion.aggregation import BatchHash
        from ..recursion.fold import AggregationFoldCircuit, verify_fold
        from ..recursion.layer import layer1_accumulator

        marks = timings if timings is not None else {}
        t0 = time.perf_counter()
        accs = [layer1_accumulator(c, v) for c, v in layer_items]
        circ = AggregationFoldCircuit(accs)
        kk = circ.min_k()
        marks["circuit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        srs = layers.srs(kk)
        marks["srs"] = time.perf_counter() - t0
        key = f"fold_k{kk}_m{len(accs)}"
        t0 = time.perf_counter()
        if key not in layers._keys:
            kw = _on(layers.device)
            if timings is not None:
                kw["timings"] = marks["keygen_phases"] = {}
            with timer(f"keygen {key}"):
                layers._keys[key] = keygen(circ, kk, srs, **kw)
        pk, vk_f = layers._keys[key]
        marks["keygen"] = time.perf_counter() - t0
        insts = circ.instances()
        t0 = time.perf_counter()
        kw = _on(layers.device)
        if timings is not None:
            kw["timings"] = marks["prove_phases"] = {}
        with timer("prove fold"):
            fproof = prove(pk, circ, insts, srs, **kw)
        marks["prove"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert plonk_verify(vk_f, insts, fproof)
        assert verify_fold(srs_vk, insts[0], len(accs)), (
            "folded accumulator pairing rejected"
        )
        marks["verify"] = time.perf_counter() - t0
        batch = BatchHash(chunk_hashes)
        return {
            "batch_pi_hash": hex(batch.pi_hash()),
            "n_chunks": len(chunk_hashes),
            "chunk_pi_hashes": [hex(c.pi_hash()) for c in chunk_hashes],
            "fold_proof": Proof(proof=fproof, instances=insts, k=kk),
            "folded_acc": insts[0][-8:],
        }
