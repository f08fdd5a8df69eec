"""Production proving API — chunk prover with file-memoized artifacts
(port of the first half of zkevm_circuits_tpu/service/prover.py).

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
The recursion layers (compression/aggregation) stack on this API next.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import pickle

import torch

from ..circuits.super_circuit import SuperCircuit, SuperParams
from ..crypto.curve import G1
from ..device import resolve
from ..plonk.circuit import usable_rows
from ..plonk.keygen import keygen
from ..plonk.prover import prove
from ..plonk.verifier import verify
from ..poly.kzg import Srs
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
            path = os.path.join(self.params_dir, f"srs_k{self.k}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    d = pickle.load(f)
                self._srs = Srs(
                    k=d["k"], g2=d["g2"], s_g2=d["s_g2"],
                    g1_powers=G1(*(torch.as_tensor(a, device=resolve(self.device))
                                   for a in d["g1_powers"])))
            else:
                with timer(f"SRS setup k={self.k}"):
                    self._srs = Srs.unsafe_setup(self.k, device=self.device)
                with open(path, "wb") as f:
                    pickle.dump({
                        "k": self._srs.k, "g2": self._srs.g2,
                        "s_g2": self._srs.s_g2,
                        "g1_powers": [c.cpu().numpy()
                                      for c in self._srs.g1_powers],
                    }, f)
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
