"""The slow tier of the port's recursion layer.

The reference's slow recursion tests (tests/conftest.py lists their modules
as slow; tests/test_pipeline.py marks its tests so) run twice, as they are
and as their port twin, with every verdict compared
(tests/test_torch_recursion_twins.py::verdicts_match); and the port's CPU
proofs of the recursion goldens (plonk/demo.py::RECURSION_GOLDENS) equal the
reference's bytes."""

import hashlib

import numpy as np
import pytest
import torch
from test_torch_recursion_twins import _tests_of, verdicts_match

from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.keygen import keygen
from zkevm_circuits_tpu_torch.plonk.prover import prove
from zkevm_circuits_tpu_torch.plonk.verifier import verify
from zkevm_circuits_tpu_torch.poly.kzg import Srs
from zkevm_circuits_tpu_torch.poly.transcript import PoseidonTranscript

pytestmark = pytest.mark.slow
torch.set_num_threads(2)

SLOW_MODULES = ("test_ecmsm", "test_straus", "test_fold", "test_compression",
                "test_layer1", "test_aggregation", "test_aggregation_snarks",
                "test_pipeline")


@pytest.mark.parametrize("case", [(m, t) for m in SLOW_MODULES for t in _tests_of(m)],
                         ids=lambda c: f"{c[0]}::{c[1]}")
def test_recursion_twin(case, tmp_path_factory):
    verdicts_match(*case, tmp_path_factory)


@pytest.mark.parametrize("name", sorted(demo.RECURSION_GOLDENS))
def test_cpu_proof_matches_golden(name):
    """The port's CPU proof of the golden's witness is the reference's."""
    k, sha, length = demo.RECURSION_GOLDENS[name]
    inner = None
    if name == "compression":
        srs_i = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu")
        pk_i, vk_i = keygen(demo.DemoCircuit(), demo.K, srs_i, device="cpu")
        inner = (vk_i, prove(pk_i, demo.DemoCircuit(), [[demo.A_IN]], srs_i,
                             transcript=PoseidonTranscript(), device="cpu",
                             rng=np.random.default_rng(demo.COMPRESSION_INNER_SEED)))
        tau, seed = demo.COMPRESSION_TAU, demo.COMPRESSION_SEED
    else:
        tau, seed = demo.PARTNER_GOLDEN_TAU, demo.PARTNER_GOLDEN_SEED
    circuit, inst = demo.recursion_golden(name, inner=inner)
    srs = Srs.unsafe_setup(k, tau=tau, device="cpu")
    pk, vk = keygen(circuit, k, srs, device="cpu")
    proof = prove(pk, circuit, inst, srs, rng=np.random.default_rng(seed), device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, inst, proof)
