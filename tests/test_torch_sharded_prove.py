"""The port's prove(mesh=...) over gloo process groups on the CPU: every
rank proves the k=5 DemoCircuit with the same rng, and every rank's proof
bytes equal the reference's golden (plonk/demo.py, the single-device
proof), so each other; the proof verifies.  D = 1 and 2 in the fast tier,
D = 4 in the slow tier (a CPU demo proof takes about a minute per rank).

Ranks are spawned with torch.multiprocessing (see test_torch_sharding.py);
the rank function imports only torch, numpy and the port.
"""

import hashlib
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sharding import run_ranks
from zkevm_circuits_tpu_torch.plonk import demo


def _prove_rank(rank, world, init, out_dir):
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        g = dist.group.WORLD
        srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu")
        pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device="cpu")
        proof = prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                      rng=np.random.default_rng(demo.GOLDEN_SEED), device="cpu",
                      mesh=g)
        res = {"proof": proof, "verify": verify(vk, [[demo.A_IN]], proof)}
        try:  # a gloo group with tensors of another device
            prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs, device="meta", mesh=g)
            res["mismatch"] = "no error"
        except ValueError as e:
            res["mismatch"] = str(e)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def _check(results):
    for res in results:
        assert len(res["proof"]) == demo.GOLDEN_LEN
        assert hashlib.sha256(res["proof"]).hexdigest() == demo.GOLDEN_SHA256
        assert res["verify"]
        assert "gloo process group cannot carry meta" in res["mismatch"]
    assert all(res["proof"] == results[0]["proof"] for res in results)


@pytest.mark.parametrize("world", [1, 2], ids=["D1", "D2"])
def test_sharded_demo_proof_matches_golden(world, tmp_path):
    _check(run_ranks(_prove_rank, world, tmp_path))


@pytest.mark.slow
def test_sharded_demo_proof_matches_golden_d4(tmp_path):
    _check(run_ranks(_prove_rank, 4, tmp_path))
