"""Port service layer (zkevm_circuits_tpu_torch.service.prover,
utils/stats.py, and the chunk workload of service/bench_circuits.py)
against the JAX package's: circuit_stats and the phase timer, Proof's
JSON text, ChunkProver's load-or-gen cache (tests/test_service_prover.py
with a fake prove patched into the port's module) and its SRS file,
CircuitCapacityChecker.estimate on the same builders, and
super_workload's witness, regions and MockProver verdict at k=9 against
the same workload built from the JAX package's modules.  The slow tier
holds test_variadic_sizes_one_vk's real proofs, byte for byte against the
reference's, and the port's CPU proof of the k=9 SuperCircuit golden."""

import hashlib
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import evm as jevm
from zkevm_circuits_tpu.circuits import exp as jexp
from zkevm_circuits_tpu.circuits import rlp as jrlp
from zkevm_circuits_tpu.circuits import super_circuit as jsuper
from zkevm_circuits_tpu.circuits import tx as jtxc
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.service import prover as jprover
from zkevm_circuits_tpu.types import transaction as jtx
from zkevm_circuits_tpu.utils import stats as jstats
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.circuits.super_circuit import SuperCircuit, SuperParams
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench
from zkevm_circuits_tpu_torch.service import prover as tprover
from zkevm_circuits_tpu_torch.utils import stats as tstats
from zkevm_circuits_tpu_torch.witness import builder as tb

from test_torch_super import JAX, twin

torch.set_num_threads(2)
CHIP_SMOKE_SEED = 20261016  # chip_smoke.SEED


def test_circuit_stats_and_timer_match_reference(caplog):
    for make in (demo.super_golden, demo.DemoCircuit):
        cs = ConstraintSystem()
        make().configure(cs)
        assert set(tstats.circuit_stats(cs)) == {
            "num_fixed_columns", "num_advice_columns", "num_instance_columns",
            "num_gates", "num_lookup_arguments", "num_lookup_inputs",
            "num_permutation_columns", "num_challenges", "num_phases", "degree"}
    from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS

    jcs, tcs = JCS(), ConstraintSystem()
    demo.super_golden(JAX).configure(jcs)
    demo.super_golden().configure(tcs)
    assert tstats.circuit_stats(tcs) == jstats.circuit_stats(jcs)
    assert tstats.circuit_stats(tcs)["num_advice_columns"] == 605
    with caplog.at_level(logging.INFO, logger="zkevm_tpu"):
        with tstats.timer("port phase"):
            pass
        with jstats.timer("port phase"):
            pass
    msgs = [r.getMessage().split(" (")[0] for r in caplog.records]
    assert msgs == ["start: port phase", "end: port phase"] * 2
    assert tstats.log is jstats.log  # one logger name, "zkevm_tpu"


PROOFS = [
    (b"\x01\x02\xff" * 11, [[5, R - 1], []], 13),
    (bytes(range(256)) * 3, [], 9),
    (b"", [[0], [1, 2, 3]], 20),
]


@pytest.mark.parametrize("proof,instances,k", PROOFS)
def test_proof_json_matches_reference(proof, instances, k):
    tp = tprover.Proof(proof=proof, instances=instances, k=k)
    jp = jprover.Proof(proof=proof, instances=instances, k=k)
    assert tp.to_json() == jp.to_json()
    q = tprover.Proof.from_json(jp.to_json())
    assert (q.proof, q.instances, q.k) == (proof, instances, k)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_chunk_prover_load_or_gen(side, tmp_path, monkeypatch):
    """tests/test_service_prover.py::test_chunk_prover_load_or_gen, as it
    is and as its port twin (a fake prove patched into each package's
    prover module): a cache hit on the same witness, a re-prove on a
    different one; both packages name the cached proofs alike."""
    import test_service_prover as ref

    mod = ref if side == "reference" else twin("test_service_prover")
    if side == "port":
        assert mod.ChunkProver is tprover.ChunkProver
    mod.test_chunk_prover_load_or_gen(tmp_path, monkeypatch)
    names = sorted(os.listdir(tmp_path / "out"))
    assert len(names) == 2 and all(n.startswith("proof_chunk_") for n in names)
    if side == "port":
        other = tmp_path / "reference"
        other.mkdir()
        monkeypatch.undo()
        ref.test_chunk_prover_load_or_gen(other, monkeypatch)
        assert sorted(os.listdir(other / "out")) == names


def test_chunk_prover_srs_file_holds_host_arrays(tmp_path):
    """The SRS file holds numpy arrays, no tensor, and loads back onto the
    prover's device equal to the SRS it stored."""
    a = tprover.ChunkProver(str(tmp_path / "params"), k=4, device="cpu")
    srs = a.srs()
    with open(tmp_path / "params" / "srs_k4.pkl", "rb") as f:
        d = pickle.load(f)
    assert all(isinstance(c, np.ndarray) for c in d["g1_powers"])
    b = tprover.ChunkProver(str(tmp_path / "params"), k=4, device="cpu")
    loaded = b.srs()
    assert loaded is not srs and loaded.device == torch.device("cpu")
    for x, y in zip(loaded.g1_powers, srs.g1_powers):
        assert torch.equal(x, y)
    assert (loaded.g2, loaded.s_g2, loaded.k) == (srs.g2, srs.s_g2, 4)


def test_chunk_prover_gen_passes_device_and_timings(tmp_path, monkeypatch):
    """gen_chunk_proof hands prove the prover's device, the Poseidon
    transcript and the caller's timings dict."""
    seen = {}

    def fake_prove(pk, circuit, instances, srs, **kw):
        seen.update(kw)
        kw["timings"]["quotient"] = 1.0
        return b"p"

    monkeypatch.setattr(tprover, "prove", fake_prove)
    monkeypatch.setattr(tprover.ChunkProver, "keys", lambda self, c: (None, None))
    monkeypatch.setattr(tprover.ChunkProver, "srs", lambda self: None)
    cp = tprover.ChunkProver(str(tmp_path / "params"), k=9, device="cpu")
    b, codes, txs = demo.super_witness()
    timings: dict = {}
    assert cp.gen_chunk_proof(b, codes, txs, timings=timings).proof == b"p"
    assert seen["device"] == "cpu" and timings == {"quotient": 1.0}
    assert type(seen["transcript"]).__name__ == "PoseidonTranscript"


def _simple_builder(m):
    """tests/test_service_prover.py::test_capacity_checker_estimates's
    witness, built from the modules `m`."""
    tracer, types, builder = m["tracer"], m["types"], m["builder"]
    code = types.Bytecode().push(1, 1).push(1, 2).op("ADD").op("POP").op("STOP")
    st = tracer.StateDB({0xA: tracer.Account(balance=10**15),
                         0xB: tracer.Account(code=code.to_bytes())})
    tr = tracer.Interpreter(st).run_tx(tracer.Tx(from_addr=0xA, to=0xB))
    b = builder.CircuitInputBuilder()
    b.handle_tx(dict(from_addr=0xA, to_addr=0xB, value=0, calldata=b""), tr)
    return b, [code]


def _use_jax_modules(monkeypatch):
    """Point service/bench_circuits.py's tracer, types, builder,
    transaction, keccak and RLP names at the JAX package's."""
    for name, mod in (("StateDB", jtr), ("Account", jtr), ("Interpreter", jtr),
                      ("Tx", jtr), ("Bytecode", jty), ("Transaction", jtx),
                      ("CircuitInputBuilder", jb), ("AccountState", jb),
                      ("RlpCircuit", jrlp), ("keccak256", jkeccak)):
        monkeypatch.setattr(tbench, name, getattr(mod, name))


def _workloads(k, monkeypatch):
    port = tbench.super_workload(CHIP_SMOKE_SEED, k)
    with monkeypatch.context() as mp:
        _use_jax_modules(mp)
        ref = tbench.super_workload(CHIP_SMOKE_SEED, k)
    return port, ref


def _jax_params(txs):
    return jsuper.SuperParams(
        evm=jevm.EvmParams(target_steps=0), exp=jexp.ExpParams(target_rows=0),
        tx=jtxc.TxParams(max_txs=len(txs),
                         max_calldata=sum(len(t.data) for t in txs)))


@pytest.mark.parametrize("case", ["simple", "golden", "workload_k9"])
def test_capacity_checker_matches_reference(case, monkeypatch):
    if case == "simple":
        (tb_, tcodes), (jb_, jcodes) = _simple_builder(demo.super_modules()), \
            _simple_builder(JAX)
    elif case == "golden":
        (tb_, tcodes, _), (jb_, jcodes, _) = demo.super_witness(), \
            demo.super_witness(JAX)
    else:
        (tb_, tcodes, _, _, _), (jb_, jcodes, _, _, _) = _workloads(9, monkeypatch)
    for k in (9, 13):
        got = tprover.CircuitCapacityChecker(SuperParams(), k).estimate(tb_, tcodes)
        want = jprover.CircuitCapacityChecker(jsuper.SuperParams(), k).estimate(
            jb_, jcodes)
        assert got == want
        assert got["evm"] >= len(tb_.steps) and got["state"] >= len(tb_.rws.rws)


def _same_witness(port, ref):
    (tb_, tcodes, ttxs, tparams, tst), (jb_, jcodes, jtxs, _, jst) = port, ref
    assert tst == jst
    assert [c.to_bytes() for c in tcodes] == [c.to_bytes() for c in jcodes]
    assert [t.rlp_signed() for t in ttxs] == [t.rlp_signed() for t in jtxs]
    assert [(r.rw_counter, int(r.tag), r.id, r.address, r.value)
            for r in tb_.rws.rws] == \
        [(r.rw_counter, int(r.tag), r.id, r.address, r.value) for r in jb_.rws.rws]
    assert [s.exec_state for s in tb_.steps] == [s.exec_state for s in jb_.steps]
    assert (tparams.tx.max_txs, tparams.tx.max_calldata) == \
        (len(ttxs), sum(len(t.data) for t in ttxs))


def test_super_workload_k9_matches_reference(monkeypatch):
    """super_workload(SEED, 9) through both packages' tracer, builder and
    transactions: the same witness and regions; every region fits, and
    both packages' MockProvers accept the SuperCircuit over it."""
    port, ref = _workloads(9, monkeypatch)
    _same_witness(port, ref)
    b, codes, txs, params, st = port
    rows = tbench.super_rows(b, codes, txs, 9)
    assert all(used <= room for used, room in rows.values())
    assert st["txs"] >= 1 and st["mulmod_events"] > 0
    got = TMock(9, SuperCircuit(b, codes, txs, params)).verify()
    jb_, jcodes, jtxs, _, _ = ref
    want = JMock(9, jsuper.SuperCircuit(jb_, jcodes, jtxs, _jax_params(jtxs))).verify()
    assert got == want == []


def test_super_workload_k13_matches_reference(monkeypatch):
    """chip_smoke.py's super_k13 witness: the same through both packages;
    it switches on Copy, Exp, MulMod and Keccak, fits every region, and
    fills the fullest to SUPER_FILL or more."""
    port, ref = _workloads(13, monkeypatch)
    _same_witness(port, ref)
    b, codes, txs, params, st = port
    assert max(st["fill"].values()) >= tbench.SUPER_FILL
    assert all(v <= 1 for v in st["fill"].values())
    c = SuperCircuit(b, codes, txs, params)
    assert {"CopyCircuit", "ExpCircuit", "MulModCircuit", "KeccakCircuit"} <= \
        {type(s).__name__ for s in c.subs}
    assert c.bind_bytecode


def test_evm_loop_program_without_partners_is_unchanged():
    """The partner snippets and the SHA3 are off by default: the program
    is the standalone EVM workload's (its rng draws untouched)."""
    a = tbench.evm_loop_program(np.random.default_rng(3), 5, 30)
    b = tbench.evm_loop_program(np.random.default_rng(3), 5, 30, partners=False,
                                sha3=False)
    assert a.to_bytes() == b.to_bytes()
    ops = set(a.to_bytes())
    c = tbench.evm_loop_program(np.random.default_rng(3), 5, 60, partners=True,
                                sha3=True).to_bytes()
    assert 0x20 in c and 0x20 not in ops  # SHA3
    assert {0x37, 0x0A} & set(c)  # CALLDATACOPY or EXP


# ---------------------------------------------------------------------------
# slow tier


@pytest.mark.slow
def test_variadic_sizes_one_vk():
    """tests/test_service_prover.py::test_variadic_sizes_one_vk: two
    witness sizes under one vk, real proofs on the CPU; each port proof
    equals the reference's, byte for byte, and verifies."""
    from zkevm_circuits_tpu.plonk.keygen import keygen as jkeygen
    from zkevm_circuits_tpu.plonk.prover import prove as jprove
    from zkevm_circuits_tpu.poly.kzg import Srs as JSrs
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    import test_service_prover as ref

    port = twin("test_service_prover")
    k = ref.K
    jsrs = JSrs.unsafe_setup(k, tau=424242)
    jpk, _ = jkeygen(ref.VariadicAdd(4), k, jsrs)
    srs = Srs.unsafe_setup(k, tau=424242, device="cpu")
    pk, vk = keygen(port.VariadicAdd(4), k, srs, device="cpu")
    proofs = []
    for n_rows in (4, 20):
        want = jprove(jpk, ref.VariadicAdd(n_rows), [], jsrs,
                      rng=np.random.default_rng(n_rows))
        got = prove(pk, port.VariadicAdd(n_rows), [], srs,
                    rng=np.random.default_rng(n_rows), device="cpu")
        assert got == bytes(want)
        assert verify(vk, [], got)
        proofs.append(got)
    assert proofs[0] != proofs[1]


@pytest.mark.slow
def test_cpu_proof_matches_golden():
    """The port's CPU proof of the k=9 SuperCircuit golden (605 advice
    columns; hours on the CPU) equals the reference's."""
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k = demo.SUPER_GOLDEN_K
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.super_golden(), k, srs, device="cpu")
    proof = prove(pk, demo.super_golden(), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED), device="cpu")
    assert hashlib.sha256(proof).hexdigest() == demo.SUPER_GOLDEN_SHA256
    assert len(proof) == demo.SUPER_GOLDEN_LEN
    assert verify(vk, [], proof)
