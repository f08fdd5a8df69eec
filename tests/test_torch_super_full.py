"""The chunk's whole statement (the SuperCircuit with public_data,
accounts_before and with_sig on) in the port against the JAX package, on
the same inputs: the constraint system, copy constraints, state roots and
PI instance of tests/test_super_mpt.py's witness with its signature
verified in-circuit; service/bench_circuits.py's super_full_workload run
through both packages' modules; _prove_verify with an instance at k=5;
and the default path of the existing callers (super_workload's witness,
_prove_verify without instances) unchanged.  Slow tier (the reference
slow-lists its k=13 MockProvers): both packages' MockProver verdicts at
k=13 on both witnesses, satisfied, with post_state_root + 1 and with a
wrong signer (tests/test_super_circuit.py:535's corruption)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.circuits import evm as jevm
from zkevm_circuits_tpu.circuits import exp as jexp
from zkevm_circuits_tpu.circuits import pi as jpi
from zkevm_circuits_tpu.circuits import super_circuit as jsuper
from zkevm_circuits_tpu.circuits import tx as jtxc
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.crypto.field import fr as jfr
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.witness import mpt as jwmpt
from zkevm_circuits_tpu_torch.circuits import pi as tpi
from zkevm_circuits_tpu_torch.circuits import super_circuit as tsuper
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench

from test_torch_service import CHIP_SMOKE_SEED, _use_jax_modules
from test_torch_super import (_FIXTURES, _HostFr, _copies, _fixture_value,
                              _same_system, _shape, _systems, twin)

torch.set_num_threads(2)
K = 13  # the least k that holds one signature's MulMod rows


# ---------------------------------------------------------------------------
# tests/test_super_mpt.py's witness, with_sig and PI on

def _mpt_witness(mod):
    """(b, codes, txs, accounts_before) of test_super_mpt's `witness`
    fixture, built by `mod` (the reference module or its port twin)."""
    return _fixture_value(mod, "witness", _FIXTURES)


def _public_data(pi, roots, post_bump: int = 0):
    """test_super_pi_binds_state_roots's PublicData over `roots`, the post
    root bumped by `post_bump`."""
    old_root, new_root = roots
    return pi.PublicData(
        chain_id=1337, prev_state_root=old_root.to_bytes(32, "big"),
        post_state_root=((new_root + post_bump) % R).to_bytes(32, "big"),
        withdraw_root=b"\x00" * 32, data_hash=jkeccak.keccak256(b"d"))


def _full_circuits(post_bump: int = 0, cls=None):
    """The full statement over the reference tests' witness in both
    packages: ((jax circuit, instance), (port circuit, instance))."""
    out = []
    for mod, sc, pi in ((importlib.import_module("test_super_mpt"), jsuper, jpi),
                        (twin("test_super_mpt"), tsuper, tpi)):
        b, codes, txs, before = _mpt_witness(mod)
        roots = sc.SuperCircuit(b, codes, txs, accounts_before=before).state_roots
        pd = _public_data(pi, roots, post_bump)
        make = cls[sc] if cls else sc.SuperCircuit
        out.append((make(b, codes, txs, accounts_before=before, public_data=pd,
                         with_sig=True), pd.instance()))
    return out


def test_full_statement_constraint_system_matches_reference():
    (jc, _), (tc, _) = _full_circuits()
    names = [type(s).__name__ for s in tc.subs]
    assert names == [type(s).__name__ for s in jc.subs]
    assert {"SigCircuit", "MulModCircuit", "KeccakCircuit", "PiCircuit",
            "MptCircuit"} <= set(names)
    jcs, tcs = _systems(jc, tc)
    _same_system(jcs, tcs)
    # advice, fixed, gate polynomials, logUps, their inputs, quotient degree
    assert _shape(tcs) == (2375, 87, 3902, 52, 2031, 25)
    assert len(tcs.perm_columns) == 23 and tcs.num_instance == 1
    assert _copies(tc, 1 << K) == _copies(jc, 1 << K) != []


def test_state_roots_and_instance_match_reference():
    (jc, jinst), (tc, tinst) = _full_circuits()
    assert tc.state_roots == jc.state_roots
    assert tc.state_roots[0] != tc.state_roots[1]  # the block changed state
    assert tinst == jinst and len(tinst) == 2
    assert tc.pd.pi_bytes() == jc.pd.pi_bytes()
    (_, jbad), (_, tbad) = _full_circuits(post_bump=1)
    assert tbad == jbad != tinst


# ---------------------------------------------------------------------------
# super_full_workload through both packages' modules

def _use_jax_modules_full(mp):
    """_use_jax_modules, and the names the full statement's workload adds:
    the accounts' pre-state, PI, and the SuperCircuit whose sub-circuits
    (Sig, MulMod, both MPT circuits) it counts and whose state roots it
    takes, with its parameters."""
    _use_jax_modules(mp)
    for name, mod in (("AccountFields", jwmpt), ("PublicData", jpi),
                      ("SuperCircuit", jsuper), ("SuperParams", jsuper),
                      ("EvmParams", jevm), ("ExpParams", jexp), ("TxParams", jtxc)):
        mp.setattr(tbench, name, getattr(mod, name))


_WORKLOADS: dict = {}


def _full_workloads():
    """super_full_workload(SEED, 13) built from the port's modules and from
    the JAX package's (computed once)."""
    if not _WORKLOADS:
        _WORKLOADS["port"] = tbench.super_full_workload(CHIP_SMOKE_SEED, K)
        with pytest.MonkeyPatch.context() as mp:
            _use_jax_modules_full(mp)
            _WORKLOADS["jax"] = tbench.super_full_workload(CHIP_SMOKE_SEED, K)
    return _WORKLOADS["port"], _WORKLOADS["jax"]


def test_super_full_workload_k13_matches_reference():
    """chip_smoke.py's super_full_k13 witness: the same transactions, RW
    rows, steps, accounts_before, roots, instance and fill through both
    packages; every region fits, the fullest is at SUPER_FILL or more, and
    Sig, both MPT circuits with their Poseidon tables and PI are on."""
    port, ref = _full_workloads()
    (tb_, tcodes, ttxs, tparams, tpd, tbefore, tst) = port
    (jb_, jcodes, jtxs, _, jpd, jbefore, jst) = ref
    assert tst == jst
    assert [c.to_bytes() for c in tcodes] == [c.to_bytes() for c in jcodes]
    assert [t.rlp_signed() for t in ttxs] == [t.rlp_signed() for t in jtxs]
    assert [(r.rw_counter, int(r.tag), r.id, r.address, r.value)
            for r in tb_.rws.rws] == \
        [(r.rw_counter, int(r.tag), r.id, r.address, r.value) for r in jb_.rws.rws]
    assert [s.exec_state for s in tb_.steps] == [s.exec_state for s in jb_.steps]
    assert {a: dataclasses.astuple(f) for a, f in tbefore.items()} == \
        {a: dataclasses.astuple(f) for a, f in jbefore.items()}
    assert tpd.pi_bytes() == jpd.pi_bytes() and tpd.instance() == jpd.instance()
    assert (tparams.tx.max_txs, tparams.tx.max_calldata) == \
        (len(ttxs), sum(len(t.data) for t in ttxs))

    assert max(tst["fill"].values()) >= tbench.SUPER_FILL
    assert all(v <= 1 for v in tst["fill"].values())
    assert tst["signatures"] == len(ttxs) >= 1
    assert tst["rows"]["sig"] == len(ttxs) * tbench.SIG_EV_ROWS
    assert tst["storage_updates"] >= 1 and tst["account_updates"] >= 2
    for region in ("mpt_storage", "mpt_account", "poseidon_storage",
                   "poseidon_account", "pi"):
        assert tst["rows"][region] > 0, region
    c = tsuper.SuperCircuit(tb_, tcodes, ttxs, tparams, public_data=tpd,
                            accounts_before=tbefore, with_sig=True)
    assert ["0x%x" % r for r in c.state_roots] == tst["state_roots"]
    assert c.sig is not None and c.pi is not None and c.mpt_stor is not None
    assert len(c.mulmod.events) + 1 == tst["rows"]["mulmod"]
    assert len(c.keccak.messages) and tst["rows"]["keccak"] == sum(
        len(m) // 136 + 1 for m in c.keccak.messages) * 200


def test_prove_verify_takes_an_instance():
    """_prove_verify at k=5 over the DemoCircuit with its instance, under
    the Poseidon transcript: the proof verifies with it and not with a
    changed instance."""
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.transcript import PoseidonReader

    r = tbench._prove_verify(demo.DemoCircuit, demo.K, torch.device("cpu"),
                             poseidon=True, instances=[[demo.A_IN]])
    assert r["ok"] and r["k"] == demo.K and r["k_ext"] > demo.K
    proof = r["proof"]
    assert not verify(r["vk"], [[demo.A_IN + 1]], proof,
                      transcript=PoseidonReader(proof))
    assert verify(r["vk"], [[demo.A_IN]], proof, transcript=PoseidonReader(proof))


def test_existing_callers_default_path_is_unchanged(monkeypatch):
    """_prove_verify without instances hands prove and verify none; and
    super_workload's witness (super_k12's and the k=13 chunk's) counts the
    regions it counted before the full statement was added."""
    seen = []

    class Pk:
        k_ext = 6
        vk = type("Vk", (), {"cs": None})()

    monkeypatch.setattr(tbench, "keygen", lambda c, k, srs, **kw: (Pk, Pk.vk))
    monkeypatch.setattr(tbench, "prove",
                        lambda pk, c, inst, srs, **kw: seen.append(inst) or b"p")
    monkeypatch.setattr(tbench, "verify",
                        lambda vk, inst, proof, **kw: seen.append(inst) or True)
    r = tbench._prove_verify(lambda: None, 4, torch.device("cpu"))
    assert seen == [[], []] and r["ok"] and r["proof"] == b"p"

    want = {
        12: {"state": 3827, "evm": 1191, "bytecode": 819, "tx": 88, "rlp": 816,
             "copy": 120, "exp": 361, "mulmod": 50, "keccak": 2800},
        13: {"state": 7025, "evm": 1861, "bytecode": 956, "tx": 158, "rlp": 1224,
             "copy": 560, "exp": 499, "mulmod": 71, "keccak": 4000},
    }
    for k, rows in want.items():
        b, codes, txs, _, st = tbench.super_workload(CHIP_SMOKE_SEED, k)
        assert st["rows"] == rows
        assert {n: u for n, (u, _) in tbench.super_rows(b, codes, txs, k).items()} \
            == rows


# ---------------------------------------------------------------------------
# slow tier: MockProver verdicts at k=13

def _wrong_sender(sc, F):
    """sc.SuperCircuit with tests/test_super_circuit.py:535's corruption:
    tx 1's CallerAddress row of the Tx table's value column bumped."""

    class Corrupt(sc.SuperCircuit):
        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            if phase == 1:
                arr = np.array(cols[self.tx.c_value])
                good = F.to_int(np.asarray(F.from_mont(arr[4])))
                arr[4] = F.from_int((good + 1) * F.R % F.modulus)
                cols[self.tx.c_value] = arr
            return cols

    return Corrupt


def _workload_circuits(post_bump: int = 0, cls=None):
    out = []
    for (b, codes, txs, params, pd, before, _), sc in zip(_full_workloads()[::-1],
                                                         (jsuper, tsuper)):
        if post_bump:
            post = int.from_bytes(pd.post_state_root, "big")
            pd = dataclasses.replace(
                pd, post_state_root=((post + post_bump) % R).to_bytes(32, "big"))
        make = cls[sc] if cls else sc.SuperCircuit
        out.append((make(b, codes, txs, params, public_data=pd,
                         accounts_before=before, with_sig=True), pd.instance()))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("case", ["satisfied", "post_root_plus_one", "wrong_signer"])
@pytest.mark.parametrize("witness", ["reference", "workload"])
def test_k13_mock_verdicts_match_reference(witness, case):
    """Both packages' MockProvers at k=13 on the same full statement: both
    satisfied; with post_state_root + 1 in the PI instance and with a
    wrong signer, equal failure lists, not empty."""
    build = {"reference": _full_circuits, "workload": _workload_circuits}[witness]
    kw = {}
    if case == "post_root_plus_one":
        kw["post_bump"] = 1
    elif case == "wrong_signer":
        kw["cls"] = {jsuper: _wrong_sender(jsuper, jfr()),
                     tsuper: _wrong_sender(tsuper, _HostFr())}
    (jc, jinst), (tc, tinst) = build(**kw)
    want = JMock(K, jc, [jinst]).verify()
    got = TMock(K, tc, [tinst]).verify()
    assert got == want
    assert (want == []) == (case == "satisfied")
