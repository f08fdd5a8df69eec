"""The zktrie, the MPT witness and the MPT circuit in the port
(zkevm_circuits_tpu_torch trie/zktrie.py, witness/mpt.py,
circuits/mpt.py) against the JAX package's, exact, on the same inputs:
trie roots and proofs (the port's cached trie against the JAX package's
Python backend, and against a recomputation without caches after each
write), MptUpdate fields (value updates, inserts into empty slots, leaf
splits, absences under a foreign leaf), the MPT circuit's constraint
system, columns and MockProver verdicts on the six cases of
tests/test_mpt_circuit.py, and the seeded two-level workload of
service/bench_circuits.py (chip_smoke.py's poseidon_mpt_full path).  The
slow tier composes storage-mode and two-level MPT with the State circuit
(tests/test_state_mpt_coupling.py, tests/test_account_trie.py) and
proves the MPT golden on the CPU."""

import dataclasses
import hashlib
import time

import numpy as np
import pytest
import torch

from test_torch_partners import (assert_same_columns, assert_same_cs,
                                 configured, corrupt)
from test_torch_poseidon import JAX, PORT
from zkevm_circuits_tpu import tracer as jtr
from zkevm_circuits_tpu import types as jty
from zkevm_circuits_tpu.circuits import mpt as jmpt
from zkevm_circuits_tpu.circuits import state as jstate
from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.plonk import circuit as jcircuit
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu.trie import zktrie as jz
from zkevm_circuits_tpu.witness import builder as jb
from zkevm_circuits_tpu.witness import mpt as jw
from zkevm_circuits_tpu.witness import rw as jrw
from zkevm_circuits_tpu_torch import tracer as ttr
from zkevm_circuits_tpu_torch import types as tty
from zkevm_circuits_tpu_torch.circuits import mpt as tmpt
from zkevm_circuits_tpu_torch.circuits import state as tstate
from zkevm_circuits_tpu_torch.crypto import keccak as tkeccak
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as P
from zkevm_circuits_tpu_torch.plonk import circuit as tcircuit
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock
from zkevm_circuits_tpu_torch.service import bench_circuits as tbench
from zkevm_circuits_tpu_torch.trie import zktrie as tz
from zkevm_circuits_tpu_torch.witness import builder as tb
from zkevm_circuits_tpu_torch.witness import mpt as tw

torch.set_num_threads(2)
K = 7
CHIP_SMOKE_SEED = 20261016  # chip_smoke.SEED

# tests/test_zktrie.py
KEYS = [5, 6, 7, 2**200 + 1, 2**200 + 2, P - 1, 0]
VALS = [100 + i for i in range(len(KEYS))]


def _uncached(node) -> int:
    """A node's hash recomputed from its subtree, no cache read."""
    if node.kind == 0:
        return 0
    if node.kind == 1:
        return tz.hash2_domain.__wrapped__(tz.DOM_LEAF, node.key, node.value)
    l = _uncached(node.left) if node.left else 0  # noqa: E741
    r = _uncached(node.right) if node.right else 0
    return tz.hash2_domain.__wrapped__(tz.DOM_BRANCH, l, r)


def _same_proof(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_trie_keys_match_reference():
    t, j = tz.ZkTrie(), jz.ZkTrie(use_native=False)
    assert t.root() == j.root() == 0
    for k, v in zip(KEYS, VALS):
        t.update(k, v)
        j.update(k, v)
        assert t.root() == j.root() == _uncached(t._root)
    root = t.root()
    for k in KEYS + [123456789, 2**200 + 3]:
        _same_proof(t.prove(k), j.prove(k))
        assert tz.verify_proof(root, t.prove(k))
    t.update(5, 999)
    j.update(5, 999)
    assert t.root() == j.root() != root
    _same_proof(t.prove(5), j.prove(5))
    assert tz.hash2_domain(3, 4, 5) == jz.hash2_domain(3, 4, 5)
    assert (tz.DOM_LEAF, tz.DOM_BRANCH, tz.MAX_DEPTH) == \
        (jz.DOM_LEAF, jz.DOM_BRANCH, jz.MAX_DEPTH)


def test_seeded_writes_match_reference():
    """40 seeded writes (new keys, overwrites, keys sharing low bits):
    after each, the root equals the JAX package's Python backend and the
    uncached recomputation, and the proofs of every key written agree."""
    rng = np.random.default_rng(11)
    t, j = tz.ZkTrie(), jz.ZkTrie(use_native=False)
    keys = []
    for i in range(40):
        if keys and i % 5 == 4:
            key = keys[int(rng.integers(len(keys)))]  # overwrite
        elif i % 7 == 3:
            key = (keys[-1] if keys else 0) ^ (1 << int(rng.integers(3, 12)))
        else:
            key = int.from_bytes(rng.bytes(32), "little") % P
        value = int.from_bytes(rng.bytes(32), "little")
        keys.append(key)
        t.update(key, value)
        j.update(key, value)
        assert t.root() == j.root() == _uncached(t._root)
        _same_proof(t.prove(key), j.prove(key))
    for key in keys[:10]:
        _same_proof(t.prove(key), j.prove(key))


def test_native_backend_refused():
    with pytest.raises(ValueError, match="no native library"):
        tz.ZkTrie(use_native=True)
    tz.ZkTrie(use_native=False)


# ---------------------------------------------------------------------------
# MptUpdates


def _apply(pkg, prestate, writes):
    ups = pkg.MptUpdates()
    for k, v in prestate:
        ups.trie.update(k, v)
    for k, v in writes:
        ups.write(k, v)
    return ups


# (trie pre-state, writes): tests/test_mpt_circuit.py's witnesses, and an
# absence under a foreign leaf (writing 0 to an absent key whose walk ends
# at another key's leaf) beside one in an empty slot
WITNESSES = {
    "updates": (demo.MPT_GOLDEN_PRESTATE, demo.MPT_GOLDEN_WRITES),
    "root_split": ((), ((0b00, 1), (0b10, 2))),
    "deep_split": ((), ((0b0100, 9), (0b0000, 3), (0b0000, 4))),
    "absences": (((0b01, 5), (0b000, 6), (0b100, 8)),
                 ((0b11, 0), (0b010, 0), (0b01, 7))),
}


@pytest.mark.parametrize("case", sorted(WITNESSES))
def test_mpt_updates_match_reference(case):
    pre, writes = WITNESSES[case]
    t, j = _apply(tw, pre, writes), _apply(jw, pre, writes)
    assert [dataclasses.asdict(u) for u in t.updates] == \
        [dataclasses.asdict(u) for u in j.updates]
    assert [vars(e) for e in t.poseidon_events()] == \
        [vars(e) for e in j.poseidon_events()]
    if case == "absences":
        assert [(u.new_empty, u.occupied) for u in t.updates] == \
            [(True, True), (True, False), (False, False)]
    if "split" in case:
        assert t.updates[1].is_split


def _bump(v):
    return v + 1


# tests/test_mpt_circuit.py: (witness, params, [(column, rows, new value)])
CIRCUIT_CASES = {
    "satisfied": ("updates", None, []),
    "padded": ("updates", 20, []),
    "leaf_split": ("root_split", None, []),
    "deep_split": ("deep_split", None, []),
    "absences": ("absences", None, []),
    "wrong_displaced_leaf": ("deep_split", None, [(lambda c: c.c_v1, "v1=9", lambda v: 8)]),
    "wrong_root": ("updates", None, [(lambda c: c.c_new_root, [0, 1, 2], _bump)]),
    "tampered_sibling": ("updates", None, [(lambda c: c.c_sib, [1], lambda v: 0xBAD)]),
}


def _circuit(pkg, cmod, case):
    wit, target, _ = CIRCUIT_CASES[case]
    ups = _apply(pkg, *WITNESSES[wit])
    if case == "wrong_displaced_leaf":
        ups = _apply(pkg, (), WITNESSES[wit][1][:2])
    params = cmod.MptParams(target_rows=target) if target else None
    return ups.updates, params


def _edits(case, updates):
    out = []
    for col, rows, new in CIRCUIT_CASES[case][2]:
        if rows == "v1=9":  # every row whose displaced-leaf value is 9
            rows = [sum(u.depth + 1 for u in updates[:1]) + 1]
        out += [(0, col, (lambda c, r=r: r), new) for r in rows]
    return out


@pytest.mark.parametrize("case", sorted(CIRCUIT_CASES))
def test_mpt_circuit_matches_reference(case):
    """Constraint system, fixed and advice columns, and verdicts at k=7."""
    tu, tparams = _circuit(tw, tmpt, case)
    ju, jparams = _circuit(jw, jmpt, case)
    edits = _edits(case, tu)
    tc = corrupt(tmpt.MptCircuit, edits)(tu, tparams)
    jc = corrupt(jmpt.MptCircuit, edits)(ju, jparams)
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    got, want = TMock(K, tc).verify(), JMock(K, jc).verify()
    assert got == want
    assert bool(got) == bool(edits), got
    if case == "wrong_root":
        # gate-only (chip_smoke.py's rejected MPT proof): no lookup fails,
        # so the prover makes a proof
        assert any("mpt new root" in f for f in got), got
        assert all(f.startswith("gate ") for f in got), got


def test_golden_witness_matches_reference():
    jc, _ = demo.chain_golden("mpt", JAX)
    tc, _ = demo.chain_golden("mpt")
    jcs, tcs = configured(jc, JAX), configured(tc, PORT)
    assert_same_cs(tcs, jcs)
    assert tcs.num_advice == 22
    assert_same_columns(jc, jcs, tc, tcs, 1 << K, seed=K)
    assert TMock(K, tc).verify() == JMock(K, jc).verify() == []
    assert [vars(e) for e in tc.poseidon_events()] == \
        [vars(e) for e in jc.poseidon_events()]


# ---------------------------------------------------------------------------
# schemas and the two-level workload


def test_schema_helpers_match_reference():
    rng = np.random.default_rng(12)
    for _ in range(4):
        addr = int.from_bytes(rng.bytes(20), "big")
        slot, word = (int.from_bytes(rng.bytes(32), "big") for _ in range(2))
        assert tw.storage_trie_key(addr, slot) == jw.storage_trie_key(addr, slot)
        assert tw.storage_leaf_value(word) == jw.storage_leaf_value(word)
        assert tw.account_trie_key(addr) == jw.account_trie_key(addr)
        assert tw.subtrie_key(slot) == jw.subtrie_key(slot)
        fields = (int(rng.integers(1 << 20)), 77, word >> 100, slot, word % P)
        assert tw.account_leaf_value(*fields) == jw.account_leaf_value(*fields)
        assert tw.AccountFields(*fields).leaf() == jw.AccountFields(*fields).leaf()
    assert tw.storage_leaf_value(0) == tw.account_leaf_value(0, 0, 0, 0, 0) == 0


def _jax_rws(rws):
    return [jrw.Rw(**{**vars(r), "tag": jrw.RwTag(int(r.tag))}) for r in rws]


def _jax_bench(monkeypatch):
    """bench_circuits' MPT workload built by the JAX package's witness
    and circuits from the same RW rows."""
    rws_of = tbench._mpt_rws

    def jax_rws(seed, n_slots):
        rws, before = rws_of(seed, n_slots)
        return _jax_rws(rws), {a: jw.AccountFields(**vars(f))
                               for a, f in before.items()}

    monkeypatch.setattr(tbench, "_mpt_rws", jax_rws)
    monkeypatch.setattr(tbench, "two_level_updates_from_rws",
                        jw.two_level_updates_from_rws)
    monkeypatch.setattr(tbench, "MptCircuit", jmpt.MptCircuit)
    return tbench


def test_workload_matches_reference(monkeypatch):
    """mpt_workload at k=9 through the port and through the reference
    (the same RW rows): the same stats, constraint systems, columns and
    (empty) MockProver verdicts of both circuits."""
    k = 9
    ts, ta, tstats = tbench.mpt_workload(CHIP_SMOKE_SEED, k)
    js, ja, jstats = _jax_bench(monkeypatch).mpt_workload(CHIP_SMOKE_SEED, k)
    tstats.pop("workload_s")
    jstats.pop("workload_s")
    assert tstats == jstats
    assert tstats["splits"] and tstats["absences"]
    for tc, jc in ((ts, js), (ta, ja)):
        jcs, tcs = configured(jc, JAX), configured(tc, PORT)
        assert_same_cs(tcs, jcs)
        assert_same_columns(jc, jcs, tc, tcs, 1 << k, seed=k)
    assert TMock(k, ts).verify() == JMock(k, js).verify() == []


def test_k14_workload_fills_the_rows():
    """poseidon_mpt_full's workload at k=14: the storage circuit fills at
    least MPT_FILL of the usable rows, one account circuit update per
    account, and every update kind appears."""
    t0 = time.perf_counter()
    stor, acct, st = tbench.mpt_workload(CHIP_SMOKE_SEED, 14)
    print(f"mpt_workload(k=14) host seconds {time.perf_counter() - t0:.2f}: {st}")
    assert st["fill"] >= tbench.MPT_FILL
    assert st["poseidon_rows"] <= st["usable_rows"]
    assert st["accounts"] == tbench.MPT_ACCOUNTS + 1
    kinds = {(u.was_empty, u.is_split, u.new_empty, u.occupied)
             for u in stor.updates}
    assert {(False, False, False, False), (True, False, False, False),
            (True, True, False, False), (True, False, True, False)} <= kinds
    assert len(stor.poseidon_events()) == st["poseidon_rows"]


# ---------------------------------------------------------------------------
# slow tier: MPT composed with the State circuit, and the golden's proof


def _pkg(side):
    if side == "jax":
        return dict(tracer=jtr, types=jty, builder=jb, keccak=jkeccak,
                    state=jstate, mpt=jmpt, w=jw, circuit=jcircuit,
                    mock=JMock)
    return dict(tracer=ttr, types=tty, builder=tb, keccak=tkeccak,
                state=tstate, mpt=tmpt, w=tw, circuit=tcircuit, mock=TMock)


def _composed(m, params, stor, acct=None, groups=None, accounts=None):
    """State + storage-mode MPT (+ account-mode MPT with the subtrie roots
    copied into the account leaves): tests/test_state_mpt_coupling.py's
    StateMpt and tests/test_account_trie.py's TwoLevel."""

    class Composed(m["circuit"].Circuit):
        def __init__(self, rws):
            self.state = m["state"].StateCircuit(rws, params)
            self.subs = [self.state, stor] + ([acct] if acct else [])

        def configure(self, cs):
            r = cs.challenge(phase=0)
            stor.configure(cs, challenge=r)
            if acct:
                acct.configure(cs, challenge=r)
            self.state.configure(
                cs, challenge=r, mpt_storage_table=stor.storage_table,
                mpt_account_table=acct.account_table if acct else None)

        def fixed_columns(self, n):
            out = {}
            for s in self.subs:
                out.update(s.fixed_columns(n))
            return out

        def copy_constraints(self, n):
            if not acct:
                return []
            out = list(acct.copy_constraints(n))
            span, j = {}, 0
            for addr, cnt, _, _ in groups:
                span[addr] = (j, j + cnt - 1)
                j += cnt
            for i, au in enumerate(accounts):
                cells = acct.account_cells(i)
                if au.addr in span:
                    j0, j1 = span[au.addr]
                    out.append((cells["sroot_old"], stor.update_root_cells(j0)[0]))
                    out.append((cells["sroot_new"], stor.update_root_cells(j1)[1]))
                    for jj in range(j0, j1 + 1):
                        out.append((stor.storage_addr_cell(jj), cells["addr"]))
                else:
                    out.append((cells["sroot_old"], cells["sroot_new"]))
            return out

        def synthesize(self, phase, n, challenges, instances):
            out = {}
            for s in self.subs:
                out.update(s.synthesize(phase, n, challenges, instances))
            return out

    return Composed


def _coupling_verdicts(side, case):
    """tests/test_state_mpt_coupling.py at K=9."""
    m = _pkg(side)
    sender, contract = 0xCAFE, 0xC0DE
    code = (m["types"].Bytecode()
            .push(2, 0xBEEF).push(1, 7).op("SSTORE")
            .push(1, 7).op("SLOAD").op("POP")
            .push(2, 0xD00D).push(1, 7).op("SSTORE")
            .push(1, 9).op("SLOAD").op("POP")
            .op("STOP"))
    tr_ = m["tracer"]
    st = tr_.StateDB({sender: tr_.Account(balance=10**15),
                      contract: tr_.Account(code=code.to_bytes())})
    trace = tr_.Interpreter(st).run_tx(tr_.Tx(from_addr=sender, to=contract))
    b = m["builder"].CircuitInputBuilder(accounts={
        sender: m["builder"].AccountState(balance=10**15),
        contract: m["builder"].AccountState()})
    b.handle_tx(dict(from_addr=sender, to_addr=contract, value=0,
                     calldata=b""), trace)
    storage, ups = m["w"].storage_updates_from_rws(b.rws.rws)
    if case == "missing_update":
        storage = storage[1:]
    if case == "wrong_final_value":
        storage = [dataclasses.replace(storage[0], new_word=0x1234), storage[1]]
    params = m["state"].StateParams(limb_bits=8, id_bits=16, addr_bits=160,
                                    key_bits=32, rwc_bits=16, target_rows=120)
    circ = _composed(m, params, m["mpt"].MptCircuit(storage=storage))(b.rws)
    return m["mock"](9, circ).verify()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["satisfied", "missing_update", "wrong_final_value"])
def test_state_mpt_coupling_matches_reference(case):
    got, want = _coupling_verdicts("port", case), _coupling_verdicts("jax", case)
    assert got == want
    assert bool(got) == (case != "satisfied"), got


def _two_level_verdicts(side, case):
    """tests/test_account_trie.py at K=10."""
    m = _pkg(side)
    sender, contract = 0xCAFE, 0xC0DE
    code = (m["types"].Bytecode()
            .push(1, 0x2A).push(1, 5).op("SSTORE")
            .push(2, 0x1234).push(1, 7).op("SSTORE")
            .op("STOP"))
    tr_ = m["tracer"]
    st = tr_.StateDB({sender: tr_.Account(balance=10**18),
                      contract: tr_.Account(code=code.to_bytes())})
    trace = tr_.Interpreter(st).run_tx(tr_.Tx(from_addr=sender, to=contract))
    ch = int.from_bytes(m["keccak"].keccak256(code.to_bytes()), "big")
    b = m["builder"].CircuitInputBuilder(
        accounts={sender: (0, 10**18, 0), contract: (0, 0, ch)})
    b.handle_tx(dict(from_addr=sender, to_addr=contract, value=0,
                     calldata=b"", code_hash=ch),
                trace, code_db={contract: code.to_bytes()})
    before = {sender: m["w"].AccountFields(balance=10**18),
              contract: m["w"].AccountFields(code_hash=ch, code_size=len(code))}
    storage, groups, accounts, _ = m["w"].two_level_updates_from_rws(
        b.rws.rws, before)
    if case == "detached_storage_root":
        accounts = [dataclasses.replace(au, new=dataclasses.replace(
            au.new, storage_root=au.old.storage_root))
            if au.addr == contract else au for au in accounts]
    params = m["state"].StateParams(limb_bits=8, id_bits=16, addr_bits=160,
                                    key_bits=32, rwc_bits=16, target_rows=160)
    stor = m["mpt"].MptCircuit(storage=storage, two_level=True,
                               chain_groups=[g[1] for g in groups])
    acct = m["mpt"].MptCircuit(accounts=accounts)
    cls = _composed(m, params, stor, acct, groups, accounts)
    if case == "tampered_nonce":
        i = next(ix for ix, au in enumerate(accounts) if au.addr == sender)
        pos = acct._leaf_row_positions()[i]
        base = acct._expo_base()
        cls = corrupt(cls, [(0, lambda c: acct.a_non[1], lambda c: pos, lambda v: 99),
                            (1, lambda c: acct.x_new, lambda c: base + 4 * i,
                             lambda v: 99)])
    return m["mock"](10, cls(b.rws)).verify()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["satisfied", "tampered_nonce",
                                  "detached_storage_root"])
def test_two_level_matches_reference(case):
    got, want = _two_level_verdicts("port", case), _two_level_verdicts("jax", case)
    assert got == want
    assert bool(got) == (case != "satisfied"), got


@pytest.mark.slow
def test_cpu_proof_matches_golden():
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.CHAIN_GOLDENS["mpt"]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.chain_golden("mpt")[0], k, srs, device="cpu")
    proof = prove(pk, demo.chain_golden("mpt")[0], [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                  device="cpu")
    assert (hashlib.sha256(proof).hexdigest(), len(proof)) == (sha, length)
    assert verify(vk, [], proof)
