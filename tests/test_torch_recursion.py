"""The port's recursion layer (zkevm_circuits_tpu_torch/recursion/) against
the JAX package's, exact: the verification tape of a k=5 DemoCircuit proof
made under the Poseidon transcript (ops, values, exposed rows, sponge rows,
the deferred claim, finish_deferred's verdicts), the CompressionCircuit's
constraint system and columns, the EcMsm and Straus host traces with their
MulMod events, the fold tape and folded points, the chunk and batch
digests, the BatchHashCircuit's constraint system and columns, and the
serialized vk of the verifier artifact.

The inner proof is the port's (it equals the reference's, plonk/demo.py's
goldens); the reference's vk is the port's commitments over the reference's
own constraint system."""

import dataclasses

import numpy as np
import pytest
import torch
from test_plonk_prove import DemoCircuit as JDemo
from test_torch_super import _copies, _same_columns, _systems

from zkevm_circuits_tpu.crypto import keccak as jkeccak
from zkevm_circuits_tpu.crypto.curve import host_g1_mul as j_g1_mul
from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
from zkevm_circuits_tpu.plonk.circuit import assemble_fixed as j_fixed
from zkevm_circuits_tpu.plonk.keygen import VerifyingKey as JVK
from zkevm_circuits_tpu.plonk.keygen import quotient_degree as jqd
from zkevm_circuits_tpu.recursion import aggregation as jagg
from zkevm_circuits_tpu.recursion import batch_hash as jbh
from zkevm_circuits_tpu.recursion import compression as jcomp
from zkevm_circuits_tpu.recursion import ecmsm as jec
from zkevm_circuits_tpu.recursion import evm_verifier as jev
from zkevm_circuits_tpu.recursion import fold as jfold
from zkevm_circuits_tpu.recursion import layer as jlayer
from zkevm_circuits_tpu_torch.crypto import field as tfield
from zkevm_circuits_tpu_torch.crypto import pairing as tpairing
from zkevm_circuits_tpu_torch.crypto.curve import host_g1_mul
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.crypto.params import G1_GEN
from zkevm_circuits_tpu_torch.plonk import demo
from zkevm_circuits_tpu_torch.plonk.circuit import assemble_fixed as t_fixed
from zkevm_circuits_tpu_torch.plonk.keygen import keygen
from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree as tqd
from zkevm_circuits_tpu_torch.plonk.prover import prove
from zkevm_circuits_tpu_torch.plonk.verifier import verify
from zkevm_circuits_tpu_torch.poly.kzg import Srs
from zkevm_circuits_tpu_torch.poly.transcript import PoseidonReader, PoseidonTranscript
from zkevm_circuits_tpu_torch.recursion import aggregation as tagg
from zkevm_circuits_tpu_torch.recursion import batch_hash as tbh
from zkevm_circuits_tpu_torch.recursion import compression as tcomp
from zkevm_circuits_tpu_torch.recursion import ecmsm as tec
from zkevm_circuits_tpu_torch.recursion import evm_verifier as tev
from zkevm_circuits_tpu_torch.recursion import fold as tfold
from zkevm_circuits_tpu_torch.recursion import layer as tlayer

torch.set_num_threads(2)
F = tfield.fr()
JAX = dict(aggregation=jagg, batch_hash=jbh, compression=jcomp, keccak=jkeccak)


@pytest.fixture(scope="module")
def inner():
    """(port vk, reference vk, proof): DemoCircuit at k=5 under the
    Poseidon transcript, the inner proof of the compression golden."""
    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device="cpu")
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device="cpu")
    proof = prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                  transcript=PoseidonTranscript(),
                  rng=np.random.default_rng(demo.COMPRESSION_INNER_SEED), device="cpu")
    assert verify(vk, [[demo.A_IN]], proof, transcript=PoseidonReader(proof))
    jcs = JCS()
    JDemo().configure(jcs)
    jvk = JVK(k=vk.k, cs=jcs, fixed_commitments=list(vk.fixed_commitments),
              sigma_commitments=list(vk.sigma_commitments), g2=vk.g2, s_g2=vk.s_g2)
    return vk, jvk, proof


def _same_system(jcs, tcs):
    """The two constraint systems are the same, expression for expression."""
    for attr in ("num_advice", "advice_phases", "num_fixed", "num_instance",
                 "challenge_phases", "perm_columns"):
        assert getattr(tcs, attr) == getattr(jcs, attr), attr
    assert [(g.name, [repr(p) for p in g.polys]) for g in tcs.gates] == \
        [(g.name, [repr(p) for p in g.polys]) for g in jcs.gates]
    assert [(lk.name, [repr(e) for e in lk.inputs + lk.tables]) for lk in tcs.lookups] == \
        [(lk.name, [repr(e) for e in lk.inputs + lk.tables]) for lk in jcs.lookups]
    assert [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
             [repr(e) for e in lg.table]) for lg in tcs.logups] == \
        [(lg.name, [repr(e) for tup in lg.inputs for e in tup],
          [repr(e) for e in lg.table]) for lg in jcs.logups]
    assert sorted(tcs.all_queries()) == sorted(jcs.all_queries())
    assert tqd(tcs) == jqd(jcs)


def _flip(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


def _tape(t):
    return t.ops, t.values, t.exposed


def _rows(perm_rows):
    return [tuple(s.idx for s in row) for row in perm_rows]


# ---------------------------------------------------------------------------
# the verification tape and the deferred claim

@pytest.mark.parametrize("corrupt", [False, True], ids=["honest", "byte7"])
def test_verify_tape_matches_reference(inner, corrupt):
    """build_verify_tape over the proof (and over it with byte 7 flipped,
    tests/test_compression.py::test_compression_rejects_bad_inner_proof):
    the same tape, sponge rows, claim and points; finish_deferred accepts
    the honest proof and rejects the flipped one in both packages, and the
    claim's pairing sides are the reference's points."""
    vk, jvk, proof = inner
    p = _flip(proof, 7) if corrupt else proof
    t, rows, claim, pts = tcomp.build_verify_tape(vk, p, [[demo.A_IN]])
    jt, jrows, jclaim, jpts = jcomp.build_verify_tape(jvk, p, [[demo.A_IN]])
    assert _tape(t) == _tape(jt)
    assert _rows(rows) == _rows(jrows)
    assert dataclasses.asdict(claim) == dataclasses.asdict(jclaim)
    assert pts == jpts
    inst = [t.values[i] for i in t.exposed]
    want = jcomp.finish_deferred(jvk, jclaim, inst)
    assert tcomp.finish_deferred(vk, claim, inst) == want == (not corrupt)
    if not corrupt:
        # the port's one host MSM is the reference's sum of products
        assert tcomp.deferred_sides(vk, claim, inst) == \
            jagg._claim_sides(jvk, jclaim, inst)


def test_compression_circuit_matches_reference(inner):
    """CompressionCircuit at its min_k: constraint system, copies, fixed
    and advice columns, instances and the Poseidon events it hands a
    composed PoseidonCircuit."""
    vk, jvk, proof = inner
    tc = tcomp.CompressionCircuit(vk, proof, [[demo.A_IN]])
    jc = jcomp.CompressionCircuit(jvk, proof, [[demo.A_IN]])
    k = tc.min_k()
    assert k == jc.min_k() == demo.RECURSION_GOLDENS["compression"][0]
    jcs, tcs = _systems(jc, tc)
    _same_system(jcs, tcs)
    n = 1 << k
    assert _copies(tc, n) == _copies(jc, n)
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    _same_columns(jc.synthesize(0, n, {}, []), tc.synthesize(0, n, {}, []))
    assert tc.instances() == jc.instances()
    assert [dataclasses.astuple(e) for e in tc.poseidon_events()] == \
        [dataclasses.astuple(e) for e in jc.poseidon_events()]


def test_layer1_statement_matches_reference(inner):
    """CompressionLayerCircuit (the EC side in-circuit): instances, the
    accumulator pair and verify_layer1's verdicts, honest and with the
    exposed LHS point bent."""
    vk, jvk, proof = inner
    tl = tlayer.CompressionLayerCircuit(vk, proof, [[demo.A_IN]])
    jl = jlayer.CompressionLayerCircuit(jvk, proof, [[demo.A_IN]])
    inst = tl.instances()
    assert inst == jl.instances() and tl.min_k() == jl.min_k()
    assert tlayer.layer1_accumulator(tl.claim, inst[0]) == \
        jlayer.layer1_accumulator(jl.claim, inst[0])
    bent = list(inst[0])
    bent[-1] = (bent[-1] + 1) % (1 << 128)
    for vals, ok in ((inst[0], True), (bent, False)):
        assert tlayer.verify_layer1(vk, tl.claim, vals) == ok
        assert jlayer.verify_layer1(jvk, jl.claim, vals) == ok


def test_serialized_vk_matches_reference(inner):
    """The verifier artifact's embedded vk."""
    vk, jvk, _ = inner
    assert tev.serialize_vk(vk) == jev.serialize_vk(jvk)


# ---------------------------------------------------------------------------
# the EC host traces

def _events(evs):
    return [dataclasses.astuple(e) for e in evs]


@pytest.mark.parametrize("scalars", [[3, R - 5], [0x1234, 0xBEEF]])
def test_ecmsm_trace_matches_reference(scalars):
    """tests/test_ecmsm.py's programs: walk rows, fold rows, the result
    and every MulMod event."""
    pts = [host_g1_mul(G1_GEN, 1000 + 77 * i) for i in range(len(scalars))]
    assert pts == [j_g1_mul(G1_GEN, 1000 + 77 * i) for i in range(len(scalars))]
    t = tec.EcMsmProgram(scalars=list(scalars), points=pts)
    j = jec.EcMsmProgram(scalars=list(scalars), points=pts)
    terms, folds, out, events = t.trace()
    jterms, jfolds, jout, jevents = j.trace()
    assert (terms, folds, out) == (jterms, jfolds, jout)
    assert _events(events) == _events(jevents)
    assert t.rows == j.rows
    assert (tec.D_PT, tec.D2_PT, tec.E_PT) == (jec.D_PT, jec.D2_PT, jec.E_PT)


def test_straus_trace_matches_reference():
    """tests/test_straus.py's program, a zero scalar included."""
    scalars = [5, R - 3, 0, 0xDEADBEEF << 200]
    pts = [host_g1_mul(G1_GEN, k) for k in (2, 9, 31, 77)]
    t = tec.EcStrausProgram(scalars=list(scalars), points=pts)
    j = jec.EcStrausProgram(scalars=list(scalars), points=pts)
    assert t.result() == j.result()
    assert (t.n_terms, t.rows) == (j.n_terms, j.rows)
    got, want = t.trace(), j.trace()
    assert got[:-1] == want[:-1]
    assert _events(t.mulmod_events()) == _events(j.mulmod_events())


# ---------------------------------------------------------------------------
# the in-circuit fold

TAU = 0xFADE0FF


def _pairs(m, bad=None):
    """tests/test_fold.py::_valid_pairs: (lhs, w2) with lhs = TAU * w2,
    pair `bad` bent to another lhs."""
    out = []
    for i in range(m):
        b = 0x1234 + 7 * i
        lhs = host_g1_mul(G1_GEN, 999 if i == bad else b * TAU % R)
        out.append((lhs, host_g1_mul(G1_GEN, b)))
    return out


class _G2:
    s_g2 = tpairing.g2_scalar_mul(tpairing.G2_GENERATOR, TAU)
    g2 = tpairing.G2_GENERATOR


@pytest.mark.parametrize("m,bad", [(2, None), (3, None), (3, 1)])
def test_fold_matches_reference(m, bad):
    """build_fold_tape, the fold circuit's instances (folded L and W),
    min_k and verify_fold's verdict."""
    pairs = _pairs(m, bad)
    t, rows, powers = tfold.build_fold_tape(pairs)
    jt, jrows, jpowers = jfold.build_fold_tape(pairs)
    assert (_tape(t), _rows(rows), powers) == (_tape(jt), _rows(jrows), jpowers)
    tc, jc = tfold.AggregationFoldCircuit(pairs), jfold.AggregationFoldCircuit(pairs)
    assert tc.folded == jc.folded
    assert tc.instances() == jc.instances() and tc.min_k() == jc.min_k()
    assert _events(tc._mm_events) == _events(jc._mm_events)
    ok = tfold.verify_fold(_G2, tc.instances()[0], m)
    assert ok == jfold.verify_fold(_G2, jc.instances()[0], m) == (bad is None)


# ---------------------------------------------------------------------------
# chunk and batch hashes, the BatchHashCircuit

@pytest.mark.parametrize("m", [1, 3, tagg.MAX_AGG_SNARKS])
def test_batch_hashes_match_reference(m):
    tb = demo.mk_batch(demo.recursion_modules(), m)
    jb = demo.mk_batch(JAX, m)
    assert [c.pi_hash() for c in tb.chunks] == [c.pi_hash() for c in jb.chunks]
    assert tb.pi_hash() == jb.pi_hash()
    assert tagg.MAX_AGG_SNARKS == jagg.MAX_AGG_SNARKS == 15
    c = tb.chunks[0]
    for agg in (tagg, jagg):
        with pytest.raises(AssertionError):
            agg.BatchHash([agg.ChunkHash(**dataclasses.asdict(c))] * 2)


@pytest.mark.parametrize("m", [1, 3])
def test_batch_hash_circuit_matches_reference(m):
    """tests/test_batch_hash.py's circuit at K=10: constraint system,
    copies, fixed columns, both phases' advice columns, the instance."""
    tc = tbh.BatchHashCircuit(demo.mk_batch(demo.recursion_modules(), m))
    jc = jbh.BatchHashCircuit(demo.mk_batch(JAX, m))
    k = demo.RECURSION_GOLDENS["batch_hash"][0]
    jcs, tcs = _systems(jc, tc)
    _same_system(jcs, tcs)
    n = 1 << k
    assert tc.instance() == jc.instance()
    assert _copies(tc, n) == _copies(jc, n)
    assert np.array_equal(j_fixed(jc, jcs, n), t_fixed(tc, tcs, n))
    inst = [tc.instance()]
    _same_columns(jc.synthesize(0, n, {}, inst), tc.synthesize(0, n, {}, inst))
    v = int.from_bytes(np.random.default_rng(m).bytes(32), "little") % R
    ci = tc.r.index
    _same_columns(jc.synthesize(1, n, {ci: np.asarray(F.scalar(v, "cpu"))}, inst),
                  tc.synthesize(1, n, {ci: F.scalar(v, "cpu")}, inst))
