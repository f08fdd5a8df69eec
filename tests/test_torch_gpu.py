"""Card-only tests of the port: each CUDA kernel against its plain
version on the card, byte for byte (field_add_sub as F.add, F.sub and
F.neg of either field, one launch each; K5's three modes, its warp vote and
its bucket-step form, K6 once and eight times), the sharded ops on an
NCCL group of one rank against the unsharded ones, the MSM's K6 launch
count, and the k=5 demo, k=9 Keccak and k=9 EVM golden proofs on the
card, the golden proofs of the EVM's table partners (MulMod, Exp,
Bytecode, Tx, Copy, RLP), of the precompile circuits (SHA-256, ModExp,
ECC) and of the Poseidon chain (the demo under the Poseidon transcript,
Poseidon, MPT, PI) and of the SuperCircuit on the card, the chunk
prover at k=9 on the card (it verifies; a second call is a cache hit),
and the batched Poseidon permutation on the card against the host one.

They skip without a card.  This file imports no JAX (the card's machine
has none); run it there with

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import hashlib

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.crypto.curve import G1, g1_to_affine_ints
from zkevm_circuits_tpu_torch.crypto.field import fq, fr
from zkevm_circuits_tpu_torch.ops import cuda_curve as cc
from zkevm_circuits_tpu_torch.ops import cuda_field as cf
from zkevm_circuits_tpu_torch.poly.msm import msm_many

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_fe(seed, n, modulus):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    d[:, 31] = rng.integers(0, modulus >> 248, size=n, dtype=np.uint8)
    for i, v in enumerate((0, 1, modulus - 1)):
        d[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return d


@pytest.mark.parametrize("fid", [cf.FIELD_FR, cf.FIELD_FQ])
def test_k1_kernel_matches_plain(dev, fid):
    """K1 against its plain version, byte for byte, at 1, 31, 4097, 2^16
    and 2^16 + 3 rows: row against row, against a broadcast row either
    side, and a against itself (the square); one launch a call; a row that
    is not 16-byte aligned raises."""
    p = cf.MODULI[fid]
    n_max = (1 << 16) + 3
    a = torch.as_tensor(_rand_fe(1, n_max, p), device=dev)
    b = torch.as_tensor(_rand_fe(2, n_max, p), device=dev)
    for n in (1, 31, 4097, 1 << 16, n_max):
        x, y = a[:n], b[:n]
        for u, v in ((x, y), (x, b[7]), (b[2], y), (x, x)):
            before = cf.LAUNCHES["mont_mul"]
            assert torch.equal(cf.mont_mul_cuda(u, v, fid), cf.mont_mul_plain(u, v, fid)), n
            assert cf.LAUNCHES["mont_mul"] == before + 1
    before = cf.LAUNCHES["mont_mul"]
    assert torch.equal(cf.mont_mul(a, b, fid), cf.mont_mul_plain(a, b, fid))
    assert cf.LAUNCHES["mont_mul"] == before + 1
    with pytest.raises(ValueError, match="aligned"):
        cf.mont_mul(a.view(-1)[8:8 + 32 * 16].view(16, 32), b[:16], fid)


def test_k2_k3_kernels_match_plain(dev):
    rng = np.random.default_rng(3)
    t = rng.integers(0, 2**31 - 1, size=(4096, 63), dtype=np.int64)
    t[:, 34:] = rng.integers(0, 2**20, size=(4096, 29))
    t[:, 60:] = 0
    t = torch.as_tensor(t.astype(np.int32), device=dev)
    assert torch.equal(cf.redc34_cuda(t), cf.redc34_plain(t))
    y = torch.as_tensor(_rand_fe(4, 16 * 3 * 32, fr().modulus), device=dev)
    y = y.reshape(16, 3, 32, 32)
    tw = torch.as_tensor(_rand_fe(5, 16 * 32, fr().modulus), device=dev)
    tw = tw.reshape(16, 32, 32)
    assert torch.equal(cf.twiddle_mul_cuda(y, tw), cf.twiddle_mul_plain(y, tw))


def test_k4_kernel_matches_plain(dev):
    p = fr().modulus
    lo, hi, tw = (torch.as_tensor(_rand_fe(s, 4096, p), device=dev) for s in (8, 9, 10))
    hi[3:6] = lo[:3]
    before = cf.LAUNCHES["butterfly_stage"]
    got = cf.butterfly_stage(lo, hi, tw)
    assert cf.LAUNCHES["butterfly_stage"] == before + 1
    want = cf.butterfly_stage_plain(lo, hi, tw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.as_tensor(_rand_fe(11, 3 * 1024, p), device=dev).reshape(3, 1024, 32)
    for s in (1, 2, 5, 10):
        half = 1 << (s - 1)
        tw = torch.as_tensor(_rand_fe(12 + s, max(3, half), p)[:half], device=dev)
        assert torch.equal(cf.dit_stage(x, tw, s), cf.dit_stage_plain(x, tw, s)), s


@pytest.mark.parametrize("fid", [cf.FIELD_FR, cf.FIELD_FQ])
def test_add_sub_neg_on_card_are_one_launch_each(dev, fid):
    """F.add, F.sub and F.neg on CUDA tensors, either field: one launch
    each of field_add_sub, counted as "fr_add_sub" or "fq_add_sub", which
    allocates only its output, and equal to the plain version on the same
    rows (0, 1, p - 1, sums to p and equal pairs among them), broadcast
    either way."""
    F = fr() if fid == cf.FIELD_FR else fq()
    name = cf.ADD_SUB_COUNTER[fid]
    a = torch.as_tensor(_rand_fe(21, 4096, F.modulus), device=dev)
    b = torch.as_tensor(_rand_fe(22, 4096, F.modulus), device=dev)
    b[5:8] = a[:3]
    b[16:32] = cf.field_add_sub_plain(a[16:32], None, cf.OP_NEG, fid)

    def one_launch(fn, args, want, materialised=False):
        torch.cuda.reset_peak_memory_stats(dev)
        before, mem = dict(cf.LAUNCHES), torch.cuda.memory_allocated(dev)
        got = fn(*args)
        assert cf.LAUNCHES == {**before, name: before[name] + 1}
        assert torch.cuda.memory_allocated(dev) - mem == _block(got)
        if not materialised:  # nothing but the output, even for a moment
            assert torch.cuda.max_memory_allocated(dev) - mem == _block(got)
        assert torch.equal(got, want)

    forms = ((a, b), (a, b[2]), (a[1], b), (a.reshape(64, 64, 32), b[:64, None]))
    for i, (x, y) in enumerate(forms):
        for fn, op in ((F.add, cf.OP_ADD), (F.sub, cf.OP_SUB)):
            one_launch(fn, (x, y), cf.field_add_sub_plain(x, y, op, fid), i == 3)
    for x in (a, b[2], a.reshape(64, 64, 32)):
        one_launch(F.neg, (x,), cf.field_add_sub_plain(x, None, cf.OP_NEG, fid))
    assert not F.neg(torch.zeros_like(a)).any()
    assert F.add(a[:0], b[:0]).shape == (0, 32)
    with pytest.raises(ValueError, match="aligned"):
        F.add(a.view(-1)[8:8 + 32 * 16].view(16, 32), b[:16])


def _block(t: torch.Tensor) -> int:
    """Bytes the caching allocator gives a tensor: 512-byte blocks."""
    return -(-t.numel() * t.element_size() // 512) * 512


@pytest.fixture
def nccl_group(dev):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_sharded_ops_on_an_nccl_group_of_one(dev, nccl_group):
    from zkevm_circuits_tpu_torch.parallel.sharding import ProverMesh, make_sharded_commit
    from zkevm_circuits_tpu_torch.plonk import prover
    from zkevm_circuits_tpu_torch.poly import ntt
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, k_ext = 10, 12
    p = fr().modulus
    x = torch.as_tensor(_rand_fe(20, 2 << k, p), device=dev).reshape(2, 1 << k, 32)
    ext = torch.as_tensor(_rand_fe(21, 2 << k_ext, p), device=dev).reshape(2, 1 << k_ext, 32)
    srs = Srs.unsafe_setup(k, tau=0x77, device=dev)
    pm = ProverMesh(nccl_group, k, k_ext, srs)
    before = cf.LAUNCHES["butterfly_stage"]
    assert torch.equal(pm.intt(x), ntt.intt(x, k))
    assert cf.LAUNCHES["butterfly_stage"] == before + k  # one launch a stage
    assert torch.equal(pm.coset_ntt_ext(ext), ntt.coset_ntt(ext, k_ext))
    assert torch.equal(pm.coset_intt_ext(ext), ntt.coset_intt(ext, k_ext))
    scan = x[0]
    assert torch.equal(pm.exclusive_prefix_sum(scan), prover._exclusive_prefix_sum(scan))
    assert torch.equal(pm.exclusive_prefix_product(scan, 1000, 1 << k),
                       prover._exclusive_prefix_product(scan, 1000, 1 << k))
    assert pm.commit_many(x) == srs.commit_many(x)
    scal = fr().from_mont(x)
    assert g1_to_affine_ints(make_sharded_commit(nccl_group)(srs.g1_powers, scal)) == \
        g1_to_affine_ints(msm_many(srs.g1_powers, scal))


@pytest.mark.parametrize("mode", ["complete", "incomplete", "affine"])
def test_k5_kernel_matches_plain(dev, mode):
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    n = 256
    Q = fq()
    pts = srs_g1_powers(2 * n, 77, dev)
    p, q = G1(*(c[:n] for c in pts)), G1(*(c[n:] for c in pts))
    if mode != "affine":
        z = torch.as_tensor(_rand_fe(6, n, Q.modulus)[::-1].copy(), device=dev)
        z2 = Q.mul(z, z)
        p = G1(Q.mul(p.x, z2), Q.mul(p.y, Q.mul(z2, z)), z)
    p, q = [c.clone() for c in p], [c.clone() for c in q]
    p[2][:4] = 0  # P at infinity
    q[2][4:8] = 0  # Q at infinity
    if mode == "complete":
        for cp, cq in zip(p, q):
            cq[8:12] = cp[8:12]  # P = Q
        q[0][12:16], q[2][12:16] = p[0][12:16], p[2][12:16]
        q[1][12:16] = Q.neg(p[1][12:16])  # P = -Q
    got = cc.g1_add_cuda(*p, *q, mode=mode)
    want = cc.g1_add_plain(*p, *q, mode=mode)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k6_kernel_matches_plain(dev):
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    n = 300
    Q = fq()
    p = srs_g1_powers(n, 78, dev)
    z = torch.as_tensor(_rand_fe(7, n, Q.modulus)[::-1].copy(), device=dev)
    z2 = Q.mul(z, z)
    p = [Q.mul(p.x, z2), Q.mul(p.y, Q.mul(z2, z)), z]
    p[0][:4], p[1][:4] = Q.ones_mont((4,), dev), Q.ones_mont((4,), dev)
    p[2][:8] = 0  # infinity: (1, 1, 0) and random (x, y, 0)
    got = cc.g1_double_cuda(*p)
    want = cc.g1_double_plain(*p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[2][:8].eq(0).all()
    got10 = cc.g1_double_cuda(*(c[:10] for c in p))
    assert all(torch.equal(g, w[:10]) for g, w in zip(got10, want))


def _jacobian_points(n, seed, dev):
    """n seeded SRS points, moved to random Jacobian representatives."""
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    Q = fq()
    p = srs_g1_powers(n, seed, dev)
    z = torch.as_tensor(_rand_fe(seed, n, Q.modulus)[::-1].copy(), device=dev)
    z2 = Q.mul(z, z)
    return [Q.mul(p.x, z2), Q.mul(p.y, Q.mul(z2, z)), z]


@pytest.mark.parametrize("case", ["one_same_in_a_warp", "generic_warps", "ragged_edge"])
def test_k5_complete_vote_matches_plain(dev, case):
    """The doubling's warp vote: one P = Q row among 31 generic rows, warps
    of generic rows only, and a P = Q row in a last, partial warp."""
    n = 45 if case == "ragged_edge" else 64
    p = _jacobian_points(n, 30, dev)
    q = _jacobian_points(n, 31, dev)
    row = {"one_same_in_a_warp": 5, "ragged_edge": 40}.get(case)
    if row is not None:
        for cp, cq in zip(p, q):
            cq[row] = cp[row]
    got = cc.g1_add_cuda(*p, *q, mode="complete")
    want = cc.g1_add_plain(*p, *q, mode="complete")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k5_bucket_form_matches_plain(dev):
    """Three bucket steps from empty buckets, byte for byte over the whole
    array; step 1 brings lane 0 its step-0 point and digits again."""
    from zkevm_circuits_tpu_torch.crypto.curve import g1_infinity
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    c, lanes, n_win, n_buck, steps = 2, 64, 32, 256, 3
    pts = [t.reshape(steps, lanes, 32).clone()
           for t in srs_g1_powers(steps * lanes, 33, dev)]
    for t in pts:
        t[1, 0] = t[0, 0]
    rng = np.random.default_rng(34)
    dig = rng.integers(0, n_buck, size=(steps, c, lanes, n_win), dtype=np.uint8)
    dig[:, 0, 1] = 0
    dig[:, 1] *= rng.integers(0, 2, size=(steps, lanes, n_win), dtype=np.uint8)
    dig[1, :, 0] = dig[0, :, 0]
    dig = torch.as_tensor(dig, device=dev)
    got = list(g1_infinity((c, lanes, n_win, n_buck), dev))
    want = [t.clone() for t in got]
    before = cf.LAUNCHES["g1_bucket_add"]
    for s in range(steps):
        cc.g1_bucket_add(*got, dig[s], *(t[s] for t in pts))
        cc.g1_bucket_add_plain(*want, dig[s], *(t[s] for t in pts))
    assert cf.LAUNCHES["g1_bucket_add"] == before + steps
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k6_times_matches_plain(dev):
    p = _jacobian_points(300, 35, dev)
    p[2][:8] = 0  # infinity stays infinity
    for times in (1, 8):
        before = cf.LAUNCHES["g1_double"]
        got = cc.g1_double(*p, times=times)
        assert cf.LAUNCHES["g1_double"] == before + 1
        want = cc.g1_double_plain(*p, times=times)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[2][:8].eq(0).all()
        got10 = cc.g1_double_cuda(*(c[:10] for c in p), times=times)
        assert all(torch.equal(g, w[:10]) for g, w in zip(got10, want))


def test_msm_many_k6_launches(dev):
    """A (10, 2^12) stack at 8-bit windows: one K6 launch per window step
    of the Horner (31) and per bit of the bucket weighting (7); one bucket
    step per block of 512 points (8)."""
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    n = 1 << 12
    pts = srs_g1_powers(n, 36, dev)
    scal = torch.as_tensor(_rand_fe(37, 10 * n, fr().modulus).reshape(10, n, 32),
                           device=dev)
    before = dict(cf.LAUNCHES)
    out = msm_many(pts, scal)
    assert cf.LAUNCHES["g1_double"] - before["g1_double"] == 31 + 7
    assert cf.LAUNCHES["g1_bucket_add"] - before["g1_bucket_add"] == 8
    assert out.x.shape == (10, 32)


def test_g1_double_on_card_is_one_k6_launch(dev):
    from zkevm_circuits_tpu_torch.crypto.curve import g1_double, g1_infinity

    p = g1_infinity((10,), dev)
    before = dict(cf.LAUNCHES)
    out = g1_double(p)
    assert cf.LAUNCHES["g1_double"] == before["g1_double"] + 1
    assert {k: v for k, v in cf.LAUNCHES.items() if k != "g1_double"} == \
        {k: v for k, v in before.items() if k != "g1_double"}
    assert out.z.eq(0).all()


def test_keccak_k9_proof_on_card_matches_golden(dev):
    from zkevm_circuits_tpu_torch.circuits.keccak import KeccakCircuit
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, msgs = demo.KECCAK_GOLDEN_K, list(demo.KECCAK_GOLDEN_MESSAGES)
    srs = Srs.unsafe_setup(k, tau=demo.KECCAK_GOLDEN_TAU)
    pk, vk = keygen(KeccakCircuit(msgs), k, srs)
    proof = prove(pk, KeccakCircuit(msgs), [], srs,
                  rng=np.random.default_rng(demo.KECCAK_GOLDEN_SEED))
    assert len(proof) == demo.KECCAK_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.KECCAK_GOLDEN_SHA256
    assert verify(vk, [], proof)


def test_demo_proof_on_card_matches_golden(dev):
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU)
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs)
    proof = prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                  rng=np.random.default_rng(demo.GOLDEN_SEED))
    assert hashlib.sha256(proof).hexdigest() == demo.GOLDEN_SHA256
    assert verify(vk, [[demo.A_IN]], proof)


def test_evm_k9_proof_on_card_matches_golden(dev):
    from zkevm_circuits_tpu_torch.circuits.evm import EvmCircuit, EvmParams
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.service.bench_circuits import evm_witness

    b = evm_witness(demo.EVM_GOLDEN_CODE, demo.EVM_GOLDEN_SENDER,
                    demo.EVM_GOLDEN_CONTRACT)
    params = EvmParams(target_steps=demo.EVM_GOLDEN_TARGET_STEPS,
                       rw_target=demo.EVM_GOLDEN_RW_TARGET)
    srs = Srs.unsafe_setup(demo.EVM_GOLDEN_K, tau=demo.EVM_GOLDEN_TAU)
    pk, vk = keygen(EvmCircuit(b.steps, b.rws.rws, params), demo.EVM_GOLDEN_K, srs)
    proof = prove(pk, EvmCircuit(b.steps, b.rws.rws, params), [], srs,
                  rng=np.random.default_rng(demo.EVM_GOLDEN_SEED))
    assert len(proof) == demo.EVM_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.EVM_GOLDEN_SHA256
    assert verify(vk, [], proof)


@pytest.mark.parametrize("name", ["mulmod", "exp", "bytecode", "tx", "copy", "rlp"])
def test_partner_proof_on_card_matches_golden(dev, name):
    """The EVM's table partners at small k (plonk/demo.py's goldens)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.PARTNER_GOLDENS[name]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU)
    pk, vk = keygen(demo.partner_golden(name), k, srs)
    proof = prove(pk, demo.partner_golden(name), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED))
    assert len(proof) == length
    assert hashlib.sha256(proof).hexdigest() == sha
    assert verify(vk, [], proof)


@pytest.mark.parametrize("name", ["sha256", "modexp", "ecc"])
def test_precompile_proof_on_card_matches_golden(dev, name):
    """The precompile circuits at k=9 (plonk/demo.py's goldens)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.PRECOMPILE_GOLDENS[name]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU)
    pk, vk = keygen(demo.precompile_golden(name), k, srs)
    proof = prove(pk, demo.precompile_golden(name), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED))
    assert len(proof) == length
    assert hashlib.sha256(proof).hexdigest() == sha
    assert verify(vk, [], proof)


def test_permute_batch_on_card_matches_host(dev):
    """The batched Poseidon permutation (K1 launches) on 4,096 seeded
    states against the host permutation, byte for byte."""
    from zkevm_circuits_tpu_torch.crypto.poseidon import permute, permute_batch

    F = fr()
    p = F.modulus
    rng = np.random.default_rng(8)
    states = [[0, 0, 0], [1, 2, 3], [p - 1, p - 1, p - 1]]
    states += [[int.from_bytes(rng.bytes(32), "little") % p for _ in range(3)]
               for _ in range(4096 - len(states))]
    mont = lambda rows: np.stack([F.from_ints([v * F.R % p for v in r])  # noqa: E731
                                  for r in rows])
    before = cf.LAUNCHES["mont_mul"]
    got = permute_batch(torch.as_tensor(mont(states), device=dev))
    assert cf.LAUNCHES["mont_mul"] > before
    assert np.array_equal(got.cpu().numpy(), mont([permute(s) for s in states]))


def test_poseidon_transcript_proof_on_card_matches_golden(dev):
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.poly.transcript import (
        PoseidonReader, PoseidonTranscript)

    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU)
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs)
    proof = prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                  transcript=PoseidonTranscript(),
                  rng=np.random.default_rng(demo.POSEIDON_TRANSCRIPT_GOLDEN_SEED))
    assert len(proof) == demo.POSEIDON_TRANSCRIPT_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.POSEIDON_TRANSCRIPT_GOLDEN_SHA256
    assert verify(vk, [[demo.A_IN]], proof, transcript=PoseidonReader(proof))


@pytest.mark.parametrize("name", ["poseidon", "mpt", "pi"])
def test_chain_proof_on_card_matches_golden(dev, name):
    """The Poseidon, MPT and PI circuits' goldens (plonk/demo.py)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k, sha, length = demo.CHAIN_GOLDENS[name]
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU)
    c, inst = demo.chain_golden(name)
    pk, vk = keygen(c, k, srs)
    proof = prove(pk, demo.chain_golden(name)[0], inst, srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED))
    assert len(proof) == length
    assert hashlib.sha256(proof).hexdigest() == sha
    assert verify(vk, inst, proof)


def test_super_k9_proof_on_card_matches_golden(dev):
    """The SuperCircuit's golden (plonk/demo.py::super_golden)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k = demo.SUPER_GOLDEN_K
    srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU)
    pk, vk = keygen(demo.super_golden(), k, srs)
    proof = prove(pk, demo.super_golden(), [], srs,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED))
    assert len(proof) == demo.SUPER_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.SUPER_GOLDEN_SHA256
    assert verify(vk, [], proof)


def test_chunk_prover_on_card(dev, tmp_path):
    """ChunkProver at k=9 over the golden's witness: the chunk proof
    (Poseidon transcript) verifies, and a second gen_chunk_proof of the
    same witness comes from the cache with equal bytes and no launch."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.service.prover import ChunkProver

    b, codes, txs = demo.super_witness()
    cp = ChunkProver(str(tmp_path / "params"), str(tmp_path / "out"), k=9)
    proof = cp.gen_chunk_proof(b, codes, txs)
    assert proof.k == 9 and proof.instances == []
    assert cp.verify_chunk_proof(proof)
    before = dict(cf.LAUNCHES)
    again = cp.gen_chunk_proof(b, codes, txs)
    assert again.proof == proof.proof and cf.LAUNCHES == before
    # the SRS file loads back onto the card
    srs = ChunkProver(str(tmp_path / "params"), k=9).srs()
    assert srs.device.type == "cuda"
    assert torch.equal(srs.g1_powers.x, cp.srs().g1_powers.x)


@pytest.mark.parametrize("distinct", [False, True], ids=["complete", "distinct"])
def test_msm_grid_on_card_matches_msm(dev, distinct):
    """msm_grid on CUDA tensors equals msm in affine form.  Its launches:
    one K5 per halving level of the grid (one window group at this n),
    8 + 7 in the bucket weighting and 31 in the Horner; one K6 per bit of
    the weighting (7) and per window step of the Horner (31)."""
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers
    from zkevm_circuits_tpu_torch.poly.msm import _grid_indices_host, msm, msm_grid

    n = 1 << 12
    pts = srs_g1_powers(n, 38, dev)
    sc = _rand_fe(39, n, fr().modulus)
    sc[::5] = 0
    _, S = _grid_indices_host(sc)
    scal = torch.as_tensor(sc, device=dev)
    before = dict(cf.LAUNCHES)
    out = msm_grid(pts, scal, distinct=distinct)
    assert cf.LAUNCHES["g1_add"] - before["g1_add"] == S.bit_length() - 1 + 8 + 7 + 31
    assert cf.LAUNCHES["g1_double"] - before["g1_double"] == 7 + 31
    want = msm(pts, scal)
    one = lambda p: G1(*(c[None] for c in p))  # noqa: E731
    assert g1_to_affine_ints(one(out)) == g1_to_affine_ints(one(want))


def test_testool_prove_level_on_card_matches_golden(dev):
    """The testool golden (plonk/demo.py): run_state_test's prove level on
    the card (device None) passes, and its proof is the reference's."""
    import json

    from zkevm_circuits_tpu_torch import testool
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.testool import statetest

    st, = testool.load_json_fillers(json.dumps(demo.TESTOOL_GOLDEN_FILLER))
    cfg = testool.CircuitsConfig(level="prove", k=demo.TESTOOL_GOLDEN_K,
                                 srs_tau=demo.TESTOOL_GOLDEN_TAU)
    r = testool.run_state_test(st, cfg)
    assert r.ok and not r.skipped, r.reason
    _, circ = statetest._host_levels(st, cfg)
    proof, ok = statetest._prove_level(circ, cfg)
    assert ok and len(proof) == demo.TESTOOL_GOLDEN_LEN
    assert hashlib.sha256(proof).hexdigest() == demo.TESTOOL_GOLDEN_SHA256


def test_entry_step_on_card_matches_cpu(dev):
    """entry()'s step on the card: 3 x K K4 launches (three transforms)
    and 2 K1 launches (the product, n^-1); equal to the step on CPU
    tensors."""
    from zkevm_circuits_tpu_torch.entry import K, entry

    step, (x, y) = entry()
    assert x.is_cuda and y.is_cuda
    before = dict(cf.LAUNCHES)
    got = step(x, y)
    assert cf.LAUNCHES["butterfly_stage"] - before["butterfly_stage"] == 3 * K
    assert cf.LAUNCHES["mont_mul"] - before["mont_mul"] == 2
    assert torch.equal(got.cpu(), step(x.cpu(), y.cpu()))
