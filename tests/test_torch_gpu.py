"""Card-only tests of the port: each CUDA kernel against its plain
version on the card, byte for byte (K5's three modes, its warp vote and
its bucket-step form, K6 once and eight times), the sharded ops on an
NCCL group of one rank against the unsharded ones, the MSM's K6 launch
count, and the k=5 demo and k=9 Keccak golden proofs on the card.

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
    p = cf.MODULI[fid]
    a = torch.as_tensor(_rand_fe(1, 4096, p), device=dev)
    b = torch.as_tensor(_rand_fe(2, 4096, p), device=dev)
    before = cf.LAUNCHES["mont_mul"]
    assert torch.equal(cf.mont_mul(a, b, fid), cf.mont_mul_plain(a, b, fid))
    assert cf.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(cf.mont_mul_cuda(a, b[7], fid), cf.mont_mul_plain(a, b[7], fid))


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
