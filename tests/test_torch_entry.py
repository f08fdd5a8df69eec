"""The port's entry points (zkevm_circuits_tpu_torch/entry.py), its
bucket-grid MSM (poly/msm.py::msm_grid) and the public names added with
them (crypto/curve.py g1_generator and g1_is_infinity, poly/kzg.py
vanishing_poly) against the JAX package on the same inputs.

`entry()`'s step on CPU tensors equals the reference's
(__graft_entry__.entry(), JAX on the CPU) byte for byte.  msm_grid, in
complete mode over tests/test_msm.py::test_msm_grid_matches_oracle's inputs
(duplicate points, zero scalars, the infinity sentinel) and in distinct
mode (affine, then incomplete adds) over SRS powers, equals msm, the host
oracle and the reference's msm_grid(use_pallas=False) in affine form.
dryrun_multichip over gloo ranks is in the slow tier: its sharded and
single-device proofs of the k=6 MiniCircuit take minutes each on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from zkevm_circuits_tpu.crypto import curve as jc
from zkevm_circuits_tpu.poly import kzg as jkzg
from zkevm_circuits_tpu.poly import msm as jmsm
from zkevm_circuits_tpu_torch import entry as tentry
from zkevm_circuits_tpu_torch.crypto import curve as tc
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS, G1_GEN, to_digits
from zkevm_circuits_tpu_torch.poly import kzg as tkzg
from zkevm_circuits_tpu_torch.poly import msm as tmsm

torch.set_num_threads(2)


def _affine(p):
    """One port point -> (x, y) or None."""
    return tc.g1_to_affine_ints(tc.G1(*(c.reshape(1, 32) for c in p)))[0]


def _j_affine(p):
    return jc.g1_to_affine_ints(jax.tree.map(lambda x: x[None], p))[0]


def _oracle(base, scalars):
    want = None
    for p, s in zip(base, scalars):
        want = tc.host_g1_add(want, tc.host_g1_mul(p, s))
    return want


def test_entry_step_matches_reference(monkeypatch):
    from zkevm_circuits_tpu.utils import cache

    monkeypatch.setattr(cache, "setup_compile_cache", lambda path=None: None)
    import __graft_entry__ as ref

    jstep, (jx, jy) = ref.entry()
    step, (x, y) = tentry.entry(device="cpu")
    assert x.device.type == "cpu" and x.shape == (1 << tentry.K, 32)
    assert np.array_equal(x.numpy(), jx) and np.array_equal(y.numpy(), jy)
    want = np.asarray(jstep(jnp.asarray(jx), jnp.asarray(jy)))
    assert np.array_equal(step(x, y).numpy(), want)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(1)
    assert not dist.is_initialized()


def _msm_case(seed=0xC0FFEE):
    """tests/test_msm.py::test_msm_grid_matches_oracle's inputs: 22 random
    multiples of G, base[0] and base[1] again, scalar 0 and scalar 1."""
    rng = np.random.default_rng(seed)
    n = 24
    base = [tc.host_g1_mul(G1_GEN, int(rng.integers(1, 1 << 60)))
            for _ in range(n - 2)]
    base += [base[0], base[1]]
    scalars = [int.from_bytes(rng.bytes(40), "little") % FR_MODULUS
               for _ in range(n)]
    scalars[0] = 0
    scalars[1] = 1
    return base, scalars


SRS_K, SRS_TAU = 5, 0x5EED


def _srs_case(seed=5):
    """The 2^SRS_K powers [tau^i]G of Srs.unsafe_setup(SRS_K, SRS_TAU)
    (distinct, affine), a few zero scalars."""
    base = [tc.host_g1_mul(G1_GEN, pow(SRS_TAU, i, FR_MODULUS))
            for i in range(1 << SRS_K)]
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(40), "little") % FR_MODULUS
               for _ in base]
    scalars[2] = scalars[9] = 0
    return base, scalars


@pytest.mark.parametrize("case", ["complete", "distinct"])
def test_msm_grid_matches_msm_and_oracle(case):
    base, scalars = _msm_case() if case == "complete" else _srs_case()
    pts = tc.g1_from_affine_ints(base, "cpu")
    sc = np.array([to_digits(s) for s in scalars], np.uint8)
    got = tmsm.msm_grid(pts, torch.as_tensor(sc), distinct=case == "distinct")
    want = _oracle(base, scalars)
    assert _affine(got) == want
    assert _affine(tmsm.msm(pts, torch.as_tensor(sc))) == want


@pytest.mark.slow
@pytest.mark.parametrize("case", ["complete", "distinct"])
def test_msm_grid_matches_reference_grid(case):
    """Against the reference's msm_grid(use_pallas=False) on the same
    inputs (its XLA compile takes minutes)."""
    base, scalars = _msm_case() if case == "complete" else _srs_case()
    sc = np.array([to_digits(s) for s in scalars], np.uint8)
    ref = jmsm.msm_grid(jc.g1_from_affine_ints(base), jnp.asarray(sc),
                        use_pallas=False, distinct=case == "distinct")
    got = tmsm.msm_grid(tc.g1_from_affine_ints(base, "cpu"), sc,
                        distinct=case == "distinct")
    assert _affine(got) == _j_affine(ref)


def test_grid_indices_match_reference():
    for base, scalars in (_msm_case(), _srs_case()):
        sc = np.array([to_digits(s) for s in scalars], np.uint8)
        j_idx, j_s = jmsm._grid_indices_host(sc)
        p_idx, p_s = tmsm._grid_indices_host(sc)
        assert p_s == j_s and np.array_equal(p_idx, j_idx)
    assert (tmsm.N_WINDOWS, tmsm.N_BUCKETS) == (jmsm.N_WINDOWS, jmsm.N_BUCKETS)


def test_srs_case_points_are_the_srs_powers():
    srs = tkzg.Srs.unsafe_setup(SRS_K, tau=SRS_TAU, device="cpu")
    assert tc.g1_to_affine_ints(srs.g1_powers) == _srs_case()[0]


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_g1_generator_and_is_infinity(shape):
    got = tc.g1_generator(shape, "cpu")
    want = jc.g1_generator(shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tc.g1_is_infinity(got).numpy(),
                          np.asarray(jc.g1_is_infinity(want)))
    inf = tc.g1_infinity(shape, "cpu")
    assert np.array_equal(tc.g1_is_infinity(inf).numpy(),
                          np.asarray(jc.g1_is_infinity(jc.g1_infinity(shape))))


@pytest.mark.parametrize("points", [[], [0], [5], [1, 2, 3], [FR_MODULUS - 1, 7, 7]])
def test_vanishing_poly_matches_reference(points):
    got = tkzg.vanishing_poly(points)
    assert got == jkzg.vanishing_poly(points)
    for p in points:
        assert tkzg.host_eval_poly(got, p) == 0


@pytest.mark.slow
@pytest.mark.parametrize("world", [1, 2, 4], ids=["D1", "D2", "D4"])
def test_dryrun_multichip_gloo(world):
    """The sharded NTT, MSM and prefix scans and the MiniCircuit proof
    over `world` gloo ranks equal their single-device results (the dry
    run raises otherwise); no process group stays initialised."""
    out = tentry.dryrun_multichip(world, device="cpu")
    assert out["ranks"] == world and out["proof_bytes"] > 0
    assert not dist.is_initialized()
