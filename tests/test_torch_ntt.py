"""Port NTTs (zkevm_circuits_tpu_torch.poly.ntt / ntt_mxu) and the plain
versions of kernels K2 and K3 against the JAX package, exact bytes."""

import jax
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.crypto.field import fr as jfr
from zkevm_circuits_tpu.poly import ntt as jntt
from zkevm_circuits_tpu.poly import ntt_mxu as jmxu
from zkevm_circuits_tpu_torch.ops import cuda_field as cf
from zkevm_circuits_tpu_torch.poly import ntt as tntt
from zkevm_circuits_tpu_torch.poly import ntt_mxu as tmxu

torch.set_num_threads(2)
F = jfr()
_jredc = jax.jit(jmxu._redc)


def _poly(seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % F.modulus for _ in range(n)]
    return F.from_ints(vals).reshape(*shape, 32)


def _digit_sums(seed, rows):
    """Exact digit sums T < 2^272 p, as a DFT pass leaves them."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 2**31 - 1, size=(rows, 63), dtype=np.int64)
    t[:, 34:] = rng.integers(0, 2**20, size=(rows, 29))
    t[:, 60:] = 0
    return t.astype(np.int32)


def test_k3_plain_matches_reference_redc():
    t = _digit_sums(1, 200)
    t[0] = 0
    got = cf.redc34_plain(torch.as_tensor(t)).numpy()
    assert np.array_equal(got, np.asarray(_jredc(t)))


def test_k3_plain_on_a_real_pass():
    """Digit sums from an actual DFT-pass matmul of the port."""
    k = 6
    x = torch.as_tensor(_poly(2, (1 << k,)))
    k1, _ = tmxu._split_k(k)
    w1, _, _ = tmxu._consts2(k, False, 1, 1, 1, "cpu")
    n1 = 1 << k1
    y = x.reshape(n1, -1, 32)
    m = y.shape[1]
    t = tmxu.dft_matmul(*w1, y.permute(1, 0, 2).reshape(m, n1 * 32))
    t32 = t.reshape(n1, 63, m).permute(0, 2, 1).reshape(-1, 63).contiguous()
    got = cf.redc34_plain(t32).numpy()
    assert np.array_equal(got, np.asarray(_jredc(t32.numpy())))


def test_k2_plain_matches_reference_mul():
    y = _poly(3, (4, 2, 8))
    tw = _poly(4, (4, 8))
    got = cf.twiddle_mul_plain(torch.as_tensor(y), torch.as_tensor(tw)).numpy()
    assert np.array_equal(got, np.asarray(F.mul(y, np.broadcast_to(tw[:, None], y.shape))))


def test_dft_matmul_is_exact():
    """The int8 matmul with rank-1 corrections equals the u8 product."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 256, size=(63 * 4, 128), dtype=np.uint8)
    x = rng.integers(0, 256, size=(128, 13), dtype=np.uint8)
    wq = (torch.as_tensor(w) ^ 0x80).view(torch.int8)
    rows = wq.sum(dim=1, dtype=torch.int32)
    got = tmxu.dft_matmul(wq, rows, torch.as_tensor(x.T.copy()))
    assert np.array_equal(got.numpy(), w.astype(np.int64) @ x.astype(np.int64))


@pytest.mark.parametrize("k", [3, 4, 6, 8])
@pytest.mark.parametrize("name", ["ntt", "intt", "coset_ntt", "coset_intt"])
def test_transforms_match_reference(k, name):
    x = _poly(10 + k, (2, 1 << k))
    got = getattr(tntt, name)(torch.as_tensor(x), k).numpy()
    assert np.array_equal(got, np.asarray(getattr(jntt, name)(x, k)))


@pytest.mark.parametrize("k", [3, 6])
def test_round_trips(k):
    x = torch.as_tensor(_poly(20 + k, (2, 1 << k)))
    assert torch.equal(tntt.intt(tntt.ntt(x, k), k), x)
    assert torch.equal(tntt.coset_intt(tntt.coset_ntt(x, k), k), x)
