"""Port field arithmetic (zkevm_circuits_tpu_torch.crypto.field and the
plain version of kernel K1) against the JAX package, exact bytes.

Inputs are made with numpy from a seed and handed to both sides; the port
runs on CPU tensors.
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.crypto import field as jfield
from zkevm_circuits_tpu_torch.crypto import field as tfield
from zkevm_circuits_tpu_torch.ops import cuda_field as cf

torch.set_num_threads(2)

FIELDS = ["fr", "fq"]


def _fields(name):
    return getattr(jfield, name)(), getattr(tfield, name)()


def _vals(J, seed, n):
    rng = np.random.default_rng(seed)
    p = J.modulus
    edge = [0, 1, p - 1, p - 2, J.R, (1 << 255) % p]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - len(edge))]
    return J.from_ints(edge + rand)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", FIELDS)
def test_k1_plain_matches_reference_mul(name):
    J, T = _fields(name)
    a, b = _vals(J, 1, 96), _vals(J, 2, 96)[::-1].copy()
    fid = cf.FIELD_FR if name == "fr" else cf.FIELD_FQ
    got = cf.mont_mul_plain(_t(a), _t(b), fid).numpy()
    assert np.array_equal(got, np.asarray(J.mul(a, b)))


@pytest.mark.parametrize("name", FIELDS)
def test_mul_2d_batch_and_broadcast(name):
    J, T = _fields(name)
    a = _vals(J, 3, 60).reshape(5, 12, 32)
    b = _vals(J, 4, 60).reshape(5, 12, 32)
    assert np.array_equal(T.mul(_t(a), _t(b)).numpy(), np.asarray(J.mul(a, b)))
    assert np.array_equal(T.mul(_t(a), _t(b[2, 3])).numpy(),
                          np.asarray(J.mul(a, b[2, 3])))


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub(name, op):
    J, T = _fields(name)
    a, b = _vals(J, 5, 64), _vals(J, 6, 64)[::-1].copy()
    want = np.asarray(getattr(J, op)(a, b))
    assert np.array_equal(getattr(T, op)(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("bshape", [(64,), (), (4, 1)])
def test_fr_add_sub_through_k4_plain_stage(bshape):
    """K4's first stage with twiddle 1 over the pairs (a, b), Fr's add and
    sub on the card, in its plain version: the reference's add and sub,
    broadcast either way, with 0, 1 and p - 1 among the rows."""
    J, _ = _fields("fr")
    a = _vals(J, 11, 64)
    b = _vals(J, 12, 64)[::-1].copy()[:int(np.prod(bshape))].reshape(*bshape, 32)
    a2 = a.reshape(4, 16, 32) if len(bshape) == 2 else a
    for x, y in ((a2, b), (b, a2)):
        got = cf.fr_add_sub_plain(_t(x), _t(y))
        assert np.array_equal(got[0].numpy(), np.asarray(J.add(x, y)))
        assert np.array_equal(got[1].numpy(), np.asarray(J.sub(x, y)))
    assert cf.fr_add_sub_plain(_t(a[:0]), _t(a[:0]))[0].shape == (0, 32)


@pytest.mark.parametrize("name", FIELDS)
def test_neg_square_mont_roundtrip(name):
    J, T = _fields(name)
    a = _vals(J, 7, 40)
    assert np.array_equal(T.neg(_t(a)).numpy(), np.asarray(J.neg(a)))
    assert np.array_equal(T.square(_t(a)).numpy(), np.asarray(J.square(a)))
    assert np.array_equal(T.to_mont(_t(a)).numpy(), np.asarray(J.to_mont(a)))
    assert np.array_equal(T.from_mont(T.to_mont(_t(a))).numpy(), a)


@pytest.mark.parametrize("name", FIELDS)
def test_inv_and_pow(name):
    J, T = _fields(name)
    a = _vals(J, 8, 8)
    assert np.array_equal(T.inv(_t(a)).numpy(), np.asarray(J.inv(a)))
    assert np.array_equal(T.pow(_t(a), 12345).numpy(), np.asarray(J.pow(a, 12345)))


@pytest.mark.parametrize("name", FIELDS)
def test_batch_inv_with_zeros(name):
    """Inverses are unique, so the reference's elementwise `inv` (which
    maps 0 to 0 too) is the oracle for any batching."""
    J, T = _fields(name)
    a = _vals(J, 9, 36)
    a[[4, 20]] = 0
    want = np.asarray(J.inv(a))
    got = T.batch_inv(_t(a)).numpy()
    assert np.array_equal(got, want)
    assert not got[4].any() and not got[20].any()
    a2 = a.reshape(4, 9, 32)
    assert np.array_equal(T.batch_inv(_t(a2), axis=1).numpy(), want.reshape(4, 9, 32))


@pytest.mark.parametrize("name", FIELDS)
def test_power_table(name):
    J, T = _fields(name)
    x = 0xABCDEF123
    want = J.from_ints([pow(x, i, J.modulus) * J.R % J.modulus for i in range(37)])
    for n in (1, 5, 37):
        got = T.power_table(x, n, device="cpu").numpy()
        assert np.array_equal(got, want[:n])


@pytest.mark.parametrize("name", FIELDS)
def test_host_conversions(name):
    J, T = _fields(name)
    vals = [0, 1, 5, 5, -3, 2**70, J.modulus + 2, 123456789]
    assert np.array_equal(T.mont_from_ints(vals), J.mont_from_ints(vals))
    assert np.array_equal(T.from_ints(vals), J.from_ints(vals))
    digits = J.from_ints(vals)
    assert T.to_ints(_t(digits)) == J.to_ints(digits)
    assert np.array_equal(T.mont_from_ints_padded([7, 8], 4),
                          J.mont_from_ints_padded([7, 8], 4))


def test_cpu_tensors_take_plain_version():
    T = tfield.fr()
    cf.reset_launches()
    a = _t(_vals(jfield.fr(), 10, 16))
    T.mul(a, a)
    T.batch_inv(a)
    assert all(v == 0 for v in cf.LAUNCHES.values())


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    a = np.zeros((2, 32), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfield.fr().mul(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfield.fr().zeros((2,))
