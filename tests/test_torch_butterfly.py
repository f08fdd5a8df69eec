"""Kernel K4 (radix-2 butterfly stage) of the port: its plain version
against the JAX package's Pallas kernel body (run in interpret mode) and
against the JAX radix-2 ladder, exact bytes; the port's ladder `_ntt_impl`
against the JAX one for k = 1..10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zkevm_circuits_tpu.crypto.field import fr as jfr
from zkevm_circuits_tpu.ops import pallas_field as pf
from zkevm_circuits_tpu.poly import ntt as jntt
from zkevm_circuits_tpu.poly.domain import domain as jdomain
from zkevm_circuits_tpu_torch.ops import cuda_field as cf
from zkevm_circuits_tpu_torch.poly import ntt as tntt

torch.set_num_threads(2)
F = jfr()


def _fe(seed, shape):
    """Seeded canonical Fr digit rows, with 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [0, 1, F.modulus - 1][:n]
    vals += [int.from_bytes(rng.bytes(32), "little") % F.modulus
             for _ in range(n - len(vals))]
    return F.from_ints(vals).reshape(*shape, 32)


def _pallas_butterfly(lo, hi, tw):
    """The TPU kernel body `_butterfly_kernel`, launched as
    ops/pallas_field.py::butterfly_stage launches it, in interpret mode."""
    n = lo.shape[0]
    blk = min(pf.BLK, n)
    spec = pl.BlockSpec((blk, pf.ND), lambda i: (i, 0))
    out = jax.ShapeDtypeStruct((n, pf.ND), jnp.int32)
    olo, ohi = pl.pallas_call(
        pf._butterfly_kernel, out_shape=(out, out), grid=(n // blk,),
        in_specs=[spec, spec, spec] + pf._const_specs(), out_specs=(spec, spec),
        interpret=True,
    )(*(jnp.asarray(a, jnp.int32) for a in (lo, hi, tw)), *pf._const_args(F))
    return np.asarray(olo).astype(np.uint8), np.asarray(ohi).astype(np.uint8)


@pytest.mark.parametrize("rows", [256, 1024])
def test_k4_plain_matches_pallas_kernel_body(rows):
    lo, hi, tw = _fe(rows, (rows,)), _fe(rows + 1, (rows,)), _fe(rows + 2, (rows,))
    hi[3:6] = lo[:3]  # lo == hi on a few rows: lo - hi * tw meets 0 and p - 1
    want_lo, want_hi = _pallas_butterfly(lo, hi, tw)
    got_lo, got_hi = cf.butterfly_stage(*(torch.as_tensor(a) for a in (lo, hi, tw)))
    assert np.array_equal(got_lo.numpy(), want_lo)
    assert np.array_equal(got_hi.numpy(), want_hi)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_k4_stage_form_is_one_stage_of_the_jax_ladder(s):
    """Stage s of the port (stage form) after stages 1..s-1 of the JAX
    ladder equals stages 1..s of the JAX ladder (k = 3: half-blocks of 1, 2
    and 4 rows, two columns)."""
    k, n = 3, 8
    x = jnp.asarray(_fe(40 + s, (2, n)))
    tws = jdomain(k).stage_twiddles
    before = np.array(jntt._butterfly_stages(x, tws[:s - 1], n))
    want = np.asarray(jntt._butterfly_stages(x, tws[:s], n))
    got = cf.dit_stage(torch.as_tensor(before), torch.as_tensor(tws[s - 1]), s)
    assert np.array_equal(got.numpy(), want)


def test_k4_stage_form_rejects_a_wrong_table():
    x = torch.zeros(2, 8, 32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="twiddle table"):
        cf.dit_stage(x, torch.zeros(2, 32, dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="stage 4"):
        cf.dit_stage(x, torch.zeros(8, 32, dtype=torch.uint8), 4)


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("k", range(1, 11))
def test_ntt_impl_matches_jax(k, inverse):
    x = _fe(100 + k, (3, 1 << k))
    got = tntt._ntt_impl(torch.as_tensor(x), k, inverse).numpy()
    assert np.array_equal(got, np.asarray(jntt._ntt_impl(x, k, inverse)))
