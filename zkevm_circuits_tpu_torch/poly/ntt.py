"""NTT / iNTT / coset transforms over BN254 Fr (port of
zkevm_circuits_tpu/poly/ntt.py).

Polynomials are (..., n, 32) uint8 Montgomery digit tensors; the transform
axis is -2 and leading axes are a batch.  As in the reference, k >=
MXU_MIN_K routes to the four-step matmul NTT (ntt_mxu.py); smaller k runs
the radix-2 DIT ladder here, whose products go through Fr.mul (kernel K1).
"""

from __future__ import annotations

import torch

from ..crypto.field import fr
from .domain import domain

F = fr()

MXU_MIN_K = 4


def _butterfly_stages(x, twiddles, n):
    """DIT butterfly stages over a bit-reversed (..., n, 32) input."""
    batch = x.shape[:-2]
    for s, tw in enumerate(twiddles, start=1):
        m = 1 << s
        half = m // 2
        xv = x.reshape(*batch, n // m, m, 32)
        lo = xv[..., :half, :]
        hi = xv[..., half:, :]
        t = F.mul(hi, torch.as_tensor(tw, device=x.device))
        x = torch.cat([F.add(lo, t), F.sub(lo, t)], dim=-2).reshape(*batch, n, 32)
    return x


def _ntt_impl(x, k: int, inverse: bool):
    dom = domain(k)
    x = x[..., torch.as_tensor(dom.bitrev, device=x.device), :]
    tws = dom.stage_twiddles_inv if inverse else dom.stage_twiddles
    x = _butterfly_stages(x, tws, dom.n)
    if inverse:
        x = F.mul(x, torch.as_tensor(dom.n_inv_mont, device=x.device))
    return x


def _k(x, k):
    k = k if k is not None else int(x.shape[-2]).bit_length() - 1
    assert x.shape[-2] == 1 << k
    return k


def ntt(x, k: int | None = None):
    """coeffs -> evals at H (natural order: index i holds p(omega^i))."""
    k = _k(x, k)
    if k >= MXU_MIN_K:
        from .ntt_mxu import ntt_mxu

        return ntt_mxu(x, k)
    return _ntt_impl(x, k, False)


def intt(x, k: int | None = None):
    """evals at H -> coeffs."""
    k = _k(x, k)
    if k >= MXU_MIN_K:
        from .ntt_mxu import intt_mxu

        return intt_mxu(x, k)
    return _ntt_impl(x, k, True)


def coset_scale(x, k: int, inverse: bool = False):
    """Multiply coefficient i by g^i (or g^-i)."""
    dom = domain(k)
    pw = dom.coset_powers_inv if inverse else dom.coset_powers
    return F.mul(x, torch.as_tensor(pw, device=x.device))


def coset_ntt(x, k: int | None = None):
    """coeffs -> evals on the coset g*H."""
    k = _k(x, k)
    if k >= MXU_MIN_K:
        from .ntt_mxu import coset_ntt_mxu

        return coset_ntt_mxu(x, k)
    return ntt(coset_scale(x, k), k)


def coset_intt(x, k: int | None = None):
    """evals on g*H -> coeffs."""
    k = _k(x, k)
    if k >= MXU_MIN_K:
        from .ntt_mxu import coset_intt_mxu

        return coset_intt_mxu(x, k)
    return coset_scale(intt(x, k), k, inverse=True)
