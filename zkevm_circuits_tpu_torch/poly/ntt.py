"""NTT / iNTT / coset transforms over BN254 Fr (port of
zkevm_circuits_tpu/poly/ntt.py).

Polynomials are (..., n, 32) uint8 Montgomery digit tensors; the transform
axis is -2 and leading axes are a batch.  As in the reference, k >=
MXU_MIN_K routes to the four-step matmul NTT (ntt_mxu.py); smaller k runs
the radix-2 DIT ladder here, each stage one launch of kernel K4 over the
whole batch.  The ladder is also the local transform of the mesh NTT
(`make_sharded_ntt`), at the full k with one rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS, FR_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..ops import cuda_field as cf
from .domain import domain

F = fr()

MXU_MIN_K = 4


@functools.cache
def _ladder_tables(k: int, inverse: bool, device: torch.device):
    """Device copies of the bit-reversal index, the stage twiddle tables
    and n^-1 (Montgomery) for the k-point ladder."""
    dom = domain(k)
    tws = dom.stage_twiddles_inv if inverse else dom.stage_twiddles
    return (torch.as_tensor(dom.bitrev, device=device),
            [torch.as_tensor(tw, device=device) for tw in tws],
            torch.as_tensor(dom.n_inv_mont, device=device))


def _butterfly_stages(x, twiddles):
    """DIT butterfly stages over a bit-reversed (..., n, 32) input; stage s
    is one K4 launch over the whole batch with the stage's table."""
    for s, tw in enumerate(twiddles, start=1):
        x = cf.dit_stage(x, tw, s)
    return x


def _ntt_impl(x, k: int, inverse: bool):
    rev, tws, n_inv = _ladder_tables(k, inverse, x.device)
    x = _butterfly_stages(x[..., rev, :], tws)
    if inverse:
        x = F.mul(x, n_inv)
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


# ---------------------------------------------------------------------------
# Four-step (Bailey) NTT: local form and mesh-sharded form
# ---------------------------------------------------------------------------
@functools.cache
def _twiddle_matrix(k: int, rows: int, cols: int, inverse: bool) -> np.ndarray:
    """(rows, cols, 32) Montgomery digits of w^(i*j), w the 2^k-th root of
    unity (or its inverse): the four-step fixup and the mesh NTT's table."""
    r = FR_MODULUS
    w = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), r)
    if inverse:
        w = pow(w, r - 2, r)
    out = []
    for i in range(rows):
        wi, acc, row = pow(w, i, r), 1, []
        for _ in range(cols):
            row.append(acc * F.R % r)
            acc = acc * wi % r
        out.append(F.from_ints(row))
    return np.stack(out)


def four_step_ntt_local(x, k: int, inverse: bool = False):
    """Four-step NTT of a local (n1, n2, 32) matrix view.

    Equal to ntt(flat) with coefficient j = j1*n2 + j2 stored at [j1, j2];
    returns the flat (n, 32) result in natural order:
    (1) n1-point NTT down the columns -> C[i1, j2]; (2) twiddle
    omega^(i1 j2); (3) n2-point NTT along the rows -> A[i1 + n1*i2] at
    [i1, i2]; (4) transpose to natural order."""
    n1, n2 = x.shape[0], x.shape[1]
    k1, k2 = n1.bit_length() - 1, n2.bit_length() - 1
    assert k1 + k2 == k
    y = _ntt_impl(x.transpose(0, 1), k1, inverse).transpose(0, 1)
    y = F.mul(y, torch.as_tensor(_twiddle_matrix(k, n1, n2, inverse), device=x.device))
    y = _ntt_impl(y, k2, inverse)
    return y.transpose(0, 1).reshape(n1 * n2, 32)


def _all_to_all(y, group):
    """Send slab e of the leading axis to rank e; slab j of the result came
    from rank j."""
    y = y.contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group)
    return out


def gather_rows(y, group):
    """Each rank's (..., L, 32) rows -> the full (..., D L, 32) tensor, rank
    order, on every rank."""
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim=-2)


def local_rows(x, group):
    """This rank's rows [r L, (r + 1) L) of a full (..., n, 32) tensor."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[-2] // d
    return x[..., r * size:(r + 1) * size, :]


def ntt_shard_body(x_local, tw_local, k: int, group, inverse: bool = False):
    """Four-step NTT over the D ranks of `group`, on this rank's shard.

    The global (..., n, 32) polynomial is natural-contiguous over the ranks;
    x_local is this rank's (..., L, 32) shard, L = n / D.  Matrix view
    M[j1, j2] with n1 = D rows (one per rank) and n2 = L: row j1 is rank
    j1's shard.  tw_local is this rank's (L/D, D, 32) block of
    T[j2, i1] = omega_n^(j2*i1) (`sharded_ntt_twiddles`).

      T1: all_to_all -> (D, L/D): all j1, my j2-block.
      S2: D-point NTT over j1 -> C[j2_loc, i1].
      S3: twiddle omega^(j2_global * i1).
      S4: all_to_all -> (L,): all j2, my i1 = d.
      S5: L-point NTT over j2 -> A[d + D*i2] for all i2.
      S6: all_to_all + local transpose -> natural-contiguous shard of A.

    Leading axes are a batch: every column goes through the same three
    all_to_alls."""
    D = dist.get_world_size(group)
    lead = x_local.shape[:-2]
    L = x_local.shape[-2]
    kD, kL = D.bit_length() - 1, L.bit_length() - 1
    assert kD + kL == k and L >= D, (k, D, L)
    y = x_local.reshape(-1, D, L // D, 32)  # [b, e, j2_loc]
    y = _all_to_all(y.transpose(0, 1), group)  # [j1, b, j2_loc]
    y = _ntt_impl(y.permute(1, 2, 0, 3), kD, inverse)  # [b, j2_loc, i1]
    y = F.mul(y, tw_local)
    y = _all_to_all(y.permute(2, 0, 1, 3), group)  # [src, b, j2_loc], my i1
    y = _ntt_impl(y.transpose(0, 1).reshape(-1, L, 32), kL, inverse)
    y = y.reshape(-1, D, L // D, 32).transpose(0, 1)  # [e, b, i2_loc]
    y = _all_to_all(y, group)  # [i1, b, i2_loc], my i2-block
    return y.permute(1, 2, 0, 3).reshape(*lead, L, 32)


def sharded_ntt_twiddles(k: int, n_dev: int, inverse: bool = False) -> np.ndarray:
    """Global (L, D, 32) twiddle table T[j2, i1] = omega_n^(j2*i1); rank r
    takes rows [r L/D, (r + 1) L/D)."""
    return _twiddle_matrix(k, (1 << k) // n_dev, n_dev, inverse)


def make_sharded_ntt(group, k: int, inverse: bool = False):
    """Natural -> natural NTT (or iNTT) of a full (..., 2^k, 32) tensor over
    the ranks of the torch.distributed `group`: each rank transforms its
    shard with the four-step body and the shards are gathered back.  With
    one rank it is the full-k radix-2 ladder."""
    D = dist.get_world_size(group)
    if D == 1:
        return lambda x: _ntt_impl(x, k, inverse)
    blk = (1 << k) // D // D
    r = dist.get_rank(group)
    tw_host = sharded_ntt_twiddles(k, D, inverse)[r * blk:(r + 1) * blk]

    def fn(x):
        tw = torch.as_tensor(tw_host, device=x.device)
        return gather_rows(
            ntt_shard_body(local_rows(x, group), tw, k, group, inverse), group)

    return fn
