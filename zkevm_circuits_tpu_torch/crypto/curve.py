"""BN254 G1 group ops on PyTorch tensors.

Port of zkevm_circuits_tpu/crypto/curve.py.  Points are Jacobian
(X, Y, Z) triples of Montgomery Fq elements, each (..., 32) uint8;
infinity is Z == 0.  `g1_add` and `g1_bucket_add` are kernel K5 and
`g1_double` kernel K6 on CUDA tensors (their plain versions on CPU
tensors), one launch per call.
The host `host_*` / `_hj_*` helpers are pure Python.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..ops import cuda_curve
from .field import fq
from .params import FQ_MODULUS


class G1(NamedTuple):
    """Batch of Jacobian points; coords in Montgomery form, (..., 32) u8."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


F = fq()


def g1_infinity(shape=(), device=None) -> G1:
    return G1(F.ones_mont(shape, device), F.ones_mont(shape, device),
              F.zeros(shape, device))


def g1_from_affine_ints(xy_list, device=None) -> G1:
    """Host: list of (x, y) ints (or None for infinity) -> Jacobian batch."""
    xs, ys, zs = [], [], []
    for p in xy_list:
        if p is None:
            xs.append(1)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            zs.append(1)
    dev = resolve(device)
    to = lambda vals: torch.as_tensor(  # noqa: E731
        F.from_ints([v * F.R % F.modulus for v in vals]), device=dev)
    return G1(to(xs), to(ys), to(zs))


def g1_to_affine_ints(p: G1) -> list:
    """Host: Jacobian batch -> list of (x, y) ints or None (infinity)."""
    zinv = F.inv(p.z)
    zinv2 = F.square(zinv)
    zinv3 = F.mul(zinv2, zinv)
    ax = F.from_mont(F.mul(p.x, zinv2))
    ay = F.from_mont(F.mul(p.y, zinv3))
    inf = F.is_zero(p.z).reshape(-1).cpu().numpy()
    xs = F.to_ints(ax)
    ys = F.to_ints(ay)
    return [None if i else (x, y) for i, x, y in zip(inf, xs, ys)]


def g1_double(p: G1, times: int = 1) -> G1:
    """2^times P for a=0 curves (kernel K6, one launch).  Correct for
    infinity (Z=0 stays Z=0)."""
    return G1(*cuda_curve.g1_double(p.x, p.y, p.z, times))


def g1_add(p: G1, q: G1, mode: str = "complete") -> G1:
    """Jacobian addition (kernel K5).  `complete` handles P = Q, P = -Q
    and infinity; `incomplete` and `affine` carry the contracts of
    ops/cuda_curve.py."""
    shape = torch.broadcast_shapes(p.x.shape, q.x.shape)
    args = [c.expand(shape) for c in (*p, *q)]
    return G1(*cuda_curve.g1_add(*args, mode=mode))


def g1_bucket_add(buckets: G1, digits: torch.Tensor, points: G1) -> None:
    """One MSM bucket step, in place (kernel K5's bucket form): for each
    (column c, lane l, window w) whose digit d = digits[c, l, w] is not 0,
    buckets[c, l, w, d] += points[l] (complete add).  Buckets are
    (c, lanes, n_win, n_buck) points, digits (c, lanes, n_win) uint8,
    points (lanes,)."""
    cuda_curve.g1_bucket_add(*buckets, digits, *points)


def g1_neg(p: G1) -> G1:
    return G1(p.x, F.neg(p.y), p.z)


def g1_select(cond, p: G1, q: G1) -> G1:
    return G1(F.select(cond, p.x, q.x), F.select(cond, p.y, q.y),
              F.select(cond, p.z, q.z))


def g1_scalar_mul(p: G1, scalar_digits) -> G1:
    """Double-and-add over 256 bits, MSB first.  scalar_digits: (..., 32)
    u8 plain (not Montgomery) little-endian scalar bytes."""
    sd = scalar_digits if isinstance(scalar_digits, torch.Tensor) else \
        torch.as_tensor(np.asarray(scalar_digits), device=p.x.device)
    acc = g1_infinity(p.batch_shape, p.x.device)
    for i in range(32):
        byte = sd[..., 31 - i].to(torch.int32)
        for j in range(8):
            acc = g1_double(acc)
            bit = ((byte >> (7 - j)) & 1) == 1
            added = g1_add(acc, p)
            acc = g1_select(bit, added, acc)
    return acc


def g1_normalize(p: G1) -> G1:
    """Batch-normalize Jacobian points to affine form (z in {0, mont(1)})
    with one batched inversion; infinity rows keep (x, y, 0)."""
    flat_z = p.z.reshape(-1, 32)
    zinv = F.batch_inv(flat_z, axis=0).reshape(p.z.shape)
    zinv2 = F.square(zinv)
    zinv3 = F.mul(zinv2, zinv)
    inf = F.is_zero(p.z)
    one = F.ones_mont(p.z.shape[:-1], p.z.device)
    return G1(
        F.select(inf, p.x, F.mul(p.x, zinv2)),
        F.select(inf, p.y, F.mul(p.y, zinv3)),
        F.select(inf, torch.zeros_like(p.z), one),
    )


# host-side oracle (pure ints) ---------------------------------------------
def host_g1_add(p, q, modulus=FQ_MODULUS):
    """Affine int-pair addition oracle; None = infinity."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % modulus == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, -1, modulus) % modulus
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, modulus) % modulus
    x3 = (lam * lam - x1 - x2) % modulus
    y3 = (lam * (x1 - x3) - y1) % modulus
    return (x3, y3)


def host_g1_mul(p, k, modulus=FQ_MODULUS):
    acc = None
    while k:
        if k & 1:
            acc = host_g1_add(acc, p, modulus)
        p = host_g1_add(p, p, modulus)
        k >>= 1
    return acc


# host-side Jacobian bigint helpers ---------------------------------------
# (X, Y, Z) with Z == 0 is infinity.

def _hj_double(p, m):
    X, Y, Z = p
    if Z == 0:
        return p
    A = X * X % m
    B = Y * Y % m
    C = B * B % m
    D = 2 * ((X + B) * (X + B) - A - C) % m
    E = 3 * A % m
    F_ = E * E % m
    X3 = (F_ - 2 * D) % m
    Y3 = (E * (D - X3) - 8 * C) % m
    Z3 = 2 * Y * Z % m
    return (X3, Y3, Z3)


def _hj_add_mixed(p, q_aff, m):
    """Jacobian + affine (x2, y2)."""
    X1, Y1, Z1 = p
    x2, y2 = q_aff
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % m
    U2 = x2 * Z1Z1 % m
    S2 = y2 * Z1 * Z1Z1 % m
    H = (U2 - X1) % m
    r = (S2 - Y1) % m
    if H == 0:
        if r == 0:
            return _hj_double(p, m)
        return (1, 1, 0)
    HH = H * H % m
    HHH = H * HH % m
    V = X1 * HH % m
    X3 = (r * r - HHH - 2 * V) % m
    Y3 = (r * (V - X3) - Y1 * HHH) % m
    Z3 = Z1 * H % m
    return (X3, Y3, Z3)


def _hj_add(p, q, m):
    """Jacobian + Jacobian."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % m
    Z2Z2 = Z2 * Z2 % m
    U1 = X1 * Z2Z2 % m
    U2 = X2 * Z1Z1 % m
    S1 = Y1 * Z2 * Z2Z2 % m
    S2 = Y2 * Z1 * Z1Z1 % m
    H = (U2 - U1) % m
    r = (S2 - S1) % m
    if H == 0:
        if r == 0:
            return _hj_double(p, m)
        return (1, 1, 0)
    HH = H * H % m
    HHH = H * HH % m
    V = U1 * HH % m
    X3 = (r * r - HHH - 2 * V) % m
    Y3 = (r * (V - X3) - S1 * HHH) % m
    Z3 = Z1 * Z2 * H % m
    return (X3, Y3, Z3)


def _hj_to_affine(p, m):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, -1, m)
    zi2 = zi * zi % m
    return (X * zi2 % m, Y * zi2 * zi % m)


def host_msm(points_affine: list, scalars: list[int],
             modulus: int = FQ_MODULUS):
    """Pippenger over host ints: points as (x, y) pairs (None = infinity),
    byte windows MSB-first.  Returns (x, y) or None."""
    m = modulus
    pairs = [
        (p, s) for p, s in zip(points_affine, scalars) if p is not None and s
    ]
    acc = (1, 1, 0)
    for w in range(31, -1, -1):
        if acc[2] != 0:
            for _ in range(8):
                acc = _hj_double(acc, m)
        buckets: dict[int, tuple] = {}
        for p, s in pairs:
            d = (s >> (8 * w)) & 255
            if d:
                cur = buckets.get(d)
                buckets[d] = (
                    _hj_add_mixed(cur, p, m) if cur is not None
                    else (p[0], p[1], 1)
                )
        if not buckets:
            continue
        run = (1, 1, 0)
        wsum = (1, 1, 0)
        for d in range(max(buckets), 0, -1):
            b = buckets.get(d)
            if b is not None:
                run = _hj_add(run, b, m)
            wsum = _hj_add(wsum, run, m)
        acc = _hj_add(acc, wsum, m)
    return _hj_to_affine(acc, m)
