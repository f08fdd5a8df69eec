"""Kernels K5 (BN254 G1 Jacobian addition over Fq, a = 0, three modes and
a bucket-step form) and K6 (G1 Jacobian doubling, repeated), with their
plain PyTorch versions.

A CUDA tensor goes to the kernel (csrc/curve.cu), a CPU tensor to the
plain version; there is no other route.  K5's modes, as in the TPU kernel
(products + squarings):
  complete   (11 + 5, and the doubling's 2 + 5 where P = Q) no
             preconditions; P = Q, P = -Q and infinity are resolved by the
             select ladder of crypto/curve.py::g1_add, whose bytes it
             reproduces;
  incomplete (11 + 5) operands distinct or at infinity;
  affine     (4 + 2)  z in {0, mont(1)}, operands distinct or at infinity.
K5's bucket-step form (`g1_bucket_add`) is one step of the MSM's bucket
accumulation, in place: bucket [c, l, w, d] += point [l] with the complete
add wherever the digit d = digits[c, l, w] is not 0.  Its own launch
counter is LAUNCHES["g1_bucket_add"].

K6 is dbl-2009-l (2 + 5); infinity (z = 0) stays z = 0.  `times=k`
applies it k times in one launch (2^k P).

The plain versions run the same formulas on 16-bit limbs (cuda_field),
with the independent products of each step stacked into one multiply.
"""

from __future__ import annotations

import torch

from . import build
from .cuda_field import (
    FIELD_FQ,
    LAUNCHES,
    _check_rows,
    _consts,
    _stream,
    add_limbs,
    from_limbs,
    mont_mul_limbs,
    sub_limbs,
    to_limbs,
)

MODES = {"complete": 0, "incomplete": 1, "affine": 2}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _mul_many(pairs, cs):
    """Independent products as one stacked multiply."""
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    return list(mont_mul_limbs(a, b, cs).unbind(0))


def _is_zero(x):
    return (x == 0).all(dim=-1, keepdim=True)


def g1_add_plain(ax, ay, az, bx, by, bz, mode: str = "complete"):
    """Plain version of K5 over (..., 32) u8 Montgomery Fq coordinates.
    The complete mode's doubling (crypto/curve.py::g1_double) shares the
    stacked product steps of the addition."""
    cs = _consts(FIELD_FQ, ax.device)
    x1, y1, z1, x2, y2, z2 = (to_limbs(t) for t in (ax, ay, az, bx, by, bz))
    add = lambda a, b: add_limbs(a, b, cs)  # noqa: E731
    sub = lambda a, b: sub_limbs(a, b, cs)  # noqa: E731
    full = mode != "affine"
    dbl = mode == "complete"
    p_inf, q_inf = _is_zero(z1), _is_zero(z2)
    if full:
        step = [(z1, z1), (z2, z2), (y1, z2), (y2, z1)]
        if dbl:
            step += [(x1, x1), (y1, y1), (y1, z1)]
        res = _mul_many(step, cs)
        z1z1, z2z2, a1, a2 = res[:4]
        step = [(x1, z2z2), (x2, z1z1), (a1, z2z2), (a2, z1z1)]
        if dbl:
            xsq, ysq, yz = res[4:]
            xb = add(x1, ysq)
            e = add(add(xsq, xsq), xsq)
            step += [(ysq, ysq), (xb, xb), (e, e)]
        res = _mul_many(step, cs)
        u1, u2, s1, s2 = res[:4]
        h, r = sub(u2, u1), sub(s2, s1)
    else:
        u1, s1 = x1, y1
        h, r = sub(x2, x1), sub(y2, y1)
    h2, rr = add(h, h), add(r, r)
    step = [(h2, h2), (rr, rr)]
    if full:
        zs = add(z1, z2)
        step.append((zs, zs))
    res3 = _mul_many(step, cs)
    i, rr2 = res3[:2]
    step = [(h, i), (u1, i)]
    if full:
        step.append((sub(sub(res3[2], z1z1), z2z2), h))
    if dbl:
        c, xb2, f = res[4:]
        d = sub(sub(xb2, xsq), c)
        d = add(d, d)
        dx = sub(f, add(d, d))
        step.append((e, sub(d, dx)))
    res4 = _mul_many(step, cs)
    j, v = res4[:2]
    x3 = sub(sub(rr2, j), add(v, v))
    y3a, s1j = _mul_many([(rr, sub(v, x3)), (s1, j)], cs)
    y3 = sub(y3a, add(s1j, s1j))
    z3 = res4[2] if full else add(h, h)
    if dbl:
        c8 = add(c, c)
        c8 = add(c8, c8)
        c8 = add(c8, c8)
        dy = sub(res4[3], c8)
        dz = add(yz, yz)
        h0, r0 = _is_zero(h), _is_zero(r)
        fin = ~p_inf & ~q_inf
        same = h0 & r0 & fin
        oppo = h0 & ~r0 & fin
        one = to_limbs(torch.as_tensor(_ONE_MONT_FQ, device=ax.device))
        x3 = torch.where(oppo, one, torch.where(same, dx, x3))
        y3 = torch.where(oppo, one, torch.where(same, dy, y3))
        z3 = torch.where(oppo, torch.zeros_like(z3), torch.where(same, dz, z3))
    x3 = torch.where(q_inf, x1, torch.where(p_inf, x2, x3))
    y3 = torch.where(q_inf, y1, torch.where(p_inf, y2, y3))
    z3 = torch.where(q_inf, z1, torch.where(p_inf, z2, z3))
    return from_limbs(x3), from_limbs(y3), from_limbs(z3)


def g1_double_plain(ax, ay, az, times: int = 1):
    """Plain version of K6 over (..., 32) u8 Montgomery Fq coordinates:
    2^times P for a = 0, one dbl-2009-l after another."""
    _check_times(times)
    for _ in range(times):
        ax, ay, az = _double_once(ax, ay, az)
    return ax, ay, az


def _double_once(ax, ay, az):
    """2P (dbl-2009-l); z3 = 2 Y Z, so infinity stays infinity."""
    cs = _consts(FIELD_FQ, ax.device)
    x, y, z = (to_limbs(t) for t in (ax, ay, az))
    add = lambda a, b: add_limbs(a, b, cs)  # noqa: E731
    sub = lambda a, b: sub_limbs(a, b, cs)  # noqa: E731
    a, b, yz = _mul_many([(x, x), (y, y), (y, z)], cs)  # X^2, Y^2, YZ
    xb = add(x, b)
    e = add(add(a, a), a)  # 3X^2
    c, xb2, f = _mul_many([(b, b), (xb, xb), (e, e)], cs)  # Y^4, (X+B)^2, E^2
    d = sub(sub(xb2, a), c)
    d = add(d, d)
    x3 = sub(f, add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    (y3a,) = _mul_many([(e, sub(d, x3))], cs)
    y3 = sub(y3a, c8)
    z3 = add(yz, yz)
    return from_limbs(x3), from_limbs(y3), from_limbs(z3)


def _one_mont_fq():
    import numpy as np

    from ..crypto.params import FQ_MODULUS

    one = (1 << 256) % FQ_MODULUS
    return np.frombuffer(one.to_bytes(32, "little"), np.uint8).copy()


_ONE_MONT_FQ = _one_mont_fq()


def g1_bucket_add_plain(bx, by, bz, digits, px, py, pz) -> None:
    """Plain version of K5's bucket-step form, in place: gather the buckets
    the nonzero digits select, add the lanes' points (complete mode),
    scatter the sums back.  Bucket coordinates (c, lanes, n_win, n_buck,
    32), digits (c, lanes, n_win), points (lanes, 32)."""
    ci, li, wi = (digits != 0).nonzero(as_tuple=True)
    d = digits[ci, li, wi].long()
    out = g1_add_plain(*(t[ci, li, wi, d] for t in (bx, by, bz)),
                       *(t[li] for t in (px, py, pz)), mode="complete")
    for t, o in zip((bx, by, bz), out):
        t[ci, li, wi, d] = o


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def _coords_in(op: str, names, coords) -> list:
    """Same-shape (..., 32) u8 CUDA coordinates, made contiguous."""
    shape = coords[0].shape
    out = []
    for name, t in zip(names, coords):
        if t.shape != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        t = t.contiguous()
        _check_rows(t, f"{op} {name}")
        out.append(t)
    return out


def _coords_out(like: torch.Tensor) -> list:
    return [torch.empty(like.shape, dtype=torch.uint8, device=like.device)
            for _ in range(3)]


def g1_add_cuda(ax, ay, az, bx, by, bz, mode: str = "complete"):
    ins = _coords_in("g1_add", ("ax", "ay", "az", "bx", "by", "bz"),
                     (ax, ay, az, bx, by, bz))
    outs = _coords_out(ax)
    build.check(build.lib().zk_g1_add(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
        ax.numel() // 32, MODES[mode], _stream()), "g1_add")
    LAUNCHES["g1_add"] += 1
    return tuple(outs)


def g1_add(ax, ay, az, bx, by, bz, mode: str = "complete"):
    """K5: CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if mode not in MODES:
        raise ValueError(f"g1_add: unknown mode {mode!r}")
    if ax.is_cuda:
        return g1_add_cuda(ax, ay, az, bx, by, bz, mode)
    return g1_add_plain(ax, ay, az, bx, by, bz, mode)


def g1_bucket_add_cuda(bx, by, bz, digits, px, py, pz) -> None:
    """K5's bucket-step form on the card; updates bx, by, bz in place, so
    they must be contiguous already."""
    shape = bx.shape
    if len(shape) != 5 or shape[-1] != 32:
        raise ValueError(f"g1_bucket_add: buckets have shape {tuple(shape)}, "
                         "expected (c, lanes, n_win, n_buck, 32)")
    c, lanes, n_win, n_buck = shape[:4]
    if n_buck > 256:
        raise ValueError(f"g1_bucket_add: {n_buck} buckets, at most 256")
    for name, t in (("bx", bx), ("by", by), ("bz", bz)):
        if t.shape != shape:
            raise ValueError(f"g1_bucket_add: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        _check_rows(t, f"g1_bucket_add {name}")
    pts = _coords_in("g1_bucket_add", ("px", "py", "pz"), (px, py, pz))
    if pts[0].shape != (lanes, 32):
        raise ValueError(f"g1_bucket_add: points have shape "
                         f"{tuple(pts[0].shape)}, expected ({lanes}, 32)")
    if digits.shape != (c, lanes, n_win) or digits.dtype != torch.uint8 \
            or not digits.is_cuda:
        raise ValueError(f"g1_bucket_add: digits must be ({c}, {lanes}, "
                         f"{n_win}) uint8 on the card, got "
                         f"{tuple(digits.shape)} {digits.dtype}")
    digits = digits.contiguous()
    build.check(build.lib().zk_g1_bucket_add(
        bx.data_ptr(), by.data_ptr(), bz.data_ptr(), digits.data_ptr(),
        *(t.data_ptr() for t in pts), digits.numel(), lanes, n_win, n_buck,
        _stream()), "g1_bucket_add")
    LAUNCHES["g1_bucket_add"] += 1


def g1_bucket_add(bx, by, bz, digits, px, py, pz) -> None:
    """K5's bucket-step form, in place: CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if bx.is_cuda:
        return g1_bucket_add_cuda(bx, by, bz, digits, px, py, pz)
    return g1_bucket_add_plain(bx, by, bz, digits, px, py, pz)


def _check_times(times: int) -> None:
    if times < 1:
        raise ValueError(f"g1_double: times must be >= 1, got {times}")


def g1_double_cuda(ax, ay, az, times: int = 1):
    _check_times(times)
    ins = _coords_in("g1_double", ("ax", "ay", "az"), (ax, ay, az))
    outs = _coords_out(ax)
    build.check(build.lib().zk_g1_double(
        *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
        ax.numel() // 32, times, _stream()), "g1_double")
    LAUNCHES["g1_double"] += 1
    return tuple(outs)


def g1_double(ax, ay, az, times: int = 1):
    """K6, 2^times P: CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if ax.is_cuda:
        return g1_double_cuda(ax, ay, az, times)
    return g1_double_plain(ax, ay, az, times)
