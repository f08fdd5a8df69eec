"""KZG commitments over BN254 + SHPLONK multiopen (port of
zkevm_circuits_tpu/poly/kzg.py).

Commitments are MSMs of coefficient-form polynomials against the monomial
SRS; quotients by vanishing polynomials are computed in evaluation form on
a coset; the multiopen is BDFG21 with two witness commitments, verified by
a 2-pairing product on the host.  The protocol, transcript order and
bytes are the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from ..crypto import pairing as pr
from ..crypto.curve import (
    G1,
    g1_add,
    g1_infinity,
    g1_normalize,
    g1_to_affine_ints,
    host_g1_add,
    host_g1_mul,
    host_msm,
)
from ..crypto.field import fq, fr
from ..crypto.params import FQ_MODULUS, FR_MODULUS, G1_GEN
from ..device import resolve
from ..utils.stats import timer
from .msm import msm_many
from .ntt import coset_intt, coset_ntt

F = fr()
R = FR_MODULUS


# ---------------------------------------------------------------------------
# SRS
# ---------------------------------------------------------------------------
def _fixed_base_tables(device) -> G1:
    """(32, 256) Jacobian points d * 2^(8w) * G (affine, z = mont(1); d = 0
    is infinity), built with host ints."""
    Fq = fq()
    pts = []
    base = G1_GEN
    for _ in range(32):
        row = [None]
        acc = None
        for _ in range(255):
            acc = host_g1_add(acc, base)
            row.append(acc)
        pts.extend(row)
        for _ in range(8):
            base = host_g1_add(base, base)
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    mont = lambda vals: torch.as_tensor(  # noqa: E731
        Fq.from_ints([v * Fq.R for v in vals]), device=device
    ).reshape(32, 256, 32)
    z = torch.as_tensor(
        np.array([[0] * 32 if p is None else list(Fq.ONE_MONT) for p in pts],
                 np.uint8), device=device).reshape(32, 256, 32)
    inf = g1_infinity((32, 256), device)
    is_inf = z.eq(0).all(-1, keepdim=True)
    return G1(torch.where(is_inf, inf.x, mont(xs)),
              torch.where(is_inf, inf.y, mont(ys)), z)


def srs_g1_powers(n: int, tau: int, device) -> G1:
    """[tau^i] G for i < n in affine layout (z = mont(1)): a batched
    fixed-base ladder over the scalars' bytes, one complete add (kernel
    K5) per window, then one batched normalisation (kernel K1)."""
    scal, s = [], 1
    for _ in range(n):
        scal.append(s)
        s = s * tau % R
    digits = torch.as_tensor(fr().from_ints(scal), device=device).to(torch.int64)
    table = _fixed_base_tables(device)
    acc = None
    for w in range(32):
        term = G1(*(t[w][digits[:, w]] for t in table))
        acc = term if acc is None else g1_add(acc, term)
    return g1_normalize(acc)


@dataclasses.dataclass
class Srs:
    """Powers-of-tau SRS: [tau^i]G1 for i < n, plus [1]G2 and [tau]G2.
    `g1_powers` lives on the device; the G2 side stays host ints."""

    k: int
    g1_powers: G1  # (n, 32) coords, Montgomery Fq digits
    g2: tuple
    s_g2: tuple

    @classmethod
    def unsafe_setup(cls, k: int, tau: int | None = None, device=None) -> "Srs":
        """Test-only SRS with a known tau; G1 powers equal the reference's
        bit for bit."""
        dev = resolve(device)
        n = 1 << k
        tau = tau if tau is not None else 0xC0FFEE ^ (k << 32)
        tau %= R
        g1_powers = srs_g1_powers(n, tau, dev)
        s_g2 = pr.g2_scalar_mul(pr.G2_GENERATOR, tau)
        return cls(k=k, g1_powers=g1_powers, g2=pr.G2_GENERATOR, s_g2=s_g2)

    @property
    def device(self):
        return self.g1_powers.x.device

    def commit(self, coeffs) -> G1:
        """coeffs: (m, 32) u8 Montgomery digits, m <= n -> one point."""
        out = self.commit_points(coeffs[None])
        return G1(*(c[0] for c in out))

    def commit_points(self, coeff_cols) -> G1:
        """(c, m, 32) Montgomery coefficient columns -> (c,) Jacobian points."""
        m = coeff_cols.shape[-2]
        plain = F.from_mont(coeff_cols)  # MSM scalars are plain LE bytes
        pts = G1(*(c[:m] for c in self.g1_powers))
        return msm_many(pts, plain)

    def commit_affine(self, coeffs):
        """coeffs -> affine (x, y) int pair (None = infinity)."""
        return self.commit_many(coeffs[None])[0]

    def commit_many(self, coeff_cols) -> list:
        """(c, m, 32) stacked Montgomery coefficient columns -> list of c
        affine points (host ints), from one multi-column MSM."""
        return g1_to_affine_ints(self.commit_points(coeff_cols))


def srs_file(path: str | None, k: int, device=None) -> Srs:
    """The SRS of degree k kept in the file `path`: loaded from it, or set
    up (Srs.unsafe_setup(k)) and stored there.  The file holds host arrays
    (the G1 powers' digit planes and the G2 points), so it loads onto any
    device.  With `path` None the SRS is only set up."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            d = pickle.load(f)
        return Srs(k=d["k"], g2=d["g2"], s_g2=d["s_g2"],
                   g1_powers=G1(*(torch.as_tensor(a, device=resolve(device))
                                  for a in d["g1_powers"])))
    with timer(f"SRS setup k={k}"):
        srs = Srs.unsafe_setup(k, device=device)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"k": srs.k, "g2": srs.g2, "s_g2": srs.s_g2,
                         "g1_powers": [c.cpu().numpy() for c in srs.g1_powers]}, f)
    return srs


# ---------------------------------------------------------------------------
# host-side scalar helpers (transcript-adjacent, tiny data)
# ---------------------------------------------------------------------------
def host_eval_poly(coeffs_int: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs_int):
        acc = (acc * x + c) % R
    return acc


def lagrange_interpolate(points: list[int], values: list[int]) -> list[int]:
    """Coefficients of the unique poly of degree < len(points) through
    (points[i], values[i]).  Host ints, O(m^2): Z(X) = prod (X - p_j) once,
    each basis numerator Z(X) / (X - p_i) by synthetic division (a
    circuit that queries a column at hundreds of rotations opens it at a
    point set that large)."""
    m = len(points)
    z = vanishing_poly(points)
    coeffs = [0] * m
    for i, pi in enumerate(points):
        num = [0] * m
        carry = 0
        for d in range(m, 0, -1):
            carry = (z[d] + carry * pi) % R
            num[d - 1] = carry
        denom = 1
        for j, pj in enumerate(points):
            if j != i:
                denom = denom * (pi - pj) % R
        scale = values[i] * pow(denom, -1, R) % R
        for d in range(m):
            coeffs[d] = (coeffs[d] + num[d] * scale) % R
    return coeffs


def poly_mul_linear(coeffs: list[int], c: int) -> list[int]:
    """coeffs(X) * (X + c), host ints."""
    out = [0] * (len(coeffs) + 1)
    for i, a in enumerate(coeffs):
        out[i] = (out[i] + a * c) % R
        out[i + 1] = (out[i + 1] + a) % R
    return out


def vanishing_poly(points: list[int]) -> list[int]:
    """prod_p (X - p), host ints, lowest coefficient first."""
    out = [1]
    for p in points:
        out = poly_mul_linear(out, (-p) % R)
    return out


# ---------------------------------------------------------------------------
# device-side poly utilities
# ---------------------------------------------------------------------------
def eval_at(coeffs, x_int: int) -> int:
    """Evaluate a (m, 32) Montgomery coefficient array at a host scalar."""
    return eval_batch(coeffs[None], x_int)[0]


def eval_batch(stack, x_int: int) -> list[int]:
    """Evaluate a (q, m, 32) batch of Montgomery coefficient arrays at one
    host scalar: power table, broadcast multiply, log-depth add tree."""
    m = stack.shape[-2]
    pw = F.power_table(x_int, m, stack.device)
    terms = F.mul(stack, pw)
    s = _tree_sum_rows(terms)
    return F.to_ints(F.from_mont(s))


def _tree_sum_rows(x):
    """(..., m, 32) -> (..., 32) log-depth field sum over axis -2."""
    m = x.shape[-2]
    pot = 1 << (m - 1).bit_length() if m > 1 else 1
    if pot != m:
        pad = x.new_zeros(*x.shape[:-2], pot - m, 32)
        x = torch.cat([x, pad], dim=-2)
        m = pot
    while m > 1:
        half = m // 2
        x = F.add(x[..., :half, :], x[..., half:, :])
        m = half
    return x[..., 0, :]


def divide_by_vanishing_coset(num_coeffs, zs_points: list[int], k: int):
    """num(X) / prod(X - p) computed on the coset g*H of size 2^k.
    `num_coeffs`: (n, 32) Montgomery coeffs of a poly divisible by Z_S."""
    n = 1 << k
    assert num_coeffs.shape[0] == n
    evals = coset_ntt(num_coeffs, k)
    zs_inv = _coset_vanishing_inv(tuple(zs_points), k, num_coeffs.device)
    return coset_intt(F.mul(evals, zs_inv), k)


def _coset_vanishing_inv(zs_points: tuple, k: int, device):
    """Montgomery digits of 1 / Z_S(g*omega^i) for i < 2^k."""
    from ..crypto.params import FR_GENERATOR
    from .domain import domain

    dom = domain(k)
    xs = F.mul(F.power_table(dom.omega, dom.n, device),
               F.scalar(FR_GENERATOR, device))
    acc = F.ones_mont((dom.n,), device)
    for p in zs_points:
        acc = F.mul(acc, F.sub(xs, F.scalar(p, device).expand_as(xs)))
    return F.batch_inv(acc, axis=0)


# ---------------------------------------------------------------------------
# SHPLONK multiopen
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Query:
    """One opening claim: poly (coeff form, device) evaluated at point."""

    poly: object  # (n, 32) Montgomery coeffs
    point: int
    eval: int
    commitment: tuple


def _group_by_point_set(queries: list[Query]):
    """Group query indices by the SET of points their poly is opened at
    (polys are identified by object identity, as in the reference)."""
    by_poly: dict[int, list[int]] = {}
    for qi, q in enumerate(queries):
        by_poly.setdefault(id(q.poly), []).append(qi)
    groups: dict[frozenset, list[list[int]]] = {}
    for qis in by_poly.values():
        pts = frozenset(queries[qi].point for qi in qis)
        groups.setdefault(pts, []).append(qis)
    return groups


def shplonk_open(srs: Srs, queries: list[Query], transcript) -> None:
    """Prover side.  Appends W1, W2 to the transcript."""
    k = srs.k
    n = 1 << k
    dev = srs.device
    gamma = transcript.squeeze_challenge()

    groups = _group_by_point_set(queries)
    h = F.zeros((n,), dev)
    c = 0
    group_data = []
    for pts, polys in groups.items():
        pts_l = sorted(pts)
        merged = F.zeros((n,), dev)
        r_vals: dict[int, int] = {p: 0 for p in pts_l}
        for qis in polys:
            w = pow(gamma, c, R)
            c += 1
            poly = queries[qis[0]].poly
            merged = F.add(merged, F.mul(poly, F.scalar(w, dev)))
            evals = {queries[qi].point: queries[qi].eval for qi in qis}
            for p in pts_l:
                r_vals[p] = (r_vals[p] + w * evals[p]) % R
        r_coeffs = lagrange_interpolate(pts_l, [r_vals[p] for p in pts_l])
        r_dev = torch.as_tensor(
            F.from_ints([v * F.R % R for v in r_coeffs] + [0] * (n - len(r_coeffs))),
            device=dev,
        )
        hk = divide_by_vanishing_coset(F.sub(merged, r_dev), pts_l, k)
        h = F.add(h, hk)
        group_data.append((pts_l, merged, r_vals))

    transcript.write_point(srs.commit_affine(h))
    u = transcript.squeeze_challenge()

    # L(X) = sum_k gamma^{c_k} Z_{S_k}(u)^{-1} (g_k(X) - r_k(u)) - h(X)
    L = F.mul(h, F.scalar(R - 1, dev))
    for pts_l, merged, r_vals in group_data:
        zs_u = 1
        for p in pts_l:
            zs_u = zs_u * (u - p) % R
        zinv = pow(zs_u, -1, R)
        r_coeffs = lagrange_interpolate(pts_l, [r_vals[p] for p in pts_l])
        r_u = host_eval_poly(r_coeffs, u)
        const = F.sub(merged[0:1], F.scalar(r_u, dev)[None])
        shifted = torch.cat([const, merged[1:]], dim=0)
        L = F.add(L, F.mul(shifted, F.scalar(zinv, dev)))

    w2_poly = divide_by_vanishing_coset(L, [u], k)
    transcript.write_point(srs.commit_affine(w2_poly))


@dataclasses.dataclass
class VerifierQuery:
    commitment: tuple | None  # affine ints, or None => scalar claim only
    point: int
    eval: int
    poly_id: int  # queries with the same id belong to one polynomial


def shplonk_verify(srs_g2, queries: list[VerifierQuery], transcript) -> bool:
    """Verifier side (host ints).  `srs_g2` = (g2, s_g2).  Reads W1, W2
    and checks e(W2, [s]_2 - u [1]_2) = e(-C_L, [1]_2)."""
    g2, s_g2 = srs_g2
    gamma = transcript.squeeze_challenge()

    by_poly: dict[int, list[VerifierQuery]] = {}
    order: list[int] = []
    for q in queries:
        if q.poly_id not in by_poly:
            order.append(q.poly_id)
        by_poly.setdefault(q.poly_id, []).append(q)
    groups: dict[frozenset, list[list[VerifierQuery]]] = {}
    gorder = []
    for pid in order:
        qs = by_poly[pid]
        pts = frozenset(q.point for q in qs)
        if pts not in groups:
            gorder.append(pts)
        groups.setdefault(pts, []).append(qs)

    w1 = transcript.read_point()
    u = transcript.squeeze_challenge()

    # C_L = sum_j scal_j [C_j] - const [1] - W1, as one host MSM (the
    # same point as a double-and-add a commitment, in a fraction of the
    # time: the queries number in the thousands for the SuperCircuit)
    comms, scals = [], []
    const_scalar = 0
    c = 0
    for pts in gorder:
        pts_l = sorted(pts)
        zs_u = 1
        for p in pts_l:
            zs_u = zs_u * (u - p) % R
        zinv = pow(zs_u, -1, R)
        for qs in groups[pts]:
            w = pow(gamma, c, R)
            c += 1
            evals = {q.point: q.eval for q in qs}
            r_coeffs = lagrange_interpolate(pts_l, [evals[p] for p in pts_l])
            r_u = host_eval_poly(r_coeffs, u)
            scal = w * zinv % R
            comms.append(qs[0].commitment)
            scals.append(scal)
            const_scalar = (const_scalar + scal * r_u) % R

    acc = host_msm(comms + [G1_GEN, w1],
                   scals + [(R - const_scalar) % R, R - 1])  # ... - W1

    w2 = transcript.read_point()
    lhs_pt = host_g1_add(host_g1_mul(w2, u), acc)
    neg = lambda p: None if p is None else (p[0], (-p[1]) % FQ_MODULUS)  # noqa: E731
    return pr.pairing_product_is_one([(w2, s_g2), (neg(lhs_pt), g2)])
