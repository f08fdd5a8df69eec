"""Key generation (port of zkevm_circuits_tpu/plonk/keygen.py).

Precomputes the fixed column commitments, the permutation argument's sigma
polynomials (from the circuit's copy constraints), the Lagrange helpers
(l_0, l_last, l_active) and the extended-coset tables the quotient needs.
Sigmas follow halo2: cell (column c, row i) is labelled delta^c omega^i,
copy constraints merge labels into cycles, and sigma_c(omega^i) is the
label of the next cell in the cycle.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..crypto.field import fr
from ..crypto.params import FR_GENERATOR, FR_MODULUS as R, FR_TWO_ADICITY
from ..device import resolve
from ..poly.domain import domain
from ..poly.kzg import Srs
from ..poly.ntt import coset_ntt, intt
from .circuit import Circuit, ConstraintSystem, assemble_fixed, usable_rows

F = fr()

DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, R)


def ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def quotient_degree(cs: ConstraintSystem) -> int:
    """Max constraint degree across gates + permutation + lookup arguments."""
    d = 2
    for g in cs.gates:
        for p in g.polys:
            d = max(d, p.degree())
    if cs.perm_columns:
        d = max(d, len(cs.perm_columns) + 2)
    for lk in cs.lookups:
        di = max((e.degree() for e in lk.inputs), default=1)
        dt = max((e.degree() for e in lk.tables), default=1)
        d = max(d, 2 + di + dt, 4)
    for lg in cs.logups:
        for tup in lg.inputs:
            d = max(d, 2 + max((e.degree() for e in tup), default=1))
        d = max(d, 2 + max((e.degree() for e in lg.table), default=1))
    return d


@dataclasses.dataclass
class VerifyingKey:
    k: int
    cs: ConstraintSystem
    fixed_commitments: list  # affine ints per fixed column
    sigma_commitments: list  # affine ints per permutation column
    g2: tuple
    s_g2: tuple

    @property
    def n(self):
        return 1 << self.k

    @functools.cached_property
    def omega(self):
        return domain(self.k).omega


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    # device tables, all Montgomery digit tensors
    fixed_evals: torch.Tensor  # (nf, n, 32)
    fixed_coeffs: torch.Tensor  # (nf, n, 32)
    sigma_evals: torch.Tensor  # (np, n, 32)
    sigma_coeffs: torch.Tensor  # (np, n, 32)
    k_ext: int
    fixed_ext: torch.Tensor  # (nf, n_ext, 32)
    sigma_ext: torch.Tensor  # (np, n_ext, 32)
    l0_ext: torch.Tensor  # (n_ext, 32)
    llast_ext: torch.Tensor
    lactive_ext: torch.Tensor
    x_ext: torch.Tensor  # evals of the identity poly X on the extended coset
    t_inv_ext: torch.Tensor  # 1 / (X^n - 1) on the extended coset
    delta_pows: list  # host ints delta^c per perm column

    @property
    def k(self):
        return self.vk.k

    @property
    def n(self):
        return 1 << self.vk.k


def _to_ext(coeffs, n: int, k_ext: int):
    pad = coeffs.new_zeros(*coeffs.shape[:-2], (1 << k_ext) - n, 32)
    return coset_ntt(torch.cat([coeffs, pad], dim=-2), k_ext)


def _lagrange_indicators_ext(row_sets, k: int, k_ext: int, device):
    """Extended-coset evals of the polys that are 1 on the H-rows of each
    set, else 0 (one batched transform for all sets)."""
    n = 1 << k
    vals = np.zeros((len(row_sets), n, 32), np.uint8)
    one = F.from_int(F.R)  # Montgomery 1
    for si, rows in enumerate(row_sets):
        vals[si, list(rows)] = one
    coeffs = intt(torch.as_tensor(vals, device=device), k)
    return _to_ext(coeffs, n, k_ext)


def _copy_cycles(circuit: Circuit, cs: ConstraintSystem, n: int):
    """The permutation's cycles as (cells, next): every cell of a copy
    constraint as c * n + row (c its index in cs.perm_columns), each cycle
    sorted by (c, row), and next[j] the cell after cells[j] in its cycle
    (the first after the last), as halo2 and the reference lay them out.
    The components come from label propagation with pointer jumping over
    the copy edges, in numpy."""
    col_index = {pc: i for i, pc in enumerate(cs.perm_columns)}
    flat = [(col_index[(a.kind, a.col)] * n + a.row, col_index[(b.kind, b.col)] * n + b.row)
            for a, b in circuit.copy_constraints(n)]
    if not flat:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ends = np.asarray(flat, np.int64)
    cells, inv = np.unique(ends, return_inverse=True)
    ea, eb = inv.reshape(-1, 2).T
    lab = np.arange(len(cells))
    while True:
        lo = np.minimum(lab[ea], lab[eb])
        new = lab.copy()
        np.minimum.at(new, ea, lo)
        np.minimum.at(new, eb, lo)
        new = new[new]
        if np.array_equal(new, lab):
            break
        lab = new
    order = np.lexsort((cells, lab))
    cells, lab = cells[order], lab[order]
    first = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    nxt = np.roll(cells, -1)
    last = np.r_[first[1:], len(cells)] - 1
    nxt[last] = cells[first]
    return cells, nxt


def keygen(circuit: Circuit, k: int, srs: Srs, device=None, timings=None):
    """(pk, vk) for `circuit` at degree k.  `timings`, when a dict, gets
    the seconds of each keygen phase."""
    dev = resolve(device)
    marks = timings if timings is not None else {}
    t0 = time.perf_counter()

    def _mark(stage: str):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        marks[stage] = marks.get(stage, 0.0) + now - t0
        t0 = now

    cs = ConstraintSystem()
    circuit.configure(cs)
    n = 1 << k
    dom = domain(k)

    # ---- fixed columns ------------------------------------------------------
    if cs.num_fixed == 0:
        fixed_np = np.zeros((1, n, 32), np.uint8)
    else:
        fixed_np = assemble_fixed(circuit, cs, n)
    fixed_evals = torch.as_tensor(np.ascontiguousarray(fixed_np), device=dev)
    fixed_coeffs = intt(fixed_evals, k)
    _mark("fixed")

    # ---- permutation sigmas -------------------------------------------------
    perm_cols = cs.perm_columns
    npc = len(perm_cols)
    delta_pows = [pow(DELTA, c, R) for c in range(max(npc, 1))]
    omega_pw = F.power_table(dom.omega, n, dev)
    ident = F.mul(omega_pw[None],
                  torch.stack([F.scalar(d, dev) for d in delta_pows])[:, None])
    sig = ident.clone()
    cells, nxt = _copy_cycles(circuit, cs, n)
    if len(cells):
        # sigma at a cycle member is the identity label of the next one
        src = torch.as_tensor(cells, device=dev)
        dst = torch.as_tensor(nxt, device=dev)
        sig[src // n, src % n] = ident[dst // n, dst % n]
    sigma_evals = sig
    sigma_coeffs = intt(sigma_evals, k)
    _mark("sigmas")

    # ---- extended-coset tables ----------------------------------------------
    d = quotient_degree(cs)
    k_ext = k + ceil_log2(max(d - 1, 2))
    n_ext = 1 << k_ext
    fixed_ext = _to_ext(fixed_coeffs, n, k_ext)
    sigma_ext = _to_ext(sigma_coeffs, n, k_ext)
    _mark("ext tables")

    u = usable_rows(n)
    l0_ext, llast_ext, inact_ext = _lagrange_indicators_ext(
        [[0], [u], range(u, n)], k, k_ext, dev)
    lactive_ext = F.sub(F.ones_mont((n_ext,), dev), inact_ext)

    dom_ext = domain(k_ext)
    x_ext = F.mul(F.power_table(dom_ext.omega, n_ext, dev),
                  F.scalar(FR_GENERATOR, dev))
    gn = pow(FR_GENERATOR, n, R)
    wn = pow(dom_ext.omega, n, R)
    tvals = F.sub(F.mul(F.power_table(wn, n_ext, dev), F.scalar(gn, dev)),
                  F.ones_mont((n_ext,), dev))
    t_inv_ext = F.batch_inv(tvals, axis=0)
    _mark("lagrange/coset helpers")

    # ---- commitments -> vk (fixed and sigma columns in one MSM) ---------------
    parts = ([fixed_coeffs] if cs.num_fixed else []) + (
        [sigma_coeffs] if npc else [])
    comms = srs.commit_many(torch.cat(parts)) if parts else []
    nfc = fixed_coeffs.shape[0] if cs.num_fixed else 0
    fixed_comms, sigma_comms = comms[:nfc], comms[nfc:]
    _mark("commitments")

    vk = VerifyingKey(
        k=k, cs=cs, fixed_commitments=fixed_comms,
        sigma_commitments=sigma_comms, g2=srs.g2, s_g2=srs.s_g2,
    )
    pk = ProvingKey(
        vk=vk, fixed_evals=fixed_evals, fixed_coeffs=fixed_coeffs,
        sigma_evals=sigma_evals, sigma_coeffs=sigma_coeffs, k_ext=k_ext,
        fixed_ext=fixed_ext, sigma_ext=sigma_ext, l0_ext=l0_ext,
        llast_ext=llast_ext, lactive_ext=lactive_ext, x_ext=x_ext,
        t_inv_ext=t_inv_ext, delta_pows=delta_pows,
    )
    return pk, vk
