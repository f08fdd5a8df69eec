"""Sharded hot ops of the prover over a torch.distributed process group
(port of zkevm_circuits_tpu/parallel/sharding.py).

The layout is SPMD: every rank runs the whole prover with the same `rng`,
so the host state and the transcript are the same on every rank.  Each hot
op takes the full tensor, works on this rank's rows [r L, (r + 1) L),
L = n / D, and all_gathers its result back to the full tensor.  (In the
reference the outputs stay sharded between ops; gathering them is the
port's one departure.)

  * `make_sharded_commit`: commit one or many coefficient columns against
    the row-split SRS: a local multi-column MSM per rank, one all_gather of
    the partial points, a tree sum (poly/msm.py `msm_sharded_body`).
  * `make_sharded_prefix_product` / `make_sharded_prefix_sum`: the grand
    products and the logUp running sum as two-level scans: local inclusive
    scan, all_gather of the block totals, the exclusive fold of the totals
    before this rank, a shift by one row.
  * the transforms: poly/ntt.py `make_sharded_ntt` (the four-step body with
    three all_to_alls; the radix-2 ladder, kernel K4, with one rank).

The group's backend and the tensors' device must agree: NCCL with CUDA,
gloo with the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..crypto.curve import G1, g1_to_affine_ints
from ..crypto.field import fr
from ..poly.msm import local_points, msm_sharded_body
from ..poly.ntt import gather_rows, local_rows, make_sharded_ntt

F = fr()

BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def check_backend(group, device) -> None:
    """Raise unless the process group's backend can carry tensors of
    `device`."""
    backend = dist.get_backend(group)
    if BACKEND_DEVICE.get(str(backend)) != torch.device(device).type:
        raise ValueError(
            f"a {backend} process group cannot carry {torch.device(device)} "
            f"tensors (nccl goes with cuda, gloo with cpu)")


def make_sharded_commit(group):
    """(points (n,), scalar columns (c, n, 32) plain bytes) -> (c,)
    Jacobian commitments, replicated; an (n, 32) column gives one point."""

    def fn(points: G1, cols: torch.Tensor) -> G1:
        out = msm_sharded_body(local_points(points, group),
                               local_rows(cols if cols.dim() == 3 else cols[None],
                                          group), group)
        return out if cols.dim() == 3 else G1(*(t[0] for t in out))

    return fn


def _make_exclusive_scan(group, scan, op, identity):
    r = dist.get_rank(group)

    def fn(x: torch.Tensor) -> torch.Tensor:
        incl = scan(local_rows(x, group), 0)
        totals = gather_rows(incl[-1:], group)  # (D, 32)
        offset = identity(x.device)
        for i in range(r):
            offset = op(offset, totals[i])
        shifted = torch.cat([offset[None], op(incl[:-1], offset)], dim=0)
        return gather_rows(shifted, group)

    return fn


def make_sharded_prefix_sum(group):
    """Exclusive prefix SUM of (n, 32) Montgomery rows over the ranks of
    `group` (the logUp running-sum phi column)."""
    return _make_exclusive_scan(group, F.prefix_sum, F.add,
                                lambda dev: F.zeros((), dev))


def make_sharded_prefix_product(group):
    """Exclusive prefix product of (n, 32) Montgomery rows over the ranks
    of `group`: local inclusive scan, all_gather of the rank totals,
    multiply by the product of the totals of the ranks before this one,
    then shift right by one row (the first row takes that product)."""
    return _make_exclusive_scan(group, F.prefix_product, F.mul,
                                lambda dev: F.ones_mont((), dev))


# ---------------------------------------------------------------------------
# ProverMesh: the bundle of sharded hot ops prove() swaps in
# ---------------------------------------------------------------------------
class ProverMesh:
    """Process-group execution context for `plonk.prover.prove(mesh=...)`.

    Replaces the prover's hot primitives with row-sharded versions:
      * NTT / iNTT at k and coset NTT / iNTT at k_ext
        (`poly.ntt.make_sharded_ntt`)
      * column commitments: per-rank partial MSM + all_gather tree sum
      * permutation / lookup grand products and the logUp running sum:
        two-level scans
    All ops are exact field arithmetic, so a D-rank proof is byte-identical
    to the single-device proof for the same blinding rng.  Commitments
    always go through the sharded MSM, whatever the device and size."""

    def __init__(self, group, k: int, k_ext: int, srs):
        from ..poly.domain import domain

        dev = srs.device
        check_backend(group, dev)
        D = dist.get_world_size(group)
        assert D & (D - 1) == 0, f"the rank count must be a power of two (D={D})"
        assert (1 << k) // D >= D, f"four-step layout needs n/D >= D (k={k}, D={D})"
        self.group, self.k, self.k_ext = group, k, k_ext
        self._ntt_k = make_sharded_ntt(group, k)
        self._intt_k = make_sharded_ntt(group, k, inverse=True)
        self._ntt_ext = make_sharded_ntt(group, k_ext)
        self._intt_ext = make_sharded_ntt(group, k_ext, inverse=True)
        self._pprod = make_sharded_prefix_product(group)
        self._psum = make_sharded_prefix_sum(group)
        dext = domain(k_ext)
        self._coset_pw = torch.as_tensor(dext.coset_powers, device=dev)
        self._coset_pw_inv = torch.as_tensor(dext.coset_powers_inv, device=dev)
        self._pts = G1(*(c[:1 << k] for c in srs.g1_powers))
        self._commit = make_sharded_commit(group)

    # -- transforms -------------------------------------------------------
    def ntt(self, x, k: int | None = None):
        assert k is None or k == self.k
        return self._ntt_k(x)

    def intt(self, x, k: int | None = None):
        assert k is None or k == self.k
        return self._intt_k(x)

    def coset_ntt_ext(self, coeffs):
        """coeffs (..., n_ext, 32) -> evals on g*H_ext."""
        return self._ntt_ext(F.mul(coeffs, self._coset_pw))

    def coset_intt_ext(self, evals):
        return F.mul(self._intt_ext(evals), self._coset_pw_inv)

    # -- commitments ------------------------------------------------------
    def commit_many(self, coeff_cols) -> list:
        """(c, n, 32) Montgomery coefficient columns -> c affine (x, y) int
        pairs (None = infinity), from one sharded multi-column MSM."""
        return g1_to_affine_ints(self._commit(self._pts, F.from_mont(coeff_cols)))

    def commit_affine(self, coeffs):
        """(n, 32) Montgomery coeffs -> affine (x, y) int pair."""
        return self.commit_many(coeffs[None])[0]

    # -- grand products / running sums -------------------------------------
    def exclusive_prefix_product(self, ratio, u: int, n: int):
        row = torch.arange(n, device=ratio.device)
        ratio = F.select(row < u, ratio, F.ones_mont((n,), ratio.device))
        return self._pprod(ratio)

    def exclusive_prefix_sum(self, delta):
        return self._psum(delta)
