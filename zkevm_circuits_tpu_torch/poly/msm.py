"""Pippenger multi-scalar multiplication over BN254 G1 (port of
zkevm_circuits_tpu/poly/msm.py, the lane-private scan path of `msm()`).

  * Window size 8 bits, aligned with the byte-digit scalar layout: 32
    windows, all processed at once as a batch axis.  Below SMALL_N points
    the windows are nibbles (64 windows of 16 buckets): there the fixed
    256-bucket reduction, not the points, would dominate the work.
  * Lane-private buckets: points stream in blocks of `default_lanes(n)`; each
    (lane, window) pair owns a private 256-entry bucket array, so a step is
    one conflict-free in-place bucket update (kernel K5's bucket form:
    bucket [c, l, w, digit] += point [l]).  Digit 0 adds nothing: bucket 0
    has weight 0 and is never read.
  * Several scalar columns against the same points share every step (the
    column axis is one more batch axis), so a multi-column commit costs the
    sequential steps of one MSM.
  * Lanes and buckets reduce by log-depth halving trees (the reference
    folds them with a sequential scan to keep its XLA graph small; eager
    PyTorch has no graph, and a tree launches log2 of the adds).  The
    bucket weighting sum_b b B_b runs over the 8 bits of b, then a Horner
    over bits and one over windows (8 doublings per window step, one K6
    launch).

Results are equal to the reference's as group elements; compare them in
affine form.  Scalars are (n, 32) uint8 little-endian bytes (plain, not
Montgomery).

`make_sharded_msm` splits the rows over the ranks of a torch.distributed
group: a local MSM per rank, then an all_gather of the partial points and
a tree sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..crypto.curve import G1, g1_add, g1_bucket_add, g1_double, g1_infinity

SMALL_N = 1 << 11  # below this, 4-bit windows
BUCKET_BYTES_BUDGET = 4 << 30  # bucket arrays of one column group


def default_lanes(n: int) -> int:
    """Lane width: wide enough to fill the device, small enough that the
    (lanes, 32, 256) private bucket arrays stay ~100s of MB."""
    return max(1, min(512, 1 << max(0, (n.bit_length() - 4))))


def g1_tree_sum(p: G1, axis: int = 0) -> G1:
    """Sum a batch of points along `axis` by halving (log depth)."""
    m = p.x.shape[axis]
    pot = 1 << (m - 1).bit_length() if m > 1 else 1
    if pot != m:
        shape = list(p.x.shape[:-1])
        shape[axis] = pot - m
        pad = g1_infinity(tuple(shape), p.x.device)
        p = G1(*(torch.cat([a, b], dim=axis) for a, b in zip(p, pad)))
        m = pot
    while m > 1:
        half = m // 2
        p = g1_add(G1(*(c.narrow(axis, 0, half) for c in p)),
                   G1(*(c.narrow(axis, half, half) for c in p)))
        m = half
    return G1(*(c.select(axis, 0) for c in p))


def _bucket_weighted_sum(buckets: G1, wbits: int) -> G1:
    """sum_b b * B_b over the bucket axis (-2 of the batch, 2^wbits long),
    through the bits of b: sum_j 2^j (sum of buckets with bit j set)."""
    dev = buckets.x.device
    lead = buckets.x.shape[:-2]
    b_idx = torch.arange(1 << wbits, device=dev)
    bits = ((b_idx[None, :] >> torch.arange(wbits, device=dev)[:, None]) & 1) == 1
    mask = bits.reshape(wbits, *([1] * len(lead)), 1 << wbits, 1)
    inf = g1_infinity((), dev)
    masked = G1(*(torch.where(mask, c[None], i) for c, i in zip(buckets, inf)))
    s = g1_tree_sum(masked, axis=1 + len(lead))  # (wbits, *lead)
    acc = G1(*(c[wbits - 1] for c in s))
    for i in range(wbits - 2, -1, -1):
        acc = g1_add(g1_double(acc), G1(*(c[i] for c in s)))
    return acc


def _window_digits(scalars_u8: torch.Tensor, wbits: int) -> torch.Tensor:
    """(..., 32) scalar bytes -> (..., 256 / wbits) uint8 window digits,
    least significant window first."""
    d = scalars_u8.to(torch.uint8)
    if wbits == 8:
        return d
    return torch.stack((d & 15, d >> 4), dim=-1).reshape(*d.shape[:-1], 64)


def _msm_group(points: G1, scalars_u8: torch.Tensor, lanes: int,
               wbits: int) -> G1:
    """points (n,), scalars (c, n, 32) -> (c,) Jacobian sums."""
    dev = points.x.device
    n_win, n_buck = 256 // wbits, 1 << wbits
    c, n = scalars_u8.shape[:2]
    steps = -(-n // lanes)
    pad = steps * lanes - n
    px, py, pz = points
    if pad:
        inf = g1_infinity((pad,), dev)
        px, py, pz = (torch.cat([a, b]) for a, b in zip((px, py, pz), inf))
        scalars_u8 = torch.cat(
            [scalars_u8, scalars_u8.new_zeros(c, pad, 32)], dim=1)
    pts = [t.reshape(steps, lanes, 32) for t in (px, py, pz)]
    # (steps, c, lanes, n_win): each step's digits one contiguous block
    digits = _window_digits(scalars_u8, wbits).reshape(
        c, steps, lanes, n_win).transpose(0, 1).contiguous()

    acc = g1_infinity((c, lanes, n_win, n_buck), dev)
    for s in range(steps):
        g1_bucket_add(acc, digits[s], G1(*(t[s] for t in pts)))
    buckets = g1_tree_sum(acc, axis=1)  # (c, n_win, n_buck)
    wsum = _bucket_weighted_sum(buckets, wbits)  # (c, n_win) window sums
    # Horner from the most significant window down
    res = G1(*(t[:, n_win - 1] for t in wsum))
    for w in range(n_win - 2, -1, -1):
        res = g1_add(g1_double(res, wbits), G1(*(t[:, w] for t in wsum)))
    return res


def msm_many(points: G1, scalars_u8: torch.Tensor) -> G1:
    """sum_i scalars[j, i] * points[i] for each column j of a (c, n, 32)
    scalar stack -> (c,) Jacobian points.  Columns run in groups whose
    bucket arrays fit BUCKET_BYTES_BUDGET."""
    c, n = scalars_u8.shape[:2]
    lanes = default_lanes(n)
    wbits = 4 if n < SMALL_N else 8
    per_col = 3 * lanes * (256 // wbits) * (1 << wbits) * 32
    group = max(1, BUCKET_BYTES_BUDGET // per_col)
    parts = [_msm_group(points, scalars_u8[s:s + group], lanes, wbits)
             for s in range(0, c, group)]
    return G1(*(torch.cat(cs) for cs in zip(*parts)))


def msm(points: G1, scalars_u8) -> G1:
    """sum_i scalars[i] * points[i] -> single Jacobian point."""
    s = scalars_u8 if isinstance(scalars_u8, torch.Tensor) else \
        torch.as_tensor(scalars_u8, device=points.x.device)
    out = msm_many(points, s[None])
    return G1(*(t[0] for t in out))


def msm_sharded_body(points: G1, scalars_u8: torch.Tensor, group) -> G1:
    """This rank's rows: points (L,), scalar columns (c, L, 32) -> (c,)
    Jacobian sums over all ranks, the same on every rank.  The local MSM
    runs through `msm_many`; the D partial points are all_gathered and
    summed by a log-depth tree (point addition is no reduction op of a
    collective; one point per rank and column crosses the wire)."""
    local = msm_many(points, scalars_u8)
    d = dist.get_world_size(group)
    parts = []
    for coord in local:
        got = [torch.empty_like(coord) for _ in range(d)]
        dist.all_gather(got, coord.contiguous(), group=group)
        parts.append(torch.stack(got))  # (D, c, 32)
    return g1_tree_sum(G1(*parts), axis=0)


def local_points(points: G1, group) -> G1:
    """This rank's rows [r L, (r + 1) L) of an (n,) point array."""
    d, r = dist.get_world_size(group), dist.get_rank(group)
    size = points.x.shape[0] // d
    return G1(*(c[r * size:(r + 1) * size] for c in points))


def make_sharded_msm(group):
    """(points (n,), scalars (n, 32)) -> one Jacobian point, replicated:
    each rank sums its rows of both, see `msm_sharded_body`."""
    d, r = dist.get_world_size(group), dist.get_rank(group)

    def fn(points: G1, scalars_u8: torch.Tensor) -> G1:
        size = scalars_u8.shape[0] // d
        out = msm_sharded_body(local_points(points, group),
                               scalars_u8[None, r * size:(r + 1) * size], group)
        return G1(*(t[0] for t in out))

    return fn
