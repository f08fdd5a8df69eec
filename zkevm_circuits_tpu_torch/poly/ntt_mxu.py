"""Four-step NTT with each DFT pass as one exact integer matmul.

Port of zkevm_circuits_tpu/poly/ntt_mxu.py, same decomposition and
constants: n = n1 * n2 with k1 = k // 2, k2 = k - k1 (a third pass above
k = 20); each pass applies an r-point DFT to all columns at once as one
(63r x 32r) @ (32r x m) product against the digit-Toeplitz expansion of
the DFT matrix, whose T digits are exact integers < 2^31.

On the card the pieces are:
  * the pass matmul: `torch._int_mm` on int8 operands offset by -128 with
    rank-1 corrections, so the pass matrix stays u8-sized (2.1 GB at
    r = 1024) and the tensor cores' int8 path computes it exactly;
  * the wide REDC of T (kernel K3, ops/cuda_field.redc34);
  * the twiddle multiply between the passes (kernel K2,
    ops/cuda_field.twiddle_mul), which indexes the (n1, n2) table.
CPU tensors run the same code with the kernels' plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto.field import ND, fr
from ..crypto.params import FR_GENERATOR, FR_MODULUS, FR_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..ops.cuda_field import redc34, twiddle_mul

F = fr()
P = FR_MODULUS
G_COSET = FR_GENERATOR
MAX_RADIX_K = 10  # int32 accumulator exactness bound (r <= 1024)
T_CHUNK_BYTES = 1 << 30  # int32 T of one matmul call stays below this


def _split_k(k: int) -> tuple[int, int]:
    k1 = k // 2
    k2 = k - k1
    assert k2 <= MAX_RADIX_K, f"k={k} > {2 * MAX_RADIX_K}: use the 3-pass path"
    return k1, k2


def _split_k3(k: int) -> tuple[int, int]:
    ka = k // 3
    kb = k - ka
    assert ka <= MAX_RADIX_K and kb <= 2 * MAX_RADIX_K, (
        f"k={k} > {3 * MAX_RADIX_K} needs 4 passes"
    )
    return ka, kb


def _omega(k: int, inverse: bool) -> int:
    w = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), P)
    return pow(w, P - 2, P) if inverse else w


def _pows(base: int, r: int) -> list[int]:
    out, acc = [], 1
    for _ in range(r):
        out.append(acc)
        acc = acc * base % P
    return out


# Wide REDC: a pass's r-term product sums T < r p^2 exceed the usual REDC
# bound, so the passes reduce by 2^272 (kernel K3); the extra 2^-16 is
# pre-compensated by baking 2^16 into the DFT matrices.
SHIFT16 = 1 << 16


def _digits(vals: list[int]) -> np.ndarray:
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, np.uint8).reshape(len(vals), ND).copy()


@functools.cache
def _pass_digits(r_k: int, w: int, col_scale: int, row_scale: int,
                 scale_all: int) -> np.ndarray:
    """(r, r, 32) Montgomery digits of
    W[i, k] = w^{ik} col_scale^k row_scale^i scale_all 2^16."""
    r = 1 << r_k
    wpow = _pows(w, r)
    cpow = _pows(col_scale % P, r)
    rpow = _pows(row_scale % P, r)
    base = (scale_all % P) * F.R % P * SHIFT16 % P
    vals = []
    for i in range(r):
        ri = rpow[i] * base % P
        vals.extend(wpow[(i * kk) % r] * cpow[kk] % P * ri % P for kk in range(r))
    return _digits(vals).reshape(r, r, ND)


_DEVICE_CACHE: dict = {}


def _pass_matrix(r_k: int, w: int, col_scale: int, row_scale: int,
                 scale_all: int, device) -> tuple:
    """The (63r, 32r) digit-Toeplitz pass matrix on `device`, as int8
    (u8 - 128), with its int32 row sums:
    What[(i, d), (kk, d1)] = digits(W[i, kk])[d - d1]."""
    key = ("pass", r_k, w, col_scale, row_scale, scale_all, str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    r = 1 << r_k
    wdig = torch.as_tensor(
        _pass_digits(r_k, w, col_scale, row_scale, scale_all), device=device
    )
    wt = wdig.permute(0, 2, 1)  # (r, 32, r): [i, d, kk]
    out = torch.zeros((r, 63, r, ND), dtype=torch.uint8, device=device)
    for d1 in range(ND):
        out[:, d1:d1 + ND, :, d1] = wt
    wq = (out.reshape(r * 63, r * ND) ^ 0x80).view(torch.int8)
    del out
    rows = wq.sum(dim=1, dtype=torch.int32)
    _DEVICE_CACHE[key] = (wq, rows)
    return wq, rows


def _twiddle_table(k: int, inverse: bool, col_scale: int, row_scale: int,
                   device) -> torch.Tensor:
    """(n1, n2, 32) Montgomery digits of w^{i1 j2} col^{j2} row^{i1}."""
    key = ("tw", k, inverse, col_scale, row_scale, str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        return hit
    k1, k2 = _split_k(k)
    n1, n2 = 1 << k1, 1 << k2
    w = _omega(k, inverse)
    rpow = _pows(row_scale % P, n1)
    cpow = _pows(col_scale % P, n2)
    vals = []
    for i1 in range(n1):
        wi_pows = _pows(pow(w, i1, P), n2)
        ri = rpow[i1] * F.R % P
        vals.extend(wi_pows[j2] * cpow[j2] % P * ri % P for j2 in range(n2))
    out = torch.as_tensor(_digits(vals).reshape(n1, n2, ND), device=device)
    _DEVICE_CACHE[key] = out
    return out


def dft_matmul(wq: torch.Tensor, rows: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Exact u8 product What @ X -> (63r, m) int32, with What given as int8
    (What - 128) plus its row sums and X given transposed, xt = X^T as
    (m, 32r) u8 (the int8 GEMM's column-major right operand).

    (Wq + 128)(Xq + 128) = Wq Xq + 128 rowsum(Wq) + 128 colsum(Xq) + 2^14 K,
    computed in wrapping int32: every true T digit is < 2^31."""
    m, kdim = xt.shape
    xq = (xt ^ 0x80).view(torch.int8)
    pad = (-m) % 8  # the int8 GEMM takes widths that are multiples of 8
    if pad:
        xq = torch.cat([xq, xq.new_zeros(pad, kdim)])
    t = torch._int_mm(wq, xq.t())[:, :m]
    cols = xq[:m].sum(dim=1, dtype=torch.int32)
    t += (rows * 128)[:, None]
    t += (cols * 128 + (kdim << 14))[None, :]
    return t


def _dft_pass(x: torch.Tensor, mat: tuple) -> torch.Tensor:
    """x: (r, m, 32) u8 -> (r, m, 32) u8, DFT over axis 0: one exact
    matmul per column chunk, then the wide REDC (kernel K3)."""
    wq, rows = mat
    r, m, _ = x.shape
    xt = x.permute(1, 0, 2).reshape(m, r * ND)
    step = max(8, (T_CHUNK_BYTES // (63 * r * 4)) // 8 * 8)
    outs = []
    for s in range(0, m, step):
        t = dft_matmul(wq, rows, xt[s:s + step])
        mc = t.shape[1]
        t = t.reshape(r, 63, mc).permute(0, 2, 1).reshape(r * mc, 63)
        outs.append(redc34(t).reshape(r, mc, ND))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


@functools.cache
def _gens(k: int, inverse: bool, coset: bool) -> tuple[int, int, int]:
    g_inv = pow(G_COSET, P - 2, P)
    col_gen = G_COSET if (coset and not inverse) else 1
    row_gen = g_inv if (coset and inverse) else 1
    scale_all = pow(1 << k, P - 2, P) if inverse else 1
    return col_gen, row_gen, scale_all


def _consts2(k: int, inverse: bool, col_gen: int, row_gen: int,
             scale_all: int, device):
    k1, k2 = _split_k(k)
    n1, n2 = 1 << k1, 1 << k2
    w = _omega(k, inverse)
    w1 = _pass_matrix(k1, pow(w, n2, P), pow(col_gen, n2, P), 1, 1, device)
    tw = _twiddle_table(k, inverse, col_gen, row_gen, device)
    w2 = _pass_matrix(k2, pow(w, n1, P), 1, pow(row_gen, n1, P), scale_all,
                      device)
    return w1, tw, w2


def _two_pass_body(x, w1, tw, w2, k: int):
    k1, k2 = _split_k(k)
    n1, n2 = 1 << k1, 1 << k2
    batch = x.shape[:-2]
    b = int(np.prod(batch)) if batch else 1
    y = x.reshape(b, n1, n2, ND)
    # pass 1: DFT_{n1} over j1
    y = y.permute(1, 0, 2, 3).reshape(n1, b * n2, ND)
    y = _dft_pass(y, w1).reshape(n1, b, n2, ND)
    y = twiddle_mul(y, tw)  # kernel K2
    # pass 2: DFT_{n2} over j2
    y = y.permute(2, 1, 0, 3).reshape(n2, b * n1, ND)
    y = _dft_pass(y, w2).reshape(n2, b, n1, ND)  # [i2, b, i1]
    # natural order: out[j] with j = i1 + n1*i2
    return y.permute(1, 0, 2, 3).reshape(*batch, n1 * n2, ND)


def _ab_tables(ka: int, kb: int, inverse: bool, col_gen: int, row_gen: int,
               device):
    """Outer twiddles of the 3-pass path, factored small (see the
    reference's `_ab_tables`)."""
    k = ka + kb
    w = _omega(k, inverse)
    kb1, kb2 = _split_k(kb)
    na, nb1, nb2 = 1 << ka, 1 << kb1, 1 << kb2
    tb, tc = [], []
    R_ = F.R
    for i1 in range(na):
        b = pow(w, i1, P) * col_gen % P
        bb = pow(b, nb2, P)
        acc = pow(row_gen, i1, P)
        for _ in range(nb1):
            tb.append(acc * R_ % P)
            acc = acc * bb % P
        acc = 1
        for _ in range(nb2):
            tc.append(acc * R_ % P)
            acc = acc * b % P
    return (torch.as_tensor(_digits(tb).reshape(na, nb1, ND), device=device),
            torch.as_tensor(_digits(tc).reshape(na, nb2, ND), device=device))


def _three_pass(x, k: int, inverse: bool, coset: bool):
    ka, kb = _split_k3(k)
    kb1, kb2 = _split_k(kb)
    na, nb = 1 << ka, 1 << kb
    nb1, nb2 = 1 << kb1, 1 << kb2
    dev = x.device
    col_gen, row_gen, scale_all = _gens(k, inverse, coset)
    w = _omega(k, inverse)
    wa = _pass_matrix(ka, pow(w, 1 << kb, P), pow(col_gen, 1 << kb, P), 1, 1, dev)
    tb, tc = _ab_tables(ka, kb, inverse, col_gen, row_gen, dev)
    w1, tw, w2 = _consts2(kb, inverse, 1, pow(row_gen, na, P), scale_all, dev)
    batch = x.shape[:-2]
    b = int(np.prod(batch)) if batch else 1
    y = x.reshape(b, na, nb, ND)
    y = y.permute(1, 0, 2, 3).reshape(na, b * nb, ND)
    y = _dft_pass(y, wa)
    y = y.reshape(na, b, nb1, nb2, ND)
    y = F.mul(y, tb[:, None, :, None, :])
    y = F.mul(y, tc[:, None, None, :, :])
    y = _two_pass_body(y.reshape(na, b, nb, ND), w1, tw, w2, kb)
    y = y.permute(1, 2, 0, 3)  # (b, nb, na, ND)
    return y.reshape(*batch, na * nb, ND)


def _ntt_mxu_impl(x, k: int, inverse: bool, coset: bool):
    if k > 2 * MAX_RADIX_K:
        return _three_pass(x, k, inverse, coset)
    col_gen, row_gen, scale_all = _gens(k, inverse, coset)
    w1, tw, w2 = _consts2(k, inverse, col_gen, row_gen, scale_all, x.device)
    return _two_pass_body(x, w1, tw, w2, k)


def _k_of(x, k):
    k = k if k is not None else int(x.shape[-2]).bit_length() - 1
    assert x.shape[-2] == 1 << k
    return k


def ntt_mxu(x, k: int | None = None):
    """coeffs -> evals at H (natural order)."""
    return _ntt_mxu_impl(x, _k_of(x, k), False, False)


def intt_mxu(x, k: int | None = None):
    """evals at H -> coeffs."""
    return _ntt_mxu_impl(x, _k_of(x, k), True, False)


def coset_ntt_mxu(x, k: int | None = None):
    """coeffs -> evals on the coset gH."""
    return _ntt_mxu_impl(x, _k_of(x, k), False, True)


def coset_intt_mxu(x, k: int | None = None):
    """evals on gH -> coeffs."""
    return _ntt_mxu_impl(x, _k_of(x, k), True, True)
