"""Prime-field arithmetic over BN254 Fr and Fq on PyTorch tensors.

Port of zkevm_circuits_tpu/crypto/field.py.  The layout is the reference's:
a field element is a (..., 32) uint8 tensor of little-endian digits, any
leading batch shape, Montgomery form with R = 2^256, canonical (< p) at
every public function.

`mul` is kernel K1 (ops/cuda_field.py) on CUDA tensors and its plain
version on CPU tensors.  add, sub and neg are one launch each of the
field_add_sub kernel (ops/cuda_field.py, csrc/field.cu) on CUDA tensors,
either field, and plain tensor code over 16-bit limbs on CPU tensors.  Ops
run on the device of their tensor inputs; numpy inputs are moved to the
default device, the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from ..ops import cuda_field as cf
from .params import N_DIGITS, from_digits, to_digits

ND = N_DIGITS


def as_tensor(x, device=None) -> torch.Tensor:
    """Tensors stay where they are; anything else goes to `device` (the
    card when None)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve(device))


def _pair(a, b):
    """Both operands as tensors on one device (a host operand follows the
    device of the tensor one)."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return a, torch.as_tensor(np.asarray(b), device=a.device)
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        return torch.as_tensor(np.asarray(a), device=b.device), b
    return as_tensor(a), as_tensor(b)


class Fp:
    """A prime field instance: per-modulus constants (numpy) and ops."""

    def __init__(self, modulus: int, name: str, field_id: int):
        self.modulus = modulus
        self.name = name
        self.field_id = field_id
        self.nbits = modulus.bit_length()
        assert self.nbits <= 255, "need headroom for 2p in 256 bits"
        self.R = (1 << 256) % modulus
        self.R2 = (self.R * self.R) % modulus
        self.ZERO = np.zeros(ND, np.uint8)
        self.ONE = np.array(to_digits(1), np.uint8)
        self.ONE_MONT = np.array(to_digits(self.R), np.uint8)
        self.R2_DIGITS = np.array(to_digits(self.R2), np.uint8)

    # ------------------------------------------------------------------
    # host-side conversions (Python ints <-> digit arrays)
    # ------------------------------------------------------------------
    def from_int(self, x: int) -> np.ndarray:
        return np.array(to_digits(x % self.modulus), np.uint8)

    def from_ints(self, xs) -> np.ndarray:
        xs = list(xs)
        raw = b"".join((int(x) % self.modulus).to_bytes(32, "little") for x in xs)
        return np.frombuffer(raw, np.uint8).reshape(len(xs), ND).copy()

    def to_int(self, a) -> int:
        return from_digits(_np(a).reshape(-1)[:ND])

    def to_ints(self, a) -> list[int]:
        raw = _np(a).reshape(-1, ND).tobytes()
        return [int.from_bytes(raw[i: i + ND], "little")
                for i in range(0, len(raw), ND)]

    def mont_from_ints(self, vals) -> np.ndarray:
        """ints -> Montgomery digit rows ((len, 32) uint8), on the host.
        Witness columns repeat few distinct values, so each distinct value
        is converted once with Python ints and gathered back."""
        vals = vals if isinstance(vals, (list, np.ndarray)) else list(vals)
        n = len(vals)
        if n == 0:
            return np.zeros((0, ND), np.uint8)
        try:
            arr = np.asarray(vals, dtype=np.int64)
        except (OverflowError, TypeError, ValueError):
            return self.from_ints([int(v) % self.modulus * self.R for v in vals])
        uniq, inv = np.unique(arr, return_inverse=True)
        table = self.from_ints([int(v) % self.modulus * self.R for v in uniq])
        return table[inv.reshape(-1)]

    def mont_from_ints_padded(self, vals, n: int) -> np.ndarray:
        out = np.zeros((n, ND), np.uint8)
        m = len(vals)
        if m:
            out[:m] = self.mont_from_ints(vals)
        return out

    # ------------------------------------------------------------------
    # core ops
    # ------------------------------------------------------------------
    def _cs(self, device):
        return cf._consts(self.field_id, device)

    def add(self, a, b):
        """a + b: one field_add_sub launch on CUDA tensors."""
        a, b = _pair(a, b)
        if a.is_cuda or b.is_cuda:
            return cf.field_add_sub_cuda(a, b, cf.OP_ADD, self.field_id)
        cs = self._cs(a.device)
        return cf.from_limbs(cf.add_limbs(cf.to_limbs(a), cf.to_limbs(b), cs))

    def sub(self, a, b):
        """a - b: one field_add_sub launch on CUDA tensors."""
        a, b = _pair(a, b)
        if a.is_cuda or b.is_cuda:
            return cf.field_add_sub_cuda(a, b, cf.OP_SUB, self.field_id)
        cs = self._cs(a.device)
        return cf.from_limbs(cf.sub_limbs(cf.to_limbs(a), cf.to_limbs(b), cs))

    def neg(self, a):
        """-a (0 maps to 0): one field_add_sub launch on a CUDA tensor,
        which reads `a` only."""
        a = as_tensor(a)
        if a.is_cuda:
            return cf.field_add_sub_cuda(a, None, cf.OP_NEG, self.field_id)
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product REDC(a*b): kernel K1 on CUDA tensors."""
        a, b = _pair(a, b)
        return cf.mont_mul(a, b, self.field_id)

    def square(self, a):
        a = as_tensor(a)
        return self.mul(a, a)

    def to_mont(self, a):
        a = as_tensor(a)
        return self.mul(a, torch.as_tensor(self.R2_DIGITS, device=a.device))

    def from_mont(self, a):
        a = as_tensor(a)
        return self.mul(a, torch.as_tensor(self.ONE, device=a.device))

    def pow(self, a, e: int):
        """a^e with a in Montgomery form, host integer exponent e >= 0."""
        a = as_tensor(a)
        result = self.ones_mont(a.shape[:-1], a.device)
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return result

    def inv(self, a):
        """Inverse in Montgomery form (Fermat).  inv(0) = 0."""
        return self.pow(a, self.modulus - 2)

    def prefix_product(self, a, axis: int = 0):
        """Inclusive prefix products along `axis` (log-depth doubling)."""
        x = as_tensor(a)
        n = x.shape[axis]
        s = 1
        while s < n:
            hi = self.mul(x.narrow(axis, s, n - s), x.narrow(axis, 0, n - s))
            x = torch.cat([x.narrow(axis, 0, s), hi], dim=axis)
            s <<= 1
        return x

    def prefix_sum(self, a, axis: int = 0):
        """Inclusive prefix sums along `axis` (log-depth doubling)."""
        x = as_tensor(a)
        n = x.shape[axis]
        s = 1
        while s < n:
            hi = self.add(x.narrow(axis, s, n - s), x.narrow(axis, 0, n - s))
            x = torch.cat([x.narrow(axis, 0, s), hi], dim=axis)
            s <<= 1
        return x

    def batch_inv(self, a, axis: int = 0):
        """Batched inverse from prefix and suffix products; 0 maps to 0."""
        a = as_tensor(a)
        assert axis >= 0, "axis must be a non-negative batch axis"
        one = torch.as_tensor(self.ONE_MONT, device=a.device)
        z = self.is_zero(a)
        safe = torch.where(z[..., None], one, a)
        pref = self.prefix_product(safe, axis)
        n = a.shape[axis]
        total_inv = self.inv(pref.select(axis, n - 1).unsqueeze(axis))
        suff = self.prefix_product(safe.flip(axis), axis).flip(axis)
        shifted_pref = _shift_fill(pref, 1, axis, one)
        shifted_suff = _shift_fill(suff, -1, axis, one)
        out = self.mul(self.mul(shifted_pref, shifted_suff),
                       total_inv.expand_as(a))
        return torch.where(z[..., None], torch.zeros_like(out), out)

    # ------------------------------------------------------------------
    # predicates / selection
    # ------------------------------------------------------------------
    @staticmethod
    def is_zero(a):
        return (as_tensor(a) == 0).all(dim=-1)

    @staticmethod
    def eq(a, b):
        a, b = _pair(a, b)
        return (a == b).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        """cond: (...,) bool -> elementwise a or b."""
        a, b = _pair(a, b)
        return torch.where(cond[..., None], a, b)

    def power_table(self, x: int, n: int, device=None):
        """(n, 32) Montgomery digits of x^i for i < n (log2(n) doubling
        steps, one batched mul each).  `x` is a host int (plain)."""
        dev = resolve(device)
        x = x % self.modulus
        out = torch.as_tensor(self.ONE_MONT, device=dev)[None]
        total = 1
        while total < n:
            step = min(total, n - total)
            xm = torch.as_tensor(
                self.from_int(pow(x, total, self.modulus) * self.R % self.modulus),
                device=dev,
            )
            out = torch.cat([out, self.mul(out[:step], xm)], dim=0)
            total += step
        return out

    def scalar(self, v: int, device=None) -> torch.Tensor:
        """(32,) Montgomery digits of the host int v."""
        return torch.as_tensor(
            self.from_int(v % self.modulus * self.R % self.modulus),
            device=resolve(device),
        )

    def zeros(self, shape=(), device=None):
        return torch.zeros((*shape, ND), dtype=torch.uint8, device=resolve(device))

    def ones_mont(self, shape=(), device=None):
        one = torch.as_tensor(self.ONE_MONT, device=resolve(device))
        return one.expand(*shape, ND).contiguous()


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _shift_fill(x, shift, axis, fill_vec):
    """Shift along `axis` by `shift` (+1: toward higher index), fill edges."""
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = abs(shift)
    fill = fill_vec.expand(*shape).to(x.dtype)
    if shift > 0:
        return torch.cat([fill, x.narrow(axis, 0, n - shift)], dim=axis)
    return torch.cat([x.narrow(axis, -shift, n + shift), fill], dim=axis)


@functools.cache
def fr() -> Fp:
    from .params import FR_MODULUS

    return Fp(FR_MODULUS, "Fr", cf.FIELD_FR)


@functools.cache
def fq() -> Fp:
    from .params import FQ_MODULUS

    return Fp(FQ_MODULUS, "Fq", cf.FIELD_FQ)
