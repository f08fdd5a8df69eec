"""Evaluation domains over BN254 Fr (port of zkevm_circuits_tpu/poly/domain.py).

Domain size n = 2^k, omega a primitive n-th root of unity; the extended
domain is evaluated on the coset g * H_ext with g = FR_GENERATOR.  Tables
are host numpy arrays (Montgomery digits), built on first use.
"""

from __future__ import annotations

import functools

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_GENERATOR, FR_MODULUS, FR_ROOT_OF_UNITY, FR_TWO_ADICITY


def _mont_pows(base: int, count: int) -> np.ndarray:
    F = fr()
    r, R = FR_MODULUS, F.R
    out, acc = [], R
    for _ in range(count):
        out.append(acc)
        acc = acc * base % r
    return F.from_ints(out)


class Domain:
    def __init__(self, k: int):
        assert 1 <= k <= FR_TWO_ADICITY
        self.k = k
        self.n = 1 << k
        self.F = fr()
        r = FR_MODULUS
        self.omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), r)
        self.omega_inv = pow(self.omega, r - 2, r)
        self.n_inv = pow(self.n, r - 2, r)
        idx = np.arange(self.n)
        rev = np.zeros(self.n, np.int64)
        for b in range(k):
            rev |= ((idx >> b) & 1) << (k - 1 - b)
        self.bitrev = rev
        self.n_inv_mont = self.F.from_int(self.n_inv * self.F.R % r)

    def omega_pow(self, e: int) -> int:
        return pow(self.omega, e % self.n, FR_MODULUS)

    # per-stage twiddles: stage s in [1, k] uses m = 2^s, w_m = omega^(n/m)
    # and the table [w_m^j for j < m/2] (Montgomery digits)
    @functools.cached_property
    def stage_twiddles(self):
        return [_mont_pows(pow(self.omega, self.n >> s, FR_MODULUS), 1 << (s - 1))
                for s in range(1, self.k + 1)]

    @functools.cached_property
    def stage_twiddles_inv(self):
        return [_mont_pows(pow(self.omega_inv, self.n >> s, FR_MODULUS), 1 << (s - 1))
                for s in range(1, self.k + 1)]

    @functools.cached_property
    def coset_powers(self):
        return _mont_pows(FR_GENERATOR, self.n)

    @functools.cached_property
    def coset_powers_inv(self):
        return _mont_pows(pow(FR_GENERATOR, FR_MODULUS - 2, FR_MODULUS), self.n)


@functools.cache
def domain(k: int) -> Domain:
    return Domain(k)
