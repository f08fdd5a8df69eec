"""Poseidon hash over BN254 Fr (port of zkevm_circuits_tpu/crypto/poseidon.py):
host reference on Python ints + batched permutation on tensors.

Plays the role of the reference's external `poseidon-circuit` (hash-circuit)
host hashing and the Poseidon scheme the Go zktrie registers via
`init_hash_scheme` (reference zktrie/src/state/builder.rs:16).

Parameters: t = 3 (rate 2, capacity 1), S-box x^5, R_F = 8 full rounds,
R_P = 57 partial rounds — the standard 128-bit-security instantiation for
a 254-bit prime.  Round constants and the Cauchy MDS matrix are generated
by the Poseidon paper's Grain-LFSR procedure
(`generate_params_poseidon.sage` algorithm), deterministic and identical to
the JAX package's.  `PoseidonSpec` takes explicit constants, so swapping in
Scroll's table for bit-parity is a data change only.

Conventions (iden3/circomlib-style, used by zktrie):
  * ``hash2(a, b)``: state (0, a, b) -> permute -> state[0].
  * ``hash_msg(fields, cap)``: variable-length absorption, rate 2, initial
    capacity element = ``cap`` (Scroll's code hash uses length * 2^64 as
    the domain, prover-side convention).

The host permutation differs from the reference in speed only: the round
loop is unrolled over the three lanes with the constants hoisted, and the
partial rounds leave lanes 1 and 2 unreduced until the MDS mix reduces
them.  Every output and every round state is the same integer.

`permute_batch` runs on (B, 3, 32) uint8 Montgomery tensors through
`Fp.mul` / `Fp.add`: on a CUDA tensor every product is a launch of kernel
K1 (ops/cuda_field.py), on a CPU tensor its plain version.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .params import FR_MODULUS

T = 3
ALPHA = 5
R_FULL = 8
R_PARTIAL = 57


# ---------------------------------------------------------------------------
# Grain LFSR parameter generation (Poseidon reference algorithm)
# ---------------------------------------------------------------------------
class _Grain:
    """80-bit Grain LFSR from the Poseidon reference implementation:
    state = field(2) ‖ sbox(4) ‖ n(12) ‖ t(12) ‖ R_F(10) ‖ R_P(10) ‖ 1^30,
    feedback taps {62, 51, 38, 23, 13, 0}, 160 warm-up bits, von Neumann
    pair filtering on outputs."""

    def __init__(self, n_bits: int, t: int, r_f: int, r_p: int):
        bits: list[int] = []
        for val, width in ((1, 2), (0, 4), (n_bits, 12), (t, 12),
                           (r_f, 10), (r_p, 10)):
            bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._raw()

    def _raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def bit(self) -> int:
        while True:
            b1 = self._raw()
            b2 = self._raw()
            if b1:
                return b2

    def field_element(self, p: int, n_bits: int) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.bit()
            if v < p:
                return v


@functools.cache
def _grain_params(p: int = FR_MODULUS):
    n_bits = p.bit_length()
    g = _Grain(n_bits, T, R_FULL, R_PARTIAL)
    n_rounds = R_FULL + R_PARTIAL
    rc = [[g.field_element(p, n_bits) for _ in range(T)] for _ in range(n_rounds)]
    # Cauchy MDS from fresh grain samples: mds[i][j] = 1/(x_i + y_j)
    xs = [g.field_element(p, n_bits) for _ in range(T)]
    ys = [g.field_element(p, n_bits) for _ in range(T)]
    mds = [
        [pow((xs[i] + ys[j]) % p, p - 2, p) for j in range(T)] for i in range(T)
    ]
    # sanity: invertible (Cauchy with distinct x_i, x_i + y_j != 0)
    assert len({x % p for x in xs}) == T
    assert all((xs[i] + ys[j]) % p != 0 for i in range(T) for j in range(T))
    return rc, mds


@dataclasses.dataclass(frozen=True)
class PoseidonSpec:
    p: int
    rc: tuple  # (R_FULL + R_PARTIAL, T) ints
    mds: tuple  # (T, T) ints

    @property
    def n_rounds(self) -> int:
        return len(self.rc)

    def is_full_round(self, r: int) -> bool:
        half = R_FULL // 2
        return r < half or r >= self.n_rounds - half


@functools.cache
def spec(p: int = FR_MODULUS) -> PoseidonSpec:
    rc, mds = _grain_params(p)
    return PoseidonSpec(
        p=p,
        rc=tuple(tuple(row) for row in rc),
        mds=tuple(tuple(row) for row in mds),
    )


# ---------------------------------------------------------------------------
# host permutation / hashes (Python ints)
# ---------------------------------------------------------------------------
@functools.cache
def _round_plan(sp: PoseidonSpec):
    """[(full, c0, c1, c2)] per round, and the nine MDS entries."""
    plan = tuple((sp.is_full_round(r), *sp.rc[r]) for r in range(sp.n_rounds))
    return plan, tuple(m for row in sp.mds for m in row)


def _rounds(state, sp: PoseidonSpec, trace: list | None):
    plan, (m00, m01, m02, m10, m11, m12, m20, m21, m22) = _round_plan(sp)
    p = sp.p
    s0, s1, s2 = state
    for full, c0, c1, c2 in plan:
        s0 = pow(s0 + c0, ALPHA, p)
        if full:
            s1 = pow(s1 + c1, ALPHA, p)
            s2 = pow(s2 + c2, ALPHA, p)
        else:
            s1 += c1
            s2 += c2
        s0, s1, s2 = ((m00 * s0 + m01 * s1 + m02 * s2) % p,
                      (m10 * s0 + m11 * s1 + m12 * s2) % p,
                      (m20 * s0 + m21 * s1 + m22 * s2) % p)
        if trace is not None:
            trace.append([s0, s1, s2])
    return [s0, s1, s2]


def permute(state, sp: PoseidonSpec | None = None):
    """One Poseidon permutation on a length-3 int state; returns new list."""
    return _rounds(state, sp or spec(), None)


def round_states(state, sp: PoseidonSpec | None = None):
    """All n_rounds+1 states (inputs of each round + final) — the circuit
    witness for one permutation block."""
    out = [list(state)]
    _rounds(state, sp or spec(), out)
    return out


def hash2(a: int, b: int, sp: PoseidonSpec | None = None) -> int:
    """2-to-1 hash: state (0, a, b) -> permute -> state[0]."""
    return permute([0, a, b], sp)[0]


def hash_msg(fields, cap: int | None = None, sp: PoseidonSpec | None = None) -> int:
    """Variable-length sponge: absorb rate-2 chunks (zero-padded), initial
    capacity = ``cap`` (default: len(fields) * 2^64, Scroll's var-len
    domain convention for code hashing)."""
    sp = sp or spec()
    p = sp.p
    if cap is None:
        cap = (len(fields) << 64) % p
    s = [cap % p, 0, 0]
    chunks = list(fields) + [0] * ((-len(fields)) % 2)
    if not chunks:
        chunks = [0, 0]  # empty message still runs one permutation
    for i in range(0, len(chunks), 2):
        s[1] = (s[1] + chunks[i]) % p
        s[2] = (s[2] + chunks[i + 1]) % p
        s = permute(s, sp)
    return s[0]


# ---------------------------------------------------------------------------
# batched permutation (tensors of Montgomery digit rows)
# ---------------------------------------------------------------------------
@functools.cache
def _mont_consts():
    from .field import fr

    F = fr()
    sp = spec()
    rc = np.stack([F.from_ints([c * F.R % F.modulus for c in row]) for row in sp.rc])
    mds = np.stack([F.from_ints([m * F.R % F.modulus for m in row]) for row in sp.mds])
    return rc, mds  # (65, 3, 32), (3, 3, 32) uint8 Montgomery


def permute_batch(states: torch.Tensor) -> torch.Tensor:
    """(B, 3, 32) uint8 Montgomery states -> permuted, on the states'
    device.  Used for bulk witness hashing; each product is one K1 launch
    on the card."""
    from .field import fr

    F = fr()
    sp = spec()
    rc, mds = _mont_consts()
    rc = torch.as_tensor(rc, device=states.device)
    mds = torch.as_tensor(mds, device=states.device)
    s = states
    for r in range(sp.n_rounds):
        s = F.add(s, rc[r][None])
        sq = F.mul(s, s)
        s5 = F.mul(F.mul(sq, sq), s)
        if sp.is_full_round(r):
            s = s5
        else:
            s = torch.cat([s5[:, :1], s[:, 1:]], dim=1)
        # MDS: out_i = sum_j mds[i][j] * s_j
        outs = []
        for i in range(T):
            acc = None
            for j in range(T):
                term = F.mul(s[:, j], mds[i, j])
                acc = term if acc is None else F.add(acc, term)
            outs.append(acc)
        s = torch.stack(outs, dim=1)
    return s
