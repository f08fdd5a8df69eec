"""The k=5 demonstration circuit of the reference's tests
(tests/test_plonk_prove.py::DemoCircuit), written against the port's IR.

It exercises every argument of the proof system at once: two gates
(degree 2 and 3), a rotation-using chain gate, a lookup into a fixed table,
and copy constraints across advice columns and into the instance column.
"""

from __future__ import annotations

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from .circuit import Cell, Circuit, ConstraintSystem
from .expression import Advice, Fixed

F = fr()
K = 5
A_IN = 3
N_ADD = 10  # rows 0..9: c = a + b, chained a[i+1] = c[i] on rows 0..8
MUL_ROWS = range(10, 15)

# sha256 of the reference's proof of DemoCircuit at k = 5 with
# Srs.unsafe_setup(5, tau=987654321), instance [[3]] and
# rng=np.random.default_rng(7); the port's proof must equal it.
GOLDEN_TAU = 987654321
GOLDEN_SEED = 7
GOLDEN_SHA256 = "962e1792f8246ca5d9df549779d984e975344954eeb27b88606cb7f1706c9e36"
GOLDEN_LEN = 1792

# sha256 of the reference's proof of circuits/keccak.py::KeccakCircuit
# (Z_PER_ROW = 8) over KECCAK_GOLDEN_MESSAGES at k = 9 with
# Srs.unsafe_setup(9, tau=0xBE2C4), no instances and
# rng=np.random.default_rng(7); the port's proof must equal it.
KECCAK_GOLDEN_K = 9
KECCAK_GOLDEN_TAU = 0xBE2C4
KECCAK_GOLDEN_SEED = 7
KECCAK_GOLDEN_MESSAGES = (b"abc",)
KECCAK_GOLDEN_SHA256 = "61910750f7403e117d53a961c58cd2b9a42689ddf05b23d8089cf89e39c4aa5a"
KECCAK_GOLDEN_LEN = 139360

# The EVM circuit's k=9 proof: circuits/evm.py::EvmCircuit with
# EvmParams(target_steps=40, rw_target=256) over one transaction from
# EVM_GOLDEN_SENDER to EVM_GOLDEN_CONTRACT (no value, no calldata) running
# PUSH2 0xBEEF, PUSH1 7, MSTORE, PUSH1 7, MLOAD, PUSH1 5, ADD, POP, STOP,
# traced by tracer.Interpreter and replayed by CircuitInputBuilder, with
# Srs.unsafe_setup(9, tau=0xBE2C4), no instances and
# rng=np.random.default_rng(7): sha256 and length of the reference's proof
# (the JAX package on the CPU, native library built); the port's proof
# must equal it.
EVM_GOLDEN_K = 9
EVM_GOLDEN_TAU = 0xBE2C4
EVM_GOLDEN_SEED = 7
EVM_GOLDEN_SENDER = 0xCAFE
EVM_GOLDEN_CONTRACT = 0xC0DE
EVM_GOLDEN_CODE = bytes.fromhex("61beef6007526007516005015000")
EVM_GOLDEN_TARGET_STEPS = 40
EVM_GOLDEN_RW_TARGET = 256
EVM_GOLDEN_SHA256 = "487c95f60e07c8b469ba6ed3497d4176e47b759452a0f1f6bc94b226dfba6e0b"
EVM_GOLDEN_LEN = 134816


def _mont(vals):
    return F.from_ints([v % R * F.R % R for v in vals])


class DemoCircuit(Circuit):
    def __init__(self, corrupt_row: int | None = None):
        self.corrupt_row = corrupt_row

    def configure(self, cs: ConstraintSystem):
        self.qadd = cs.fixed_column()
        self.qmul = cs.fixed_column()
        self.qchain = cs.fixed_column()
        self.tbl = cs.fixed_column()
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.c = cs.advice_column()
        self.d = cs.advice_column()
        self.inst = cs.instance_column()
        cs.create_gate(
            "add", Fixed(self.qadd) * (Advice(self.a) + Advice(self.b) - Advice(self.c))
        )
        cs.create_gate(
            "mul", Fixed(self.qmul) * (Advice(self.a) * Advice(self.b) - Advice(self.c))
        )
        cs.create_gate(
            "chain", Fixed(self.qchain) * (Advice(self.a, 1) - Advice(self.c))
        )
        cs.lookup("range16", [(Advice(self.d), Fixed(self.tbl))])
        cs.enable_equality("advice", self.a)
        cs.enable_equality("advice", self.b)
        cs.enable_equality("advice", self.c)
        cs.enable_equality("instance", self.inst)

    def _witness(self, n):
        a = [0] * n
        b = [0] * n
        c = [0] * n
        a[0] = A_IN
        for i in range(N_ADD):
            b[i] = 2 * i + 1
            c[i] = (a[i] + b[i]) % R
            if i + 1 < n:
                a[i + 1] = c[i]
        for i in MUL_ROWS:
            a[i] = i + 2
            b[i] = 3 * i + 1
            c[i] = a[i] * b[i] % R
        # copy constraint target: b[20] must equal c[12]
        b[20] = c[12]
        if self.corrupt_row is not None:
            c[self.corrupt_row] = (c[self.corrupt_row] + 1) % R
        d = [i % 16 for i in range(n)]
        return a, b, c, d

    def fixed_columns(self, n):
        qadd = [1 if i < N_ADD else 0 for i in range(n)]
        qmul = [1 if i in MUL_ROWS else 0 for i in range(n)]
        qchain = [1 if i < N_ADD - 1 else 0 for i in range(n)]
        tbl = [i if i < 16 else 0 for i in range(n)]
        return np.stack([_mont(col) for col in (qadd, qmul, qchain, tbl)])

    def copy_constraints(self, n):
        return [
            (Cell("instance", self.inst, 0), Cell("advice", self.a, 0)),
            (Cell("advice", self.b, 20), Cell("advice", self.c, 12)),
        ]

    def synthesize(self, phase, n, challenges, instances):
        assert phase == 0
        a, b, c, d = self._witness(n)
        return {
            self.a: _mont(a),
            self.b: _mont(b),
            self.c: _mont(c),
            self.d: _mont(d),
        }
