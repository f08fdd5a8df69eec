"""Gate expression IR (port of zkevm_circuits_tpu/plonk/expression.py).

The reference builds constraints as expression trees over column queries
(`zkevm-circuits` gadgets emit them through `EVMConstraintBuilder`,
SURVEY.md §2.2) and its backend evaluates them row-by-row in Rust.  Here a
gate is the same small AST, but evaluation is COLUMNWISE: a query pulls an
entire rotated column (one torch.roll), and the DAG evaluates as batched
field ops over all n rows at once.

Rotations use halo2 semantics: Rotation(1) of column c at row i reads
c[(i+1) % n].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..crypto.field import fr

F = fr()


class Expression:
    def __add__(self, o):
        return Sum(self, _lift(o))

    def __radd__(self, o):
        return Sum(_lift(o), self)

    def __sub__(self, o):
        return Sum(self, Neg(_lift(o)))

    def __rsub__(self, o):
        return Sum(_lift(o), Neg(self))

    def __mul__(self, o):
        return Product(self, _lift(o))

    def __rmul__(self, o):
        return Product(_lift(o), self)

    def __neg__(self):
        return Neg(self)

    # -- analysis ----------------------------------------------------------
    def degree(self) -> int:
        raise NotImplementedError

    def queries(self, out: set):
        """Collect (kind, col, rot) column queries and challenge uses."""
        raise NotImplementedError


def _host(a):
    """A numpy view of a host array or a tensor on any device."""
    import numpy as np

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _lift(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot lift {type(v)} into Expression")


@dataclasses.dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0

    def queries(self, out):
        pass


@dataclasses.dataclass(frozen=True)
class Query(Expression):
    """A (kind, column, rotation) cell query; kind in {fixed, advice, instance}."""

    kind: str
    col: int
    rot: int = 0

    def degree(self):
        return 1

    def queries(self, out):
        out.add((self.kind, self.col, self.rot))


def Fixed(col, rot=0):
    return Query("fixed", col, rot)


def Advice(col, rot=0):
    return Query("advice", col, rot)


def Instance(col, rot=0):
    return Query("instance", col, rot)


@dataclasses.dataclass(frozen=True)
class Challenge(Expression):
    """Fiat-Shamir challenge (by phase-local index); degree 0."""

    index: int

    def degree(self):
        return 0

    def queries(self, out):
        out.add(("challenge", self.index, 0))


@dataclasses.dataclass(frozen=True)
class Neg(Expression):
    a: Expression

    def degree(self):
        return self.a.degree()

    def queries(self, out):
        self.a.queries(out)


@dataclasses.dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def queries(self, out):
        self.a.queries(out)
        self.b.queries(out)


@dataclasses.dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()

    def queries(self, out):
        self.a.queries(out)
        self.b.queries(out)


class IntEvaluator:
    """Columnwise DAG evaluator over PYTHON BIGINTS (numpy object arrays).

    The MockProver's fast path: evaluating gates through the device field
    kernels op-by-op pays ~100us of eager-dispatch overhead per primitive
    (hundreds of gates x dozens of nodes x dozens of primitives dominated
    test wall-clock).  Row-wise constraint checking needs no device math
    at all — plain 254-bit Python ints vectorized through numpy object
    arrays evaluate the same DAG ~50x faster on the host.

    `tables` maps kind -> (num_cols, n, 32) uint8 MONTGOMERY arrays (or
    col->array dicts); values are converted to canonical standard-form
    ints lazily per queried column.  `challenges` maps index ->
    Montgomery (32,) arrays or ints.  Results of `eval` are canonical
    ints in [0, p) — scalars or (n,) object arrays.
    """

    def __init__(self, tables: dict, challenges: dict | None = None):
        self.tables = tables
        self.challenges = challenges or {}
        self.p = F.modulus
        self.rinv = pow(F.R, -1, F.modulus)
        self._cache: dict[Any, Any] = {}
        self._cols: dict[tuple, Any] = {}

    def _column(self, kind, col):
        key = (kind, col)
        hit = self._cols.get(key)
        if hit is not None:
            return hit
        t = self.tables[kind]
        import numpy as np

        arr = _host(t[col])
        n = arr.shape[0]
        raw = arr.tobytes()
        p, rinv = self.p, self.rinv
        out = np.fromiter(
            (
                int.from_bytes(raw[32 * i : 32 * i + 32], "little") * rinv % p
                for i in range(n)
            ),
            dtype=object,
            count=n,
        )
        self._cols[key] = out
        return out

    def _challenge(self, index):
        v = self.challenges[index]
        if isinstance(v, int):
            return v % self.p
        import numpy as np

        b = _host(v).tobytes()
        return int.from_bytes(b, "little") * self.rinv % self.p

    def eval(self, e: Expression):
        key = e
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        import numpy as np

        p = self.p
        if isinstance(e, Constant):
            out = e.value % p
        elif isinstance(e, Query):
            colv = self._column(e.kind, e.col)
            r = e.rot % colv.shape[0]
            out = np.roll(colv, -r) if r else colv
        elif isinstance(e, Challenge):
            out = self._challenge(e.index)
        elif isinstance(e, Neg):
            v = self.eval(e.a)
            out = (p - v) % p if isinstance(v, int) else (-v) % p
        elif isinstance(e, Sum):
            out = (self.eval(e.a) + self.eval(e.b)) % p
        elif isinstance(e, Product):
            out = (self.eval(e.a) * self.eval(e.b)) % p
        else:
            raise TypeError(type(e))
        self._cache[key] = out
        return out


class Evaluator:
    """Columnwise DAG evaluator with node memoization.

    `tables` maps kind -> (num_cols, n, 32) uint8 Montgomery arrays (or a
    dict col->array); `challenges` maps index -> (32,) Montgomery scalar.
    `rot_scale` stretches rotations (extended-domain evaluation: a rotation
    of 1 on H corresponds to `rate` rows on the extended coset domain).
    """

    def __init__(self, tables: dict, challenges: dict | None = None,
                 rot_scale: int = 1, device=None):
        self.tables = tables
        self.challenges = challenges or {}
        self.rot_scale = rot_scale
        self.device = device
        self._cache: dict[Any, Any] = {}
        self._const_cache: dict[int, Any] = {}
        self._cint_cache: dict[Any, int | None] = {}

    def _const_int(self, e: Expression) -> int | None:
        """Host value of a constant subtree (no queries/challenges), or
        None.  Folding these on the host keeps Constant x Constant
        products off the device."""
        hit = self._cint_cache.get(e, "miss")
        if hit != "miss":
            return hit
        if isinstance(e, Constant):
            v = e.value % F.modulus
        elif isinstance(e, Neg):
            a = self._const_int(e.a)
            v = None if a is None else (-a) % F.modulus
        elif isinstance(e, Sum):
            a, b = self._const_int(e.a), self._const_int(e.b)
            v = None if a is None or b is None else (a + b) % F.modulus
        elif isinstance(e, Product):
            a, b = self._const_int(e.a), self._const_int(e.b)
            v = None if a is None or b is None else a * b % F.modulus
        else:
            v = None
        self._cint_cache[e] = v
        return v

    def _const_arr(self, v: int):
        arr = self._const_cache.get(v)
        if arr is None:
            arr = torch.as_tensor(F.from_int(v * F.R % F.modulus),
                                  device=self.device)
            self._const_cache[v] = arr
        return arr

    def _column(self, kind, col):
        t = self.tables[kind]
        return t[col] if not isinstance(t, dict) else t[col]

    def eval(self, e: Expression):
        key = e
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        cv = self._const_int(e)
        if cv is not None:
            out = self._const_arr(cv)
            self._cache[key] = out
            return out
        if isinstance(e, Constant):
            out = self._const_arr(e.value % F.modulus)
        elif isinstance(e, Query):
            out = self._query(e)
        elif isinstance(e, Challenge):
            out = self.challenges[e.index]
        elif isinstance(e, Neg):
            out = F.neg(self.eval(e.a))
        elif isinstance(e, Sum):
            out = self._bin(F.add, e.a, e.b)
        elif isinstance(e, Product):
            out = self._bin(F.mul, e.a, e.b)
        else:
            raise TypeError(type(e))
        self._cache[key] = out
        return out

    def _query(self, e: Query):
        colv = self._column(e.kind, e.col)
        r = (e.rot * self.rot_scale) % colv.shape[0]
        return torch.roll(colv, -r, dims=0) if r else colv

    def _bin(self, op, a, b):
        va, vb = self.eval(a), self.eval(b)
        if va.ndim < vb.ndim:
            va = va.expand(vb.shape)
        elif vb.ndim < va.ndim:
            vb = vb.expand(va.shape)
        return op(va, vb)


class PreRolledEvaluator(Evaluator):
    """Evaluator over PRE-SLICED chunk tables keyed (kind, col, rot).

    Used by the prover's chunked quotient pass: rotations are resolved
    outside (wrapping row-window slices of the extended-domain columns),
    so the chunk body is purely elementwise."""

    def __init__(self, chunks: dict, challenges: dict | None = None,
                 device=None):
        super().__init__({}, challenges, rot_scale=1, device=device)
        self._chunks = chunks

    def _query(self, e: Query):
        return self._chunks[(e.kind, e.col, e.rot)]
