"""Shared affine EC building blocks over MulMod-table rows.

Used by the Sig circuit (secp256k1, circuits/sig.py) and the ECC
circuit (BN254 precompiles, circuits/ecc.py): every modular operation
is one MulMod-circuit row; these helpers emit the lookup tuples on the
constraint side and mirror the exact ops on the witness side.

Conventions: values are (lo, hi) 128-bit half pairs (expressions in
configure, ints in witness); `mm(gate, a, b, n, r, is_add)` appends one
lookup input tuple for the row  r = (a mod n) op b  (mod n).

Affine formulas use witnessed slopes with an inverse witness proving
x1 != x2 (add) / y != 0 (double) — degenerate cases make proofs FAIL,
never forge; complete-addition case handling is the caller's job.

Port of zkevm_circuits_tpu/circuits/ecblocks.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

M128 = (1 << 128) - 1

ONE = (1, 0)

ADD_CELLS = ("ddx", "dinv", "dyd", "lama", "s2", "au", "d3", "t5", "rx",
             "ry")
DBL_CELLS = ("t1", "t2", "t3", "w2", "lamd", "s1", "du", "d2", "t4", "dx",
             "dy")


def halves(v: int) -> tuple[int, int]:
    return (v & M128, v >> 128)


class MmCollector:
    """Accumulates MulMod-table lookup input tuples during configure."""

    def __init__(self):
        self.inputs: list = []

    def mm(self, gate, a, b, n, r, is_add=0):
        self.inputs.append([
            gate, gate * is_add, gate * a[0], gate * a[1],
            gate * b[0], gate * b[1], gate * n[0], gate * n[1],
            gate * r[0], gate * r[1],
        ])


def emit_add_block(col: MmCollector, gate, cell, Pp, Qp, nh):
    """Constraint side of P + Q -> (rx, ry); `cell(name)` returns the
    block's cell pairs; `nh` is the modulus half pair."""
    mm = col.mm
    mm(gate, cell("ddx"), Pp[0], nh, Qp[0], is_add=1)
    mm(gate, cell("dinv"), cell("ddx"), nh, ONE)
    mm(gate, cell("dyd"), Pp[1], nh, Qp[1], is_add=1)
    mm(gate, cell("lama"), cell("ddx"), nh, cell("dyd"))
    mm(gate, cell("lama"), cell("lama"), nh, cell("s2"))
    mm(gate, cell("rx"), Pp[0], nh, cell("au"), is_add=1)
    mm(gate, cell("au"), Qp[0], nh, cell("s2"), is_add=1)
    mm(gate, cell("d3"), cell("rx"), nh, Pp[0], is_add=1)
    mm(gate, cell("lama"), cell("d3"), nh, cell("t5"))
    mm(gate, cell("ry"), Pp[1], nh, cell("t5"), is_add=1)
    return cell("rx"), cell("ry")


def emit_dbl_block(col: MmCollector, gate, cell, Pp, nh):
    """Constraint side of 2P -> (dx, dy)."""
    mm = col.mm
    mm(gate, Pp[0], Pp[0], nh, cell("t1"))
    mm(gate, cell("t1"), cell("t1"), nh, cell("t2"), is_add=1)
    mm(gate, cell("t2"), cell("t1"), nh, cell("t3"), is_add=1)
    mm(gate, Pp[1], Pp[1], nh, cell("w2"), is_add=1)
    mm(gate, cell("lamd"), cell("w2"), nh, cell("t3"))
    mm(gate, cell("lamd"), cell("lamd"), nh, cell("s1"))
    mm(gate, cell("dx"), Pp[0], nh, cell("du"), is_add=1)
    mm(gate, cell("du"), Pp[0], nh, cell("s1"), is_add=1)
    mm(gate, cell("d2"), cell("dx"), nh, Pp[0], is_add=1)
    mm(gate, cell("lamd"), cell("d2"), nh, cell("t4"))
    mm(gate, cell("dy"), Pp[1], nh, cell("t4"), is_add=1)
    return cell("dx"), cell("dy")


# ---------------------------------------------------------------------------
# host-side mirrors (emit MulModEvents + the block cell values)
# ---------------------------------------------------------------------------
def _ev(events, a, b, n, r, is_add=False):
    from .mulmod import MulModEvent

    events.append(MulModEvent(a=a, b=b, n=n, r=r, is_add=is_add))


def host_add_block(events, P, Q, p: int):
    """P + Q (affine, x1 != x2) mod p.  Returns (cells, (x3, y3))."""
    ddx = (Q[0] - P[0]) % p
    dinv = pow(ddx, -1, p)
    dyd = (Q[1] - P[1]) % p
    lam = dyd * dinv % p
    s2 = lam * lam % p
    x3 = (s2 - P[0] - Q[0]) % p
    au = (x3 + P[0]) % p
    d3 = (P[0] - x3) % p
    t5 = lam * d3 % p
    y3 = (t5 - P[1]) % p
    _ev(events, ddx, P[0], p, Q[0], True)
    _ev(events, dinv, ddx, p, 1)
    _ev(events, dyd, P[1], p, Q[1], True)
    _ev(events, lam, ddx, p, dyd)
    _ev(events, lam, lam, p, s2)
    _ev(events, x3, P[0], p, au, True)
    _ev(events, au, Q[0], p, s2, True)
    _ev(events, d3, x3, p, P[0], True)
    _ev(events, lam, d3, p, t5)
    _ev(events, y3, P[1], p, t5, True)
    cells = dict(ddx=ddx, dinv=dinv, dyd=dyd, lama=lam, s2=s2, au=au,
                 d3=d3, t5=t5, rx=x3, ry=y3)
    return cells, (x3, y3)


def host_dbl_block(events, P, p: int):
    t1 = P[0] * P[0] % p
    t2 = 2 * t1 % p
    t3 = 3 * t1 % p
    w2 = 2 * P[1] % p
    lam = t3 * pow(w2, -1, p) % p
    s1 = lam * lam % p
    dx = (s1 - 2 * P[0]) % p
    du = (dx + P[0]) % p
    d2 = (P[0] - dx) % p
    t4 = lam * d2 % p
    dy = (t4 - P[1]) % p
    _ev(events, P[0], P[0], p, t1)
    _ev(events, t1, t1, p, t2, True)
    _ev(events, t2, t1, p, t3, True)
    _ev(events, P[1], P[1], p, w2, True)
    _ev(events, lam, w2, p, t3)
    _ev(events, lam, lam, p, s1)
    _ev(events, dx, P[0], p, du, True)
    _ev(events, du, P[0], p, s1, True)
    _ev(events, d2, dx, p, P[0], True)
    _ev(events, lam, d2, p, t4)
    _ev(events, dy, P[1], p, t4, True)
    cells = dict(t1=t1, t2=t2, t3=t3, w2=w2, lamd=lam, s1=s1, du=du,
                 d2=d2, t4=t4, dx=dx, dy=dy)
    return cells, (dx, dy)
