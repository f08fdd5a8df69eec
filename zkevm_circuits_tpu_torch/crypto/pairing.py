"""BN254 optimal-ate pairing — host-side, pure Python big ints.

Pairings appear only on the VERIFIER side of KZG/SHPLONK (two pairings per
proof) and later inside the recursion circuits as constraint systems; the
prover's device path never computes one.  A straightforward big-int
implementation is therefore the right tool: latency-irrelevant, easy to
audit (reference: the reference repo gets this from halo2curves,
SURVEY.md §2.3 item 1).

Construction (standard alt_bn128 / EIP-197 math, re-derived):
  * Fq12 modeled flat as Fq[w]/(w^12 - 18 w^6 + 82), with the Fq2 element
    u = w^6 - 9 (u^2 = -1), so G2 coordinates (a + b*u) embed as
    (a - 9b) + b*w^6.
  * The sextic twist maps G2 into E(Fq12): (x, y) -> (x * w^2, y * w^3).
  * Miller loop over ate_loop_count = 6u+2 with affine line functions,
    plus the two Frobenius correction lines.
  * Final exponentiation done directly as f^((q^12 - 1) / r) — slow
    (~1s) but verification-only and unconditionally correct.
"""

from __future__ import annotations

from .params import BN_U, FQ_MODULUS as Q, FR_MODULUS as R
from .params import G2_GEN_X, G2_GEN_Y

ATE_LOOP_COUNT = 6 * BN_U + 2
LOG_ATE = ATE_LOOP_COUNT.bit_length() - 1

# w^12 = 18 w^6 - 82
_MOD_HI = 18
_MOD_LO = -82


class Fq12(tuple):
    """Coefficients c[0..11] of an Fq-polynomial in w (lowest first)."""

    def __new__(cls, coeffs):
        return super().__new__(cls, tuple(c % Q for c in coeffs))

    @classmethod
    def zero(cls):
        return cls((0,) * 12)

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * 11)

    @classmethod
    def scalar(cls, a: int):
        return cls((a,) + (0,) * 11)

    def __add__(self, o):
        return Fq12(x + y for x, y in zip(self, o))

    def __sub__(self, o):
        return Fq12(x - y for x, y in zip(self, o))

    def __neg__(self):
        return Fq12(-x for x in self)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(x * o for x in self)
        t = [0] * 23
        for i, a in enumerate(self):
            if a:
                for j, b in enumerate(o):
                    t[i + j] += a * b
        # reduce w^k for k >= 12: w^k = 18 w^(k-6) - 82 w^(k-12)
        for k in range(22, 11, -1):
            c = t[k] % Q
            if c:
                t[k - 6] += _MOD_HI * c
                t[k - 12] += _MOD_LO * c
            t[k] = 0
        return Fq12(t[:12])

    __rmul__ = __mul__

    def inv(self):
        # extended Euclid over Fq[x] against the modulus polynomial
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self) + [0]
        # modulus poly w^12 - 18w^6 + 82, monic coeffs lowest-first
        high = [82, 0, 0, 0, 0, 0, (-18) % Q, 0, 0, 0, 0, 0, 1]

        def deg(p):
            for i in reversed(range(len(p))):
                if p[i]:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = pow(b[degb], -1, Q)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r_ = poly_rounded_div(high, low)
            r_ += [0] * (13 - len(r_))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r_[j]) % Q
                    new[i + j] = (new[i + j] - low[i] * r_[j]) % Q
            high, low, hm, lm = low, new, lm, nm
        c0inv = pow(low[0], -1, Q)
        return Fq12([(c * c0inv) % Q for c in lm[:12]])

    def __pow__(self, e: int):
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def is_one(self):
        return self[0] == 1 and all(c == 0 for c in self[1:])


# w-power basis helpers
_W = Fq12((0, 1) + (0,) * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def fq2_to_fq12(c0: int, c1: int) -> Fq12:
    """a + b*u with u = w^6 - 9  ->  (a - 9b) + b*w^6."""
    co = [0] * 12
    co[0] = (c0 - 9 * c1) % Q
    co[6] = c1 % Q
    return Fq12(co)


def twist_g2(pt):
    """G2 affine ((x0,x1),(y0,y1)) -> point on E(Fq12) via the twist."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    x = fq2_to_fq12(x0, x1) * _W2
    y = fq2_to_fq12(y0, y1) * _W3
    return (x, y)


def g1_to_fq12(pt):
    if pt is None:
        return None
    return (Fq12.scalar(pt[0]), Fq12.scalar(pt[1]))


def _double(pt):
    x, y = pt
    m = (3 * (x * x)) * (2 * y).inv()
    nx = m * m - x - x
    ny = m * (x - nx) - y
    return (nx, ny)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all on E(Fq12))."""
    (x1, y1), (x2, y2) = p1, p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) * (2 * y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_tw, p_emb) -> Fq12:
    if q_tw is None or p_emb is None:
        return Fq12.one()
    r_pt = q_tw
    f = Fq12.one()
    for i in reversed(range(LOG_ATE)):
        f = f * f * _linefunc(r_pt, r_pt, p_emb)
        r_pt = _double(r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r_pt, q_tw, p_emb)
            r_pt = _add(r_pt, q_tw)
    # Frobenius corrections
    q1 = (q_tw[0] ** Q, q_tw[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r_pt, q1, p_emb)
    r_pt = _add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p_emb)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def pairing(p_g1, q_g2) -> Fq12:
    """e(P, Q) for P affine G1 int pair, Q affine G2 ((x0,x1),(y0,y1))."""
    f = miller_loop(twist_g2(q_g2), g1_to_fq12(p_g1))
    return f**_FINAL_EXP


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the KZG verification predicate.  Runs the
    Miller loops separately, multiplies, one shared final exponentiation."""
    f = Fq12.one()
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = f * miller_loop(twist_g2(q_g2), g1_to_fq12(p_g1))
    return (f**_FINAL_EXP).is_one()


G2_GENERATOR = (G2_GEN_X, G2_GEN_Y)


def g2_scalar_mul(pt, k: int):
    """[k]Q for Q affine G2 ((x0,x1),(y0,y1)); returns same representation.

    Internally works on the twisted E(Fq12) curve and maps back.
    """
    acc = None
    base = twist_g2(pt)
    while k:
        if k & 1:
            acc = _add(acc, base)
        base = _double(base)
        k >>= 1
    return untwist_g2(acc)


def untwist_g2(pt_tw):
    if pt_tw is None:
        return None
    x = pt_tw[0] * _W2.inv()
    y = pt_tw[1] * _W3.inv()

    def from_fq12(e: Fq12):
        # expect e = (a - 9b) + b*w^6
        b = e[6]
        a = (e[0] + 9 * b) % Q
        assert all(e[i] == 0 for i in (1, 2, 3, 4, 5, 7, 8, 9, 10, 11)), "not in Fq2"
        return (a, b)

    return (from_fq12(x), from_fq12(y))
