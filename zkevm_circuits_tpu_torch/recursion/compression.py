"""CompressionCircuit — layer-1 recursion: in-circuit PLONK verification.

Equivalent of the reference's `CompressionCircuit`
(aggregator/src/compression/circuit.rs:39) + the scalar half of
snark-verifier's in-circuit PLONK verifier.  Given an inner proof made
with the Poseidon transcript (poly/transcript.py), this circuit:

  * replays the Fiat-Shamir transcript with in-circuit Poseidon chain
    rows (one PoseidonTable row per sponge step),
  * re-computes every challenge and runs the FULL scalar verification of
    plonk/verifier.py on an arithmetic tape (recursion/tape.py): gate
    expressions at x, Lagrange/vanishing evals, permutation + lookup +
    logUp terms, the quotient identity, and the SHPLONK multiopen scalar
    reductions,
  * exposes the DEFERRED elliptic claim as its public instance: the
    proof's commitment coordinates (witnessed as 128-bit limbs, absorbed
    into the very transcript they bind) and the MSM scalars, such that

        C_L = sum_k scal_k * [P_k] - const_scalar * G - W1
        and   e(W2, [s]_2 - u [1]_2) * e(-C_L, [1]_2) = 1

    `finish_deferred` performs that MSM + pairing host-side (the
    aggregation layer folds many such claims and defers a single pairing,
    reference aggregator/src/core.rs KZG accumulation).

v0 scope (documented): the elliptic side is deferred, not in-circuit —
in-circuit scalar muls over the MulMod table (the Sig-circuit pattern)
land next; standalone mode leaves the Poseidon permutation itself to the
composed PoseidonCircuit (pass `poseidon_table=` to bind it).

Port of zkevm_circuits_tpu/recursion/compression.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.  `finish_deferred` sums the
deferred MSM as one host MSM (`deferred_sides`, crypto/curve.host_msm) where
the reference adds one scalar multiplication per term: the same point, in
seconds for the thousands of terms of a production chunk proof's claim.
"""

from __future__ import annotations

import dataclasses

from ..crypto import pairing as pr
from ..crypto.curve import host_msm
from ..crypto.params import FQ_MODULUS, FR_MODULUS as R, G1_GEN
from ..crypto.poseidon import permute, spec
from ..crypto.field import fr
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import (
    Advice, Challenge, Constant, Fixed, Neg, Product, Query, Sum,
)
from ..plonk.keygen import DELTA, VerifyingKey, ceil_log2, quotient_degree
from ..poly.domain import domain
from ..poly.transcript import SQUEEZE_TAG
from .tape import OP_ADD, OP_CONST, OP_INPUT, OP_INV, OP_MUL, Sym, Tape

F = fr()
_LIMB = (1 << 128) - 1


class _SymSponge:
    """PoseidonSponge over tape symbols; records (state, a, b, out) rows."""

    def __init__(self, tape: Tape):
        self.tape = tape
        self._sp = spec()
        self.state = tape.const(0)
        self._buf: list[Sym] = []
        self._count = 0
        self.perm_rows: list[tuple[Sym, Sym, Sym, Sym]] = []

    def _step(self, a: Sym, b: Sym):
        t = self.tape
        out_v = permute(
            [t.value(self.state), t.value(a), t.value(b)], self._sp
        )[0]
        out = t.input(out_v)  # bound by the PoseidonTable lookup
        self.perm_rows.append((self.state, a, b, out))
        self.state = out

    def absorb(self, *syms: Sym):
        self._buf.extend(syms)
        self._count += len(syms)

    def _flush(self):
        t = self.tape
        for i in range(0, len(self._buf), 2):
            a = self._buf[i]
            b = self._buf[i + 1] if i + 1 < len(self._buf) else t.const(0)
            self._step(a, b)
        self._buf = []

    def squeeze(self) -> Sym:
        self._flush()
        self._step(self.tape.const(self._count),
                   self.tape.const(SQUEEZE_TAG))
        return self.state


class _Reader:
    """Proof-byte reader that mirrors PoseidonReader, producing tape
    symbols and collecting the host-side points for the deferred MSM."""

    def __init__(self, tape: Tape, sponge: _SymSponge, proof: bytes):
        self.tape, self.sponge = tape, sponge
        self.buf = memoryview(bytes(proof))
        self.off = 0
        self.points: list = []  # host (x, y) | None, in read order
        self.point_limbs: list[Sym] = []  # 4 limb syms per point, exposed

    def read_scalar(self) -> Sym:
        v = int.from_bytes(self.buf[self.off:self.off + 32], "little")
        self.off += 32
        s = self.tape.input(v)
        self.sponge.absorb(s)
        return s

    def read_point(self):
        x = int.from_bytes(self.buf[self.off:self.off + 32], "little")
        y = int.from_bytes(self.buf[self.off + 32:self.off + 64], "little")
        self.off += 64
        xy = None if (x == 0 and y == 0) else (x, y)
        self.points.append(xy)
        limbs = [self.tape.input(v) for v in
                 (x & _LIMB, x >> 128, y & _LIMB, y >> 128)]
        self.point_limbs.extend(limbs)
        self.sponge.absorb(*limbs)
        return len(self.points) - 1  # handle into self.points


def _eval_expr_sym(t: Tape, e, getq, ch: dict) -> Sym:
    if isinstance(e, Constant):
        return t.const(e.value % R)
    if isinstance(e, Challenge):
        return ch[e.index]
    if isinstance(e, Query):
        return getq(e.kind, e.col, e.rot)
    if isinstance(e, Neg):
        return t.mulc(_eval_expr_sym(t, e.a, getq, ch), R - 1)
    if isinstance(e, Sum):
        return t.add(_eval_expr_sym(t, e.a, getq, ch),
                     _eval_expr_sym(t, e.b, getq, ch))
    if isinstance(e, Product):
        return t.mul(_eval_expr_sym(t, e.a, getq, ch),
                     _eval_expr_sym(t, e.b, getq, ch))
    raise TypeError(type(e))


@dataclasses.dataclass
class DeferredClaim:
    """The elliptic work this circuit defers (host/next layer).

    Scalars are instance positions; points are either read-order indices
    into the witnessed proof points ("p", i) or vk constants ("f", c) /
    ("s", c) / ("g",) — resolved by finish_deferred."""

    msm: list[tuple[tuple, int]]  # (point_ref, scalar_instance_pos)
    const_scalar_pos: int
    w1_ref: tuple
    w2_ref: tuple
    u_pos: int
    n_points: int  # witnessed proof points (4 limbs each, instance head)
    n_inner_instance: int


def build_verify_tape(vk: VerifyingKey, proof: bytes,
                      instances: list[list[int]]):
    """Run plonk/verifier.py's algorithm symbolically over a tape.

    Returns (tape, perm_rows, claim).  Structure depends only on vk (and
    instance SHAPE); values on the proof — so the same circuit layout
    serves every proof of the inner circuit."""
    t = Tape()
    sponge = _SymSponge(t)
    rd = _Reader(t, sponge, proof)
    cs = vk.cs
    k, n = vk.k, vk.n
    u_rows = usable_rows(n)
    omega = domain(k).omega

    # -- inner instances: witnessed, exposed, absorbed ----------------------
    inst_syms: list[list[Sym]] = []
    n_inner_inst = 0
    for col in instances:
        syms = [t.input(v % R) for v in col]
        inst_syms.append(syms)
        for s_ in syms:
            sponge.absorb(s_)
            t.expose(s_)
        n_inner_inst += len(syms)

    # -- transcript replay (mirrors verifier.py exactly) --------------------
    advice_comms: dict[int, int] = {}
    challenge_syms: dict[int, Sym] = {}
    for phase in range(cs.num_phases):
        for ci in sorted(
            c for c, ph in enumerate(cs.advice_phases) if ph == phase
        ):
            advice_comms[ci] = rd.read_point()
        for idx, ph in enumerate(cs.challenge_phases):
            if ph == phase:
                challenge_syms[idx] = sponge.squeeze()

    theta = sponge.squeeze()
    lookup_comms = [(rd.read_point(), rd.read_point()) for _ in cs.lookups]
    logup_m_comms = [rd.read_point() for _ in cs.logups]
    beta = sponge.squeeze()
    gamma = sponge.squeeze()
    perm_cols = cs.perm_columns
    z_perm_comm = rd.read_point() if perm_cols else None
    lookup_z_comms = [rd.read_point() for _ in cs.lookups]
    logup_comms = []
    for lg in cs.logups:
        h_js = [rd.read_point() for _ in lg.inputs]
        logup_comms.append((h_js, rd.read_point(), rd.read_point()))
    y = sponge.squeeze()
    d = quotient_degree(cs)
    k_ext = k + ceil_log2(max(d - 1, 2))
    n_pieces = (1 << k_ext) // n
    h_comms = [rd.read_point() for _ in range(n_pieces)]
    x = sponge.squeeze()
    xn = t.pow(x, n)

    # -- evals ----------------------------------------------------------------
    adv_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "advice"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "advice"}
    )
    fix_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "fixed"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "fixed"}
    )
    adv_evals = {q_: rd.read_scalar() for q_ in adv_queries}
    fix_evals = {q_: rd.read_scalar() for q_ in fix_queries}
    sigma_evals = [rd.read_scalar() for _ in perm_cols]
    if perm_cols:
        z_perm_x = rd.read_scalar()
        z_perm_wx = rd.read_scalar()
    lk_evals = [
        dict(z_x=rd.read_scalar(), z_wx=rd.read_scalar(),
             ap_x=rd.read_scalar(), ap_winv=rd.read_scalar(),
             sp_x=rd.read_scalar())
        for _ in cs.lookups
    ]
    lg_evals = [
        dict(h_x=[rd.read_scalar() for _ in lg.inputs],
             ht_x=rd.read_scalar(), m_x=rd.read_scalar(),
             phi_x=rd.read_scalar(), phi_wx=rd.read_scalar())
        for lg in cs.logups
    ]

    # -- Lagrange machinery ---------------------------------------------------
    one = t.const(1)
    pow_cache: dict[int, Sym] = {x.idx: xn}

    def pn_of(p: Sym) -> Sym:
        if p.idx not in pow_cache:
            pow_cache[p.idx] = t.pow(p, n)
        return pow_cache[p.idx]

    def lagrange_at(i: int, p: Sym) -> Sym:
        """wi (p^n - 1) / (n (p - wi)); branchless — p in H is negligible
        (and would only fail witness gen / the inv gate, not soundness)."""
        wi = pow(omega, i, R)
        denom = t.mulc(t.addc(p, R - wi), n)
        num = t.mulc(t.addc(pn_of(p), R - 1), wi)
        return t.mul(num, t.inv(denom))

    rot_cache: dict[int, Sym] = {0: x}

    def rot_sym(rot: int) -> Sym:
        """One Sym per rotation: the SHPLONK grouping below keys on point
        symbols, which must coincide exactly when the point values do
        (the prover groups by point-value sets, kzg._group_by_point_set)."""
        key = rot % n
        if key not in rot_cache:
            rot_cache[key] = t.mulc(x, pow(omega, key, R))
        return rot_cache[key]

    def instance_eval(col: int, rot: int) -> Sym:
        p = rot_sym(rot)
        vals = inst_syms[col] if col < len(inst_syms) else []
        acc = t.const(0)
        for i, s_ in enumerate(vals):
            acc = t.add(acc, t.mul(s_, lagrange_at(i, p)))
        return acc

    def getq(kind, col, rot) -> Sym:
        if kind == "advice":
            return adv_evals[(col, rot)]
        if kind == "fixed":
            return fix_evals[(col, rot)]
        if kind == "instance":
            return instance_eval(col, rot)
        raise KeyError(kind)

    l0_x = lagrange_at(0, x)
    llast_x = lagrange_at(u_rows, x)
    lsum = t.const(0)
    for i in range(u_rows, n):
        lsum = t.add(lsum, lagrange_at(i, x))
    lactive_x = t.sub(one, lsum)

    # -- expected quotient eval (y-fold of all constraint terms) -----------
    expected = t.const(0)

    def add_c(c: Sym):
        nonlocal expected
        expected = t.add(t.mul(expected, y), c)

    for g in cs.gates:
        for p_ in g.polys:
            add_c(_eval_expr_sym(t, p_, getq, challenge_syms))

    if perm_cols:
        add_c(t.mul(l0_x, t.sub(z_perm_x, one)))
        add_c(t.mul(llast_x, t.sub(t.mul(z_perm_x, z_perm_x), z_perm_x)))
        num = one
        den = one
        for ci, (kind, col) in enumerate(perm_cols):
            v = getq(kind, col, 0)
            idt = t.mulc(x, pow(DELTA, ci, R))
            num = t.mul(num, t.add(v, t.add(t.mul(beta, idt), gamma)))
            den = t.mul(den, t.add(v, t.add(t.mul(beta, sigma_evals[ci]),
                                            gamma)))
        add_c(t.mul(lactive_x,
                    t.sub(t.mul(z_perm_wx, den), t.mul(z_perm_x, num))))

    def compress(exprs) -> Sym:
        acc = t.const(0)
        for e in exprs:
            acc = t.add(t.mul(acc, theta),
                        _eval_expr_sym(t, e, getq, challenge_syms))
        return acc

    for lk, le in zip(cs.lookups, lk_evals):
        a_x = compress(lk.inputs)
        s_x = compress(lk.tables)
        add_c(t.mul(l0_x, t.sub(le["z_x"], one)))
        add_c(t.mul(llast_x, t.sub(t.mul(le["z_x"], le["z_x"]), le["z_x"])))
        lhs = t.mul(le["z_wx"], t.mul(t.add(le["ap_x"], beta),
                                      t.add(le["sp_x"], gamma)))
        rhs = t.mul(le["z_x"], t.mul(t.add(a_x, beta), t.add(s_x, gamma)))
        add_c(t.mul(lactive_x, t.sub(lhs, rhs)))
        add_c(t.mul(l0_x, t.sub(le["ap_x"], le["sp_x"])))
        add_c(t.mul(lactive_x, t.mul(t.sub(le["ap_x"], le["sp_x"]),
                                     t.sub(le["ap_x"], le["ap_winv"]))))

    for lg, le in zip(cs.logups, lg_evals):
        add_c(t.mul(l0_x, le["phi_x"]))
        add_c(t.mul(llast_x, le["phi_x"]))
        dsum = t.const(0)
        for tup, h_x in zip(lg.inputs, le["h_x"]):
            a_x = compress(tup)
            add_c(t.mul(lactive_x,
                        t.sub(t.mul(h_x, t.add(a_x, beta)), one)))
            dsum = t.add(dsum, h_x)
        t_x_val = compress(lg.table)
        add_c(t.mul(lactive_x, t.sub(t.mul(le["ht_x"],
                                           t.add(t_x_val, beta)),
                                     le["m_x"])))
        dsum = t.sub(dsum, le["ht_x"])
        add_c(t.mul(lactive_x,
                    t.sub(t.sub(le["phi_wx"], le["phi_x"]), dsum)))

    t_x = t.addc(xn, R - 1)
    expected_h = t.mul(expected, t.inv(t_x))

    # -- multiopen queries (mirror verifier.py order; h_comb expands into
    # its pieces with x^{n i} weights folded into the group scalar) --------
    queries: list[tuple] = []  # (point_ref, key, point_sym, eval_sym)
    pid = 0
    poly_ids: dict = {}

    def q(ref, key, point, ev):
        nonlocal pid
        if key not in poly_ids:
            poly_ids[key] = pid
            pid += 1
        queries.append((ref, key, point, ev, poly_ids[key]))

    for c, r_ in adv_queries:
        q(("p", advice_comms[c]), ("a", c), rot_sym(r_), adv_evals[(c, r_)])
    for c, r_ in fix_queries:
        q(("f", c), ("f", c), rot_sym(r_), fix_evals[(c, r_)])
    for ci in range(len(perm_cols)):
        q(("s", ci), ("s", ci), x, sigma_evals[ci])
    if perm_cols:
        q(("p", z_perm_comm), ("zp",), x, z_perm_x)
        q(("p", z_perm_comm), ("zp",), rot_sym(1), z_perm_wx)
    for li, le in enumerate(lk_evals):
        ap_c, sp_c = lookup_comms[li]
        q(("p", lookup_z_comms[li]), ("lz", li), x, le["z_x"])
        q(("p", lookup_z_comms[li]), ("lz", li), rot_sym(1), le["z_wx"])
        q(("p", ap_c), ("lap", li), x, le["ap_x"])
        q(("p", ap_c), ("lap", li), rot_sym(-1), le["ap_winv"])
        q(("p", sp_c), ("lsp", li), x, le["sp_x"])
    for li, le in enumerate(lg_evals):
        h_js, ht_c, phi_c = logup_comms[li]
        for j, hc in enumerate(h_js):
            q(("p", hc), ("gh", li, j), x, le["h_x"][j])
        q(("p", ht_c), ("ght", li), x, le["ht_x"])
        q(("p", logup_m_comms[li]), ("gm", li), x, le["m_x"])
        q(("p", phi_c), ("gphi", li), x, le["phi_x"])
        q(("p", phi_c), ("gphi", li), rot_sym(1), le["phi_wx"])
    q(("h",), ("h",), x, expected_h)

    # -- SHPLONK verify scalars (mirrors kzg.shplonk_verify) ----------------
    gamma_mo = sponge.squeeze()
    by_poly: dict[int, list] = {}
    order: list[int] = []
    for ref, key, point, ev, pd in queries:
        if pd not in by_poly:
            order.append(pd)
        by_poly.setdefault(pd, []).append((ref, point, ev))
    groups: dict[frozenset, list] = {}
    gorder = []
    for pd in order:
        qs = by_poly[pd]
        pts = frozenset(p.idx for (_, p, _) in qs)
        if pts not in groups:
            gorder.append(pts)
        groups.setdefault(pts, []).append(qs)

    w1 = rd.read_point()
    u = sponge.squeeze()

    msm: list[tuple[tuple, Sym]] = []  # (point_ref, scalar_sym)
    const_scalar = t.const(0)
    gamma_pow = one  # gamma^c, c incrementing per poly (verifier order)
    for pts_set in gorder:
        # one Sym per rotation (rot_sym cache), so index order is the
        # canonical structural order matching the prover's value grouping
        pts_l = sorted(pts_set)
        pt_syms = [Sym(i) for i in pts_l]
        zs_u = one
        for p_ in pt_syms:
            zs_u = t.mul(zs_u, t.sub(u, p_))
        zinv = t.inv(zs_u)
        for qs in groups[pts_set]:
            scal = t.mul(gamma_pow, zinv)
            gamma_pow = t.mul(gamma_pow, gamma_mo)
            # r(u): Lagrange interpolation over the query points
            evals = {p.idx: e for (_, p, e) in qs}
            r_u = t.const(0)
            for j, pj in enumerate(pt_syms):
                num = evals[pj.idx]
                for m, pm in enumerate(pt_syms):
                    if m == j:
                        continue
                    num = t.mul(num, t.sub(u, pm))
                    num = t.mul(num, t.inv(t.sub(pj, pm)))
                r_u = t.add(r_u, num)
            ref = qs[0][0]
            if ref == ("h",):
                # h_comb = sum_i x^{n i} [h_i]: expand into pieces
                piece_scal = scal
                for i, hc in enumerate(h_comms):
                    msm.append((("p", hc), piece_scal))
                    if i + 1 < len(h_comms):
                        piece_scal = t.mul(piece_scal, xn)
            else:
                msm.append((ref, scal))
            const_scalar = t.add(const_scalar, t.mul(scal, r_u))

    w2 = rd.read_point()

    # -- expose the deferred claim -----------------------------------------
    # instance layout: [inner instances] [point limbs, read order]
    #                  [msm scalars] [const_scalar] [u]
    for s_ in rd.point_limbs:
        t.expose(s_)
    head = n_inner_inst + len(rd.point_limbs)
    msm_refs = []
    for pos, (ref, scal) in enumerate(msm):
        t.expose(scal)
        msm_refs.append((ref, head + pos))
    t.expose(const_scalar)
    t.expose(u)
    claim = DeferredClaim(
        msm=msm_refs,
        const_scalar_pos=head + len(msm),
        w1_ref=("p", w1),
        w2_ref=("p", w2),
        u_pos=head + len(msm) + 1,
        n_points=len(rd.points),
        n_inner_instance=n_inner_inst,
    )
    return t, sponge.perm_rows, claim, rd.points


# ---------------------------------------------------------------------------
# host finisher: the deferred MSM + pairing
# ---------------------------------------------------------------------------
def claim_points(claim: DeferredClaim, instance_values: list[int]) -> list:
    """The witnessed proof points, rebuilt from their exposed limbs
    (None = infinity), in read order."""
    points = []
    base = claim.n_inner_instance
    for i in range(claim.n_points):
        xl, xh, yl, yh = instance_values[base + 4 * i: base + 4 * i + 4]
        x_ = xl + (xh << 128)
        y_ = yl + (yh << 128)
        points.append(None if (x_ == 0 and y_ == 0) else (x_, y_))
    return points


def deferred_sides(vk_inner: VerifyingKey, claim: DeferredClaim,
                   instance_values: list[int]) -> tuple:
    """(W2, LHS) of the deferred claim, LHS = u W2 + sum scal_k [P_k]
    - const_scalar G - W1, as one host MSM (crypto/curve.host_msm: the
    claim of a production chunk proof has thousands of terms)."""
    vals = instance_values
    points = claim_points(claim, vals)

    def resolve(ref):
        if ref[0] == "p":
            return points[ref[1]]
        if ref[0] == "f":
            return vk_inner.fixed_commitments[ref[1]]
        if ref[0] == "s":
            return vk_inner.sigma_commitments[ref[1]]
        raise KeyError(ref)

    w2 = resolve(claim.w2_ref)
    bases = [resolve(ref) for ref, _ in claim.msm]
    scalars = [vals[pos] for _, pos in claim.msm]
    bases += [G1_GEN, resolve(claim.w1_ref), w2]
    scalars += [(R - vals[claim.const_scalar_pos]) % R, R - 1, vals[claim.u_pos]]
    return w2, host_msm(bases, scalars)


def finish_deferred(vk_inner: VerifyingKey, claim: DeferredClaim,
                    instance_values: list[int]) -> bool:
    """Resolve the deferred elliptic claim against the compression
    circuit's public instance (reference: the aggregation layer folds
    these; the outermost verifier runs the pairing,
    prover/src/common/prover/evm.rs)."""
    w2, lhs_pt = deferred_sides(vk_inner, claim, instance_values)
    neg = lambda p: None if p is None else (p[0], (-p[1]) % FQ_MODULUS)
    return pr.pairing_product_is_one(
        [(w2, vk_inner.s_g2), (neg(lhs_pt), vk_inner.g2)]
    )


# ---------------------------------------------------------------------------
# the circuit
# ---------------------------------------------------------------------------
class TapeCircuit(Circuit):
    """Columnar tape circuit: one row per field op — c = a op b with
    operands routed by plonk copy constraints (the permutation argument
    does all wiring, so the gates stay uniform degree-2 and the whole
    column evaluates in one vectorized pass, the columnar replacement
    for snark-verifier's per-gadget halo2 regions).  A parallel Poseidon
    section carries sponge steps, one row per permutation, each bound to
    the tape by copies and (composed mode) to the PoseidonTable."""

    def __init__(self, tape, perm_rows):
        self.tape = tape
        self.perm_rows = perm_rows

    # -- public API ---------------------------------------------------------
    def instances(self) -> list[list[int]]:
        tv = self.tape.values
        return [[tv[i] for i in self.tape.exposed]]

    def min_k(self) -> int:
        rows = max(len(self.tape.ops), len(self.perm_rows),
                   len(self.tape.exposed))
        return ceil_log2(rows + 12)  # + blinding tail

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, poseidon_table=None):
        self.poseidon_table = poseidon_table
        self.q_tape = cs.fixed_column()
        self.f_add = cs.fixed_column()
        self.f_mul = cs.fixed_column()
        self.f_inv = cs.fixed_column()
        self.f_const = cs.fixed_column()
        self.c_constv = cs.fixed_column()
        self.q_perm = cs.fixed_column()
        self.c_val = cs.advice_column()
        self.c_a = cs.advice_column()
        self.c_b = cs.advice_column()
        self.p_state = cs.advice_column()
        self.p_a = cs.advice_column()
        self.p_b = cs.advice_column()
        self.p_out = cs.advice_column()
        self.inst = cs.instance_column()

        q = Fixed(self.q_tape)
        v = Advice(self.c_val)
        a = Advice(self.c_a)
        b = Advice(self.c_b)
        cs.create_gate("tape add", q * Fixed(self.f_add) * (a + b - v))
        cs.create_gate("tape mul", q * Fixed(self.f_mul) * (a * b - v))
        cs.create_gate("tape inv", q * Fixed(self.f_inv) * (a * v - 1))
        cs.create_gate(
            "tape const", q * Fixed(self.f_const) * (v - Fixed(self.c_constv))
        )
        for col in (self.c_val, self.c_a, self.c_b, self.p_state,
                    self.p_a, self.p_b, self.p_out):
            cs.enable_equality("advice", col)
        cs.enable_equality("instance", self.inst)
        if poseidon_table is not None:
            qp = Fixed(self.q_perm)
            cs.lookup_logup(
                "transcript poseidon",
                [[qp, qp * Advice(self.p_state), qp * Advice(self.p_a),
                  qp * Advice(self.p_b), qp * Advice(self.p_out)]],
                poseidon_table,
            )

    def poseidon_events(self):
        """PoseidonEvents the composed PoseidonCircuit must prove."""
        from ..circuits.poseidon import PoseidonEvent

        tv = self.tape.values
        return [
            PoseidonEvent(domain=tv[st.idx], in0=tv[a.idx], in1=tv[b.idx])
            for (st, a, b, _) in self.perm_rows
        ]

    def copy_constraints(self, n):
        out = []
        for i, (op, ia, ib, _) in enumerate(self.tape.ops):
            if op in (OP_ADD, OP_MUL, OP_INV):
                out.append((Cell("advice", self.c_a, i),
                            Cell("advice", self.c_val, ia)))
            if op in (OP_ADD, OP_MUL):
                out.append((Cell("advice", self.c_b, i),
                            Cell("advice", self.c_val, ib)))
        for j, (st, a, b, outp) in enumerate(self.perm_rows):
            out.append((Cell("advice", self.p_state, j),
                        Cell("advice", self.c_val, st.idx)))
            out.append((Cell("advice", self.p_a, j),
                        Cell("advice", self.c_val, a.idx)))
            out.append((Cell("advice", self.p_b, j),
                        Cell("advice", self.c_val, b.idx)))
            out.append((Cell("advice", self.p_out, j),
                        Cell("advice", self.c_val, outp.idx)))
        for pos, idx in enumerate(self.tape.exposed):
            out.append((Cell("instance", self.inst, pos),
                        Cell("advice", self.c_val, idx)))
        return out

    def fixed_columns(self, n):
        T = len(self.tape.ops)
        P = len(self.perm_rows)
        assert max(T, P, len(self.tape.exposed)) <= usable_rows(n), (
            f"tape {T} / perm {P} rows exceed domain {n}"
        )
        mont = lambda vals: F.from_ints(
            [int(x) % R * F.R % R for x in vals] + [0] * (n - len(vals))
        )
        flags = {OP_ADD: [], OP_MUL: [], OP_INV: [], OP_CONST: []}
        consts = []
        for (op, ia, ib, cv) in self.tape.ops:
            for kf, lst in flags.items():
                lst.append(int(op == kf))
            consts.append(cv)
        return {
            self.q_tape: mont([1] * T),
            self.f_add: mont(flags[OP_ADD]),
            self.f_mul: mont(flags[OP_MUL]),
            self.f_inv: mont(flags[OP_INV]),
            self.f_const: mont(flags[OP_CONST]),
            self.c_constv: mont(consts),
            self.q_perm: mont([1] * P),
        }

    def synthesize(self, phase, n, challenges, instances):
        assert phase == 0
        tv = self.tape.values
        mont = lambda vals: F.from_ints(
            [int(x) % R * F.R % R for x in vals] + [0] * (n - len(vals))
        )
        a_vals, b_vals = [], []
        for (op, ia, ib, _) in self.tape.ops:
            a_vals.append(tv[ia] if op in (OP_ADD, OP_MUL, OP_INV) else 0)
            b_vals.append(tv[ib] if op in (OP_ADD, OP_MUL) else 0)
        return {
            self.c_val: mont(tv),
            self.c_a: mont(a_vals),
            self.c_b: mont(b_vals),
            self.p_state: mont([tv[st.idx] for st, _, _, _ in self.perm_rows]),
            self.p_a: mont([tv[a.idx] for _, a, _, _ in self.perm_rows]),
            self.p_b: mont([tv[b.idx] for _, _, b, _ in self.perm_rows]),
            self.p_out: mont([tv[o.idx] for _, _, _, o in self.perm_rows]),
        }


class CompressionCircuit(TapeCircuit):
    """TapeCircuit executing `build_verify_tape`'s program — the scalar
    half of one inner proof's verification (reference
    aggregator/src/compression/circuit.rs:39)."""

    def __init__(self, vk_inner: VerifyingKey, proof: bytes,
                 inner_instances: list[list[int]]):
        self.vk_inner = vk_inner
        tape, perm_rows, self.claim, self._points = build_verify_tape(
            vk_inner, proof, inner_instances
        )
        super().__init__(tape, perm_rows)
