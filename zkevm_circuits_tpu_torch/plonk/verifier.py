"""PLONK verifier (port of zkevm_circuits_tpu/plonk/verifier.py): the
host-side mirror of prover.py.

Equivalent of halo2's `verify_proof::<KZG, VerifierSHPLONK, ...>`
(reference circuit-benchmarks/src/evm_circuit.rs:106-120).  Verification
cost is negligible next to proving, so everything here is
plain Python big-int arithmetic: transcript replay, gate/argument
evaluation at the challenge point, commitment algebra, and the final
2-pairing SHPLONK check.
"""

from __future__ import annotations

from ..crypto.params import FR_MODULUS as R
from ..crypto.curve import host_g1_add, host_g1_mul
from ..poly.domain import domain
from ..poly.kzg import VerifierQuery, shplonk_verify
from ..poly.transcript import Blake2bReader
from .circuit import usable_rows
from .expression import Challenge, Constant, Neg, Product, Query, Sum
from .keygen import VerifyingKey, ceil_log2, quotient_degree


def _eval_expr(e, getq, ch):
    if isinstance(e, Constant):
        return e.value % R
    if isinstance(e, Query):
        return getq(e.kind, e.col, e.rot)
    if isinstance(e, Challenge):
        return ch[e.index]
    if isinstance(e, Neg):
        return (-_eval_expr(e.a, getq, ch)) % R
    if isinstance(e, Sum):
        return (_eval_expr(e.a, getq, ch) + _eval_expr(e.b, getq, ch)) % R
    if isinstance(e, Product):
        return _eval_expr(e.a, getq, ch) * _eval_expr(e.b, getq, ch) % R
    raise TypeError(type(e))


def verify(vk: VerifyingKey, instances: list[list[int]], proof: bytes,
           transcript=None) -> bool:
    """`transcript`: optional reader instance (default Blake2bReader);
    pass poly.transcript.PoseidonReader(proof) to verify proofs made with
    PoseidonTranscript."""
    cs = vk.cs
    k, n = vk.k, vk.n
    u = usable_rows(n)
    dom = domain(k)
    omega = dom.omega
    rd = transcript if transcript is not None else Blake2bReader(proof)

    for col in instances:
        for v in col:
            rd.common_scalar(v % R)

    # ---- commitments ------------------------------------------------------
    advice_comms: dict[int, tuple] = {}
    challenge_ints: dict[int, int] = {}
    for phase in range(cs.num_phases):
        for ci in sorted(
            c for c, ph in enumerate(cs.advice_phases) if ph == phase
        ):
            advice_comms[ci] = rd.read_point()
        for idx, ph in enumerate(cs.challenge_phases):
            if ph == phase:
                challenge_ints[idx] = rd.squeeze_challenge()

    theta = rd.squeeze_challenge()
    lookup_comms = []
    for _ in cs.lookups:
        ap_c = rd.read_point()
        sp_c = rd.read_point()
        lookup_comms.append((ap_c, sp_c))

    logup_m_comms = [rd.read_point() for _ in cs.logups]

    beta = rd.squeeze_challenge()
    gamma = rd.squeeze_challenge()

    perm_cols = cs.perm_columns
    z_perm_comm = rd.read_point() if perm_cols else None
    lookup_z_comms = [rd.read_point() for _ in cs.lookups]
    logup_comms = []
    for lg in cs.logups:
        h_comms_j = [rd.read_point() for _ in lg.inputs]
        ht_comm = rd.read_point()
        phi_comm = rd.read_point()
        logup_comms.append((h_comms_j, ht_comm, phi_comm))

    y = rd.squeeze_challenge()

    d = quotient_degree(cs)
    k_ext = k + ceil_log2(max(d - 1, 2))
    n_pieces = (1 << k_ext) // n
    h_comms = [rd.read_point() for _ in range(n_pieces)]

    x = rd.squeeze_challenge()
    xn = pow(x, n, R)

    # ---- evals ----------------------------------------------------------------
    adv_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "advice"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "advice"}
    )
    fix_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "fixed"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "fixed"}
    )
    adv_evals = {(c, r): rd.read_scalar() for c, r in adv_queries}
    fix_evals = {(c, r): rd.read_scalar() for c, r in fix_queries}
    sigma_evals = [rd.read_scalar() for _ in perm_cols]
    if perm_cols:
        z_perm_x = rd.read_scalar()
        z_perm_wx = rd.read_scalar()
    lk_evals = []
    for _ in cs.lookups:
        lk_evals.append(
            dict(
                z_x=rd.read_scalar(),
                z_wx=rd.read_scalar(),
                ap_x=rd.read_scalar(),
                ap_winv=rd.read_scalar(),
                sp_x=rd.read_scalar(),
            )
        )
    lg_evals = []
    for lg in cs.logups:
        lg_evals.append(
            dict(
                h_x=[rd.read_scalar() for _ in lg.inputs],
                ht_x=rd.read_scalar(),
                m_x=rd.read_scalar(),
                phi_x=rd.read_scalar(),
                phi_wx=rd.read_scalar(),
            )
        )

    # instance evals computed locally: L_i(p) = omega^i (p^n - 1) / (n (p - omega^i))
    def lagrange_at(i: int, p: int) -> int:
        wi = pow(omega, i, R)
        denom = n * (p - wi) % R
        if denom == 0:
            # p is in H: L_i(p) is 1 at omega^i else 0
            return 1 if p == wi else 0
        return wi * (pow(p, n, R) - 1) % R * pow(denom, -1, R) % R

    def instance_eval(col: int, rot: int) -> int:
        p = x * pow(omega, rot % n, R) % R
        vals = instances[col] if col < len(instances) else []
        return sum(v % R * lagrange_at(i, p) for i, v in enumerate(vals)) % R

    def getq(kind, col, rot):
        if kind == "advice":
            return adv_evals[(col, rot)]
        if kind == "fixed":
            return fix_evals[(col, rot)]
        if kind == "instance":
            return instance_eval(col, rot)
        raise KeyError(kind)

    # ---- reconstruct expected quotient eval -----------------------------------
    l0_x = lagrange_at(0, x)
    llast_x = lagrange_at(u, x)
    lactive_x = (1 - sum(lagrange_at(i, x) for i in range(u, n))) % R

    expected = 0

    def add_c(c):
        nonlocal expected
        expected = (expected * y + c) % R

    for g in cs.gates:
        for p in g.polys:
            add_c(_eval_expr(p, getq, challenge_ints))

    from .keygen import DELTA

    if perm_cols:
        add_c(l0_x * (z_perm_x - 1) % R)
        add_c(llast_x * (z_perm_x * z_perm_x - z_perm_x) % R)
        num = 1
        den = 1
        for ci, (kind, col) in enumerate(perm_cols):
            v = getq(kind, col, 0)
            num = num * (v + beta * pow(DELTA, ci, R) % R * x + gamma) % R
            den = den * (v + beta * sigma_evals[ci] + gamma) % R
        add_c(lactive_x * (z_perm_wx * den - z_perm_x * num) % R)

    for lk, le in zip(cs.lookups, lk_evals):
        a_x = 0
        for e in lk.inputs:
            a_x = (a_x * theta + _eval_expr(e, getq, challenge_ints)) % R
        s_x = 0
        for e in lk.tables:
            s_x = (s_x * theta + _eval_expr(e, getq, challenge_ints)) % R
        add_c(l0_x * (le["z_x"] - 1) % R)
        add_c(llast_x * (le["z_x"] * le["z_x"] - le["z_x"]) % R)
        lhs = le["z_wx"] * (le["ap_x"] + beta) % R * (le["sp_x"] + gamma) % R
        rhs = le["z_x"] * (a_x + beta) % R * (s_x + gamma) % R
        add_c(lactive_x * (lhs - rhs) % R)
        add_c(l0_x * (le["ap_x"] - le["sp_x"]) % R)
        add_c(
            lactive_x
            * (le["ap_x"] - le["sp_x"])
            % R
            * (le["ap_x"] - le["ap_winv"])
            % R
        )

    for lg, le in zip(cs.logups, lg_evals):
        add_c(l0_x * le["phi_x"] % R)
        add_c(llast_x * le["phi_x"] % R)
        dsum = 0
        for tup, h_x in zip(lg.inputs, le["h_x"]):
            a_x = 0
            for e in tup:
                a_x = (a_x * theta + _eval_expr(e, getq, challenge_ints)) % R
            add_c(lactive_x * (h_x * (a_x + beta) - 1) % R)
            dsum = (dsum + h_x) % R
        t_x_val = 0
        for e in lg.table:
            t_x_val = (t_x_val * theta + _eval_expr(e, getq, challenge_ints)) % R
        add_c(lactive_x * (le["ht_x"] * (t_x_val + beta) - le["m_x"]) % R)
        dsum = (dsum - le["ht_x"]) % R
        add_c(lactive_x * (le["phi_wx"] - le["phi_x"] - dsum) % R)

    t_x = (xn - 1) % R
    if t_x == 0:
        return False
    expected_h = expected * pow(t_x, -1, R) % R

    # combined h commitment: sum_i x^{n i} [h_i]
    h_comb = None
    for i, c in enumerate(h_comms):
        h_comb = host_g1_add(h_comb, host_g1_mul(c, pow(xn, i, R)))

    # ---- multiopen queries (must mirror prover order) ---------------------------
    def rot_point(rot: int) -> int:
        return x * pow(omega, rot % n, R) % R

    queries: list[VerifierQuery] = []
    pid = 0
    poly_ids: dict = {}

    def q(comm, key, point, ev):
        nonlocal pid
        if key not in poly_ids:
            poly_ids[key] = pid
            pid += 1
        queries.append(VerifierQuery(comm, point, ev, poly_ids[key]))

    for c, r in adv_queries:
        q(advice_comms[c], ("a", c), rot_point(r), adv_evals[(c, r)])
    for c, r in fix_queries:
        q(vk.fixed_commitments[c], ("f", c), rot_point(r), fix_evals[(c, r)])
    for ci in range(len(perm_cols)):
        q(vk.sigma_commitments[ci], ("s", ci), x, sigma_evals[ci])
    if perm_cols:
        q(z_perm_comm, ("zp",), x, z_perm_x)
        q(z_perm_comm, ("zp",), rot_point(1), z_perm_wx)
    for li, le in enumerate(lk_evals):
        ap_c, sp_c = lookup_comms[li]
        q(lookup_z_comms[li], ("lz", li), x, le["z_x"])
        q(lookup_z_comms[li], ("lz", li), rot_point(1), le["z_wx"])
        q(ap_c, ("lap", li), x, le["ap_x"])
        q(ap_c, ("lap", li), rot_point(-1), le["ap_winv"])
        q(sp_c, ("lsp", li), x, le["sp_x"])
    for li, le in enumerate(lg_evals):
        h_comms_j, ht_comm, phi_comm = logup_comms[li]
        for j, hc in enumerate(h_comms_j):
            q(hc, ("gh", li, j), x, le["h_x"][j])
        q(ht_comm, ("ght", li), x, le["ht_x"])
        q(logup_m_comms[li], ("gm", li), x, le["m_x"])
        q(phi_comm, ("gphi", li), x, le["phi_x"])
        q(phi_comm, ("gphi", li), rot_point(1), le["phi_wx"])
    q(h_comb, ("h",), x, expected_h)

    return shplonk_verify((vk.g2, vk.s_g2), queries, rd)
