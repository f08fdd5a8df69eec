"""Standalone verifier-artifact generator — the reference's EVM-verifier
analogue.

The reference's layer-4 step emits a Yul contract hard-wired to the final
compression vk so ANY Ethereum node can verify the batch proof with no
prover-side code (reference prover/src/common/prover/evm.rs:11-46,
`gen_evm_verifier` + `evm_verify`).  This framework's deployment
surface is a host binary, so the equivalent artifact is a SELF-CONTAINED
pure-Python verifier file: stdlib-only (hashlib for the Blake2b
transcript), with the vk — commitments, constraint system (gates /
lookups / logUps serialized as postfix programs), domain parameters, G2
points — embedded as literals, plus inlined copies of the repo's own
big-int pairing and transcript code.  A user ships ONE .py file and runs

    python verifier_artifact.py proof.bin instances.json

`gen_verifier_artifact(vk, path)` writes the artifact;
`evm_verify(path, instances, proof)` runs it in a subprocess the way the
reference's `evm_verify` spawns the EVM (a clean interpreter with no
access to this repo).

Port of zkevm_circuits_tpu/recursion/evm_verifier.py: the same names, signatures,
data layout and behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from ..crypto import params as _params
from ..plonk.expression import Challenge, Constant, Neg, Product, Query, Sum
from ..plonk.keygen import VerifyingKey, ceil_log2, quotient_degree
from ..plonk.circuit import usable_rows


def _postfix(e, out: list):
    """Serialize an Expression to a postfix program (JSON-safe lists)."""
    if isinstance(e, Constant):
        out.append(["c", e.value % _params.FR_MODULUS])
    elif isinstance(e, Query):
        out.append(["q", e.kind, e.col, e.rot])
    elif isinstance(e, Challenge):
        out.append(["ch", e.index])
    elif isinstance(e, Neg):
        _postfix(e.a, out)
        out.append(["neg"])
    elif isinstance(e, Sum):
        _postfix(e.a, out)
        _postfix(e.b, out)
        out.append(["add"])
    elif isinstance(e, Product):
        _postfix(e.a, out)
        _postfix(e.b, out)
        out.append(["mul"])
    else:  # pragma: no cover
        raise TypeError(type(e))


def _prog(e) -> list:
    out: list = []
    _postfix(e, out)
    return out


def _inline_module(path: str, strip_prefixes: tuple) -> str:
    """Module source with repo-relative imports stripped (the needed
    constants are embedded separately) — keeps the artifact's pairing /
    transcript byte-identical to the library's."""
    src = open(path).read()
    lines = []
    for ln in src.splitlines():
        if any(ln.startswith(p) for p in strip_prefixes):
            continue
        lines.append(ln)
    return "\n".join(lines)


def serialize_vk(vk: VerifyingKey) -> dict:
    cs = vk.cs
    d = quotient_degree(cs)
    return {
        "k": vk.k,
        "usable_rows": usable_rows(vk.n),
        "n_pieces": (1 << (vk.k + ceil_log2(max(d - 1, 2)))) // vk.n,
        "fixed_commitments": [
            list(c) if c is not None else None for c in vk.fixed_commitments
        ],
        "sigma_commitments": [
            list(c) if c is not None else None for c in vk.sigma_commitments
        ],
        "g2": [list(vk.g2[0]), list(vk.g2[1])],
        "s_g2": [list(vk.s_g2[0]), list(vk.s_g2[1])],
        "advice_phases": list(cs.advice_phases),
        "challenge_phases": list(cs.challenge_phases),
        "perm_cols": [[kind, col] for kind, col in cs.perm_columns],
        "gates": [[_prog(p) for p in g.polys] for g in cs.gates],
        "lookups": [
            {"inputs": [_prog(e) for e in lk.inputs],
             "tables": [_prog(e) for e in lk.tables]}
            for lk in cs.lookups
        ],
        "logups": [
            {"inputs": [[_prog(e) for e in tup] for tup in lg.inputs],
             "table": [_prog(e) for e in lg.table]}
            for lg in cs.logups
        ],
    }


_ENGINE = '''
# ---------------------------------------------------------------------------
# generic verification engine (mirrors zkevm_circuits_tpu_torch/plonk/verifier.py)
# ---------------------------------------------------------------------------
def _run_prog(prog, getq, ch):
    st = []
    for op in prog:
        t = op[0]
        if t == "c":
            st.append(op[1] % R)
        elif t == "q":
            st.append(getq(op[1], op[2], op[3]))
        elif t == "ch":
            st.append(ch[op[1]])
        elif t == "neg":
            st.append((-st.pop()) % R)
        elif t == "add":
            b, a = st.pop(), st.pop()
            st.append((a + b) % R)
        elif t == "mul":
            b, a = st.pop(), st.pop()
            st.append(a * b % R)
        else:
            raise ValueError(t)
    return st[-1]


def _domain_omega(k):
    t_odd = (R - 1) >> FR_TWO_ADICITY
    root = pow(FR_GENERATOR, t_odd, R)
    return pow(root, 1 << (FR_TWO_ADICITY - k), R)


def verify(instances, proof):
    k = VK["k"]
    n = 1 << k
    u = VK["usable_rows"]
    omega = _domain_omega(k)
    rd = Blake2bReader(proof)
    tup = lambda p: None if p is None else tuple(p)
    num_phases = max(
        [0] + list(VK["advice_phases"])
        + [p + 1 for p in VK["challenge_phases"]]
    ) + 1

    for col in instances:
        for v in col:
            rd.common_scalar(v % R)

    advice_comms = {}
    challenge_ints = {}
    for phase in range(num_phases):
        for ci in sorted(
            c for c, ph in enumerate(VK["advice_phases"]) if ph == phase
        ):
            advice_comms[ci] = rd.read_point()
        for idx, ph in enumerate(VK["challenge_phases"]):
            if ph == phase:
                challenge_ints[idx] = rd.squeeze_challenge()

    theta = rd.squeeze_challenge()
    lookup_comms = [(rd.read_point(), rd.read_point()) for _ in VK["lookups"]]
    logup_m_comms = [rd.read_point() for _ in VK["logups"]]
    beta = rd.squeeze_challenge()
    gamma = rd.squeeze_challenge()
    perm_cols = VK["perm_cols"]
    z_perm_comm = rd.read_point() if perm_cols else None
    lookup_z_comms = [rd.read_point() for _ in VK["lookups"]]
    logup_comms = []
    for lg in VK["logups"]:
        h_comms_j = [rd.read_point() for _ in lg["inputs"]]
        logup_comms.append((h_comms_j, rd.read_point(), rd.read_point()))
    y = rd.squeeze_challenge()
    h_comms = [rd.read_point() for _ in range(VK["n_pieces"])]
    x = rd.squeeze_challenge()
    xn = pow(x, n, R)

    all_q = set()
    for g in VK["gates"]:
        for prog in g:
            for op in prog:
                if op[0] == "q":
                    all_q.add((op[1], op[2], op[3]))
    for lk in VK["lookups"]:
        for prog in lk["inputs"] + lk["tables"]:
            for op in prog:
                if op[0] == "q":
                    all_q.add((op[1], op[2], op[3]))
    for lg in VK["logups"]:
        for tup_ in lg["inputs"]:
            for prog in tup_:
                for op in prog:
                    if op[0] == "q":
                        all_q.add((op[1], op[2], op[3]))
        for prog in lg["table"]:
            for op in prog:
                if op[0] == "q":
                    all_q.add((op[1], op[2], op[3]))
    adv_queries = sorted(
        {(c, r) for (kind, c, r) in all_q if kind == "advice"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "advice"}
    )
    fix_queries = sorted(
        {(c, r) for (kind, c, r) in all_q if kind == "fixed"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "fixed"}
    )
    adv_evals = {(c, r): rd.read_scalar() for c, r in adv_queries}
    fix_evals = {(c, r): rd.read_scalar() for c, r in fix_queries}
    sigma_evals = [rd.read_scalar() for _ in perm_cols]
    if perm_cols:
        z_perm_x = rd.read_scalar()
        z_perm_wx = rd.read_scalar()
    lk_evals = [
        dict(z_x=rd.read_scalar(), z_wx=rd.read_scalar(),
             ap_x=rd.read_scalar(), ap_winv=rd.read_scalar(),
             sp_x=rd.read_scalar())
        for _ in VK["lookups"]
    ]
    lg_evals = [
        dict(h_x=[rd.read_scalar() for _ in lg["inputs"]],
             ht_x=rd.read_scalar(), m_x=rd.read_scalar(),
             phi_x=rd.read_scalar(), phi_wx=rd.read_scalar())
        for lg in VK["logups"]
    ]

    def lagrange_at(i, p):
        wi = pow(omega, i, R)
        denom = n * (p - wi) % R
        if denom == 0:
            return 1 if p == wi else 0
        return wi * (pow(p, n, R) - 1) % R * pow(denom, -1, R) % R

    def instance_eval(col, rot):
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

    l0_x = lagrange_at(0, x)
    llast_x = lagrange_at(u, x)
    lactive_x = (1 - sum(lagrange_at(i, x) for i in range(u, n))) % R

    expected = 0

    def add_c(c):
        nonlocal expected
        expected = (expected * y + c) % R

    for g in VK["gates"]:
        for prog in g:
            add_c(_run_prog(prog, getq, challenge_ints))

    DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, R)
    if perm_cols:
        add_c(l0_x * (z_perm_x - 1) % R)
        add_c(llast_x * (z_perm_x * z_perm_x - z_perm_x) % R)
        num = den = 1
        for ci, (kind, col) in enumerate(perm_cols):
            v = getq(kind, col, 0)
            num = num * (v + beta * pow(DELTA, ci, R) % R * x + gamma) % R
            den = den * (v + beta * sigma_evals[ci] + gamma) % R
        add_c(lactive_x * (z_perm_wx * den - z_perm_x * num) % R)

    for lk, le in zip(VK["lookups"], lk_evals):
        a_x = 0
        for prog in lk["inputs"]:
            a_x = (a_x * theta + _run_prog(prog, getq, challenge_ints)) % R
        s_x = 0
        for prog in lk["tables"]:
            s_x = (s_x * theta + _run_prog(prog, getq, challenge_ints)) % R
        add_c(l0_x * (le["z_x"] - 1) % R)
        add_c(llast_x * (le["z_x"] * le["z_x"] - le["z_x"]) % R)
        lhs = le["z_wx"] * (le["ap_x"] + beta) % R * (le["sp_x"] + gamma) % R
        rhs = le["z_x"] * (a_x + beta) % R * (s_x + gamma) % R
        add_c(lactive_x * (lhs - rhs) % R)
        add_c(l0_x * (le["ap_x"] - le["sp_x"]) % R)
        add_c(lactive_x * (le["ap_x"] - le["sp_x"]) % R
              * (le["ap_x"] - le["ap_winv"]) % R)

    for lg, le in zip(VK["logups"], lg_evals):
        add_c(l0_x * le["phi_x"] % R)
        add_c(llast_x * le["phi_x"] % R)
        dsum = 0
        for tup_, h_x in zip(lg["inputs"], le["h_x"]):
            a_x = 0
            for prog in tup_:
                a_x = (a_x * theta
                       + _run_prog(prog, getq, challenge_ints)) % R
            add_c(lactive_x * (h_x * (a_x + beta) - 1) % R)
            dsum = (dsum + h_x) % R
        t_x_val = 0
        for prog in lg["table"]:
            t_x_val = (t_x_val * theta
                       + _run_prog(prog, getq, challenge_ints)) % R
        add_c(lactive_x * (le["ht_x"] * (t_x_val + beta) - le["m_x"]) % R)
        dsum = (dsum - le["ht_x"]) % R
        add_c(lactive_x * (le["phi_wx"] - le["phi_x"] - dsum) % R)

    t_x = (xn - 1) % R
    if t_x == 0:
        return False
    expected_h = expected * pow(t_x, -1, R) % R

    h_comb = None
    for i, c in enumerate(h_comms):
        h_comb = host_g1_add(h_comb, host_g1_mul(tup(c), pow(xn, i, R)))

    # ---- SHPLONK multiopen verification (prover query order) ---------------
    def rot_point(rot):
        return x * pow(omega, rot % n, R) % R

    queries = []
    pid = 0
    poly_ids = {}

    def q(comm, key, point, ev):
        nonlocal pid
        if key not in poly_ids:
            poly_ids[key] = pid
            pid += 1
        queries.append((tup(comm), point, ev, poly_ids[key]))

    for c, r in adv_queries:
        q(advice_comms[c], ("a", c), rot_point(r), adv_evals[(c, r)])
    for c, r in fix_queries:
        q(VK["fixed_commitments"][c], ("f", c), rot_point(r),
          fix_evals[(c, r)])
    for ci in range(len(perm_cols)):
        q(VK["sigma_commitments"][ci], ("s", ci), x, sigma_evals[ci])
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

    # group queries by poly, then by point set (kzg.shplonk_verify logic)
    gamma2 = rd.squeeze_challenge()
    by_poly = {}
    order = []
    for comm, point, ev, poly_id in queries:
        if poly_id not in by_poly:
            order.append(poly_id)
        by_poly.setdefault(poly_id, []).append((comm, point, ev))
    groups = {}
    gorder = []
    for pid_ in order:
        qs = by_poly[pid_]
        pts = frozenset(p for _, p, _ in qs)
        if pts not in groups:
            gorder.append(pts)
        groups.setdefault(pts, []).append(qs)

    w1 = rd.read_point()
    uu = rd.squeeze_challenge()

    def lagrange_interp(points, values):
        m = len(points)
        coeffs = [0] * m
        for i in range(m):
            numc = [1]
            denom = 1
            for j in range(m):
                if j == i:
                    continue
                new = [0] * (len(numc) + 1)
                cc = (-points[j]) % R
                for t_i, a in enumerate(numc):
                    new[t_i] = (new[t_i] + a * cc) % R
                    new[t_i + 1] = (new[t_i + 1] + a) % R
                numc = new
                denom = denom * (points[i] - points[j]) % R
            scale = values[i] * pow(denom, -1, R) % R
            for t_i in range(len(numc)):
                coeffs[t_i] = (coeffs[t_i] + numc[t_i] * scale) % R
        return coeffs

    def eval_poly(coeffs, p):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * p + c) % R
        return acc

    acc_pt = None
    const_scalar = 0
    cnt = 0
    for pts in gorder:
        pts_l = sorted(pts)
        zs_u = 1
        for p in pts_l:
            zs_u = zs_u * (uu - p) % R
        zinv = pow(zs_u, -1, R)
        for qs in groups[pts]:
            w = pow(gamma2, cnt, R)
            cnt += 1
            evals = {p: e for _, p, e in qs}
            r_coeffs = lagrange_interp(pts_l, [evals[p] for p in pts_l])
            r_u = eval_poly(r_coeffs, uu)
            scal = w * zinv % R
            acc_pt = host_g1_add(acc_pt, host_g1_mul(qs[0][0], scal))
            const_scalar = (const_scalar + scal * r_u) % R
    acc_pt = host_g1_add(acc_pt, host_g1_mul(G1_GEN, (R - const_scalar) % R))
    acc_pt = host_g1_add(acc_pt, host_g1_mul(tup(w1), R - 1))
    w2 = rd.read_point()
    lhs_pt = host_g1_add(host_g1_mul(tup(w2), uu), acc_pt)
    neg = lambda p: None if p is None else (p[0], (-p[1]) % Q)
    g2 = (tuple(VK["g2"][0]), tuple(VK["g2"][1]))
    s_g2 = (tuple(VK["s_g2"][0]), tuple(VK["s_g2"][1]))
    if not pairing_product_is_one([(tup(w2), s_g2), (neg(lhs_pt), g2)]):
        return False
    if ACC is not None:
        # the proof's own statement carries a folded KZG accumulator over
        # the INNER layer (last 8 limbs of the final instance column):
        # one more pairing finishes the whole recursion ladder
        vals = instances[-1]
        lx = vals[-8] + (vals[-7] << 128)
        ly = vals[-6] + (vals[-5] << 128)
        wx = vals[-4] + (vals[-3] << 128)
        wy = vals[-2] + (vals[-1] << 128)
        lhs_a = None if (lx | ly) == 0 else (lx, ly)
        w_a = None if (wx | wy) == 0 else (wx, wy)
        g2i = (tuple(ACC["g2"][0]), tuple(ACC["g2"][1]))
        s_g2i = (tuple(ACC["s_g2"][0]), tuple(ACC["s_g2"][1]))
        if not pairing_product_is_one([(w_a, s_g2i), (neg(lhs_a), g2i)]):
            return False
    return True


if __name__ == "__main__":
    import json as _json
    import sys as _sys

    proof_path, inst_path = _sys.argv[1], _sys.argv[2]
    proof_b = open(proof_path, "rb").read()
    insts = [[int(v, 16) if isinstance(v, str) else int(v) for v in col]
             for col in _json.load(open(inst_path))]
    ok = verify(insts, proof_b)
    print("OK" if ok else "FAIL")
    raise SystemExit(0 if ok else 1)
'''


def gen_verifier_artifact(vk: VerifyingKey, path: str,
                          accumulator: dict | None = None) -> str:
    """Write the standalone verifier for `vk` to `path`; returns path.

    `accumulator`: optional {"g2": [...], "s_g2": [...]} — the INNER
    layer's G2 points.  When given, the artifact additionally checks the
    folded KZG accumulator exposed in the LAST instance column's final 8
    limbs (recursion/fold.verify_fold): the layer-4 proof's deferred
    claim, making the artifact the complete end-of-pipeline verifier
    (reference prover/src/common/prover/evm.rs evm_verify)."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pairing_src = _inline_module(
        os.path.join(base, "crypto", "pairing.py"),
        ("from .params", "from __future__"),
    )
    # transcript: only the Blake2b half is needed; strip the Poseidon part
    tr_src = open(os.path.join(base, "poly", "transcript.py")).read()
    tr_src = tr_src.split("class PoseidonSponge")[0]
    tr_lines = [
        ln for ln in tr_src.splitlines()
        if not ln.startswith(("from ..crypto.params", "from __future__"))
    ]
    tr_src = "\n".join(tr_lines)

    p = _params
    header = f'''"""AUTO-GENERATED standalone proof verifier.

Generated by zkevm_circuits_tpu_torch.recursion.evm_verifier.gen_verifier_artifact
(the reference's gen_evm_verifier analogue, prover/src/common/prover/
evm.rs:11-46).  Self-contained: stdlib only.  Usage:

    python {os.path.basename(path)} proof.bin instances.json
"""

import hashlib

# BN254 parameters (crypto/params.py)
FR_MODULUS = {p.FR_MODULUS}
FQ_MODULUS = {p.FQ_MODULUS}
R = FR_MODULUS
Q = FQ_MODULUS
BN_U = {p.BN_U}
FR_TWO_ADICITY = {p.FR_TWO_ADICITY}
FR_GENERATOR = {p.FR_GENERATOR}
G1_GEN = (1, 2)
G2_GEN_X = {p.G2_GEN_X}
G2_GEN_Y = {p.G2_GEN_Y}


def host_g1_add(p, q, modulus=FQ_MODULUS):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % modulus == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, -1, modulus) % modulus
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, modulus) % modulus
    x3 = (lam * lam - x1 - x2) % modulus
    y3 = (lam * (x1 - x3) - y1) % modulus
    return (x3, y3)


def host_g1_mul(p, k, modulus=FQ_MODULUS):
    acc = None
    while k:
        if k & 1:
            acc = host_g1_add(acc, p, modulus)
        p = host_g1_add(p, p, modulus)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# inlined: zkevm_circuits_tpu_torch/crypto/pairing.py
# ---------------------------------------------------------------------------
{pairing_src}

# ---------------------------------------------------------------------------
# inlined: zkevm_circuits_tpu_torch/poly/transcript.py (Blake2b half)
# ---------------------------------------------------------------------------
{tr_src}

# ---------------------------------------------------------------------------
# the verifying key (serialized constraint system + commitments)
# ---------------------------------------------------------------------------
VK = {serialize_vk(vk)!r}

# folded-accumulator check spec (None = plain PLONK verification only)
ACC = {accumulator!r}

'''
    with open(path, "w") as f:
        f.write(header)
        f.write(_ENGINE)
    return path


def evm_verify(path: str, instances: list[list[int]], proof: bytes,
               timeout: int = 600) -> bool:
    """Run the artifact in a CLEAN subprocess (cwd = artifact dir, no repo
    on sys.path) — the reference's `evm_verify` spawns the EVM the same
    way."""
    import tempfile

    d = tempfile.mkdtemp(prefix="zkevm_verify_")
    pf = os.path.join(d, "proof.bin")
    inf = os.path.join(d, "instances.json")
    with open(pf, "wb") as f:
        f.write(proof)
    with open(inf, "w") as f:
        json.dump([[hex(v) for v in col] for col in instances], f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    res = subprocess.run(
        [sys.executable, os.path.abspath(path), pf, inf],
        capture_output=True, text=True, timeout=timeout,
        cwd=d, env=env,
    )
    return res.returncode == 0 and res.stdout.strip().endswith("OK")
