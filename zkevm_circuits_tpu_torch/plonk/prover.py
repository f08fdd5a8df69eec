"""PLONK prover (port of zkevm_circuits_tpu/plonk/prover.py, with the
quotient evaluated one group of sub-cosets at a time).

Protocol, transcript order and blinding are the reference's, so for the
same SRS, keys and `rng` the proof bytes are the reference's:
  witness columns (eval form) -> iNTT -> MSM commit
  lookup permuted columns / grand products -> host sort, device scans
  quotient -> y-folded constraint groups, pass by pass over sub-cosets of
              the extended coset (only h is held at its size)
  multiopen -> SHPLONK (poly/kzg.py)
Commitments written back to back (no challenge squeezed between them) are
computed by one multi-column MSM and written in the reference's order.
"""

from __future__ import annotations

import secrets
import time

import numpy as np
import torch

from ..crypto.field import fr
from ..crypto.params import FR_GENERATOR, FR_MODULUS as R
from ..device import resolve
from ..poly.domain import domain
from ..poly.kzg import Query, Srs, eval_batch, shplonk_open
from ..poly.ntt import coset_intt, intt, ntt
from ..poly.transcript import Blake2bTranscript, PoseidonTranscript
from .circuit import Circuit, ConstraintSystem, usable_rows
from .expression import Evaluator, PreRolledEvaluator
from .keygen import ProvingKey

F = fr()

QUOTIENT_CHUNK = 1 << 16  # extended-coset rows per quotient expression walk
GATE_BATCH = 48  # gate polys per y-folded constraint group
# columns per transform call of the quotient's passes: a transform's
# scratch is a few copies of its input, so wide circuits (Keccak: 658
# advice columns) transform in batches into one output
EXT_BATCH = 64
LOGUP_INV_SLICE = 64  # logUp inputs per batch inversion


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _exclusive_prefix_product(ratio, u: int, n: int):
    """Z[0] = 1, Z[i] = prod_{j<i} ratio[j]; rows >= u forced to ratio 1."""
    dev = ratio.device
    row = torch.arange(n, device=dev)
    ratio = F.select(row < u, ratio, F.ones_mont((n,), dev))
    incl = F.prefix_product(ratio, 0)
    return torch.cat([F.ones_mont((1,), dev), incl[:-1]], dim=0)


def _exclusive_prefix_sum(delta):
    incl = F.prefix_sum(delta, 0)
    return torch.cat([F.zeros((1,), delta.device), incl[:-1]], dim=0)


def _permuted_lookup_columns(a_dig: np.ndarray, s_dig: np.ndarray, u: int, n: int):
    """halo2's lookup permutation on host digit arrays: A' = inputs grouped
    by value; S' pairs each group's first row with a matching table row,
    leftover table rows fill the rest."""
    if u == 0:
        z = np.zeros((n, 32), np.uint8)
        return z, z.copy()
    a_u, s_u = np.asarray(a_dig)[:u], np.asarray(s_dig)[:u]
    uniq, inv = np.unique(
        np.concatenate([a_u, s_u], axis=0), axis=0, return_inverse=True
    )
    inv = inv.reshape(-1)
    a_ids, s_ids = inv[:u], inv[u:]
    a_sort = np.sort(a_ids)
    first = np.ones(u, bool)
    first[1:] = a_sort[1:] != a_sort[:-1]
    distinct = a_sort[first]
    s_sort = np.sort(s_ids)
    pos = np.searchsorted(s_sort, distinct)
    ok = (pos < u) & (s_sort[np.minimum(pos, u - 1)] == distinct)
    if not ok.all():
        bad = uniq[distinct[~ok][0]]
        raise ValueError(
            f"lookup input value {F.to_int(bad)} (mont digits) not found in table"
        )
    used = np.zeros(u, bool)
    used[pos] = True
    sp_ids = np.empty(u, inv.dtype)
    sp_ids[first] = distinct
    sp_ids[~first] = s_sort[~used]
    ap, sp = uniq[a_sort], uniq[sp_ids]
    a_pad = np.concatenate([ap, np.repeat(ap[-1:], n - u, axis=0)])
    s_pad = np.concatenate([sp, np.repeat(sp[-1:], n - u, axis=0)])
    return a_pad, s_pad


def _logup_multiplicities(name: str, t_u: torch.Tensor, a_u: torch.Tensor,
                          n: int) -> torch.Tensor:
    """(n,) int64 counts: m[i] is how many input rows equal table row i,
    each value counted at its first table row (the reference's np.unique
    mapping).  `t_u` is (u, 32), `a_u` (inputs, u, 32), the usable rows."""
    u = t_u.shape[0]
    rows = torch.cat([t_u, a_u.reshape(-1, 32)]).view(torch.int64)
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    first_idx = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=rows.device)
    first_idx.scatter_reduce_(0, inv[:u], torch.arange(u, device=rows.device),
                              "amin")
    a_ids = inv[u:]
    mapped = first_idx[a_ids]
    missing = mapped >= n
    if missing.any():
        bad = uniq[a_ids[missing.nonzero()[0, 0]]].view(torch.uint8)
        raise ValueError(
            f"logup '{name}': input value not in table "
            f"(mont digits {F.to_int(bad)})"
        )
    return torch.bincount(mapped, minlength=n)


def _logup_inverses(a: torch.Tensor, beta_m, row_lt_u) -> torch.Tensor:
    """(inputs, n, 32): 1 / (a_j + beta) on the rows where `row_lt_u`
    holds, 0 elsewhere, for each input j of the stacked `a`: one batch
    inversion along the rows for each LOGUP_INV_SLICE inputs, so its
    scratch stays a few slices, whatever the input count."""
    zeros_n = F.zeros((a.shape[1],), a.device)
    hs = torch.empty_like(a)
    for s_ in range(0, a.shape[0], LOGUP_INV_SLICE):
        inv = F.batch_inv(F.add(a[s_:s_ + LOGUP_INV_SLICE], beta_m), axis=1)
        hs[s_:s_ + LOGUP_INV_SLICE] = F.select(row_lt_u, inv, zeros_n)
    return hs


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The field sum over the first axis of (m, n, 32), pairwise."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = torch.cat([F.add(x[:half], x[half:2 * half]), x[2 * half:]])
    return x[0]


def _compress(exprs, theta, ev: Evaluator, shape, device):
    """Horner fold acc = acc * theta + expr over the expression list;
    `theta` is an int challenge or a Montgomery (32,) tensor."""
    acc = None
    th = theta if isinstance(theta, torch.Tensor) else F.scalar(theta, device)
    for e in exprs:
        v = ev.eval(e)
        if v.ndim < len(shape):
            v = v.expand(shape)
        acc = v if acc is None else F.add(F.mul(acc, th), v)
    return acc if acc is not None else torch.zeros(shape, dtype=torch.uint8,
                                                   device=device)


def _make_blinder(u: int, n: int, rng: np.random.Generator, device):
    """blind(evals, start) -> evals with rows [start, n-1) replaced by
    random canonical field elements drawn from `rng` in the reference's
    order (row n-1 stays: row-0 gates with -1 rotations wrap to it).  Two
    uniform 248-bit digit rows u, v form u + 2^248 v mod p."""
    c248 = F.scalar(1 << 248, device)

    def _rand_rows(count: int):
        raw = np.frombuffer(rng.bytes(count * 64), np.uint8).reshape(count, 2, 32).copy()
        raw[..., 31] = 0  # < 2^248
        uu = torch.as_tensor(raw[:, 0].copy(), device=device)
        vv = torch.as_tensor(raw[:, 1].copy(), device=device)
        return F.add(uu, F.mul(vv, c248))

    def blind(evals, start: int = u):
        ev = evals if isinstance(evals, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(evals), device=device)
        count = (n - 1) - start
        if count <= 0:
            return ev
        out = ev.clone()
        out[start:n - 1] = _rand_rows(count)
        return out

    return blind


def prove(
    pk: ProvingKey,
    circuit: Circuit,
    instances: list[list[int]],
    srs: Srs,
    transcript: Blake2bTranscript | PoseidonTranscript | None = None,
    rng: np.random.Generator | None = None,
    device=None,
    timings: dict | None = None,
    mesh=None,
) -> bytes:
    """Proof bytes for `circuit` under `pk`.  The proof is a function of
    `rng` (blinding rows are drawn from it in the reference's order).
    `timings`, when a dict, gets the seconds of each prover phase (the
    card is synchronized at each phase's end only then) and, on the card,
    "peak_bytes": {phase: torch.cuda.max_memory_allocated at the phase's
    end}, the peak since the caller's last reset of the statistics, which
    prove leaves alone: the phase whose entry first rises to the last one
    is where the peak was reached.

    When `mesh` (a torch.distributed process group) is given, every rank
    calls prove with the same arguments, and the hot polynomial passes
    (NTT / iNTT at k, the coset iNTT at k_ext, column commitments,
    grand-product and running-sum scans) run row-sharded over its ranks
    (parallel/sharding.ProverMesh); the proof bytes equal the single-device
    path's for the same rng.  Its backend must suit `device` (NCCL with
    CUDA, gloo with the CPU).  The quotient's passes run on every rank,
    their size-n transforms sharded, where the reference's mesh path runs
    its quotient body as one jit: the same field values, so the same
    bytes."""
    dev = resolve(device)
    if mesh is not None:
        from ..parallel.sharding import check_backend

        check_backend(mesh, dev)
    cs: ConstraintSystem = pk.vk.cs
    # (re)configure the instance so its column-index attributes exist
    circuit.configure(ConstraintSystem())
    k, n = pk.k, pk.n
    k_ext = pk.k_ext
    n_ext = 1 << k_ext
    u = usable_rows(n)
    dom = domain(k)
    t = transcript or Blake2bTranscript()
    rng = rng or np.random.default_rng(
        int.from_bytes(secrets.token_bytes(16), "little")
    )
    blind = _make_blinder(u, n, rng, dev)
    marks = timings if timings is not None else {}
    on_card = timings is not None and dev.type == "cuda"
    peaks = marks.setdefault("peak_bytes", {}) if on_card else None
    t0 = time.perf_counter()

    def _mark(stage: str):
        nonlocal t0
        if on_card:
            torch.cuda.synchronize(dev)
            peaks[stage] = torch.cuda.max_memory_allocated(dev)
        now = time.perf_counter()
        marks[stage] = marks.get(stage, 0.0) + now - t0
        t0 = now

    # hot-op bundle: single-device defaults, or row-sharded versions
    if mesh is not None:
        from ..parallel.sharding import ProverMesh

        pm = ProverMesh(mesh, k, k_ext, srs)
        ntt_k, intt_k = pm.ntt, pm.intt
        commit_many = pm.commit_many
        coset_intt_ext = pm.coset_intt_ext
        prefix_prod = pm.exclusive_prefix_product
        prefix_sum = pm.exclusive_prefix_sum
    else:
        ntt_k = lambda x: ntt(x, k)  # noqa: E731
        intt_k = lambda x: intt(x, k)  # noqa: E731
        commit_many = srs.commit_many
        coset_intt_ext = lambda x: coset_intt(x, k_ext)  # noqa: E731
        prefix_prod = _exclusive_prefix_product
        prefix_sum = _exclusive_prefix_sum

    def commit_write(cols: list):
        """Commit columns in one MSM and write the points in order."""
        if cols:
            for point in commit_many(torch.stack(cols)):
                t.write_point(point)

    # ---- instances -------------------------------------------------------------
    for col in instances:
        for v in col:
            t.common_scalar(v % R)
    inst_cols = []
    for col_vals in instances:
        dig = np.zeros((n, 32), np.uint8)
        if col_vals:
            dig[: len(col_vals)] = F.from_ints([v % R * F.R % R for v in col_vals])
        inst_cols.append(dig)
    if not inst_cols:
        inst_cols = [np.zeros((n, 32), np.uint8)]
    instance_evals = torch.as_tensor(np.stack(inst_cols), device=dev)
    instance_coeffs = intt_k(instance_evals)

    # ---- phased advice synthesis + commitment ------------------------------------
    num_adv = max(cs.num_advice, 1)
    advice_evals = torch.zeros((num_adv, n, 32), dtype=torch.uint8, device=dev)
    advice_coeffs = torch.zeros_like(advice_evals)
    challenges: dict[int, object] = {}
    for phase in range(cs.num_phases):
        cols = circuit.synthesize(phase, n, challenges, instances)
        phase_cols = sorted(
            ci for ci, ph in enumerate(cs.advice_phases) if ph == phase
        )
        if phase_cols:
            for ci in phase_cols:
                advice_evals[ci] = blind(cols[ci])
            idx = torch.as_tensor(phase_cols, device=dev)
            coeffs_batch = intt_k(advice_evals[idx])
            advice_coeffs[idx] = coeffs_batch
            commit_write(list(coeffs_batch.unbind(0)))
        for ci, ph in enumerate(cs.challenge_phases):
            if ph == phase:
                challenges[ci] = F.scalar(t.squeeze_challenge(), dev)
    if mesh is not None:
        # as the reference's mesh path: advice is transformed again after
        # the phases (there, to keep its coefficients sharded)
        advice_coeffs = intt_k(advice_evals)
    _mark("advice and commit")

    tables_h = {
        "fixed": pk.fixed_evals,
        "advice": advice_evals,
        "instance": instance_evals,
    }
    ev_h = Evaluator(tables_h, challenges, rot_scale=1, device=dev)

    # ---- lookups: permuted columns --------------------------------------------
    theta = t.squeeze_challenge()
    lookup_data = []
    for lk in cs.lookups:
        a_evals = _compress(lk.inputs, theta, ev_h, (n, 32), dev)
        s_evals = _compress(lk.tables, theta, ev_h, (n, 32), dev)
        ap_dig, sp_dig = _permuted_lookup_columns(
            _host(a_evals), _host(s_evals), u, n
        )
        ap = blind(ap_dig)
        sp = blind(sp_dig)
        lookup_data.append(dict(a=a_evals, s=s_evals, ap=ap, sp=sp,
                                ap_coeffs=intt_k(ap), sp_coeffs=intt_k(sp)))

    # ---- logup lookups: compress + multiplicities (committed pre-beta) ---------
    logup_data = []
    for lg in cs.logups:
        a = torch.stack([_compress(tup, theta, ev_h, (n, 32), dev)
                         for tup in lg.inputs])
        t_evals = _compress(lg.table, theta, ev_h, (n, 32), dev)
        mult = _logup_multiplicities(lg.name, t_evals[:u], a[:, :u], n)
        mult_dig = torch.zeros((n, 32), dtype=torch.uint8, device=dev)
        mult_dig[:, :8] = mult.view(torch.uint8).reshape(n, 8)  # counts < 2^63
        m_col = blind(F.to_mont(mult_dig))
        logup_data.append(dict(a=a, t=t_evals, m=m_col,
                               m_coeffs=intt_k(m_col)))

    commit_write([c for ld in lookup_data for c in (ld["ap_coeffs"], ld["sp_coeffs"])]
                 + [ld["m_coeffs"] for ld in logup_data])
    _mark("lookup columns")
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    beta_m, gamma_m = F.scalar(beta, dev), F.scalar(gamma, dev)

    # ---- permutation grand product -----------------------------------------------
    perm_cols = cs.perm_columns
    z_perm_coeffs = None
    to_commit = []
    if perm_cols:
        omega_vec = F.power_table(dom.omega, n, dev)
        num = F.ones_mont((n,), dev)
        den = F.ones_mont((n,), dev)
        col_tables = {"advice": advice_evals, "fixed": pk.fixed_evals,
                      "instance": instance_evals}
        for ci, (kind, col) in enumerate(perm_cols):
            v = col_tables[kind][col]
            id_term = F.mul(omega_vec, F.scalar(pk.delta_pows[ci], dev))
            num = F.mul(num, F.add(v, F.add(F.mul(beta_m, id_term), gamma_m)))
            sig = pk.sigma_evals[ci]
            den = F.mul(den, F.add(v, F.add(F.mul(beta_m, sig), gamma_m)))
        ratio = F.mul(num, F.batch_inv(den, axis=0))
        z_perm = blind(prefix_prod(ratio, u, n), u + 1)
        z_perm_coeffs = intt_k(z_perm)
        to_commit.append(z_perm_coeffs)

    # ---- lookup grand products -------------------------------------------------------
    for ld in lookup_data:
        num = F.mul(F.add(ld["a"], beta_m), F.add(ld["s"], gamma_m))
        den = F.mul(F.add(ld["ap"], beta_m), F.add(ld["sp"], gamma_m))
        ratio = F.mul(num, F.batch_inv(den, axis=0))
        z = blind(prefix_prod(ratio, u, n), u + 1)
        ld["z"] = z
        ld["z_coeffs"] = intt_k(z)
        to_commit.append(ld["z_coeffs"])

    # ---- logup helper columns + running sums ---------------------------------------
    row_lt_u = torch.arange(n, device=dev) < u
    zeros_n = F.zeros((n,), dev)
    for ld in logup_data:
        hs = _logup_inverses(ld.pop("a"), beta_m, row_lt_u)
        t_inv = F.batch_inv(F.add(ld.pop("t"), beta_m), axis=0)
        h_t = F.select(row_lt_u, F.mul(ld.pop("m"), t_inv), zeros_n)
        # phi[0] = 0; phi[i+1] = phi[i] + sum_j h_j[i] - h_t[i]
        phi = prefix_sum(F.sub(_sum_rows(hs), h_t))
        for j in range(hs.shape[0]):  # blinded in place, in the reference's order
            hs[j] = blind(hs[j])
        h_t = blind(h_t)
        phi = blind(phi, u + 1)
        ld["h_coeffs"] = list(intt_k(hs).unbind(0)) if len(hs) else []
        del hs
        ld["h_t_coeffs"] = intt_k(h_t)
        ld["phi_coeffs"] = intt_k(phi)
        to_commit += ld["h_coeffs"] + [ld["h_t_coeffs"], ld["phi_coeffs"]]
    commit_write(to_commit)
    _mark("grand products")

    y = t.squeeze_challenge()
    y_m = F.scalar(y, dev)

    # ---- quotient, one group of sub-cosets at a time -----------------------------
    # every per-proof column, as coefficients, by group
    polys = {"advice": advice_coeffs, "instance": instance_coeffs}
    if perm_cols:
        polys["zp"] = z_perm_coeffs[None]
    for i, ld in enumerate(lookup_data):
        polys[f"lk{i}"] = [ld["ap_coeffs"], ld["sp_coeffs"], ld["z_coeffs"]]
    for i, ld in enumerate(logup_data):
        polys[f"lg{i}"] = ld["h_coeffs"] + [ld["h_t_coeffs"], ld["m_coeffs"],
                                            ld["phi_coeffs"]]

    def pass_evals(name, j0, b):
        return _sub_coset_ntt(polys[name], k, k_ext, j0, b, ntt_k)

    h_ext = _quotient_passes(
        cs, pk, challenges, pass_evals, list(polys), F.scalar(theta, dev),
        beta_m, gamma_m, y_m, y, _mark, dev,
    )

    h_coeffs = coset_intt_ext(h_ext)
    n_pieces = n_ext // n
    h_pieces = [h_coeffs[i * n:(i + 1) * n] for i in range(n_pieces)]
    commit_write(h_pieces)
    _mark("h commit")
    x = t.squeeze_challenge()

    # ---- evaluations ----------------------------------------------------------------
    adv_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "advice"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "advice"}
    )
    fix_queries = sorted(
        {(c, r) for (kind, c, r) in cs.all_queries() if kind == "fixed"}
        | {(c, 0) for (kind, c) in perm_cols if kind == "fixed"}
    )

    def rot_point(rot: int) -> int:
        return x * pow(dom.omega, rot % dom.n, R) % R

    # one tensor object per queried poly: shplonk_open groups by identity
    adv_polys = {c: advice_coeffs[c] for c in {c for c, _ in adv_queries}}
    fix_polys = {c: pk.fixed_coeffs[c] for c in {c for c, _ in fix_queries}}
    sig_polys = {ci: pk.sigma_coeffs[ci] for ci in range(len(perm_cols))}

    claims: list[tuple[object, int]] = []
    for c, r in adv_queries:
        claims.append((adv_polys[c], rot_point(r)))
    for c, r in fix_queries:
        claims.append((fix_polys[c], rot_point(r)))
    for ci in range(len(perm_cols)):
        claims.append((sig_polys[ci], x))
    if perm_cols:
        claims.append((z_perm_coeffs, x))
        claims.append((z_perm_coeffs, rot_point(1)))
    for ld in lookup_data:
        claims += [
            (ld["z_coeffs"], x),
            (ld["z_coeffs"], rot_point(1)),
            (ld["ap_coeffs"], x),
            (ld["ap_coeffs"], rot_point(-1)),
            (ld["sp_coeffs"], x),
        ]
    for ld in logup_data:
        claims += [(c, x) for c in ld["h_coeffs"]]
        claims += [
            (ld["h_t_coeffs"], x),
            (ld["m_coeffs"], x),
            (ld["phi_coeffs"], x),
            (ld["phi_coeffs"], rot_point(1)),
        ]

    # combined h poly sum_i x^{n i} h_i: evaluated, not written (the
    # verifier recomputes it from the gate/argument evals)
    h_comb = F.zeros((n,), dev)
    xn = pow(x, n, R)
    for i, piece in enumerate(h_pieces):
        h_comb = F.add(h_comb, F.mul(piece, F.scalar(pow(xn, i, R), dev)))
    h_claim_idx = len(claims)
    claims.append((h_comb, x))

    by_point: dict[int, list[int]] = {}
    for qi, (_, pt) in enumerate(claims):
        by_point.setdefault(pt, []).append(qi)
    evals_out: list[int] = [0] * len(claims)
    for pt, idxs in by_point.items():
        stack = torch.stack([claims[i][0] for i in idxs])
        for i, v in zip(idxs, eval_batch(stack, pt)):
            evals_out[i] = v

    queries: list[Query] = []
    for qi, (poly, pt) in enumerate(claims):
        if qi != h_claim_idx:
            t.write_scalar(evals_out[qi])
        queries.append(Query(poly, pt, evals_out[qi], None))
    _mark("evaluations")

    shplonk_open(srs, queries, t)
    _mark("shplonk")
    return bytes(t.proof)


def _sub_cosets(arr, n: int, j0: int, b: int):
    """Sub-cosets j0 .. j0+b-1 of extended-coset evaluations (..., n_ext,
    32): extended index i = j + R t holds sub-coset j's row t, so this is
    a strided (..., b, n, 32) view."""
    r_ = arr.shape[-2] // n
    return arr.unflatten(-2, (n, r_))[..., j0:j0 + b, :].transpose(-3, -2)


def _sub_coset_ntt(cols, k: int, k_ext: int, j0: int, b: int, ntt_k):
    """(m, b, n, 32) evaluations of the m coefficient columns `cols` (a
    tensor or a list, degree < n) on sub-cosets j0 .. j0+b-1 of the
    extended coset: sub-coset j is H shifted by g w_ext^j, so each is a
    size-n NTT (`ntt_k`) of the coefficients scaled by (g w_ext^j)^i."""
    n = 1 << k
    dev = cols[0].device
    w_ext = domain(k_ext).omega
    scale = torch.stack([
        F.power_table(FR_GENERATOR * pow(w_ext, j, R) % R, n, dev)
        for j in range(j0, j0 + b)])
    out = torch.empty((len(cols), b, n, 32), dtype=torch.uint8, device=dev)
    for s_ in range(0, len(cols), EXT_BATCH):
        c = cols[s_:s_ + EXT_BATCH]
        c = c if isinstance(c, torch.Tensor) else torch.stack(c)
        out[s_:s_ + len(c)] = ntt_k(F.mul(c[:, None], scale[None]))
    return out


def _quotient_passes(cs, pk, challenges, pass_evals, names, theta_m, beta_m,
                     gamma_m, y_m, y_int, mark, dev):
    """h = (the y-folded constraints) / (X^n - 1) on the extended coset,
    evaluated one pass of b consecutive sub-cosets at a time (b n about
    QUOTIENT_CHUNK rows; b = 1 above that, and then the pass is walked in
    windows of QUOTIENT_CHUNK rows, so the expression walks are as many
    as the extended coset has QUOTIENT_CHUNK-row chunks).
    pass_evals(name, j0, b) gives the (m, b, n, 32) evaluations of the
    per-proof group `name` on the pass's sub-cosets; the key's extended
    columns are read as strided views.  A rotation by r is a shift by r
    along each sub-coset's rows, wrapping, so each constraint group is
    elementwise over a window; groups combine as acc = acc * y^|g| + g,
    exactly the flat fold the verifier recomputes.  Only h is held at the
    extended size; `mark` closes the "extended transforms" and "quotient"
    phases of each pass."""
    n, n_ext = pk.n, 1 << pk.k_ext
    rot_scale = n_ext // n
    b = min(rot_scale, max(1, QUOTIENT_CHUNK // n))
    rows = min(n, QUOTIENT_CHUNK)  # of each sub-coset, per expression walk
    chunk = b * rows
    perm_cols = cs.perm_columns
    queries = sorted(
        {(k_, c_, r_) for (k_, c_, r_) in cs.all_queries()
         if k_ in ("fixed", "advice", "instance")}
        | {(kind, col, 0) for (kind, col) in perm_cols}
    )
    delta_m = [F.scalar(d, dev) for d in pk.delta_pows]
    one_s = F.ones_mont((), dev)
    shape = (chunk, 32)

    def _fold(cvals_list):
        acc = None
        for cvals in cvals_list:
            if cvals.ndim == 1:
                cvals = cvals.expand(shape)
            acc = cvals if acc is None else F.add(F.mul(acc, y_m), cvals)
        return acc

    def gates_group(polys):
        def body(qc, aux):
            ev_e = PreRolledEvaluator(qc, challenges, device=dev)
            return _fold([ev_e.eval(p_) for p_ in polys])

        return body, len(polys)

    def perm_group():
        def body(qc, aux):
            z_c, z_w = aux["zp"], aux["zp_w"]
            cons = [
                F.mul(aux["l0"], F.sub(z_c, one_s)),
                F.mul(aux["llast"], F.sub(F.mul(z_c, z_c), z_c)),
            ]
            numx = denx = None
            for ci, (kind, col) in enumerate(perm_cols):
                v = qc[(kind, col, 0)]
                idt = F.mul(aux["x"], delta_m[ci])
                nt = F.add(v, F.add(F.mul(beta_m, idt), gamma_m))
                dt_ = F.add(v, F.add(F.mul(beta_m, aux[f"sigma{ci}"]), gamma_m))
                numx = nt if numx is None else F.mul(numx, nt)
                denx = dt_ if denx is None else F.mul(denx, dt_)
            cons.append(F.mul(aux["lactive"],
                              F.sub(F.mul(z_w, denx), F.mul(z_c, numx))))
            return _fold(cons)

        return body, 3

    def lookup_group(i, lk):
        def body(qc, aux):
            ev_e = PreRolledEvaluator(qc, challenges, device=dev)
            a_ext = _compress(lk.inputs, theta_m, ev_e, shape, dev)
            s_ext = _compress(lk.tables, theta_m, ev_e, shape, dev)
            ap, sp = aux[f"lk{i}_ap"], aux[f"lk{i}_sp"]
            z_c, z_w = aux[f"lk{i}_z"], aux[f"lk{i}_z_w"]
            ap_prev = aux[f"lk{i}_ap_prev"]
            lhs = F.mul(z_w, F.mul(F.add(ap, beta_m), F.add(sp, gamma_m)))
            rhs = F.mul(z_c, F.mul(F.add(a_ext, beta_m), F.add(s_ext, gamma_m)))
            return _fold([
                F.mul(aux["l0"], F.sub(z_c, one_s)),
                F.mul(aux["llast"], F.sub(F.mul(z_c, z_c), z_c)),
                F.mul(aux["lactive"], F.sub(lhs, rhs)),
                F.mul(aux["l0"], F.sub(ap, sp)),
                F.mul(aux["lactive"], F.mul(F.sub(ap, sp), F.sub(ap, ap_prev))),
            ])

        return body, 5

    def logup_group(i, lg):
        def body(qc, aux):
            ev_e = PreRolledEvaluator(qc, challenges, device=dev)
            ht, m_ext = aux[f"lg{i}_ht"], aux[f"lg{i}_m"]
            phi, phi_w = aux[f"lg{i}_phi"], aux[f"lg{i}_phi_w"]
            cons = [F.mul(aux["l0"], phi), F.mul(aux["llast"], phi)]
            for j, tup in enumerate(lg.inputs):
                a_j = _compress(tup, theta_m, ev_e, shape, dev)
                cons.append(F.mul(aux["lactive"], F.sub(
                    F.mul(aux[f"lg{i}_h{j}"], F.add(a_j, beta_m)), one_s)))
            t_ext = _compress(lg.table, theta_m, ev_e, shape, dev)
            cons.append(F.mul(aux["lactive"],
                              F.sub(F.mul(ht, F.add(t_ext, beta_m)), m_ext)))
            dsum = None
            for j in range(len(lg.inputs)):
                h_j = aux[f"lg{i}_h{j}"]
                dsum = h_j if dsum is None else F.add(dsum, h_j)
            dsum = F.sub(dsum, ht)
            cons.append(F.mul(aux["lactive"], F.sub(F.sub(phi_w, phi), dsum)))
            return _fold(cons)

        return body, len(lg.inputs) + 4

    groups = []
    gate_polys = [p_ for g in cs.gates for p_ in g.polys]
    for s_ in range(0, len(gate_polys), GATE_BATCH):
        groups.append(gates_group(gate_polys[s_: s_ + GATE_BATCH]))
    if perm_cols:
        groups.append(perm_group())
    for i, lk in enumerate(cs.lookups):
        groups.append(lookup_group(i, lk))
    for i, lg in enumerate(cs.logups):
        groups.append(logup_group(i, lg))

    h_ext = torch.empty((n_ext, 32), dtype=torch.uint8, device=dev)
    h_view = h_ext.view(n, rot_scale, 32)  # [t, j]: index j + R t
    for j0 in range(0, rot_scale, b):
        ev = {name: pass_evals(name, j0, b) for name in names}
        mark("extended transforms")
        key = lambda arr: _sub_cosets(arr, n, j0, b)  # noqa: E731
        src = {"fixed": key(pk.fixed_ext), "advice": ev["advice"],
               "instance": ev["instance"]}
        for t0 in range(0, n, rows):
            def win(x, rot=0):
                """Rows t0 + rot .. of each (b, n, 32) sub-coset, wrapping,
                as (b rows, 32)."""
                st = (t0 + rot) % n
                if st + rows <= n:
                    w = x[:, st:st + rows]
                else:
                    w = torch.cat([x[:, st:], x[:, :rows - (n - st)]], dim=1)
                return w.reshape(chunk, 32)

            qc = {(k_, c_, r_): win(src[k_][c_], r_) for (k_, c_, r_) in queries}
            auxc = {name: win(key(arr)) for name, arr in (
                ("l0", pk.l0_ext), ("llast", pk.llast_ext),
                ("lactive", pk.lactive_ext), ("x", pk.x_ext),
                ("tinv", pk.t_inv_ext))}
            for ci in range(len(perm_cols)):
                auxc[f"sigma{ci}"] = win(key(pk.sigma_ext[ci]))
            if perm_cols:
                auxc["zp"], auxc["zp_w"] = win(ev["zp"][0]), win(ev["zp"][0], 1)
            for i in range(len(cs.lookups)):
                ap, sp, z = ev[f"lk{i}"]
                auxc.update({f"lk{i}_ap": win(ap), f"lk{i}_ap_prev": win(ap, -1),
                             f"lk{i}_sp": win(sp), f"lk{i}_z": win(z),
                             f"lk{i}_z_w": win(z, 1)})
            for i, lg in enumerate(cs.logups):
                cols = ev[f"lg{i}"]
                for j in range(len(lg.inputs)):
                    auxc[f"lg{i}_h{j}"] = win(cols[j])
                ht, m_, phi = cols[-3:]
                auxc.update({f"lg{i}_ht": win(ht), f"lg{i}_m": win(m_),
                             f"lg{i}_phi": win(phi), f"lg{i}_phi_w": win(phi, 1)})
            acc = None
            for fn, cnt in groups:
                contrib = fn(qc, auxc)
                if acc is None:
                    acc = contrib
                else:
                    yp = F.scalar(pow(y_int, cnt, R), dev)
                    acc = F.add(F.mul(acc, yp), contrib)
            h_view[t0:t0 + rows, j0:j0 + b] = (
                F.mul(acc, auxc["tinv"]).view(b, rows, 32).transpose(0, 1))
            del qc, auxc, acc
        del ev, src
        mark("quotient")
    return h_ext
