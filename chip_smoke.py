#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (zkevm_circuits_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each (the process exits non-zero on any failure):
  1. the card's name and power limit; the build of the CUDA kernels
     (csrc/*.cu with nvcc for sm_90a) and its time;
  2. every kernel (K1 mont_mul, K2 twiddle_mul, K3 redc34, K4
     butterfly_stage, K5 g1_add in three modes and its bucket-step form
     g1_bucket_add, K6 g1_double once and eight times) against its plain
     PyTorch version on the card, byte for byte, on seeded inputs at the
     main path's shapes, both timed with CUDA events, beside the bound
     computed from the inputs; the DFT-pass int8 matmul timed beside them;
  3. six paths, each with the launch counts set to 0 just before it and
     read just after it; the run fails if a kernel the path names was not
     launched on it (K4 on the two mesh paths, every other kernel, both
     forms of K5 included, on all six):
     demo_k5     the k=5 DemoCircuit: its sha256 equals the reference's
                 proof (golden), the verifier accepts it and rejects a
                 wrong instance and a corrupted witness;
     keccak_k9   KeccakCircuit([b"abc"]) at k=9: its sha256 equals the
                 reference's proof (golden), it verifies, and a flipped
                 state bit is rejected;
     state_k16   the State circuit at DEGREE=16 (service.bench_circuits):
                 SRS, keygen, prove, verify, with per-phase seconds;
     keccak_k16  the Keccak circuit at DEGREE=16, full width (Z=8, 658
                 advice columns), 327 permutations of seeded messages:
                 SRS, keygen, prove, verify, per-phase seconds, peak
                 device memory;
     then, on a torch.distributed NCCL group of one rank (the sharded
     prover's D = 1 route: every iNTT at k and coset transform at k_ext is
     the radix-2 ladder, one K4 launch a stage):
     mesh_demo_k5    demo_k5 through prove(mesh=group): the same golden
                     and verdicts;
     mesh_state_k16  state_prove_bench(16, mesh=group): its proof's sha256
                     equals state_k16's, and it verifies;
  4. a `kernels` JSON line: each kernel (K5's two forms apart) with its
     launches on the Keccak k=16 path (K4: on mesh_state_k16) and, beside
     them, on every path, its check from phase 2, its time, bound and
     plain time, and those of its other shapes and forms;
  5. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# 32-bit integer multiply-adds per second: 64 per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz (H100 SXM boost clock).
IMAD_PER_S = 64 * 132 * 1.98e9
# 32-bit integer multiplies per Montgomery product over 8 x 32-bit words:
# 64 partial products for a*b and 64 for m*p, each two multiplies (the low
# and the high half: mad.lo / madc.hi), and one low half for each of the 8
# m's: 128 * 2 + 8.
OPS_PER_MONT_MUL = 264
# a Montgomery squaring: 36 distinct partial products for a*a (28 cross
# products, 8 squares) and 64 for m*p, two multiplies each, and the 8 m's:
# (36 + 64) * 2 + 8.
OPS_PER_MONT_SQR = 208
# wide REDC (K3): 4 64-bit steps, each m = t0 * np mod 2^64 (4 multiplies)
# and m*p (2 x 8 partial products, two multiplies each), then one 16-bit
# step (1 for m, 8 partial products for m*p)
OPS_PER_REDC34 = 4 * (4 + 2 * 8 * 2) + (1 + 8 * 2)
# K5 and K6 by their formulas' products and squarings: the Jacobian add
# (complete and incomplete modes) 11 + 5, the affine mode 4 + 2, the
# doubling (dbl-2009-l) 2 + 5
OPS_G1_ADD = 11 * OPS_PER_MONT_MUL + 5 * OPS_PER_MONT_SQR
OPS_G1_ADD_AFFINE = 4 * OPS_PER_MONT_MUL + 2 * OPS_PER_MONT_SQR
OPS_G1_DOUBLE = 2 * OPS_PER_MONT_MUL + 5 * OPS_PER_MONT_SQR
SEED = 20261016
QUEUE_FILL_CYCLES = 200_000_000  # about 0.1 s of the card's clock


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # keep the card busy while the host queues the timed launches, so that
    # the events time the kernels and not the host's launch rate
    torch.cuda._sleep(QUEUE_FILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / IMAD_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _rand_fe(rng, n: int, modulus: int) -> np.ndarray:
    """n canonical field elements (< modulus) with 0, 1 and p-1 first."""
    d = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    d[:, 31] = rng.integers(0, modulus >> 248, size=n, dtype=np.uint8)
    for i, v in enumerate((0, 1, modulus - 1)):
        d[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return d


def check_kernels(dev, log) -> tuple[dict, list]:
    """Phase 2: each kernel against its plain version at the main path's
    shapes.  Returns per-kernel records (keyed by the launch counter's
    name) and a list of failures."""
    rng = np.random.default_rng(SEED)
    rec, fails = check_field_kernels(dev, log, rng)
    rec_c, fails_c = check_curve_kernels(dev, log, rng)
    return {**rec, **rec_c}, fails + fails_c


def check_field_kernels(dev, log, rng) -> tuple[dict, list]:
    """Phase 2, K1 to K4, and the DFT-pass matmul timed beside them."""
    from zkevm_circuits_tpu_torch.crypto.field import fq, fr
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf
    from zkevm_circuits_tpu_torch.poly import ntt_mxu
    from zkevm_circuits_tpu_torch.poly.domain import domain

    rec, fails = {}, []

    # K1 at n = 2^20, both fields
    n = 1 << 20
    for fid, fld in ((cf.FIELD_FR, fr()), (cf.FIELD_FQ, fq())):
        a = torch.as_tensor(_rand_fe(rng, n, fld.modulus), device=dev)
        b = torch.as_tensor(_rand_fe(rng, n, fld.modulus)[::-1].copy(), device=dev)
        got = cf.mont_mul_cuda(a, b, fid)
        want = cf.mont_mul_plain(a, b, fid)
        ok = torch.equal(got, want)
        ms = _time_ms(lambda: cf.mont_mul_cuda(a, b, fid), 50)
        plain_ms = _time_ms(lambda: cf.mont_mul_plain(a, b, fid), 3)
        log(f"[kernels] K1 mont_mul {fld.name} n={n}: match={ok} "
            f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms")
        if not ok:
            fails.append(f"K1 {fld.name} mismatch")
        if fid == cf.FIELD_FR:
            bound, by = _bound_ms(96 * n, OPS_PER_MONT_MUL * n)
            rec["mont_mul"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by,
                                   max_abs_err=_max_err(got, want))

    # K3 and K2 on the first pass of a real k=19 coset NTT (2 columns)
    k, bcols = 19, 2
    k1, k2 = ntt_mxu._split_k(k)
    n1, n2 = 1 << k1, 1 << k2
    F = fr()
    col_gen, row_gen, scale_all = ntt_mxu._gens(k, False, True)
    w1, tw, _ = ntt_mxu._consts2(k, False, col_gen, row_gen, scale_all, dev)
    x = torch.as_tensor(_rand_fe(rng, bcols << k, F.modulus), device=dev)
    y = x.reshape(bcols, n1, n2, 32).permute(1, 0, 2, 3).reshape(n1, bcols * n2, 32)
    m = bcols * n2
    xt = y.permute(1, 0, 2).reshape(m, n1 * 32).contiguous()
    t = ntt_mxu.dft_matmul(*w1, xt)
    t32 = t.reshape(n1, 63, m).permute(0, 2, 1).reshape(n1 * m, 63).contiguous()
    got = cf.redc34_cuda(t32)
    want = cf.redc34_plain(t32)
    ok = torch.equal(got, want)
    rows = t32.shape[0]
    ms = _time_ms(lambda: cf.redc34_cuda(t32), 20)
    plain_ms = _time_ms(lambda: cf.redc34_plain(t32), 2)
    bound, by = _bound_ms(284 * rows, OPS_PER_REDC34 * rows)
    rec["redc34"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, max_abs_err=_max_err(got, want))
    log(f"[kernels] K3 redc34 rows={rows}: match={ok} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms")
    if not ok:
        fails.append("K3 mismatch")
    mm_ms = _time_ms(lambda: ntt_mxu.dft_matmul(*w1, xt), 5)
    mm_bytes = w1[0].numel() + xt.numel() + t.numel() * 4
    mm_ops = 2 * w1[0].shape[0] * w1[0].shape[1] * m
    rec["dft_matmul"] = dict(ms=mm_ms, shape=[w1[0].shape[0], w1[0].shape[1], m],
                             bound_ms=max(mm_bytes / HBM_BYTES_PER_S,
                                          mm_ops / 1979e12) * 1e3)
    log(f"[kernels] DFT-pass int8 matmul ({w1[0].shape[0]}x{w1[0].shape[1]})"
        f" @ ({w1[0].shape[1]}x{m}): {mm_ms:.3f} ms")

    y1 = got.reshape(n1, bcols, n2, 32)
    got = cf.twiddle_mul_cuda(y1, tw)
    want = cf.twiddle_mul_plain(y1, tw)
    ok = torch.equal(got, want)
    rows = y1.numel() // 32
    ms = _time_ms(lambda: cf.twiddle_mul_cuda(y1, tw), 50)
    plain_ms = _time_ms(lambda: cf.twiddle_mul_plain(y1, tw), 2)
    bound, by = _bound_ms(64 * rows + tw.numel(), OPS_PER_MONT_MUL * rows)
    rec["twiddle_mul"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, max_abs_err=_max_err(got, want))
    log(f"[kernels] K2 twiddle_mul rows={rows}: match={ok} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms")
    if not ok:
        fails.append("K2 mismatch")

    # K4, stage form (what the mesh NTT launches): stages 1, 10 and 19 of
    # one k=19 column (2^18 butterflies), stage 10 timed (a 512-row table);
    # the stage 10 launch over the prover's 64-column batch, kernel only;
    # the TPU kernel's row form at 2^20 rows
    x = torch.as_tensor(_rand_fe(rng, 1 << k, F.modulus), device=dev)
    tws = [torch.as_tensor(t, device=dev) for t in domain(k).stage_twiddles]
    pairs = 1 << (k - 1)
    for st in (1, 10, 19):
        got = cf.dit_stage_cuda(x, tws[st - 1], st)
        want = cf.dit_stage_plain(x, tws[st - 1], st)
        ok = torch.equal(got, want)
        log(f"[kernels] K4 dit_stage k={k} stage {st}: match={ok}")
        if not ok:
            fails.append(f"K4 stage {st} mismatch")
        if st == 10:
            err = _max_err(got, want)
    tw10 = tws[9]
    ms = _time_ms(lambda: cf.dit_stage_cuda(x, tw10, 10), 50)
    plain_ms = _time_ms(lambda: cf.dit_stage_plain(x, tw10, 10), 3)
    bound, by = _bound_ms(128 * pairs + tw10.numel(), OPS_PER_MONT_MUL * pairs)
    rec["butterfly_stage"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)
    log(f"[kernels] K4 dit_stage k={k} stage 10 ({pairs} butterflies): "
        f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound {bound:.4f} ms")
    xb = x.expand(64, -1, -1).contiguous()
    ms = _time_ms(lambda: cf.dit_stage_cuda(xb, tw10, 10), 10)
    bound, _ = _bound_ms(64 * 128 * pairs + tw10.numel(), 64 * OPS_PER_MONT_MUL * pairs)
    rec["butterfly_stage"]["batch64"] = dict(ms=ms, bound_ms=bound)
    log(f"[kernels] K4 dit_stage 64 columns k={k} stage 10: kernel {ms:.4f} ms "
        f"bound {bound:.4f} ms")
    del xb
    n = 1 << 20
    lo, hi, tw = (torch.as_tensor(_rand_fe(rng, n, F.modulus), device=dev)
                  for _ in range(3))
    got = cf.butterfly_stage_cuda(lo, hi, tw)
    want = cf.butterfly_stage_plain(lo, hi, tw)
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    ms = _time_ms(lambda: cf.butterfly_stage_cuda(lo, hi, tw), 50)
    plain_ms = _time_ms(lambda: cf.butterfly_stage_plain(lo, hi, tw), 3)
    bound, by = _bound_ms(160 * n, OPS_PER_MONT_MUL * n)
    rec["butterfly_stage"]["rows"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        max_abs_err=max(_max_err(g, w) for g, w in zip(got, want)))
    log(f"[kernels] K4 butterfly_stage rows={n}: match={ok} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms bound {bound:.4f} ms")
    if not ok:
        fails.append("K4 row form mismatch")

    return rec, fails


def _same_rows(p, q) -> int:
    """Rows where P = Q as finite points (U1 = U2 and S1 = S2), the rows
    whose complete add needs the doubling."""
    from zkevm_circuits_tpu_torch.crypto.field import fq

    Q = fq()
    z1z1, z2z2 = Q.mul(p.z, p.z), Q.mul(q.z, q.z)
    same = (Q.mul(p.x, z2z2) == Q.mul(q.x, z1z1)).all(-1)
    same &= (Q.mul(Q.mul(p.y, q.z), z2z2) == Q.mul(Q.mul(q.y, p.z), z1z1)).all(-1)
    same &= (p.z != 0).any(-1) & (q.z != 0).any(-1)
    return int(same.sum().item())


def check_curve_kernels(dev, log, rng) -> tuple[dict, list]:
    """Phase 2, K5 (three modes at 2^16 points, the bucket-step form at a
    column group's shape) and K6 (one and eight doublings at 2^16 points
    and at 10) against their plain versions."""
    from zkevm_circuits_tpu_torch.crypto.curve import G1, g1_infinity
    from zkevm_circuits_tpu_torch.crypto.field import fq
    from zkevm_circuits_tpu_torch.ops import cuda_curve as cc
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers

    rec, fails = {}, []

    def err(got, want):
        return max(_max_err(g, w) for g, w in zip(got, want))

    # K5 at n = 2^16 points, three modes
    n = 1 << 16
    Q = fq()
    pts = srs_g1_powers(2 * n, 0x5EED, dev)
    p_aff = G1(*(c[:n] for c in pts))
    q_aff = G1(*(c[n:] for c in pts))

    def jac(p, zs):
        z = torch.as_tensor(zs, device=dev)
        z2 = Q.mul(z, z)
        return G1(Q.mul(p.x, z2), Q.mul(p.y, Q.mul(z2, z)), Q.mul(p.z, z))

    zs = _rand_fe(rng, 2 * n, Q.modulus)
    zs[:3] = zs[3:6]  # no zero z
    p_j, q_j = jac(p_aff, zs[:n]), jac(q_aff, zs[n:])
    # complete: rows 0-15 Q = P, 16-31 Q = -P, 32-47 P = inf, 48-63 Q = inf
    cp = [c.clone() for c in p_j]
    cq = [c.clone() for c in q_j]
    for c_p, c_q in zip(cp, cq):
        c_q[:16] = c_p[:16]
    cq[0][16:32] = cp[0][16:32]
    cq[1][16:32] = Q.neg(cp[1][16:32])
    cq[2][16:32] = cp[2][16:32]
    cp[2][32:48] = 0
    cq[2][48:64] = 0
    cases = {"complete": (cp, cq), "incomplete": (p_j, q_j),
             "affine": (p_aff, q_aff)}
    for mode, (pa, pb) in cases.items():
        got = cc.g1_add_cuda(*pa, *pb, mode=mode)
        want = cc.g1_add_plain(*pa, *pb, mode=mode)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = _time_ms(lambda: cc.g1_add_cuda(*pa, *pb, mode=mode), 20)
        plain_ms = _time_ms(lambda: cc.g1_add_plain(*pa, *pb, mode=mode), 2)
        if mode == "affine":
            ops = OPS_G1_ADD_AFFINE * n
        else:
            same = _same_rows(G1(*pa), G1(*pb)) if mode == "complete" else 0
            ops = OPS_G1_ADD * n + OPS_G1_DOUBLE * same
        bound, by = _bound_ms(288 * n, ops)
        log(f"[kernels] K5 g1_add {mode} n={n}: match={ok} kernel {ms:.4f} ms "
            f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({by})")
        if not ok:
            fails.append(f"K5 {mode} mismatch")
        r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 max_abs_err=err(got, want))
        if mode == "complete":
            r["same_rows"] = same
            rec["g1_add"] = r
        else:
            rec["g1_add"][mode] = r

    # K5's bucket form at a Keccak column group's shape: 10 columns, 512
    # lanes, 32 windows of 256 buckets; four steps from empty buckets, the
    # kernel on one copy and the plain version on another, then the whole
    # arrays compared.  Scalars: column 0 all 0 or 1, column 1 with zero
    # bytes, column 2 one repeated byte, the rest random; in step 1 the
    # first 32 lanes bring step 0's points with its digits in column 3, so
    # those buckets hold P and add P (the doubling).
    c, lanes, n_win, n_buck, steps = 10, 512, 32, 256, 4
    spts = srs_g1_powers((steps + 1) * lanes, 0xB0C, dev)
    spts = [t.reshape(steps + 1, lanes, 32).clone() for t in spts]
    for t in spts:
        t[1, :32] = t[0, :32]
    sc = rng.integers(0, 256, size=(steps, c, lanes, n_win), dtype=np.uint8)
    sc[:, 0] = 0
    sc[:, 0, :, 0] = rng.integers(0, 2, size=(steps, lanes), dtype=np.uint8)
    sc[:, 1] *= rng.integers(0, 2, size=(steps, lanes, n_win), dtype=np.uint8)
    sc[:, 2] = sc[:, 2, :, :1]
    sc[1, 3, :32] = sc[0, 3, :32]
    digits = torch.as_tensor(sc, device=dev)
    kb = list(g1_infinity((c, lanes, n_win, n_buck), dev))
    pb = [t.clone() for t in kb]
    for s in range(steps):
        cc.g1_bucket_add_cuda(*kb, digits[s], *(t[s] for t in spts))
        cc.g1_bucket_add_plain(*pb, digits[s], *(t[s] for t in spts))
    ok = all(torch.equal(a, b) for a, b in zip(kb, pb))
    bucket_err = err(kb, pb)
    del pb
    # timed: one more step (the last digits, new points) on full buckets,
    # the empty ones given a point of step 0, as in a long MSM where the
    # complete add's special cases are rare
    empty = (kb[2] == 0).all(-1)
    for t, f in zip(kb, spts):
        t[empty] = f[0, 0]
    del empty
    last = (digits[-1], *(t[steps] for t in spts))
    ci, li, wi = (digits[-1] != 0).nonzero(as_tuple=True)
    live = int(ci.numel())
    d = digits[-1][ci, li, wi].long()
    same = _same_rows(G1(*(t[ci, li, wi, d] for t in kb)),
                      G1(*(t[steps][li] for t in spts)))
    del ci, li, wi, d
    ms = _time_ms(lambda: cc.g1_bucket_add_cuda(*kb, *last), 20)
    plain_ms = _time_ms(lambda: cc.g1_bucket_add_plain(*kb, *last), 2)
    bound, by = _bound_ms(c * lanes * n_win + 96 * lanes + 192 * live,
                          OPS_G1_ADD * live + OPS_G1_DOUBLE * same)
    log(f"[kernels] K5 g1_bucket_add c={c} lanes={lanes} windows={n_win} "
        f"buckets={n_buck} ({steps} steps): match={ok} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms bound {bound:.4f} ms ({by}; {live} rows "
        f"with a nonzero digit, {same} with P = Q)")
    if not ok:
        fails.append("K5 bucket form mismatch")
    rec["g1_bucket_add"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, max_abs_err=bucket_err,
                                live_rows=live)
    del kb

    # K6 at n = 2^16 (rows 0-15 at infinity as (1, 1, 0), rows 16-31 with
    # z = 0 and random x, y) and at the window Horner's (10,) shape (rows
    # 28-37: four with z = 0), once and eight times
    dp = [c_.clone() for c_ in p_j]
    dp[0][:16] = Q.ones_mont((16,), dev)
    dp[1][:16] = Q.ones_mont((16,), dev)
    dp[2][:32] = 0
    for times in (1, 8):
        for label, pts_ in ((f"n={n}", dp),
                            ("n=10", [c_[28:38].contiguous() for c_ in dp])):
            got = cc.g1_double_cuda(*pts_, times=times)
            want = cc.g1_double_plain(*pts_, times=times)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = _time_ms(lambda: cc.g1_double_cuda(*pts_, times=times), 50)
            plain_ms = _time_ms(
                lambda: cc.g1_double_plain(*pts_, times=times), 3)
            rows = pts_[0].shape[0]
            bound, by = _bound_ms(192 * rows, OPS_G1_DOUBLE * times * rows)
            log(f"[kernels] K6 g1_double {label} times={times}: match={ok} "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound "
                f"{bound:.4f} ms ({by})")
            if not ok:
                fails.append(f"K6 {label} times={times} mismatch")
            r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     max_abs_err=err(got, want))
            if times == 1 and label == f"n={n}":
                rec["g1_double"] = r
            else:
                rec["g1_double"][f"{label} times={times}"] = r
    return rec, fails


def prove_demo(dev, log, mesh=None) -> list:
    """The k=5 DemoCircuit proof on the card against the golden (through
    prove(mesh=...) when a process group is given)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    fails = []
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device=dev)
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device=dev)
    t1 = time.perf_counter()
    proof = prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                  rng=np.random.default_rng(demo.GOLDEN_SEED), device=dev,
                  mesh=mesh)
    t2 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = digest == demo.GOLDEN_SHA256 and len(proof) == demo.GOLDEN_LEN
    ok = verify(vk, [[demo.A_IN]], proof)
    wrong = verify(vk, [[demo.A_IN + 1]], proof)
    bad = prove(pk, demo.DemoCircuit(corrupt_row=5), [[demo.A_IN]], srs,
                rng=np.random.default_rng(1), device=dev, mesh=mesh)
    corrupt = verify(vk, [[demo.A_IN]], bad)
    log(f"[{'mesh ' if mesh is not None else ''}demo k=5] setup+keygen {t1 - t0:.2f} s prove {t2 - t1:.2f} s "
        f"sha256={digest} golden={golden} verify={ok} "
        f"wrong_instance={wrong} corrupt_row5={corrupt}")
    if not golden:
        fails.append("demo proof differs from the golden")
    if not ok or wrong or corrupt:
        fails.append("demo verifier verdicts wrong")
    return fails


def prove_state(dev, log, gpu: str, digests: dict, mesh=None) -> list:
    """The State circuit at DEGREE=16 (through prove(mesh=...) when a
    process group is given); its proof's sha256 goes into `digests`."""
    from zkevm_circuits_tpu_torch.service.bench_circuits import state_prove_bench

    tag = "mesh state k=16" if mesh is not None else "state k=16"
    r = state_prove_bench(16, device=dev, log=lambda m: None, mesh=mesh)
    digests[tag] = hashlib.sha256(r["proof"]).hexdigest()
    phases = {k: round(v, 3) for k, v in r["prove_phases"].items()}
    kphases = {k: round(v, 3) for k, v in r["keygen_phases"].items()}
    log(f"[{tag}] card={gpu!r} srs {r['srs_s']:.2f} s keygen "
        f"{r['keygen_s']:.2f} s prove {r['prove_s']:.2f} s verify "
        f"{r['verify_s']:.2f} s ok={r['ok']} proof_bytes={r['proof_bytes']} "
        f"sha256={digests[tag]} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    log(f"[{tag}] prove phases (s, card={gpu!r}): {json.dumps(phases)}")
    log(f"[{tag}] keygen phases (s, card={gpu!r}): {json.dumps(kphases)}")
    fails = [] if r["ok"] else [f"{tag} proof did not verify"]
    if mesh is not None and digests[tag] != digests.get("state k=16"):
        fails.append("mesh state k=16 proof differs from the state k=16 proof")
    return fails


def _flip_state_bit(circuit_cls):
    """`circuit_cls` with one state bit flipped in the phase-0 witness:
    round block 5, lane (2, 3), z = 17 (tests/test_keccak_circuit.py::
    test_keccak_f_catches_bit_flip)."""
    from zkevm_circuits_tpu_torch.crypto.field import fr

    F = fr()

    class Corrupt(circuit_cls):
        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            if phase == 0:
                z = 17
                col = self.c_a[2][3][z % self.z]
                arr = np.array(cols[col])
                row = 5 * self.rpb + z // self.z
                cur = int(np.any(arr[row]))
                arr[row] = F.from_int((1 - cur) * F.R % F.modulus)
                cols[col] = arr
            return cols

    return Corrupt


def prove_keccak_k9(dev, log) -> list:
    """KeccakCircuit([b"abc"]) at k=9 on the card against the golden."""
    from zkevm_circuits_tpu_torch.circuits.keccak import KeccakCircuit
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    fails = []
    k, msgs = demo.KECCAK_GOLDEN_K, list(demo.KECCAK_GOLDEN_MESSAGES)
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=demo.KECCAK_GOLDEN_TAU, device=dev)
    pk, vk = keygen(KeccakCircuit(msgs), k, srs, device=dev)
    t1 = time.perf_counter()
    proof = prove(pk, KeccakCircuit(msgs), [], srs,
                  rng=np.random.default_rng(demo.KECCAK_GOLDEN_SEED), device=dev)
    t2 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = (digest == demo.KECCAK_GOLDEN_SHA256
              and len(proof) == demo.KECCAK_GOLDEN_LEN)
    ok = verify(vk, [], proof)
    bad = prove(pk, _flip_state_bit(KeccakCircuit)(msgs), [], srs,
                rng=np.random.default_rng(1), device=dev)
    corrupt = verify(vk, [], bad)
    log(f"[keccak k=9] setup+keygen {t1 - t0:.2f} s prove {t2 - t1:.2f} s "
        f"sha256={digest} golden={golden} verify={ok} bit_flip={corrupt}")
    if not golden:
        fails.append("keccak k=9 proof differs from the golden")
    if not ok or corrupt:
        fails.append("keccak k=9 verifier verdicts wrong")
    return fails


KECCAK_EDGE_LENGTHS = (0, 135, 136, 271, 272)  # 1, 1, 2, 2, 3 absorb blocks


def keccak_messages(seed: int, max_perms: int) -> list[bytes]:
    """The edge lengths, then seeded random lengths of 0-300 bytes while
    the permutations fit; the last ones shrink to one block to fill
    `max_perms` exactly."""
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(n) for n in KECCAK_EDGE_LENGTHS]
    perms = sum(n // 136 + 1 for n in KECCAK_EDGE_LENGTHS)
    while perms < max_perms:
        n = int(rng.integers(0, 301))
        if perms + n // 136 + 1 > max_perms:
            n = int(rng.integers(0, 136))
        msgs.append(rng.bytes(n))
        perms += n // 136 + 1
    return msgs


def prove_keccak_k16(dev, log, gpu: str) -> list:
    """The Keccak circuit at DEGREE=16, full width."""
    from zkevm_circuits_tpu_torch.circuits.keccak import ROWS_PER_PERM, KeccakCircuit
    from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k = 16
    msgs = keccak_messages(SEED, usable_rows(1 << k) // ROWS_PER_PERM)
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=0xBE2C4, device=dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    kphases, phases = {}, {}
    pk, vk = keygen(KeccakCircuit(msgs), k, srs, device=dev, timings=kphases)
    t2 = time.perf_counter()
    circ = KeccakCircuit(msgs)
    proof = prove(pk, circ, [], srs, rng=np.random.default_rng(7), device=dev,
                  timings=phases)
    t3 = time.perf_counter()
    ok = verify(vk, [], proof)
    t4 = time.perf_counter()
    cs = pk.vk.cs
    log(f"[keccak k=16] card={gpu!r} messages={len(msgs)} "
        f"permutations={len(circ.states)} advice={cs.num_advice} "
        f"gate_polys={sum(len(g.polys) for g in cs.gates)} k_ext={pk.k_ext} "
        f"srs {t1 - t0:.2f} s keygen {t2 - t1:.2f} s prove {t3 - t2:.2f} s "
        f"verify {t4 - t3:.2f} s ok={ok} proof_bytes={len(proof)} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    log(f"[keccak k=16] prove phases (s, card={gpu!r}): "
        f"{json.dumps({k_: round(v, 3) for k_, v in phases.items()})}")
    log(f"[keccak k=16] keygen phases (s, card={gpu!r}): "
        f"{json.dumps({k_: round(v, 3) for k_, v in kphases.items()})}")
    return [] if ok else ["keccak k=16 proof did not verify"]


KERNELS = [
    ("K1", "mont_mul", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:178"),
    ("K2", "twiddle_mul", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:334"),
    ("K3", "redc34", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:273"),
    ("K4", "butterfly_stage", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:213"),
    ("K5", "g1_add", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:336"),
    ("K5", "g1_bucket_add", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:336"),
    ("K6", "g1_double", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:359"),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from zkevm_circuits_tpu_torch.ops import build
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf

    t_start = time.perf_counter()
    log = lambda m: print(m, flush=True)  # noqa: E731
    dev = torch.device("cuda")
    gpu = _gpu_line()
    log(gpu)
    t0 = time.perf_counter()
    build.lib()
    nvcc = ("cached" if build.BUILD_SECONDS is None
            else f"{build.BUILD_SECONDS:.2f} s")
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {nvcc})")
    for line in build.PTXAS_LOG.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")

    rec, fails = check_kernels(dev, log)
    paths, digests = {}, {}

    def drive_path(path, drive, kids):
        nonlocal fails
        torch.cuda.reset_peak_memory_stats(dev)
        cf.reset_launches()
        fails += drive()
        paths[path] = dict(cf.LAUNCHES)
        log(f"[launches] {path}: {json.dumps(paths[path])}")
        for kid, name, _, _ in KERNELS:
            if kid in kids and paths[path][name] == 0:
                fails.append(f"{kid} {name} was not launched on {path}")

    single = ("K1", "K2", "K3", "K5", "K6")
    drive_path("demo_k5", lambda: prove_demo(dev, log), single)
    drive_path("keccak_k9", lambda: prove_keccak_k9(dev, log), single)
    drive_path("state_k16", lambda: prove_state(dev, log, gpu, digests), single)
    drive_path("keccak_k16", lambda: prove_keccak_k16(dev, log, gpu), single)
    # the sharded prover on an NCCL group of one rank (one card)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        every = single + ("K4",)
        drive_path("mesh_demo_k5", lambda: prove_demo(dev, log, group), every)
        drive_path("mesh_state_k16",
                   lambda: prove_state(dev, log, gpu, digests, group), every)
    finally:
        dist.destroy_process_group()
    kernels = []
    for kid, name, source, replaces in KERNELS:
        r = rec[name]
        main = "mesh_state_k16" if kid == "K4" else "keccak_k16"
        # the record's other shapes and forms (K4's row form and 64
        # columns, K5's other modes, K6's Horner shape and times=8)
        extra = {k: v for k, v in r.items() if isinstance(v, dict)}
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[main][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, **extra,
        })
    log(f"[matmul] card={gpu!r} {json.dumps(rec['dft_matmul'])}")
    log(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
        f"(card={gpu!r})")
    if fails:
        for f in fails:
            log(f"FAIL: {f}")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
