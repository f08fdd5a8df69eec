#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (zkevm_circuits_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each (the process exits non-zero on any failure):
  1. the card's name and power limit; the build of the CUDA kernels
     (csrc/*.cu with nvcc for sm_90a) and its time;
  2. every kernel (K1 mont_mul, also at a 2^16-row window, and at 2^12 ..
     2^20 rows beside K7's add, fitted to a fixed and a per-row cost, with
     the host microseconds a call of K1's and K7's wrappers takes, K2
     twiddle_mul, K3 redc34, K4 butterfly_stage, K5 g1_add in three modes
     and its bucket-step form g1_bucket_add, K6 g1_double once and eight
     times, K7 field_add_sub, the add, sub and neg of crypto/field.py over
     Fr and Fq, counted as fr_add_sub and fq_add_sub) against its plain
     PyTorch version on the card, byte for byte, on seeded inputs at the
     main path's shapes, both timed with CUDA events, beside the bound
     computed from the inputs; the DFT-pass int8 matmul timed beside them;
  3. twenty-three paths, each with the launch counts set to 0 just
     before it and read, with the path's seconds and the device memory
     still allocated (all of it, after a garbage collection, and the
     NTT's module-level cache), just after it; a prove given `timings`
     also logs the peak device memory at each phase's end; the run fails
     if a kernel the path names was not launched on it (K4's NTT stage
     form on entry_k10 and the two mesh paths, K5 and K6 on msm_grid, K1
     and K5 on entry_k10, every other kernel, both forms of K5 and K7's
     fr_add_sub included, on the other twenty):
     demo_k5     the k=5 DemoCircuit: its sha256 equals the reference's
                 proof (golden), the verifier accepts it and rejects a
                 wrong instance and a corrupted witness;
     keccak_k9   KeccakCircuit([b"abc"]) at k=9: its sha256 equals the
                 reference's proof (golden), it verifies, and a flipped
                 state bit is rejected;
     state_k16   the State circuit at DEGREE=16 (service.bench_circuits):
                 SRS, keygen, prove, verify, with per-phase seconds;
     keccak_k14  the Keccak circuit at k=KECCAK_K = 14 (the reference's
                 DEGREE=16, cut for the script's time), full width (Z=8,
                 658 advice columns), every permutation that fits, of
                 seeded messages: SRS, keygen, prove, verify, per-phase
                 seconds, peak device memory;
     evm_k9      the EVM circuit at k=9 over plonk/demo.py's program,
                 through the port's tracer and builder: its sha256 equals
                 the reference's proof (golden), it verifies, and a memory
                 byte flipped in the MSTORE row (with the RW table
                 agreeing) is rejected;
     evm_k13     the EVM circuit at k=EVM_K = 13 (14 before, cut for
                 the script's time), full width (434 advice columns,
                 1,694 gate polynomials, 12 logUps), seeded transactions of
                 looping contracts filling >= 90% of the rows with RW rows
                 (service.bench_circuits.evm_workload): SRS, keygen, prove,
                 verify, per-phase seconds, peak device memory;
     partners_k9   the EVM's table partners (MulMod, Exp, Bytecode, Tx at
                   k=9, Copy at k=7, RLP at k=11) over the witnesses of the
                   reference's tests (plonk/demo.py): each sha256 equals the
                   reference's proof (golden), each verifies, and the Exp
                   circuit with a bumped result byte is rejected;
     partners_k16  Exp, Copy and Bytecode at k=16, full width, over seeded
                   workloads filling >= 90% of the rows
                   (service.bench_circuits.partner_prove_bench): SRS,
                   keygen, prove, verify, per-phase seconds, the device
                   memory still allocated when each starts and its peak;
     precompiles_k9   the precompile circuits (SHA-256, ModExp, ECC's six
                      EcAdd cases) at k=9 over the witnesses of the
                      reference's tests (plonk/demo.py): each sha256 equals
                      the reference's proof (golden), each verifies, and
                      SHA-256 with a flipped digest bit is rejected;
     precompiles_k13  Sig (one seeded ECDSA), ECC, ModExp and SHA-256 at
                      k=13, full width, over seeded workloads (each but Sig
                      >= 90% of the usable rows; service.bench_circuits.
                      precompile_prove_bench): SRS, keygen, prove, verify,
                      per-phase seconds, resident and peak memory; then Sig
                      with a flipped scalar bit, which must be rejected;
     poseidon_k9        the Poseidon chain's goldens (plonk/demo.py): the
                        k=5 DemoCircuit under the Poseidon transcript
                        (accepted by the PoseidonReader only, rejected with
                        a wrong instance), the Poseidon (k=9), MPT (k=7)
                        and PI (k=9) circuits, each equal to the
                        reference's proof and verified, and each with a
                        gate-only corruption that must be rejected;
     poseidon_mpt_full  a seeded two-level state transition
                        (service.bench_circuits.mpt_workload): its storage-
                        subtrie MPT circuit (>= 90% of the usable rows) and
                        account-trie MPT circuit at k=14, and the Poseidon
                        circuit at k=16 over its first events, full width,
                        under the Poseidon transcript: SRS, keygen, prove,
                        verify, per-phase seconds, resident and peak
                        memory; the batched permutation on the card against
                        the host one, byte for byte;
     super_k9     the SuperCircuit's golden at k=9 (State, EVM, Bytecode,
                  Tx and RLP over one signed transaction, plonk/demo.py):
                  its sha256 equals the reference's proof, it verifies,
                  and a flipped carry cell of the ADD step (gate-only) is
                  rejected;
     super_k12    the chunk prover (service.prover.ChunkProver) at
                  k=SUPER_K = 12 (13 before, cut for the script's
                  time), full width, over seeded signed
                  transactions whose contracts also run CALLDATACOPY,
                  EXP, MULMOD/ADDMOD and SHA3 (State, EVM, Bytecode, Tx,
                  RLP, Copy, Exp, MulMod and Keccak on; the fullest region
                  >= 85% of its rows; service.bench_circuits.
                  super_prove_bench): SRS, keys, gen_chunk_proof under the
                  Poseidon transcript, verify_chunk_proof, per-phase
                  seconds, resident and peak memory, the fill of every
                  region; a second gen_chunk_proof of the same witness
                  comes from the proof cache, equal and with no launch;
     recursion_k10    the recursion layer's goldens (plonk/demo.py): the
                      k=5 demo under the Poseidon transcript compressed by
                      CompressionCircuit at k=10 (its sha256 equals the
                      reference's proof; it verifies; finish_deferred
                      accepts it and rejects the inner proof with byte 7
                      flipped), the stdlib-only verifier artifact of its
                      vk run by evm_verify in a subprocess (accepts; a
                      flipped proof byte and a wrong instance rejected),
                      the BatchHashCircuit golden over three chunks at
                      k=10 (equal, verified, a bent RLC accumulator
                      rejected), and BatchHashCircuit at full width,
                      MAX_AGG_SNARKS = 15 chunks, at k=13: SRS, keygen,
                      prove, verify;
     recursion_chunk  the production layer 1 over super_k12's chunk
                      proof: service.prover.LayerProver (device None, the
                      card).gen_compression_proof, its tape's rows, min_k
                      and k_ext, keygen and prove phases, resident and
                      peak memory; verify_compression_proof, then
                      finish_deferred against the chunk's vk; a changed
                      exposed instance value rejected; BatchProver.
                      gen_batch's batch hash; a second
                      gen_compression_proof from the proof cache, equal
                      and with no launch;
     recursion_layer1 the in-circuit EC compression of the k=5 demo's
                      Poseidon-transcript proof (tests/test_pipeline.py:
                      40): recursion.pipeline.LayerProver (the card)
                      .compress proves AggregationSnarksCircuit m=1 at
                      k=15, k_ext 21; k, k_ext, columns, host, keygen,
                      prove and verify seconds with the phases, resident
                      and peak memory; verify_plonk and verify_accumulator
                      hold; a flipped proof byte is rejected;
     recursion_fold   the in-circuit fold of two CompressionLayerCircuit
                      claims over demo proofs (tests/test_fold.py:103):
                      service.prover.BatchProver.gen_batch_in_circuit on
                      the card proves AggregationFoldCircuit m=2 at k=15,
                      k_ext 20, verifies it and checks verify_fold's one
                      pairing; logs as recursion_layer1; the folded
                      accumulator with a bent limb fails verify_fold, and
                      the instance with input limb 3 bent and a flipped
                      proof byte each fail the verifier;
     testool_k9       the testool golden (plonk/demo.py: the sstoreGas
                      filler of tests/test_testool.py) through
                      testool.run_state_test's mock level, then its prove
                      level's SuperCircuit at k=9 (tau 0xBEEF, rng 0x7E57):
                      its sha256 equals the reference's proof, it verifies,
                      and the ADD step's flipped carry cell is rejected;
     msm_grid         poly/msm.py::msm_grid against msm at n=2^16 in
                      affine form, over SRS powers with distinct=True and
                      over seeded points with duplicates, infinities and
                      zero scalars in complete mode, both timed;
     entry_k10        entry.entry()'s NTT -> product -> iNTT step at K=10
                      on the card, equal byte for byte to the same step on
                      CPU tensors; entry.dryrun_multichip(1) on the card
                      (NCCL, one rank, its own process group);
     then, on a torch.distributed NCCL group of one rank (the sharded
     prover's D = 1 route: every iNTT at k and coset transform at k_ext is
     the radix-2 ladder, one K4 launch a stage):
     mesh_demo_k5    demo_k5 through prove(mesh=group): the same golden
                     and verdicts;
     mesh_state_k16  state_prove_bench(16, mesh=group): its proof's sha256
                     equals state_k16's, and it verifies;
  4. a `kernels` JSON line: each kernel (K5's two forms apart) with its
     launches on the Keccak path (K4: on mesh_state_k16) and, beside
     them, on every path, its check from phase 2, its time, bound and
     plain time, and those of its other shapes and forms (K1's: Fq at
     2^20, the window, and the sweep of phase 2 with its fits and the
     wrappers' host microseconds);
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


def _phase_json(phases: dict) -> str:
    """A prover's or keygen's `timings` as JSON: each phase's seconds and,
    where the prover kept them, the peak device memory in GB at each
    phase's end (since the path's reset: the phase where it first reaches
    its last value holds the peak)."""
    out = {k: round(v, 3) for k, v in phases.items() if k != "peak_bytes"}
    if "peak_bytes" in phases:
        out["peak_gb"] = {k: round(v / 2**30, 2)
                          for k, v in phases["peak_bytes"].items()}
    return json.dumps(out)


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
    """Phase 2, K1 to K4 and K7, and the DFT-pass matmul timed beside them."""
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
        bound, by = _bound_ms(96 * n, OPS_PER_MONT_MUL * n)
        r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 max_abs_err=_max_err(got, want))
        if fid == cf.FIELD_FR:
            rec["mont_mul"] = r
        else:
            rec["mont_mul"]["fq"] = r
    # K1 at the quotient's own shape: a 2^16-row window against another and
    # against a broadcast scalar (Fr)
    w = 1 << 16
    x, y2 = (torch.as_tensor(_rand_fe(rng, w, fr().modulus), device=dev)
             for _ in range(2))
    for form, y in (("window", y2), ("window_scalar", y2[5])):
        got = cf.mont_mul_cuda(x, y, cf.FIELD_FR)
        want = cf.mont_mul_plain(x, y, cf.FIELD_FR)
        ok = torch.equal(got, want)
        ms = _time_ms(lambda: cf.mont_mul_cuda(x, y, cf.FIELD_FR), 100)
        plain_ms = _time_ms(lambda: cf.mont_mul_plain(x, y, cf.FIELD_FR), 3)
        bound, by = _bound_ms(64 * w + y.numel(), OPS_PER_MONT_MUL * w)
        rec["mont_mul"][form] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, max_abs_err=_max_err(got, want))
        log(f"[kernels] K1 mont_mul Fr {form} n={w}: match={ok} kernel "
            f"{ms:.4f} ms plain {plain_ms:.3f} ms bound {bound:.4f} ms")
        if not ok:
            fails.append(f"K1 {form} mismatch")
    rec["mont_mul"]["sweep"] = sweep_k1_k7(dev, log, rng)

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

    # field_add_sub (crypto/field.py's add, sub and neg on the card), both
    # fields, at the quotient's shapes: a 2^16-row window against another
    # (add, sub), against a broadcast scalar either side (sub), and neg.
    # Rows 0-2 are 0, 1 and p - 1; rows 16-31 of b are p - a (sums to p)
    # and rows 32-47 equal a's.  The plain version is the 16-bit-limb code
    # under the same broadcast rule.  Adding needs no multiply: the bytes
    # bound it (each operand read once, one output row written).
    n = 1 << 16
    recs = {}
    for fid, fld in ((cf.FIELD_FR, F), (cf.FIELD_FQ, fq())):
        a, b = (torch.as_tensor(_rand_fe(rng, n, fld.modulus), device=dev)
                for _ in range(2))
        neg_a = fld.from_ints([(-v) % fld.modulus for v in fld.to_ints(a[16:32])])
        b[16:32] = torch.as_tensor(neg_a, device=dev)
        b[32:48] = a[32:48]
        forms = (("rows", a, b, cf.OP_ADD), ("rows_sub", a, b, cf.OP_SUB),
                 ("scalar", a, b[9], cf.OP_SUB), ("scalar_left", b[9], a, cf.OP_SUB),
                 ("neg", a, None, cf.OP_NEG))
        for form, x, y, op in forms:
            got = cf.field_add_sub_cuda(x, y, op, fid)
            want = cf.field_add_sub_plain(x, y, op, fid)
            ok = torch.equal(got, want)
            ms = _time_ms(lambda: cf.field_add_sub_cuda(x, y, op, fid), 100)
            plain_ms = _time_ms(lambda: cf.field_add_sub_plain(x, y, op, fid), 3)
            nbytes = x.numel() + (0 if y is None else y.numel()) + got.numel()
            bound, by = _bound_ms(nbytes, 0)
            r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     max_abs_err=_max_err(got, want))
            if form == "rows":
                recs[fid] = r
            else:
                recs[fid][form] = r
            log(f"[kernels] field_add_sub {fld.name} {form} n={n}: match={ok} "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound {bound:.4f} ms")
            if not ok:
                fails.append(f"field_add_sub {fld.name} {form} mismatch")
    # one kernel, one record: Fr's forms at the top (the main path adds
    # over Fr only), Fq's under "fq"
    rec["fr_add_sub"] = {**recs[cf.FIELD_FR], "fq": recs[cf.FIELD_FQ]}

    return rec, fails


SWEEP_N = [1 << k for k in (12, 14, 16, 18, 20)]


def _host_us(fn, calls: int = 300) -> float:
    """Host microseconds a call of `fn` takes to enqueue its work: the
    median over `calls` calls while the card is held busy (so that no call
    waits for the card)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_FILL_CYCLES)
    ts = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6


def _fit(ms: list) -> dict:
    """Least squares t = t0 + n c over SWEEP_N: t0 in ms, c in ns a row,
    and c against the 96 bytes a row of K1 or K7 moves at the card's
    memory rate."""
    c, t0 = np.polyfit(np.array(SWEEP_N, float), np.array(ms, float), 1)
    return dict(t0_ms=t0, c_ns=c * 1e6,
                c_over_bytes=c * 1e-3 / (96 / HBM_BYTES_PER_S))


def sweep_k1_k7(dev, log, rng) -> dict:
    """K1 (Fr, row against row) and K7 (Fr add) timed at n = 2^12 .. 2^20,
    each fitted to t = t0 + n c; then the host microseconds a call of K1's
    and K7's wrappers takes at the window.  Phase 2 holds both kernels'
    outputs against their plain versions."""
    from zkevm_circuits_tpu_torch.crypto.field import fr
    from zkevm_circuits_tpu_torch.ops import cuda_field as cf

    F = fr()
    a, b = (torch.as_tensor(_rand_fe(rng, SWEEP_N[-1], F.modulus), device=dev)
            for _ in range(2))
    out = {"n": SWEEP_N}
    for key, fn in (("k1", lambda x, y: cf.mont_mul_cuda(x, y, cf.FIELD_FR)),
                    ("k7", lambda x, y: cf.field_add_sub_cuda(x, y, cf.OP_ADD,
                                                              cf.FIELD_FR))):
        ms = [_time_ms(lambda: fn(a[:n], b[:n]), 100) for n in SWEEP_N]
        out[key] = dict(ms=ms, **_fit(ms))
        log(f"[sweep] {key}: " + " ".join(f"{n}:{t:.4f}" for n, t in zip(SWEEP_N, ms))
            + f" ms; {json.dumps(_fit(ms))}")
    w = 1 << 16
    x, y, s = a[:w], b[:w], b[5]
    out["host_us"] = {
        "k1": _host_us(lambda: cf.mont_mul_cuda(x, y, cf.FIELD_FR)),
        "k1_scalar": _host_us(lambda: cf.mont_mul_cuda(x, s, cf.FIELD_FR)),
        "k7": _host_us(lambda: cf.field_add_sub_cuda(x, y, cf.OP_ADD, cf.FIELD_FR)),
        "k7_scalar": _host_us(
            lambda: cf.field_add_sub_cuda(x, s, cf.OP_SUB, cf.FIELD_FR)),
    }
    log(f"[sweep] host us a call at n={w}: {json.dumps(out['host_us'])}")
    return out


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
    log(f"[{tag}] card={gpu!r} srs {r['srs_s']:.2f} s keygen "
        f"{r['keygen_s']:.2f} s prove {r['prove_s']:.2f} s verify "
        f"{r['verify_s']:.2f} s ok={r['ok']} proof_bytes={r['proof_bytes']} "
        f"sha256={digests[tag]} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    log(f"[{tag}] prove phases (s, card={gpu!r}): {_phase_json(r['prove_phases'])}")
    log(f"[{tag}] keygen phases (s, card={gpu!r}): {_phase_json(r['keygen_phases'])}")
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


# The Keccak path's degree: the reference's DEGREE=16, cut to 15 and then to
# 14, each time after a whole-script run passed 1,000 s of the 1,200 s limit
# (PERF.md, section 6).
KECCAK_K = 14


def prove_keccak_full(dev, log, gpu: str) -> list:
    """The Keccak circuit at k=KECCAK_K, full width."""
    from zkevm_circuits_tpu_torch.circuits.keccak import ROWS_PER_PERM, KeccakCircuit
    from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    k = KECCAK_K
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
    log(f"[keccak k={k}] card={gpu!r} messages={len(msgs)} "
        f"permutations={len(circ.states)} advice={cs.num_advice} "
        f"gate_polys={sum(len(g.polys) for g in cs.gates)} k_ext={pk.k_ext} "
        f"srs {t1 - t0:.2f} s keygen {t2 - t1:.2f} s prove {t3 - t2:.2f} s "
        f"verify {t4 - t3:.2f} s ok={ok} proof_bytes={len(proof)} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    log(f"[keccak k={k}] prove phases (s, card={gpu!r}): {_phase_json(phases)}")
    log(f"[keccak k={k}] keygen phases (s, card={gpu!r}): {_phase_json(kphases)}")
    return [] if ok else [f"keccak k={k} proof did not verify"]


def _mem_byte_flip(circuit_cls):
    """`circuit_cls` with the last memory byte of the MSTORE row set to 0x99
    (tests/test_evm_circuit.py::test_evm_circuit_catches_wrong_mem_byte)
    and the RW table's row of that memory write given the same byte, so
    that every logUp input stays in its table and only the word's gate
    ('MEM word rlc') fails: the prover makes a proof, the verifier must
    reject it."""
    from zkevm_circuits_tpu_torch.crypto.field import fr

    F = fr()
    bad = F.from_int(0x99 * F.R % F.modulus)

    class Corrupt(circuit_cls):
        def synthesize(self, phase, n, challenges, instances):
            cols = super().synthesize(phase, n, challenges, instances)
            row = next(i for i, s in enumerate(self.steps)
                       if s.exec_state == "MSTORE")
            if phase == 0:
                col, at = self.c_mem[31], row
            else:
                last = self.steps[row].rw_indices[-1]
                col = self.t_val
                at = next(i for i, r in enumerate(self._rw_rows)
                          if r.rw_counter == last)
            arr = np.array(cols[col])
            arr[at] = bad
            cols[col] = arr
            return cols

    return Corrupt


def prove_evm_k9(dev, log) -> list:
    """The EVM circuit at k=9 over plonk/demo.py's golden program: its
    sha256 equals the reference's proof (golden), it verifies, and the
    memory-byte corruption is rejected."""
    from zkevm_circuits_tpu_torch.circuits.evm import EvmCircuit, EvmParams
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.service.bench_circuits import evm_witness

    fails = []
    k = demo.EVM_GOLDEN_K
    params = EvmParams(target_steps=demo.EVM_GOLDEN_TARGET_STEPS,
                       rw_target=demo.EVM_GOLDEN_RW_TARGET)
    b = evm_witness(demo.EVM_GOLDEN_CODE, demo.EVM_GOLDEN_SENDER,
                    demo.EVM_GOLDEN_CONTRACT)
    steps, rws = b.steps, b.rws.rws
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=demo.EVM_GOLDEN_TAU, device=dev)
    pk, vk = keygen(EvmCircuit(steps, rws, params), k, srs, device=dev)
    t1 = time.perf_counter()
    proof = prove(pk, EvmCircuit(steps, rws, params), [], srs,
                  rng=np.random.default_rng(demo.EVM_GOLDEN_SEED), device=dev)
    t2 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = (digest == demo.EVM_GOLDEN_SHA256
              and len(proof) == demo.EVM_GOLDEN_LEN)
    ok = verify(vk, [], proof)
    bad = prove(pk, _mem_byte_flip(EvmCircuit)(steps, rws, params), [], srs,
                rng=np.random.default_rng(1), device=dev)
    corrupt = verify(vk, [], bad)
    log(f"[evm k=9] steps={len(steps)} setup+keygen {t1 - t0:.2f} s prove "
        f"{t2 - t1:.2f} s proof_bytes={len(proof)} sha256={digest} "
        f"golden={golden} verify={ok} mem_byte_flip={corrupt}")
    if not golden:
        fails.append("evm k=9 proof differs from the golden")
    if not ok or corrupt:
        fails.append("evm k=9 verifier verdicts wrong")
    return fails


EVM_K = 13


def prove_evm_full(dev, log, gpu: str) -> list:
    """The EVM circuit at k=EVM_K, full width, over the seeded looping-contract
    workload of service.bench_circuits.evm_workload (RW rows >= 90% of the
    usable rows)."""
    from zkevm_circuits_tpu_torch.service.bench_circuits import evm_prove_bench

    r = evm_prove_bench(EVM_K, seed=SEED, device=dev, log=log)
    cs, w = r["cs"], r["workload"]
    log(f"[evm k={EVM_K}] card={gpu!r} txs={w['txs']} steps={w['steps']} "
        f"rw_rows={w['rw_rows']} rw_fill={w['rw_fill']:.4f} "
        f"advice={cs.num_advice} gate_polys={sum(len(g.polys) for g in cs.gates)} "
        f"logups={len(cs.logups)} logup_inputs={sum(len(lg.inputs) for lg in cs.logups)} "
        f"workload {w['workload_s']:.2f} s srs {r['srs_s']:.2f} s keygen "
        f"{r['keygen_s']:.2f} s prove {r['prove_s']:.2f} s verify "
        f"{r['verify_s']:.2f} s ok={r['ok']} proof_bytes={r['proof_bytes']} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}")
    log(f"[evm k={EVM_K}] prove phases (s, card={gpu!r}): "
        f"{_phase_json(r['prove_phases'])}")
    log(f"[evm k={EVM_K}] keygen phases (s, card={gpu!r}): "
        f"{_phase_json(r['keygen_phases'])}")
    fails = [] if r["ok"] else [f"evm k={EVM_K} proof did not verify"]
    if w["rw_fill"] < 0.9:
        fails.append(f"evm k={EVM_K} workload filled {w['rw_fill']:.4f} of the rows")
    return fails


def _tamper(circuit_cls, column, rows, new, phase: int = 0):
    """`circuit_cls` with its advice column column(circuit) of phase
    `phase` set to new(value) on each row of `rows` (values as plain
    ints).  Each use below changes a cell that only gates read: no lookup
    fails, so the prover makes a proof, and the verifier must reject it."""
    from zkevm_circuits_tpu_torch.crypto.field import fr

    F = fr()
    r_inv = pow(F.R, -1, F.modulus)

    class Corrupt(circuit_cls):
        def synthesize(self, phase_, n, challenges, instances):
            cols = super().synthesize(phase_, n, challenges, instances)
            if phase_ == phase:
                c = column(self)
                arr = np.array(cols[c])
                for row in rows:
                    cur = F.to_ints(arr[row:row + 1])[0] * r_inv % F.modulus
                    arr[row] = F.from_int(new(cur) % F.modulus * F.R % F.modulus)
                cols[c] = arr
            return cols

    return Corrupt


def _prove_goldens(dev, log, path: str, goldens: dict, make, corrupt: dict,
                   instances=lambda name: []) -> list:
    """Each golden of `goldens` ({name: (k, sha256, proof length)}) over
    its circuit make(name) and instances(name): SRS, keygen and prove on
    the card; the proof's sha256 and length equal the golden's (the
    reference's proof), and it verifies.  `corrupt` = {name: (label,
    circuit -> corrupted circuit)}: that golden's proving key proves the
    corrupted witness, which the verifier must reject."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    fails = []
    for name, (k, sha, length) in goldens.items():
        inst = instances(name)
        t0 = time.perf_counter()
        srs = Srs.unsafe_setup(k, tau=demo.PARTNER_GOLDEN_TAU, device=dev)
        pk, vk = keygen(make(name), k, srs, device=dev)
        t1 = time.perf_counter()
        proof = prove(pk, make(name), inst, srs,
                      rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED),
                      device=dev)
        t2 = time.perf_counter()
        digest = hashlib.sha256(proof).hexdigest()
        golden = digest == sha and len(proof) == length
        ok = verify(vk, inst, proof)
        line = (f"[{path}] {name} k={k} setup+keygen {t1 - t0:.2f} s "
                f"prove {t2 - t1:.2f} s proof_bytes={len(proof)} "
                f"sha256={digest} golden={golden} verify={ok}")
        if name in corrupt:
            label, bad_circuit = corrupt[name]
            bad = prove(pk, bad_circuit(make(name)), inst, srs,
                        rng=np.random.default_rng(1), device=dev)
            rejected = not verify(vk, inst, bad)
            line += f" {label}_rejected={rejected}"
            if not rejected:
                fails.append(f"{path}: the corrupted {name} proof verified")
        log(line)
        if not golden:
            fails.append(f"{path}: {name} proof differs from the golden")
        if not ok:
            fails.append(f"{path}: {name} proof did not verify")
    return fails


def prove_partners_k9(dev, log) -> list:
    """The EVM's table partners at small k (plonk/demo.py's goldens: the
    witnesses of the reference's tests); the Exp circuit with the low byte
    of d on its first (result) row bumped by one proves and is rejected
    (tests/test_exp_circuit.py::test_exp_circuit_catches_wrong_result:
    the byte stays in the byte table, so only the gate 'exp mul lo'
    fails)."""
    from zkevm_circuits_tpu_torch.plonk import demo

    bump = lambda c: _tamper(type(c), lambda s: s.c_d[0], [0],  # noqa: E731
                             lambda v: (v + 1) % 256)(c.events)
    return _prove_goldens(
        dev, log, "partners_k9", demo.PARTNER_GOLDENS, demo.partner_golden,
        {"exp": ("d0_bump", bump)})


def _log_bench(log, gpu: str, name: str, r: dict, resident: float):
    """The lines of one *_prove_bench result: workload, shape, seconds,
    proof bytes, the device memory allocated before it and its peak; the
    prove and keygen phases."""
    cs, w, k = r["cs"], r["workload"], r["k"]
    log(f"[{name} k={k}] card={gpu!r} workload={json.dumps(w)} "
        f"advice={cs.num_advice} "
        f"gate_polys={sum(len(g.polys) for g in cs.gates)} "
        f"logup_inputs={sum(len(lg.inputs) for lg in cs.logups)} "
        f"srs {r['srs_s']:.2f} s keygen {r['keygen_s']:.2f} s prove "
        f"{r['prove_s']:.2f} s verify {r['verify_s']:.2f} s ok={r['ok']} "
        f"proof_bytes={r['proof_bytes']} resident_gb={resident:.2f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    for phase in ("prove", "keygen"):
        log(f"[{name} k={k}] {phase} phases (s, card={gpu!r}): "
            f"{_phase_json(r[phase + '_phases'])}")


def prove_partners_k16(dev, log, gpu: str) -> list:
    """Exp, Copy and Bytecode at k=16, full width, over the seeded
    workloads of service.bench_circuits (each >= 90% of the usable rows):
    SRS, keygen, prove, verify, per-phase seconds, peak device memory."""
    from zkevm_circuits_tpu_torch.service.bench_circuits import (
        PARTNER_FILL, partner_prove_bench)

    fails = []
    for name in ("exp", "copy", "bytecode"):
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev) / 2**30
        r = partner_prove_bench(name, 16, seed=SEED, device=dev,
                                log=lambda m: None)
        _log_bench(log, gpu, name, r, resident)
        if not r["ok"]:
            fails.append(f"{name} k=16 proof did not verify")
        if r["workload"]["fill"] < PARTNER_FILL:
            fails.append(f"{name} k=16 workload filled "
                         f"{r['workload']['fill']:.4f} of the rows")
    return fails


def prove_precompiles_k9(dev, log) -> list:
    """The precompile circuits at k=9 (plonk/demo.py's goldens: the
    witnesses of the reference's tests); SHA-256 with the bit of its
    digest word H'_0 flipped on the first message's last digest row proves
    and is rejected (tests/test_sha256_circuit.py::
    test_sha256_circuit_catches_wrong_digest: only "sha out rlc" fails)."""
    from zkevm_circuits_tpu_torch.plonk import demo

    flip = lambda c: _tamper(type(c), lambda s: s.c_a[0], [71],  # noqa: E731
                             lambda v: 1 - v)(c.messages)
    return _prove_goldens(
        dev, log, "precompiles_k9", demo.PRECOMPILE_GOLDENS,
        demo.precompile_golden, {"sha256": ("digest_bit_flip", flip)})


def prove_precompiles_k13(dev, log, gpu: str) -> list:
    """Sig, ECC, ModExp and SHA-256 at k=13, full width, over the seeded
    workloads of service.bench_circuits (each but Sig >= 90% of the usable
    rows): SRS, keygen, prove, verify, per-phase seconds, the device memory
    still allocated when each starts and its peak; then the Sig circuit
    with its u1 scalar bit on walk row 101 flipped, which must be rejected
    (tests/test_sig_circuit.py::test_sig_circuit_catches_tampered_scalar_bit:
    on the CPU the MockProver finds only gates failing, 'sig tx mux 0/1',
    'sig ty mux 0/1', 'sig u1h walk')."""
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.service.bench_circuits import (
        PRECOMPILE_FILL, precompile_circuit, precompile_prove_bench)

    k, fails = 13, []
    for name in ("sig", "ecc", "modexp", "sha256"):
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev) / 2**30
        r = precompile_prove_bench(name, k, seed=SEED, device=dev,
                                   log=lambda m: None)
        _log_bench(log, gpu, name, r, resident)
        if not r["ok"]:
            fails.append(f"{name} k={k} proof did not verify")
        if name != "sig" and r["workload"]["fill"] < PRECOMPILE_FILL:
            fails.append(f"{name} k={k} workload filled "
                         f"{r['workload']['fill']:.4f} of the rows")
        del r
    circuit, _ = precompile_circuit("sig", k, SEED)
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=0xBE2C4, device=dev)
    pk, vk = keygen(circuit, k, srs, device=dev)
    flipped = _tamper(type(circuit), lambda s: s.c_b1, [101], lambda v: 1 - v)
    bad = prove(pk, flipped(circuit.events), [], srs,
                rng=np.random.default_rng(1), device=dev)
    rejected = not verify(vk, [], bad)
    log(f"[sig k={k}] scalar_bit_flip_rejected={rejected} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not rejected:
        fails.append(f"sig k={k}: the corrupted proof verified")
    return fails


def prove_poseidon_k9(dev, log) -> list:
    """The Poseidon chain's goldens (plonk/demo.py).  The k=5 DemoCircuit
    under the Poseidon transcript: its sha256 equals the reference's, the
    PoseidonReader accepts it, and the verifier rejects it with the
    default Blake2b reader and with a wrong instance.  Then the Poseidon
    (k=9), MPT (k=7) and PI (k=9) circuits over the witnesses of the
    reference's tests, each equal to its golden and verified, and each
    with one cell changed that only gates read, which must be rejected:
    Poseidon's final state of the first block (tests/test_poseidon.py::
    test_poseidon_circuit_catches_wrong_state), the MPT's new root on the
    three rows of the first update (tests/test_mpt_circuit.py::
    test_mpt_circuit_catches_wrong_root) and PI's statement byte 10
    (tests/test_pi_circuit.py::
    test_pi_circuit_rejects_tampered_statement_byte)."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.poly.transcript import (
        PoseidonReader, PoseidonTranscript)

    fails = []
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device=dev)
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device=dev)
    t1 = time.perf_counter()
    inst = [[demo.A_IN]]
    proof = prove(pk, demo.DemoCircuit(), inst, srs,
                  transcript=PoseidonTranscript(),
                  rng=np.random.default_rng(demo.POSEIDON_TRANSCRIPT_GOLDEN_SEED),
                  device=dev)
    t2 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = (digest == demo.POSEIDON_TRANSCRIPT_GOLDEN_SHA256
              and len(proof) == demo.POSEIDON_TRANSCRIPT_GOLDEN_LEN)
    ok = verify(vk, inst, proof, transcript=PoseidonReader(proof))
    blake = verify(vk, inst, proof)
    wrong = verify(vk, [[demo.A_IN + 1]], proof,
                   transcript=PoseidonReader(proof))
    log(f"[poseidon_k9] demo k=5 poseidon transcript setup+keygen "
        f"{t1 - t0:.2f} s prove {t2 - t1:.2f} s sha256={digest} "
        f"golden={golden} verify={ok} blake2b_reader={blake} "
        f"wrong_instance={wrong}")
    if not golden:
        fails.append("poseidon_k9: the Poseidon-transcript demo proof differs "
                     "from the golden")
    if not ok or blake or wrong:
        fails.append("poseidon_k9: Poseidon-transcript verdicts wrong")
    corrupt = {
        "poseidon": ("final_state", lambda c: _tamper(
            type(c), lambda s: s.c_s[0], [65], lambda v: 99)(c.events)),
        "mpt": ("new_root", lambda c: _tamper(
            type(c), lambda s: s.c_new_root, [0, 1, 2],
            lambda v: v + 1)(c.updates)),
        "pi": ("statement_byte", lambda c: _tamper(
            type(c), lambda s: s.c_byte, [10], lambda v: 0x77)(c.pd)),
    }
    return fails + _prove_goldens(
        dev, log, "poseidon_k9", demo.CHAIN_GOLDENS,
        lambda name: demo.chain_golden(name)[0], corrupt,
        instances=lambda name: demo.chain_golden(name)[1])


MPT_K = 14
POSEIDON_K = 16


def prove_poseidon_mpt_full(dev, log, gpu: str) -> list:
    """The MPT circuits of a seeded two-level state transition at k=14 and
    the Poseidon circuit at k=16, full width, under the Poseidon
    transcript (service.bench_circuits): the host workload and its
    seconds; for the storage-subtrie circuit (>= MPT_FILL of the usable
    rows) and the account-trie circuit, SRS, keygen, prove, verify with
    the PoseidonReader, per-phase seconds, resident and peak memory; the
    batched permutation on the card (K1) against the host permutation,
    byte for byte, on the input states of the storage circuit's first
    Poseidon events; then the Poseidon circuit over those events, one a
    block, every block of 2^16."""
    from zkevm_circuits_tpu_torch.circuits.poseidon import ROWS_PER_BLOCK
    from zkevm_circuits_tpu_torch.crypto.field import fr
    from zkevm_circuits_tpu_torch.crypto.poseidon import permute, permute_batch
    from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
    from zkevm_circuits_tpu_torch.service.bench_circuits import (
        MPT_FILL, mpt_prove_bench, mpt_workload, poseidon_prove_bench)

    fails = []
    stor, acct, w = mpt_workload(SEED, MPT_K)
    log(f"[mpt_workload k={MPT_K}] card={gpu!r} host {w['workload_s']:.2f} s "
        f"{json.dumps(w)}")
    if w["fill"] < MPT_FILL:
        fails.append(f"mpt k={MPT_K} workload filled {w['fill']:.4f} of the rows")
    for which in ("storage", "account"):
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev) / 2**30
        r = mpt_prove_bench(which, MPT_K, (stor, acct, w), device=dev)
        _log_bench(log, gpu, f"mpt_{which}", r, resident)
        if not r["ok"]:
            fails.append(f"mpt {which} k={MPT_K} proof did not verify")
        del r
    events = stor.poseidon_events()

    # the batched permutation (K1 on the card) against the host one
    F = fr()
    p = F.modulus
    blocks = usable_rows(1 << POSEIDON_K) // ROWS_PER_BLOCK
    inputs = [[e.domain, e.in0, e.in1] for e in events[:blocks]]
    mont = lambda rows: np.stack([F.from_ints([v * F.R % p for v in r])  # noqa: E731
                                  for r in rows])
    states = torch.as_tensor(mont(inputs), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = permute_batch(states)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    want = mont([permute(s) for s in inputs])
    t2 = time.perf_counter()
    same = bool(np.array_equal(got.cpu().numpy(), want))
    log(f"[poseidon permute_batch] card={gpu!r} states={len(inputs)} "
        f"card {t1 - t0:.3f} s host {t2 - t1:.3f} s equal={same}")
    if not same:
        fails.append("permute_batch on the card differs from the host permute")

    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) / 2**30
    r = poseidon_prove_bench(POSEIDON_K, events, device=dev)
    _log_bench(log, gpu, "poseidon", r, resident)
    if not r["ok"]:
        fails.append(f"poseidon k={POSEIDON_K} proof did not verify")
    if r["workload"]["fill"] < 1:
        fails.append(f"poseidon k={POSEIDON_K}: {r['workload']} leaves blocks empty")
    return fails


def prove_super_k9(dev, log) -> list:
    """The SuperCircuit's golden at k=9 (plonk/demo.py: the witness of
    tests/test_super_circuit.py::_witness(), State, EVM, Bytecode, Tx and
    RLP composed over one signed transaction): its sha256 equals the
    reference's proof, it verifies, and the ADD step's first carry cell
    flipped (tests/test_evm_circuit.py::test_evm_circuit_catches_wrong_sum:
    on the CPU the MockProver finds only the gates 'ADD byte 0/1' failing)
    is rejected."""
    from zkevm_circuits_tpu_torch.circuits.super_circuit import SuperCircuit
    from zkevm_circuits_tpu_torch.plonk import demo

    b, codes, txs = demo.super_witness()
    row = next(i for i, s in enumerate(SuperCircuit(b, codes, txs).evm.steps)
               if s.exec_state == "ADD")
    flip = lambda c: _tamper(  # noqa: E731
        SuperCircuit, lambda s: s.evm.c_carry[0], [row],
        lambda v: 1 - (v != 0))(b, codes, txs)
    golden = {"super": (demo.SUPER_GOLDEN_K, demo.SUPER_GOLDEN_SHA256,
                        demo.SUPER_GOLDEN_LEN)}
    return _prove_goldens(dev, log, "super_k9", golden,
                          lambda name: demo.super_golden(),
                          {"super": ("carry_flip", flip)})


SUPER_K = 12


def prove_super_full(dev, log, gpu: str, chunk: dict) -> list:
    """The chunk prover at k=SUPER_K = 12 (the reference's degree for its
    full composition is 13, tests/test_super_circuit.py:157; cut for the
    script's time), full width, over
    service.bench_circuits.super_workload: seeded signed transactions of
    looping contracts that also run CALLDATACOPY, EXP, MULMOD/ADDMOD and
    a SHA3, so State, EVM, Bytecode, Tx, RLP, Copy, Exp, MulMod and Keccak
    are all on, the fullest region at SUPER_FILL or more of its rows.
    Through ChunkProver (super_prove_bench): SRS, keys, gen_chunk_proof
    under the Poseidon transcript, verify_chunk_proof; then
    gen_chunk_proof again on the same witness, which must come from the
    proof cache with equal bytes and no kernel launch.  Logs the shapes,
    the fill of every region, per-phase seconds, resident and peak
    memory.  The chunk proof, its vk and instances go into `chunk` for
    recursion_chunk."""
    from zkevm_circuits_tpu_torch.service.bench_circuits import (
        SUPER_FILL, super_prove_bench)

    r = super_prove_bench(SUPER_K, seed=SEED, device=dev, log=lambda m: None)
    chunk.update(vk=r["vk"], proof=r["proof"], instances=r["instances"])
    w, k, hit = r["workload"], r["k"], r["cached"]
    log(f"[super k={k}] card={gpu!r} workload={json.dumps(w)}")
    log(f"[super k={k}] shapes={json.dumps(r['shapes'])} k_ext={r['k_ext']}")
    log(f"[super k={k}] card={gpu!r} srs {r['srs_s']:.2f} s keygen "
        f"{r['keygen_s']:.2f} s prove {r['prove_s']:.2f} s verify "
        f"{r['verify_s']:.2f} s ok={r['ok']} proof_bytes={r['proof_bytes']} "
        f"resident_gb={r['resident_gb']:.2f} peak_mem_gb={r['peak_gb']:.2f}")
    log(f"[super k={k}] prove phases (s, card={gpu!r}): "
        f"{_phase_json(r['prove_phases'])}")
    log(f"[super k={k}] second gen_chunk_proof: {hit['s']:.3f} s "
        f"equal={hit['equal']} launches={hit['launches']}")
    fails = [] if r["ok"] else [f"super k={k} chunk proof did not verify"]
    if not hit["equal"] or hit["launches"]:
        fails.append(f"super k={k}: the second gen_chunk_proof was no cache hit")
    if max(w["fill"].values()) < SUPER_FILL:
        fails.append(f"super k={k} workload filled {w['fill']}")
    return fails


def _flip(data: bytes, at: int) -> bytes:
    bad = bytearray(data)
    bad[at] ^= 1
    return bytes(bad)


def prove_recursion_k10(dev, log, gpu: str) -> list:
    """The recursion layer's goldens and small statements (plonk/demo.py).
    The compression golden: the k=5 DemoCircuit proved under the Poseidon
    transcript, then CompressionCircuit over it (the inner proof's whole
    scalar verification on a tape) proved at its min_k = 10 with the
    Blake2b transcript: its sha256 equals the reference's proof, it
    verifies, finish_deferred accepts its deferred MSM and pairing, and
    the same circuit over the inner proof with byte 7 flipped is rejected
    by finish_deferred (tests/test_compression.py).  gen_verifier_artifact
    writes a stdlib-only verifier for the compression's vk, and evm_verify
    (a clean subprocess) accepts the card's proof and rejects a flipped
    proof byte and a wrong instance (tests/test_evm_verifier.py).  The
    BatchHashCircuit golden over three chunks at k=10 equals the
    reference's proof and verifies; its phase-1 RLC accumulator bent on
    row 5 (only the gate 'bh acc step' reads it there) is rejected.  Then
    BatchHashCircuit at full width, MAX_AGG_SNARKS chunks, at its own k:
    SRS, keygen, prove, verify."""
    import os
    import re
    import tempfile

    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.circuit import usable_rows
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.poly.transcript import (
        PoseidonReader, PoseidonTranscript)
    from zkevm_circuits_tpu_torch.recursion.aggregation import MAX_AGG_SNARKS
    from zkevm_circuits_tpu_torch.recursion.batch_hash import BatchHashCircuit
    from zkevm_circuits_tpu_torch.recursion.compression import (
        CompressionCircuit, finish_deferred)
    from zkevm_circuits_tpu_torch.recursion.evm_verifier import (
        evm_verify, gen_verifier_artifact)

    fails = []
    t0 = time.perf_counter()
    srs_i = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device=dev)
    pk_i, vk_i = keygen(demo.DemoCircuit(), demo.K, srs_i, device=dev)
    inst_i = [[demo.A_IN]]
    inner = prove(pk_i, demo.DemoCircuit(), inst_i, srs_i,
                  transcript=PoseidonTranscript(), device=dev,
                  rng=np.random.default_rng(demo.COMPRESSION_INNER_SEED))
    inner_ok = verify(vk_i, inst_i, inner, transcript=PoseidonReader(inner))
    t1 = time.perf_counter()
    comp, inst = demo.recursion_golden("compression", inner=(vk_i, inner))
    k, sha, length = demo.RECURSION_GOLDENS["compression"]
    t2 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=demo.COMPRESSION_TAU, device=dev)
    pk, vk = keygen(comp, k, srs, device=dev)
    t3 = time.perf_counter()
    proof = prove(pk, comp, inst, srs, device=dev,
                  rng=np.random.default_rng(demo.COMPRESSION_SEED))
    t4 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = digest == sha and len(proof) == length
    ok = verify(vk, inst, proof)
    deferred = finish_deferred(vk_i, comp.claim, inst[0])
    bad = CompressionCircuit(vk_i, _flip(inner, 7), inst_i)
    bad_deferred = finish_deferred(vk_i, bad.claim, bad.instances()[0])
    log(f"[recursion_k10] compression inner k={demo.K} (Poseidon transcript) "
        f"{t1 - t0:.2f} s verify={inner_ok}; tape rows={len(comp.tape.ops)} "
        f"sponge rows={len(comp.perm_rows)} instance={len(inst[0])} "
        f"min_k={comp.min_k()} host {t2 - t1:.2f} s; setup+keygen "
        f"{t3 - t2:.2f} s prove {t4 - t3:.2f} s proof_bytes={len(proof)} "
        f"sha256={digest} golden={golden} verify={ok} finish_deferred={deferred} "
        f"byte7_flipped_finish_deferred={bad_deferred}")
    if comp.min_k() != k or not golden:
        fails.append("recursion_k10: compression proof differs from the golden")
    if not (inner_ok and ok and deferred) or bad_deferred:
        fails.append("recursion_k10: compression verdicts wrong")
    with tempfile.TemporaryDirectory() as tmp:
        path = gen_verifier_artifact(vk, os.path.join(tmp, "verifier_compression.py"))
        with open(path) as f:
            src = f.read()
        mods = set(re.findall(r"^(?:import|from)\s+([\w.]+)", src, re.M))
        t5 = time.perf_counter()
        art = evm_verify(path, inst, proof)
        art_flip = evm_verify(path, inst, _flip(proof, len(proof) // 3))
        wrong = [[(inst[0][0] + 1) % (1 << 64)] + inst[0][1:]]
        art_wrong = evm_verify(path, wrong, proof)
        t6 = time.perf_counter()
    log(f"[recursion_k10] verifier artifact bytes={len(src)} imports={sorted(mods)} "
        f"evm_verify={art} flipped_byte={art_flip} wrong_instance={art_wrong} "
        f"({t6 - t5:.2f} s, three subprocesses)")
    if not mods <= {"hashlib", "json", "sys"} or not art or art_flip or art_wrong:
        fails.append("recursion_k10: verifier artifact verdicts wrong")

    bent = lambda c: _tamper(  # noqa: E731
        type(c), lambda s: s.c_acc, [5], lambda v: v + 1, phase=1)(c.batch)
    fails += _prove_goldens(
        dev, log, "recursion_k10",
        {"batch_hash": demo.RECURSION_GOLDENS["batch_hash"]},
        lambda name: demo.recursion_golden(name)[0], {"batch_hash": ("acc_step", bent)},
        instances=lambda name: demo.recursion_golden(name)[1])

    t0 = time.perf_counter()
    full = BatchHashCircuit(demo.mk_batch(demo.recursion_modules(), MAX_AGG_SNARKS))
    kf = next(k_ for k_ in range(10, 20) if usable_rows(1 << k_) >= full.rows)
    inst = [full.instance()]
    srs = Srs.unsafe_setup(kf, tau=demo.PARTNER_GOLDEN_TAU, device=dev)
    pk, vk = keygen(full, kf, srs, device=dev)
    t1 = time.perf_counter()
    phases: dict = {}
    proof = prove(pk, full, inst, srs, device=dev, timings=phases,
                  rng=np.random.default_rng(demo.PARTNER_GOLDEN_SEED))
    t2 = time.perf_counter()
    ok = verify(vk, inst, proof)
    t3 = time.perf_counter()
    log(f"[recursion_k10] batch_hash chunks={MAX_AGG_SNARKS} rows={full.rows} "
        f"k={kf} card={gpu!r} setup+keygen {t1 - t0:.2f} s prove {t2 - t1:.2f} s "
        f"verify {t3 - t2:.2f} s ok={ok} proof_bytes={len(proof)} prove phases "
        f"{_phase_json(phases)}")
    if not ok:
        fails.append(f"recursion_k10: the {MAX_AGG_SNARKS}-chunk batch hash "
                     "proof did not verify")
    return fails


def prove_recursion_chunk(dev, log, gpu: str, chunk: dict) -> list:
    """The production layer 1 over the real chunk proof: super_k12's
    Poseidon-transcript proof compressed by the service's LayerProver
    (device None: the card).  Logs the tape's rows, min_k, k_ext, the
    compression circuit's stats, the host-witness, SRS, keygen and prove
    seconds with the prove phases, resident and peak memory.  Then
    verify_compression_proof accepts it, finish_deferred accepts the
    deferred claim against the chunk's vk, and the proof with its last
    exposed instance value (the SHPLONK point u) changed is rejected;
    BatchProver.gen_batch folds the claim and returns the batch hash of
    one chunk; a second gen_compression_proof of the same inner proof
    comes from the proof cache, equal and with no kernel launch."""
    import os
    import tempfile

    from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS
    from zkevm_circuits_tpu_torch.ops import cuda_field
    from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree
    from zkevm_circuits_tpu_torch.recursion.aggregation import BatchHash, ChunkHash
    from zkevm_circuits_tpu_torch.recursion.compression import finish_deferred
    from zkevm_circuits_tpu_torch.service.prover import BatchProver, LayerProver, Proof
    from zkevm_circuits_tpu_torch.utils.stats import circuit_stats

    if "vk" not in chunk:
        return [f"recursion_chunk: super_k{SUPER_K} left no chunk proof"]
    fails = []
    vk_chunk = chunk["vk"]
    inner = Proof(proof=chunk["proof"], instances=chunk["instances"], k=vk_chunk.k)
    with tempfile.TemporaryDirectory() as tmp:
        lp = LayerProver(os.path.join(tmp, "params"), os.path.join(tmp, "out"))
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev) / 2**30
        tm: dict = {}
        cproof, comp = lp.gen_compression_proof(vk_chunk, inner, timings=tm)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        key = f"layer1_k{cproof.k}"
        pk_c, vk_c = lp._keys[key]
        stats = {**circuit_stats(vk_c.cs), "quotient_degree": quotient_degree(vk_c.cs)}
        log(f"[recursion_chunk] inner chunk k={vk_chunk.k} proof_bytes="
            f"{len(inner.proof)}; tape rows={len(comp.tape.ops)} sponge rows="
            f"{len(comp.perm_rows)} instance={len(cproof.instances[0])} "
            f"msm_terms={len(comp.claim.msm)} min_k={cproof.k} k_ext={pk_c.k_ext}")
        log(f"[recursion_chunk] shapes={json.dumps(stats)}")
        log(f"[recursion_chunk] card={gpu!r} host witness {tm['circuit']:.2f} s "
            f"srs {tm['srs']:.2f} s keygen {tm['keygen']:.2f} s prove "
            f"{tm['prove']:.2f} s proof_bytes={len(cproof.proof)} "
            f"resident_gb={resident:.2f} peak_mem_gb={peak:.2f}")
        for phases in ("keygen_phases", "prove_phases"):
            log(f"[recursion_chunk] {phases.replace('_', ' ')} (s, card={gpu!r}): "
                f"{_phase_json(tm[phases])}")
        t0 = time.perf_counter()
        ok = lp.verify_compression_proof(key, cproof)
        t1 = time.perf_counter()
        deferred = finish_deferred(vk_chunk, comp.claim, cproof.instances[0])
        t2 = time.perf_counter()
        bent = [list(cproof.instances[0])]
        bent[0][-1] = (bent[0][-1] + 1) % FR_MODULUS
        bent_ok = lp.verify_compression_proof(
            key, Proof(proof=cproof.proof, instances=bent, k=cproof.k))
        ch = ChunkHash(chain_id=1337,
                       prev_state_root=int.from_bytes(b"\x01" * 32, "big"),
                       post_state_root=int.from_bytes(b"\x02" * 32, "big"),
                       withdraw_root=int.from_bytes(b"\x03" * 32, "big"),
                       data_hash=int.from_bytes(bytes([7]) * 32, "big"))
        t3 = time.perf_counter()
        batch = BatchProver().gen_batch(
            [(vk_chunk, comp.claim, cproof.instances[0])], [ch])
        t4 = time.perf_counter()
        batch_ok = batch["batch_pi_hash"] == hex(BatchHash([ch]).pi_hash())
        before = sum(cuda_field.LAUNCHES.values())
        t5 = time.perf_counter()
        again, _ = lp.gen_compression_proof(vk_chunk, inner)
        t6 = time.perf_counter()
        launches = sum(cuda_field.LAUNCHES.values()) - before
        equal = again.proof == cproof.proof and again.instances == cproof.instances
    log(f"[recursion_chunk] verify_compression_proof={ok} ({t1 - t0:.2f} s) "
        f"finish_deferred={deferred} ({t2 - t1:.2f} s) bent_u_verify={bent_ok} "
        f"gen_batch {t4 - t3:.2f} s batch_pi_hash={batch['batch_pi_hash']} "
        f"matches={batch_ok}")
    log(f"[recursion_chunk] second gen_compression_proof: {t6 - t5:.3f} s "
        f"equal={equal} launches={launches}")
    if not (ok and deferred) or bent_ok:
        fails.append("recursion_chunk: compression verdicts wrong")
    if not batch_ok:
        fails.append("recursion_chunk: gen_batch returned another batch hash")
    if not equal or launches:
        fails.append("recursion_chunk: the second gen_compression_proof was no cache hit")
    return fails


def _demo_inner(dev, seeds) -> tuple:
    """The reference tests' inner snarks (tests/test_pipeline.py:26-36,
    tests/test_fold.py:103): the k=5 DemoCircuit's keys at tau 987654321
    and its proofs under the Poseidon transcript, one per rng seed."""
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.poly.transcript import PoseidonTranscript

    srs = Srs.unsafe_setup(demo.K, tau=demo.GOLDEN_TAU, device=dev)
    pk, vk = keygen(demo.DemoCircuit(), demo.K, srs, device=dev)
    return vk, [prove(pk, demo.DemoCircuit(), [[demo.A_IN]], srs,
                      transcript=PoseidonTranscript(),
                      rng=np.random.default_rng(seed), device=dev)
                for seed in seeds]


def _layer_stats(cs) -> dict:
    from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree
    from zkevm_circuits_tpu_torch.utils.stats import circuit_stats

    return {**circuit_stats(cs), "quotient_degree": quotient_degree(cs),
            "logup_inputs": [len(lg.inputs) for lg in cs.logups]}


def _log_layer(log, gpu: str, path: str, tm: dict, resident: float, peak: float):
    log(f"[{path}] card={gpu!r} host circuit {tm['circuit']:.2f} s srs "
        f"{tm['srs']:.2f} s keygen {tm['keygen']:.2f} s prove {tm['prove']:.2f} s "
        f"verify {tm['verify']:.2f} s resident_gb={resident:.2f} "
        f"peak_mem_gb={peak:.2f}")
    for phases in ("keygen_phases", "prove_phases"):
        log(f"[{path}] {phases.replace('_', ' ')} (s, card={gpu!r}): "
            f"{_phase_json(tm[phases])}")


def prove_recursion_layer1(dev, log, gpu: str) -> list:
    """The in-circuit EC compression layer, the twin of
    tests/test_pipeline.py:40: the k=5 demo's Poseidon-transcript proof
    (rng seed 3) compressed by recursion/pipeline.py's LayerProver (device
    None: the card), which proves AggregationSnarksCircuit m=1 (the inner
    verifier, its Poseidon transcript and the window-shared Straus MSM of
    its KZG claims, all in-circuit) and checks the proof and the exposed
    accumulator's one pairing.  Logs k, k_ext, the circuit's columns, the
    host, SRS, keygen, prove and verify seconds with the phases, resident
    and peak memory; verify_plonk and verify_accumulator hold again, and
    the proof with one byte of its last evaluation flipped is rejected."""
    import dataclasses
    import tempfile

    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.recursion.pipeline import LayerProver

    vk, (inner,) = _demo_inner(dev, (3,))
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) / 2**30
    tm: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        lp = LayerProver(srs_dir=tmp)
        s1 = lp.compress(vk, inner, [[demo.A_IN]], "layer1_0", timings=tm)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pk, _ = lp._keys[f"layer1_0:k{s1.k}"]
    log(f"[recursion_layer1] inner demo k={demo.K} proof_bytes={len(inner)}; "
        f"AggregationSnarksCircuit m={s1.m} k={s1.k} k_ext={pk.k_ext} "
        f"instance={len(s1.instances[-1])} proof_bytes={len(s1.proof)} "
        f"shapes={json.dumps(_layer_stats(s1.vk.cs))}")
    _log_layer(log, gpu, "recursion_layer1", tm, resident, peak)
    ok, acc = s1.verify_plonk(), s1.verify_accumulator()
    flipped = dataclasses.replace(s1, proof=_flip(s1.proof, len(s1.proof) - 136))
    flipped_ok = flipped.verify_plonk()
    log(f"[recursion_layer1] verify_plonk={ok} verify_accumulator={acc} "
        f"flipped_byte_verify_plonk={flipped_ok}")
    fails = []
    if s1.m != 1 or not (ok and acc):
        fails.append("recursion_layer1: the compression's verdicts are wrong")
    if flipped_ok:
        fails.append("recursion_layer1: a flipped proof byte was accepted")
    return fails


def prove_recursion_fold(dev, log, gpu: str) -> list:
    """The in-circuit aggregation fold, the twin of tests/test_fold.py:103:
    two CompressionLayerCircuit claims over the demo's Poseidon-transcript
    proofs (rng seeds 3 and 5); service/prover.py's BatchProver.
    gen_batch_in_circuit on a LayerProver of the card proves
    AggregationFoldCircuit m=2 at its min_k, verifies it and checks the
    folded accumulator's one pairing (verify_fold).  Logs as
    recursion_layer1; then the exposed folded accumulator with its first
    limb bent fails verify_fold (which reads only the last eight limbs),
    the proof against the instance with limb 3 bent (an input
    accumulator's: tests/test_fold.py:93-99 bends it for the MockProver)
    fails the verifier, and so does the proof with one byte of its last
    evaluation flipped."""
    import os
    import tempfile

    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.recursion.aggregation import BatchHash, ChunkHash
    from zkevm_circuits_tpu_torch.recursion.fold import verify_fold
    from zkevm_circuits_tpu_torch.recursion.layer import CompressionLayerCircuit
    from zkevm_circuits_tpu_torch.service.prover import BatchProver, LayerProver

    vk, proofs = _demo_inner(dev, (3, 5))
    t0 = time.perf_counter()
    items = []
    for proof in proofs:
        layer = CompressionLayerCircuit(vk, proof, [[demo.A_IN]])
        items.append((layer.claim, layer.instances()[0]))
    t1 = time.perf_counter()
    # the state roots chain 0x01.. -> 0x02.. -> 0x04.. (the reference test's
    # two chunks both go 0x01.. -> 0x02.., which BatchHash rejects)
    roots = [int.from_bytes(bytes([r]) * 32, "big") for r in (1, 2, 4)]
    hashes = [ChunkHash(chain_id=1337, prev_state_root=roots[i],
                        post_state_root=roots[i + 1],
                        withdraw_root=int.from_bytes(b"\x03" * 32, "big"),
                        data_hash=int.from_bytes(bytes([7 + i]) * 32, "big"))
              for i in range(2)]
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) / 2**30
    tm: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        layers = LayerProver(os.path.join(tmp, "params"))
        rec = BatchProver().gen_batch_in_circuit(layers, items, hashes, vk,
                                                 timings=tm)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    fp = rec["fold_proof"]
    pk, vk_f = layers._keys[f"fold_k{fp.k}_m{len(items)}"]
    log(f"[recursion_fold] two CompressionLayerCircuit claims {t1 - t0:.2f} s; "
        f"AggregationFoldCircuit m={len(items)} k={fp.k} k_ext={pk.k_ext} "
        f"instance={len(fp.instances[0])} proof_bytes={len(fp.proof)} "
        f"shapes={json.dumps(_layer_stats(vk_f.cs))}")
    _log_layer(log, gpu, "recursion_fold", tm, resident, peak)
    insts = fp.instances
    ok = verify(vk_f, insts, fp.proof)
    folded = verify_fold(vk, insts[0], len(items))
    bend = lambda at: [[(v + 1) % (1 << 128) if i == at else v  # noqa: E731
                        for i, v in enumerate(insts[0])]]
    folded_bent = verify_fold(vk, bend(len(insts[0]) - 8)[0], len(items))
    limb3_bent = verify(vk_f, bend(3), fp.proof)
    flipped_ok = verify(vk_f, insts, _flip(fp.proof, len(fp.proof) - 136))
    batch_ok = (rec["n_chunks"] == 2 and len(rec["folded_acc"]) == 8
                and rec["batch_pi_hash"] == hex(BatchHash(hashes).pi_hash()))
    log(f"[recursion_fold] verify={ok} verify_fold={folded} "
        f"bent_folded_limb_verify_fold={folded_bent} bent_limb3_verify="
        f"{limb3_bent} flipped_byte_verify={flipped_ok} "
        f"batch_pi_hash={rec['batch_pi_hash']} record_ok={batch_ok}")
    fails = []
    if not (ok and folded and batch_ok):
        fails.append("recursion_fold: the fold's verdicts or record are wrong")
    if folded_bent or limb3_bent or flipped_ok:
        fails.append("recursion_fold: a bent limb or a flipped byte was accepted")
    return fails


def prove_testool_k9(dev, log) -> list:
    """The testool golden (plonk/demo.py: tests/test_testool.py's sstoreGas
    filler): testool.run_state_test passes it through the mock level; the
    prove level's SuperCircuit proved on the card (k=9, tau 0xBEEF, rng
    0x7E57, Blake2b) equals the reference's proof and verifies; the ADD
    step's first carry cell flipped (gate-only: on the CPU the MockProver
    finds only 'ADD byte 0/1' failing) is proved under the same keys and
    rejected.  One keygen, two proofs."""
    from zkevm_circuits_tpu_torch import testool
    from zkevm_circuits_tpu_torch.circuits.super_circuit import SuperCircuit
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.testool import statetest

    fails = []
    st, = testool.load_json_fillers(json.dumps(demo.TESTOOL_GOLDEN_FILLER))
    t0 = time.perf_counter()
    mock = testool.run_state_test(st, testool.CircuitsConfig(level="mock"))
    cfg = testool.CircuitsConfig(level="prove", k=demo.TESTOOL_GOLDEN_K,
                                 srs_tau=demo.TESTOOL_GOLDEN_TAU, device=dev)
    early, circ = statetest._host_levels(st, cfg)
    t1 = time.perf_counter()
    if not (mock.ok and not mock.skipped) or early is not None:
        return [f"testool_k9: the host levels stopped: {mock} {early}"]
    keys = statetest._keygen_level(circ, cfg)
    t2 = time.perf_counter()
    proof, ok = statetest._prove_level(circ, cfg, keys)
    t3 = time.perf_counter()
    digest = hashlib.sha256(proof).hexdigest()
    golden = digest == demo.TESTOOL_GOLDEN_SHA256 and len(proof) == demo.TESTOOL_GOLDEN_LEN
    row = next(i for i, s in enumerate(circ.evm.steps) if s.exec_state == "ADD")
    Flip = _tamper(SuperCircuit, lambda s: s.evm.c_carry[0], [row],
                   lambda v: 1 - (v != 0))
    bad = object.__new__(Flip)
    bad.__dict__.update(circ.__dict__)
    _, bad_ok = statetest._prove_level(bad, cfg, keys)
    t4 = time.perf_counter()
    log(f"[testool_k9] {mock.name} mock={mock.status} host levels "
        f"{t1 - t0:.2f} s setup+keygen {t2 - t1:.2f} s prove {t3 - t2:.2f} s "
        f"proof_bytes={len(proof)} sha256={digest} golden={golden} "
        f"verify={ok} carry_flip(row {row}) verify={bad_ok} ({t4 - t3:.2f} s)")
    if not golden:
        fails.append("testool_k9: the proof differs from the reference's")
    if not ok:
        fails.append("testool_k9: the proof did not verify")
    if bad_ok:
        fails.append("testool_k9: the carry flip was accepted")
    return fails


MSM_GRID_K = 16


def check_msm_grid(dev, log, gpu: str) -> list:
    """poly/msm.py::msm_grid against msm on the card at n = 2^MSM_GRID_K,
    in affine form: over Srs.unsafe_setup's powers with distinct=True
    (affine, then incomplete adds), and over seeded points with duplicates,
    infinities and zero scalars in complete mode.  Each timed (a second,
    warm call of each, host index building included)."""
    from zkevm_circuits_tpu_torch.crypto.curve import G1, g1_to_affine_ints
    from zkevm_circuits_tpu_torch.poly.kzg import Srs
    from zkevm_circuits_tpu_torch.poly.msm import _grid_indices_host, msm, msm_grid

    n = 1 << MSM_GRID_K
    rng = np.random.default_rng(SEED + 3)
    srs = Srs.unsafe_setup(MSM_GRID_K, tau=0x5EED, device=dev)
    pts = srs.g1_powers
    dup = G1(*(c.clone() for c in pts))
    for c in dup:
        c[1::4] = c[0::4].clone()  # every fourth point repeats the one before it
    dup.z[7::97] = 0  # some points at infinity
    sc = torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
    sc_zero = sc.clone()
    sc_zero[::5] = 0  # zero scalars
    fails = []
    one = lambda p: G1(*(c[None] for c in p))  # noqa: E731

    def timed(fn):
        fn()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t) * 1e3

    for label, points, scalars, distinct in (
            ("srs distinct", pts, sc, True),
            ("seeded complete", dup, sc_zero, False)):
        grid, grid_ms = timed(lambda: msm_grid(points, scalars, distinct=distinct))
        scan, scan_ms = timed(lambda: msm(points, scalars))
        t = time.perf_counter()
        _, slots = _grid_indices_host(scalars.cpu().numpy())
        host_ms = (time.perf_counter() - t) * 1e3
        equal = g1_to_affine_ints(one(grid)) == g1_to_affine_ints(one(scan))
        log(f"[msm_grid] card={gpu!r} n=2^{MSM_GRID_K} {label}: msm_grid "
            f"{grid_ms:.2f} ms (its host indices {host_ms:.2f} ms, S={slots}) "
            f"msm {scan_ms:.2f} ms equal={equal}")
        if not equal:
            fails.append(f"msm_grid ({label}) differs from msm")
    return fails


def run_entry(dev, log) -> list:
    """entry.entry()'s NTT -> product -> iNTT step at K=10 on the card
    against the same step on CPU tensors (the plain versions), byte for
    byte; then entry.dryrun_multichip(1) on the card (NCCL, one rank: the
    sharded NTT, MSM, prefix scans and MiniCircuit proof, each equal to its
    single-device result)."""
    from zkevm_circuits_tpu_torch.entry import K, dryrun_multichip, entry

    step, (x, y) = entry()
    t0 = time.perf_counter()
    got = step(x, y)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    want = step(x.cpu(), y.cpu())
    equal = torch.equal(got.cpu(), want)
    t2 = time.perf_counter()
    summary = dryrun_multichip(1)
    t3 = time.perf_counter()
    log(f"[entry_k10] step K={K} card {1e3 * (t1 - t0):.2f} ms (first call) "
        f"cpu {t2 - t1:.2f} s equal={equal}; dryrun_multichip(1) "
        f"{t3 - t2:.2f} s {json.dumps(summary)}")
    return [] if equal else ["entry_k10: the step on the card differs from the CPU's"]


KERNELS = [
    ("K1", "mont_mul", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:178"),
    ("K2", "twiddle_mul", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:334"),
    ("K3", "redc34", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:273"),
    ("K4", "butterfly_stage", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/ops/pallas_field.py:213"),
    # K7, field_add_sub: crypto/field.py's add, sub and neg on the card,
    # counted as fr_add_sub (Fq: fq_add_sub, in the [launches] lines); it
    # replaces no Pallas kernel (the JAX package adds in jnp, no pallas_call)
    ("K7", "fr_add_sub", "zkevm_circuits_tpu_torch/csrc/field.cu",
     "zkevm_circuits_tpu/crypto/field.py:253"),
    ("K5", "g1_add", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:336"),
    ("K5", "g1_bucket_add", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:336"),
    ("K6", "g1_double", "zkevm_circuits_tpu_torch/csrc/curve.cu",
     "zkevm_circuits_tpu/ops/pallas_curve.py:359"),
]


def _resident(dev) -> dict:
    """What stays allocated on the card between paths, in GB: all of it,
    what is left after a garbage collection, and the NTT's module-level
    cache (poly/ntt_mxu.py::_DEVICE_CACHE: the DFT pass matrices, "pass",
    and twiddle tables, "tw"), which lives as long as the process."""
    import gc

    from zkevm_circuits_tpu_torch.poly import ntt_mxu

    out = {"allocated": torch.cuda.memory_allocated(dev)}
    gc.collect()
    out["after_gc"] = torch.cuda.memory_allocated(dev)
    for key, v in ntt_mxu._DEVICE_CACHE.items():
        tensors = v if isinstance(v, tuple) else (v,)
        name = f"ntt_mxu_{key[0]}"
        out[name] = out.get(name, 0) + sum(t.numel() * t.element_size() for t in tensors)
    return {k: round(v / 2**30, 2) for k, v in out.items()}


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
        t = time.perf_counter()
        fails += drive()
        torch.cuda.synchronize(dev)
        paths[path] = dict(cf.LAUNCHES)
        log(f"[launches] {path}: {json.dumps(paths[path])} "
            f"({time.perf_counter() - t:.1f} s)")
        log(f"[resident] after {path} (GB, card={gpu!r}): "
            f"{json.dumps(_resident(dev))}")
        for kid, name, _, _ in KERNELS:
            if (kid in kids or name in kids) and paths[path][name] == 0:
                fails.append(f"{kid} {name} was not launched on {path}")

    single = ("K1", "K2", "K3", "fr_add_sub", "K5", "K6")
    drive_path("demo_k5", lambda: prove_demo(dev, log), single)
    drive_path("keccak_k9", lambda: prove_keccak_k9(dev, log), single)
    drive_path("state_k16", lambda: prove_state(dev, log, gpu, digests), single)
    drive_path(f"keccak_k{KECCAK_K}", lambda: prove_keccak_full(dev, log, gpu),
               single)
    drive_path("evm_k9", lambda: prove_evm_k9(dev, log), single)
    drive_path(f"evm_k{EVM_K}", lambda: prove_evm_full(dev, log, gpu), single)
    drive_path("partners_k9", lambda: prove_partners_k9(dev, log), single)
    drive_path("partners_k16", lambda: prove_partners_k16(dev, log, gpu), single)
    drive_path("precompiles_k9", lambda: prove_precompiles_k9(dev, log), single)
    drive_path("precompiles_k13",
               lambda: prove_precompiles_k13(dev, log, gpu), single)
    drive_path("poseidon_k9", lambda: prove_poseidon_k9(dev, log), single)
    drive_path("poseidon_mpt_full",
               lambda: prove_poseidon_mpt_full(dev, log, gpu), single)
    drive_path("super_k9", lambda: prove_super_k9(dev, log), single)
    chunk: dict = {}
    drive_path(f"super_k{SUPER_K}",
               lambda: prove_super_full(dev, log, gpu, chunk), single)
    drive_path("recursion_k10", lambda: prove_recursion_k10(dev, log, gpu), single)
    drive_path("recursion_chunk",
               lambda: prove_recursion_chunk(dev, log, gpu, chunk), single)
    chunk.clear()
    drive_path("recursion_layer1",
               lambda: prove_recursion_layer1(dev, log, gpu), single)
    drive_path("recursion_fold", lambda: prove_recursion_fold(dev, log, gpu), single)
    drive_path("testool_k9", lambda: prove_testool_k9(dev, log), single)
    drive_path("msm_grid", lambda: check_msm_grid(dev, log, gpu), ("K5", "K6"))
    # before the mesh paths: the dry run makes its own process group
    drive_path("entry_k10", lambda: run_entry(dev, log),
               ("K1", "butterfly_stage", "K5"))
    # the sharded prover on an NCCL group of one rank (one card)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        every = single + ("butterfly_stage",)
        drive_path("mesh_demo_k5", lambda: prove_demo(dev, log, group), every)
        drive_path("mesh_state_k16",
                   lambda: prove_state(dev, log, gpu, digests, group), every)
    finally:
        dist.destroy_process_group()
    kernels = []
    for kid, name, source, replaces in KERNELS:
        r = rec[name]
        main = ("mesh_state_k16" if name == "butterfly_stage"
                else f"keccak_k{KECCAK_K}")
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
