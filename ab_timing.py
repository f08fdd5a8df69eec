#!/usr/bin/env python3
"""Time chosen paths of one or more checkouts of this repository on one
card, in turns, to compare two commits inside one call.

    python3 ab_timing.py LOG_DIR PATHS TREE_A TREE_B TREE_B TREE_A

Each TREE is the root of a checkout (for instance a `git archive` of
another commit unpacked into a git-ignored directory).  For each TREE, in
the order given, one process started in that tree imports the tree's own
port (and, where a path needs it, its `chip_smoke.py`) and runs PATHS, a
comma-separated list of:
  - msm: `msm_many` of 10 scalar columns against 2^16 points, after one
    warm-up call the median of 5 (host clock around a synchronised call),
    for full-width random scalars and for 0/1 scalars;
  - state_k16: the State k=16 prove seconds and phases
    (`state_prove_bench`);
  - field_kernels: chip_smoke's field kernel checks
    (`check_field_kernels`), keeping the K1, K2, K4 and add/sub records;
  - curve_kernels: chip_smoke's curve kernel checks
    (`check_curve_kernels`): the K5 and K6 records;
  - host_us: the host microseconds a call of the tree's K1 and K7
    wrappers (`mont_mul_cuda`, `field_add_sub_cuda`, Fr) takes at a
    2^16-row window, row against row and against a broadcast row: the
    median of 300 calls while `torch.cuda._sleep` holds the card;
  - recursion_layer1, keccak: chip_smoke's `prove_recursion_layer1` and
    `prove_keccak_full` with the launch counts set to 0 first: the path's
    seconds, the prove seconds, phases and launches, and the host seconds
    of each quotient pass's expression walk (from the end of the pass's
    "extended transforms" to its "quotient" mark; the prover synchronises
    the card at both);
  - recursion_layer1+trace, keccak+trace: the same, with the walk of the
    second pass of each prove that has two or more under torch.profiler:
    its kernels' count and device seconds (the device's busy time: one
    stream), the aten ops' self host seconds, and the top ops and kernels.
    The profiler slows the host, so the traced walk is slower than the
    others; its idle share is given against both.  Summing the trace
    falls in the prove's next phase, so a traced run's prove seconds are
    not comparable with an untraced run's.
It prints the card's name and power limit, each run's JSON line and,
last, all runs as one JSON list.  Each run's whole log goes to
LOG_DIR/ab_timing_<i>.log.  Exits non-zero if a run fails or a check in
it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PATHS = ("msm", "state_k16", "field_kernels", "curve_kernels", "host_us",
         "recursion_layer1", "keccak", "recursion_layer1+trace", "keccak+trace")

CHILD = r"""
import json, re, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from zkevm_circuits_tpu_torch.ops import build
from zkevm_circuits_tpu_torch.ops import cuda_field as cf

dev = torch.device("cuda")
paths, gpu = sys.argv[1].split(","), sys.argv[2]
lines = []


def log(m):
    print(m, flush=True)
    lines.append(m)


def msm():
    from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers
    from zkevm_circuits_tpu_torch.poly.msm import msm_many
    n = 1 << 16
    pts = srs_g1_powers(n, 0x5EED, dev)
    rng = np.random.default_rng(1)
    full = rng.integers(0, 256, size=(10, n, 32), dtype=np.uint8)
    full[..., 31] &= 0x1F
    bits = np.zeros((10, n, 32), np.uint8)
    bits[..., 0] = rng.integers(0, 2, size=(10, n))
    out = {}
    for name, sc in (("full_s", full), ("bits_s", bits)):
        s = torch.as_tensor(sc, device=dev)
        ts = []
        for _ in range(6):
            t0 = time.perf_counter()
            msm_many(pts, s)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name], out[name + "_all"] = statistics.median(ts[1:]), ts[1:]
    return out, []


def state_k16():
    from zkevm_circuits_tpu_torch.service.bench_circuits import state_prove_bench
    r = state_prove_bench(16, device=dev, log=lambda m: None)
    return {"prove_s": r["prove_s"], "phases": {
        k: round(v, 3) for k, v in r["prove_phases"].items()
        if isinstance(v, float)}}, []


def field_kernels():
    import chip_smoke as c
    rec, fails = c.check_field_kernels(dev, log, np.random.default_rng(c.SEED))
    return {k: rec[k] for k in ("fr_add_sub", "mont_mul", "twiddle_mul",
                                "butterfly_stage")}, fails


def curve_kernels():
    import chip_smoke as c
    return c.check_curve_kernels(dev, log, np.random.default_rng(c.SEED))


def host_us():
    def per_call(fn, calls=300):
        # the median of each call's host time, the card held busy
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        ts = []
        for _ in range(calls):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return statistics.median(ts) * 1e6

    rng = np.random.default_rng(2)
    x, y = (torch.as_tensor(rng.integers(0, 256, size=(1 << 16, 32), dtype=np.uint8)
                            & np.uint8(0x0F), device=dev) for _ in range(2))
    s = y[5]
    return {"k1": per_call(lambda: cf.mont_mul_cuda(x, y, cf.FIELD_FR)),
            "k1_scalar": per_call(lambda: cf.mont_mul_cuda(x, s, cf.FIELD_FR)),
            "k7": per_call(lambda: cf.field_add_sub_cuda(x, y, cf.OP_ADD, cf.FIELD_FR)),
            "k7_scalar": per_call(
                lambda: cf.field_add_sub_cuda(x, s, cf.OP_SUB, cf.FIELD_FR))}, []


def _dev_us(e):
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def _summary(prof, wall):
    ev = prof.key_averages()
    on_dev = [e for e in ev if str(getattr(e, "device_type", "")).endswith("CUDA")]
    on_host = [e for e in ev if e not in on_dev]
    busy = sum(_dev_us(e) for e in on_dev) / 1e6
    top = lambda es, f: [[e.key[:80], e.count, round(f(e) / 1e3, 3)]  # noqa: E731
                         for e in sorted(es, key=lambda e: -f(e))[:8]]
    return {"wall_s": wall, "kernels": sum(e.count for e in on_dev),
            "device_busy_s": busy,
            "ops_self_host_s": sum(e.self_cpu_time_total for e in on_host) / 1e6,
            "idle_share": 1 - busy / wall,
            "top_host_ops_ms": top(on_host, lambda e: e.self_cpu_time_total),
            "top_kernels_ms": top(on_dev, _dev_us)}


def _watch_walks(walks, trace):
    # wrap the prover's quotient passes: time each pass's walk, and trace
    # one if asked; returns the undo
    from zkevm_circuits_tpu_torch.plonk import prover
    orig = prover._quotient_passes

    def passes(*args):
        pk, mark, st = args[1], args[10], {"i": 0}
        r = 1 << (pk.k_ext - pk.k)
        n_pass = r // min(r, max(1, prover.QUOTIENT_CHUNK // pk.n))
        walks["walk_s"] = []  # the path's last prove is the one measured

        def finish(prof, wall):
            prof.stop()
            walks["trace"] = {"pass": 2, "of": n_pass, **_summary(prof, wall)}

        def timed_mark(stage):
            mark(stage)
            if stage == "extended transforms":
                st["i"] += 1
                if trace and st["i"] == 2:
                    st["prof"] = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    st["prof"].start()
                st["t"] = time.perf_counter()
            elif stage == "quotient":
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - st["t"]
                walks["walk_s"].append(wall)
                if "prof" in st:
                    finish(st.pop("prof"), wall)

        return orig(*args[:10], timed_mark, *args[11:])

    prover._quotient_passes = passes
    return lambda: setattr(prover, "_quotient_passes", orig)


def prove_path(name, trace):
    import chip_smoke as c
    fn = {"recursion_layer1": c.prove_recursion_layer1,
          "keccak": c.prove_keccak_full}[name]
    walks = {"walk_s": []}
    undo = _watch_walks(walks, trace)
    cf.reset_launches()
    first = len(lines)
    t = time.perf_counter()
    try:
        fails = fn(dev, log, gpu)
        torch.cuda.synchronize(dev)
    finally:
        undo()
    seconds = time.perf_counter() - t
    mine = lines[first:]
    phases = next(json.loads(m.split("): ", 1)[1]) for m in mine if "prove phases (s" in m)
    prove = next(float(g.group(1)) for m in mine
                 for g in [re.search(r"\bprove ([0-9.]+) s", m)] if g)
    ws = walks["walk_s"]
    out = {"path_s": seconds, "prove_s": prove, "quotient_s": phases["quotient"],
           "phases": phases, "launches": dict(cf.LAUNCHES),
           "walk_s_median": statistics.median(ws), "walk_s": ws}
    if "trace" in walks:
        tr = walks["trace"]
        untraced = [w for i, w in enumerate(ws) if i + 1 != tr["pass"]]
        tr["idle_share_untraced_walk"] = 1 - tr["device_busy_s"] / statistics.median(untraced)
        out["trace"] = tr
    if name == "keccak":
        out["k"] = c.KECCAK_K
    return out, fails


build.lib()
out, fails = {}, []
# registers and spills of each kernel as this tree's build reports them
out["ptxas"] = [ln.strip() for ln in build.PTXAS_LOG.splitlines()
                if "entry function" in ln or "registers" in ln or "spill" in ln]
for p in paths:
    if p in ("msm", "state_k16", "field_kernels", "curve_kernels", "host_us"):
        res, f = globals()[p]()
    else:
        res, f = prove_path(p.split("+")[0], p.endswith("+trace"))
    out[p], fails = res, fails + f
out["fails"] = fails
print("RESULT " + json.dumps(out), flush=True)
sys.exit(1 if fails else 0)
"""


def main(args: list[str]) -> int:
    if len(args) < 3 or any(p not in PATHS for p in args[1].split(",")):
        print(__doc__, file=sys.stderr)
        return 2
    log_dir, paths, trees = os.path.abspath(args[0]), args[1], args[2:]
    os.makedirs(log_dir, exist_ok=True)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=False).stdout.strip()
    print(gpu, flush=True)
    runs, rc = [], 0
    for i, tree in enumerate(trees):
        p = subprocess.run([sys.executable, "-c", CHILD, paths, gpu], cwd=tree,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        with open(os.path.join(log_dir, f"ab_timing_{i}.log"), "w") as f:
            f.write(p.stdout)
        res = [ln[len("RESULT "):] for ln in p.stdout.splitlines()
               if ln.startswith("RESULT ")]
        run = {"run": i, "tree": tree, "card": gpu, "rc": p.returncode,
               **(json.loads(res[-1]) if res else {"tail": p.stdout[-2000:]})}
        print(json.dumps(run), flush=True)
        runs.append(run)
        rc |= p.returncode != 0
    print(json.dumps(runs))
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
