#!/usr/bin/env python3
"""Time the port's MSM and the State k=16 prove on one card, for comparing
two checkouts of the repository in one session on the same card.

    cd <checkout> && python3 <path to>/msm_state_timing.py <label>

It imports the port from the current directory, so run it once from the
root of each checkout, in turns (A, B, B, A).  It prints one JSON line:
`msm_many` of 10 scalar columns against 2^16 points, the median of 5 runs
(host clock around a synchronised call) for full-width random scalars and
for 0/1 scalars (bit columns, whose window digits are mostly 0), then the
State k=16 prove seconds and its phases (`state_prove_bench`).
"""
import json
import statistics
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

from zkevm_circuits_tpu_torch.ops import build
from zkevm_circuits_tpu_torch.poly.kzg import srs_g1_powers
from zkevm_circuits_tpu_torch.poly.msm import msm_many
from zkevm_circuits_tpu_torch.service.bench_circuits import state_prove_bench

dev = torch.device("cuda")
build.lib()
n = 1 << 16
pts = srs_g1_powers(n, 0x5EED, dev)
rng = np.random.default_rng(1)
full = rng.integers(0, 256, size=(10, n, 32), dtype=np.uint8)
full[..., 31] &= 0x1F
bits = np.zeros((10, n, 32), np.uint8)
bits[..., 0] = rng.integers(0, 2, size=(10, n))
out = {"side": sys.argv[1]}
for name, sc in (("msm10x2^16_full_s", full), ("msm10x2^16_bits_s", bits)):
    s = torch.as_tensor(sc, device=dev)
    msm_many(pts, s)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        msm_many(pts, s)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    out[name] = statistics.median(ts)
    out[name + "_all"] = ts
r = state_prove_bench(16, device=dev, log=lambda m: None)
out["state_prove_s"] = r["prove_s"]
out["state_phases"] = {k: round(v, 3) for k, v in r["prove_phases"].items()}
print(json.dumps(out), flush=True)
