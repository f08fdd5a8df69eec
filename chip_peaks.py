"""A short card check through chip_smoke.py's own functions: the kernel
checks (field_add_sub's record, Fr and Fq, and K1 at a 2^16-row window
among them), the demo and State k=16 on one
device and on a one-rank NCCL mesh, then EVM at k=14 and the chunk at
k=13 with their peak device memory, one degree above the script's.

    python3 chip_peaks.py        (from the repo root, on one card)
"""
import json
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, ".")
import chip_smoke as c
from zkevm_circuits_tpu_torch.ops import build
from zkevm_circuits_tpu_torch.ops import cuda_field as cf

log = lambda m: print(m, flush=True)  # noqa: E731
dev = torch.device("cuda")
gpu = c._gpu_line()
log(gpu)
t_start = time.perf_counter()
build.lib()
rec, fails = c.check_kernels(dev, log)
log("[fr_add_sub rec] " + json.dumps(rec["fr_add_sub"]))
log("[mont_mul window rec] " + json.dumps(
    {k: rec["mont_mul"][k] for k in ("window", "window_scalar")}))
digests, chunk = {}, {}


def drive(path, fn):
    global fails
    torch.cuda.reset_peak_memory_stats(dev)
    cf.reset_launches()
    t = time.perf_counter()
    fails += fn()
    torch.cuda.synchronize(dev)
    log(f"[launches] {path}: {json.dumps(dict(cf.LAUNCHES))} ({time.perf_counter() - t:.1f} s)")


drive("demo_k5", lambda: c.prove_demo(dev, log))
drive("state_k16", lambda: c.prove_state(dev, log, gpu, digests))
dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
try:
    g = dist.group.WORLD
    drive("mesh_demo_k5", lambda: c.prove_demo(dev, log, g))
    drive("mesh_state_k16", lambda: c.prove_state(dev, log, gpu, digests, g))
finally:
    dist.destroy_process_group()
c.EVM_K = 14
drive("evm_k14", lambda: c.prove_evm_full(dev, log, gpu))
c.SUPER_K = 13
drive("super_k13", lambda: c.prove_super_full(dev, log, gpu, chunk))
log(f"[total] {time.perf_counter() - t_start:.1f} s")
log(f"FAILS {fails}")
sys.exit(1 if fails else 0)
