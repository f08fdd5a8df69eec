"""Per-circuit prove benchmark at reference degrees (port of
zkevm_circuits_tpu/service/bench_circuits.py).

`state_prove_bench(k)` builds a synthetic but constraint-complete RW
workload that fills the usable rows of 2^k (memory write/read pairs over
several call frames, so every lexicographic-ordering, range-decomposition
and tag-rule path of the State circuit runs), then the real pipeline: SRS,
keygen, prove (full SHPLONK proof), verify, with per-phase wall-clock.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..circuits.state import StateCircuit, StateParams
from ..device import resolve
from ..plonk.keygen import keygen
from ..plonk.prover import prove
from ..plonk.verifier import verify
from ..poly.kzg import Srs
from ..witness.rw import Rw, RwTag


def synthetic_rw_workload(n_rows: int) -> list[Rw]:
    """`n_rows` RW rows shaped like real execution traffic: per call frame
    a burst of memory writes, then re-reads."""
    rows: list[Rw] = []
    ctr = 1
    call_id = 1
    addr = 0
    while len(rows) < n_rows:
        burst = min(64, n_rows - len(rows))
        half = burst // 2
        for j in range(half):
            rows.append(Rw(
                rw_counter=ctr, is_write=True, tag=RwTag.Memory,
                id=call_id, address=addr + j, value=(j * 37 + call_id) & 0xFF,
            ))
            ctr += 1
        for j in range(burst - half):
            jj = min(j, half - 1) if half else 0
            rows.append(Rw(
                rw_counter=ctr, is_write=False, tag=RwTag.Memory,
                id=call_id, address=addr + jj,
                value=(jj * 37 + call_id) & 0xFF if half else 0,
            ))
            ctr += 1
        call_id += 1
        addr += 1 << 12
    # state circuit sorts by (tag, id, address, ..., rw_counter)
    rows.sort(key=lambda r: (
        int(r.tag), r.id, r.address, int(r.field_tag), r.storage_key,
        r.rw_counter,
    ))
    return rows[:n_rows]


def state_prove_bench(k: int = 18, tau: int = 0xB_E2C4, device=None,
                      log=print, mesh=None) -> dict:
    """SRS + keygen + prove + verify of the State circuit at degree `k`.
    `mesh`, a torch.distributed process group, goes to `prove(mesh=...)`.

    Returns {"k", "rows", "srs_s", "keygen_s", "prove_s", "verify_s", "ok",
    "proof_bytes", "proof", "keygen_phases", "prove_phases"}."""
    from ..plonk.circuit import usable_rows

    dev = resolve(device)
    n = 1 << k
    payload = usable_rows(n) - 8
    rows = synthetic_rw_workload(payload)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _mark(msg):
        log(f"[state_bench k={k}] {msg}")

    _mark(f"witness rows built: {len(rows)}")
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=tau, device=dev)
    _sync()
    srs_s = time.perf_counter() - t0
    _mark(f"srs: {srs_s:.2f}s")

    circuit = StateCircuit(rows, StateParams())
    keygen_phases: dict = {}
    t0 = time.perf_counter()
    pk, vk = keygen(circuit, k, srs, device=dev, timings=keygen_phases)
    keygen_s = time.perf_counter() - t0
    _mark(f"keygen: {keygen_s:.2f}s")

    prove_phases: dict = {}
    t0 = time.perf_counter()
    proof = prove(pk, circuit, [], srs, rng=np.random.default_rng(7),
                  device=dev, timings=prove_phases, mesh=mesh)
    prove_s = time.perf_counter() - t0
    _mark(f"prove: {prove_s:.2f}s")

    t0 = time.perf_counter()
    ok = verify(vk, [], proof)
    verify_s = time.perf_counter() - t0
    _mark(f"verify: {verify_s:.2f}s ok={ok}")
    return {
        "k": k, "rows": payload, "srs_s": srs_s, "keygen_s": keygen_s,
        "prove_s": prove_s, "verify_s": verify_s, "ok": bool(ok),
        "proof_bytes": len(proof), "proof": proof,
        "keygen_phases": keygen_phases, "prove_phases": prove_phases,
    }
