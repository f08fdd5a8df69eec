"""Circuit-shape statistics + phase timers (port of
zkevm_circuits_tpu/utils/stats.py).

Equivalents of the reference's `circuit_stats(meta)` profiling
(zkevm-circuits/src/util.rs:294-328) and the ark-std `start_timer!`
instrumentation around every expensive phase (SURVEY.md §5 "Tracing/
profiling").
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("zkevm_tpu")


def circuit_stats(cs) -> dict:
    """Counts mirroring the reference's circuit_stats log line."""
    num_gates = sum(len(g.polys) for g in cs.gates)
    degree = cs.max_gate_degree()
    num_lookup_inputs = sum(len(lg.inputs) for lg in cs.logups) + len(cs.lookups)
    return {
        "num_fixed_columns": cs.num_fixed,
        "num_advice_columns": cs.num_advice,
        "num_instance_columns": cs.num_instance,
        "num_gates": num_gates,
        "num_lookup_arguments": len(cs.lookups) + len(cs.logups),
        "num_lookup_inputs": num_lookup_inputs,
        "num_permutation_columns": len(cs.perm_columns),
        "num_challenges": len(cs.challenge_phases),
        "num_phases": cs.num_phases,
        "degree": degree,
    }


@contextlib.contextmanager
def timer(name: str):
    """start_timer!/end_timer! equivalent; logs at INFO."""
    t0 = time.perf_counter()
    log.info("start: %s", name)
    try:
        yield
    finally:
        log.info("end: %s (%.3fs)", name, time.perf_counter() - t0)
