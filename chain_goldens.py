#!/usr/bin/env python3
"""Make or check one of the Poseidon chain's, the SuperCircuit's or the
recursion layer's goldens (plonk/demo.py) on the CPU, or count the shapes
of their circuits.

    JAX_PLATFORMS=cpu python chain_goldens.py jax NAME   # the reference's proof
    python chain_goldens.py port NAME                    # the port's proof
    python chain_goldens.py shapes                       # the port's circuits

NAME is demo_poseidon (the k=5 DemoCircuit under the Poseidon transcript),
poseidon, mpt, pi, super (the k=9 SuperCircuit over
tests/test_super_circuit.py::_witness()), testool (the k=9 SuperCircuit
that testool.run_state_test proves at its prove level for the sstoreGas
filler of tests/test_testool.py), compression (the k=10
CompressionCircuit over a k=5 DemoCircuit proof made under the Poseidon
transcript) or batch_hash (the k=10 BatchHashCircuit over three chunks).  `jax` proves the golden's
witness with the JAX package, the reference, and prints the lines PERF.md
quotes as the golden's origin: keygen seconds, prove seconds, "RESULT k
sha256 bytes", and the verifier's verdict with the total seconds.  Run it
from the repository root (its DemoCircuit is tests/test_plonk_prove.py's);
the JAX package's native library (`make -C native`) makes it faster.
`port` proves the same witness with the port on the CPU and prints the
same lines and whether the proof equals the golden.  Each takes minutes
(PI the longest of the chain; super, 605 advice columns, the better part
of an hour from the JAX package and hours from the port).  `shapes`
prints each circuit's advice columns and phases, fixed columns, gate
polynomials, logUp inputs and quotient degree: the goldens', those of
service/bench_circuits.mpt_workload at k=9, and those of
service/bench_circuits.super_workload at k=9 and 13 (chip_smoke.py's
super_k13 witness), with its regions' fill.
"""

import hashlib
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402

NAMES = ("demo_poseidon", "poseidon", "mpt", "pi", "super", "testool",
         "compression", "batch_hash")


def _jax():
    """The JAX package on the CPU, with its tests' DemoCircuit; a thread
    clears its compile caches before the process runs out of memory maps
    (each XLA:CPU executable holds three)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))

    def clear():
        while True:
            time.sleep(5)
            with open("/proc/self/maps") as f:
                if sum(1 for _ in f) > 40_000:
                    jax.clear_caches()

    threading.Thread(target=clear, daemon=True).start()
    from test_plonk_prove import DemoCircuit

    from zkevm_circuits_tpu import tracer, types
    from zkevm_circuits_tpu.circuits import mpt, pi, poseidon, super_circuit
    from zkevm_circuits_tpu.crypto import keccak
    from zkevm_circuits_tpu.plonk.keygen import keygen
    from zkevm_circuits_tpu.plonk.prover import prove
    from zkevm_circuits_tpu.plonk.verifier import verify
    from zkevm_circuits_tpu.poly import transcript
    from zkevm_circuits_tpu.poly.kzg import Srs
    from zkevm_circuits_tpu.recursion import aggregation, batch_hash, compression
    from zkevm_circuits_tpu.types import transaction
    from zkevm_circuits_tpu.witness import builder
    from zkevm_circuits_tpu.witness import mpt as mpt_witness

    modules = dict(poseidon=poseidon, mpt=mpt, pi=pi, keccak=keccak,
                   mpt_witness=mpt_witness, types=types,
                   transaction=transaction, tracer=tracer, builder=builder,
                   super_circuit=super_circuit, aggregation=aggregation,
                   batch_hash=batch_hash, compression=compression)
    return (DemoCircuit, modules, Srs.unsafe_setup, keygen, prove, verify,
            transcript, {})


def _port():
    import torch

    torch.set_num_threads(2)
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.keygen import keygen
    from zkevm_circuits_tpu_torch.plonk.prover import prove
    from zkevm_circuits_tpu_torch.plonk.verifier import verify
    from zkevm_circuits_tpu_torch.poly import transcript
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    return (demo.DemoCircuit, {**demo.chain_modules(), **demo.super_modules(),
                               **demo.recursion_modules()},
            Srs.unsafe_setup, keygen,
            prove, verify, transcript, {"device": "cpu"})


def prove_testool(side: str) -> bool:
    """The testool golden through each package's own run_state_test at the
    prove level; its keygen and prove are wrapped to time them and keep the
    proof bytes."""
    import json

    from zkevm_circuits_tpu_torch.plonk import demo

    if side == "jax":
        _jax()
        import zkevm_circuits_tpu.plonk.keygen as kg
        import zkevm_circuits_tpu.plonk.prover as pv
        from zkevm_circuits_tpu import testool
        cfg = testool.CircuitsConfig(level="prove", k=demo.TESTOOL_GOLDEN_K,
                                     srs_tau=demo.TESTOOL_GOLDEN_TAU)
    else:
        import torch

        torch.set_num_threads(2)
        import zkevm_circuits_tpu_torch.plonk.keygen as kg
        import zkevm_circuits_tpu_torch.plonk.prover as pv
        from zkevm_circuits_tpu_torch import testool
        cfg = testool.CircuitsConfig(level="prove", k=demo.TESTOOL_GOLDEN_K,
                                     srs_tau=demo.TESTOOL_GOLDEN_TAU,
                                     device="cpu")
    proofs = []
    keygen0, prove0 = kg.keygen, pv.prove

    def keygen(*a, **kw):
        t = time.time()
        out = keygen0(*a, **kw)
        print("testool keygen", time.time() - t, flush=True)
        return out

    def prove(*a, **kw):
        t = time.time()
        proofs.append(bytes(prove0(*a, **kw)))
        print("testool prove", time.time() - t, flush=True)
        return proofs[-1]

    kg.keygen, pv.prove = keygen, prove
    t0 = time.time()
    st, = testool.load_json_fillers(json.dumps(demo.TESTOOL_GOLDEN_FILLER))
    r = testool.run_state_test(st, cfg)
    proof, = proofs
    digest = hashlib.sha256(proof).hexdigest()
    print("testool RESULT", cfg.k, digest, len(proof), flush=True)
    print("testool verify", r.ok and not r.skipped, repr(r.reason),
          time.time() - t0, flush=True)
    if side == "port":
        print("testool golden", digest == demo.TESTOOL_GOLDEN_SHA256, flush=True)
    return r.ok and not r.skipped and (
        side == "jax" or digest == demo.TESTOOL_GOLDEN_SHA256)


def prove_golden(side: str, name: str) -> bool:
    from zkevm_circuits_tpu_torch.plonk import demo

    if name == "testool":
        return prove_testool(side)
    (Demo, modules, setup, keygen, prove, verify, tr, dev) = \
        _jax() if side == "jax" else _port()
    t0 = time.time()
    kw, reader = {}, None
    if name == "demo_poseidon":
        k, tau, seed = demo.K, demo.GOLDEN_TAU, demo.POSEIDON_TRANSCRIPT_GOLDEN_SEED
        sha = demo.POSEIDON_TRANSCRIPT_GOLDEN_SHA256
        make, inst = Demo, [[demo.A_IN]]
        kw, reader = {"transcript": tr.PoseidonTranscript()}, tr.PoseidonReader
    elif name == "super":
        k, sha = demo.SUPER_GOLDEN_K, demo.SUPER_GOLDEN_SHA256
        tau, seed = demo.PARTNER_GOLDEN_TAU, demo.PARTNER_GOLDEN_SEED
        make, inst = lambda: demo.super_golden(modules), []  # noqa: E731
    elif name in demo.RECURSION_GOLDENS:
        k, sha, _ = demo.RECURSION_GOLDENS[name]
        inner = None
        if name == "compression":
            tau, seed = demo.COMPRESSION_TAU, demo.COMPRESSION_SEED
            srs_i = setup(demo.K, tau=demo.GOLDEN_TAU, **dev)
            pk_i, vk_i = keygen(Demo(), demo.K, srs_i, **dev)
            inner = (vk_i, prove(
                pk_i, Demo(), [[demo.A_IN]], srs_i, transcript=tr.PoseidonTranscript(),
                rng=np.random.default_rng(demo.COMPRESSION_INNER_SEED), **dev))
            print(name, "inner proof", time.time() - t0, flush=True)
        else:
            tau, seed = demo.PARTNER_GOLDEN_TAU, demo.PARTNER_GOLDEN_SEED
        circuit, inst = demo.recursion_golden(name, modules, inner)
        make = lambda: circuit  # noqa: E731
    else:
        k, sha, _ = demo.CHAIN_GOLDENS[name]
        tau, seed = demo.PARTNER_GOLDEN_TAU, demo.PARTNER_GOLDEN_SEED
        make = lambda: demo.chain_golden(name, modules)[0]  # noqa: E731
        inst = demo.chain_golden(name, modules)[1]
    srs = setup(k, tau=tau, **dev)
    t1 = time.time()
    pk, vk = keygen(make(), k, srs, **dev)
    print(name, "keygen", time.time() - t1, flush=True)
    t2 = time.time()
    proof = prove(pk, make(), inst, srs, rng=np.random.default_rng(seed),
                  **kw, **dev)
    print(name, "prove", time.time() - t2, flush=True)
    digest = hashlib.sha256(bytes(proof)).hexdigest()
    print(name, "RESULT", k, digest, len(proof), flush=True)
    ok = verify(vk, inst, proof,
                **({"transcript": reader(proof)} if reader else {}))
    print(name, "verify", ok, time.time() - t0, flush=True)
    if side == "port":
        print(name, "golden", digest == sha, flush=True)
    return bool(ok) and (side == "jax" or digest == sha)


def shapes():
    from zkevm_circuits_tpu_torch.circuits.poseidon import PoseidonCircuit
    from zkevm_circuits_tpu_torch.circuits.super_circuit import SuperCircuit
    from zkevm_circuits_tpu_torch.plonk import demo
    from zkevm_circuits_tpu_torch.plonk.circuit import ConstraintSystem
    from zkevm_circuits_tpu_torch.plonk.keygen import quotient_degree
    from zkevm_circuits_tpu_torch.service.bench_circuits import (
        mpt_workload, super_workload)

    seed = 20261016  # chip_smoke.SEED
    stor, acct, _ = mpt_workload(seed, 9)
    circuits = [("poseidon", PoseidonCircuit([])),
                ("mpt", demo.chain_golden("mpt")[0]),
                ("pi", demo.chain_golden("pi")[0]),
                ("mpt_workload storage", stor),
                ("mpt_workload account", acct),
                ("super", demo.super_golden())]
    for k in (9, 13):
        b, codes, txs, params, stats = super_workload(seed, k)
        print(f"super_workload k={k}: {stats}")
        circuits.append((f"super_workload k={k}",
                         SuperCircuit(b, codes, txs, params)))
    for name, c in circuits:
        cs = ConstraintSystem()
        c.configure(cs)
        print(f"{name}: advice {cs.num_advice} (phases "
              f"{max(cs.advice_phases) + 1}), fixed {cs.num_fixed}, gate "
              f"polynomials {sum(len(g.polys) for g in cs.gates)}, logUps "
              f"{len(cs.logups)} of {sum(len(lg.inputs) for lg in cs.logups)} "
              f"inputs, quotient degree {quotient_degree(cs)}")
    return True


if __name__ == "__main__":
    if sys.argv[1:] == ["shapes"]:
        ok = shapes()
    elif len(sys.argv) == 3 and sys.argv[1] in ("jax", "port") \
            and sys.argv[2] in NAMES:
        ok = prove_golden(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
    sys.exit(0 if ok else 1)
