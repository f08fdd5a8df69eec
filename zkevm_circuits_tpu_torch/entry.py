"""Entry points of the port (the counterpart of the repository's
__graft_entry__.py): a single-device step and a multi-rank dry run.

`entry()` returns one step of the prover's polynomial engine (NTT ->
pointwise product -> iNTT at K = 10, one quotient-style pass) with its
seeded inputs on the device.  `dryrun_multichip(n)` runs the sharded NTT,
the sharded MSM, both sharded prefix scans and a full sharded prove ->
verify round trip over n ranks, and holds each against its single-device
result.

    python -c "from zkevm_circuits_tpu_torch.entry import entry; ..."
    python -c "from zkevm_circuits_tpu_torch.entry import dryrun_multichip; \\
               print(dryrun_multichip(2, device='cpu'))"
"""

from __future__ import annotations

import datetime
import hashlib
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .crypto.field import fr
from .device import resolve
from .plonk.circuit import Cell, Circuit, ConstraintSystem
from .plonk.demo import _mont
from .plonk.expression import Advice, Fixed

K = 10
DRYRUN_TIMEOUT_S = 3600  # the CPU's gloo ranks take minutes a proof


def _seeded_rows(rng, n: int) -> np.ndarray:
    """n field rows of seeded bytes with the top byte cleared (< 2^248)."""
    x = np.frombuffer(rng.bytes(n * 32), np.uint8).reshape(n, 32).copy()
    x[..., 31] = 0
    return x


def entry(device=None):
    """(step, (x, y)): step(a, b) = iNTT(NTT(a) * NTT(b)) over 2^K rows,
    the transforms kernel K4's ladder and the product kernel K1 on CUDA
    tensors; x, y are seed-7 inputs on `device` (None: the card)."""
    from .poly.ntt import _ntt_impl

    F = fr()
    dev = resolve(device)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(_seeded_rows(rng, 1 << K), device=dev)
    y = torch.as_tensor(_seeded_rows(rng, 1 << K), device=dev)

    def step(a, b):
        ea = _ntt_impl(a, K, False)
        eb = _ntt_impl(b, K, False)
        return _ntt_impl(F.mul(ea, eb), K, True)

    return step, (x, y)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run `_dryrun_rank` on n_devices ranks: NCCL with one card a rank
    when `device` is None or CUDA, gloo when it is "cpu".  The calling
    process is rank 0 (so its launch counts are this process's) and
    ranks 1.. are spawned.  Raises if a rank fails, if a sharded result
    differs from its single-device one, if n_devices exceeds the visible
    cards, or when the run outlasts DRYRUN_TIMEOUT_S; no process group
    stays initialised.  Returns rank 0's summary."""
    dev = resolve(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"cards; {torch.cuda.device_count()} are visible")
    if dist.is_initialized():
        raise RuntimeError("dryrun_multichip needs no process group initialised")
    store = tempfile.mkdtemp(prefix="dryrun_")
    init = f"file://{store}/store"
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    ctx = None
    try:
        if n_devices > 1:
            ctx = mp.start_processes(
                _spawned_rank, args=(n_devices, dev.type, init),
                nprocs=n_devices - 1, join=False, start_method="spawn")
        summary = _dryrun_rank(0, n_devices, dev.type, init)
        while ctx is not None and time.monotonic() < deadline and \
                not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            pass  # join returns as each rank exits; a failed rank raises
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"dryrun_multichip({n_devices}) took more than {DRYRUN_TIMEOUT_S} s")
        return summary
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        shutil.rmtree(store, ignore_errors=True)


def _spawned_rank(i, world, dev_type, init):
    if dev_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    _dryrun_rank(i + 1, world, dev_type, init)


def _dryrun_rank(rank: int, world: int, dev_type: str, init: str) -> dict:
    """One rank of the dry run; rank 0 checks every sharded result against
    the single-device one and returns the summary."""
    from .crypto.curve import G1, g1_generator, g1_to_affine_ints
    from .parallel.sharding import (
        make_sharded_prefix_product, make_sharded_prefix_sum)
    from .poly.msm import make_sharded_msm, msm
    from .poly.ntt import _ntt_impl, make_sharded_ntt

    F = fr()
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DRYRUN_TIMEOUT_S))
    try:
        group = dist.group.WORLD
        t0 = time.perf_counter()
        # k chosen so each rank's shard L = n/D >= D (the four-step layout)
        k = max(8, 2 * (world - 1).bit_length() + 1)
        n = 1 << k
        poly = torch.as_tensor(_seeded_rows(np.random.default_rng(3), n),
                               device=dev)
        evals = make_sharded_ntt(group, k)(poly)

        # sharded MSM: commit the evals against a toy SRS of generators
        m = world * 4
        gen = g1_generator((m,), dev)
        scalars = evals[:m].contiguous()
        out = make_sharded_msm(group)(gen, scalars)

        ones = F.ones_mont((n,), dev)
        pp = make_sharded_prefix_product(group)(ones)
        ps = make_sharded_prefix_sum(group)(ones)

        proof, proof_ok = _sharded_prove_roundtrip(world, group, dev)
        dist.barrier(group)
        if rank:
            return {}

        fails = []
        if not torch.equal(evals, _ntt_impl(poly, k, False)):
            fails.append("sharded NTT")
        one = lambda p: G1(*(c[None] for c in p))  # noqa: E731
        if g1_to_affine_ints(one(out)) != g1_to_affine_ints(one(msm(gen, scalars))):
            fails.append("sharded MSM")
        if not torch.equal(pp, ones):
            fails.append("sharded prefix product")
        if F.to_ints(F.from_mont(ps)) != list(range(n)):
            fails.append("sharded prefix sum")
        single, _ = _sharded_prove_roundtrip(world, None, dev)
        if not proof_ok:
            fails.append("the sharded proof failed verification")
        if proof != single:
            fails.append("the sharded proof differs from the single-device one")
        if fails:
            raise RuntimeError(f"dryrun_multichip({world}): " + ", ".join(fails))
        return {"ranks": world, "device": str(dev), "ntt_k": k, "msm_points": m,
                "prove_k": _mini_k(world), "proof_bytes": len(proof),
                "proof_sha256": hashlib.sha256(proof).hexdigest(),
                "seconds": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()


def _mini_k(world: int) -> int:
    return max(6, 2 * ((world - 1).bit_length()))  # four-step: n/D >= D


def _sharded_prove_roundtrip(world: int, group, dev) -> tuple[bytes, bool]:
    """MiniCircuit proved with prove(mesh=group) (group None: on one
    device) and verified: (proof, verdict)."""
    from .plonk.keygen import keygen
    from .plonk.prover import prove
    from .plonk.verifier import verify
    from .poly.kzg import Srs

    k = _mini_k(world)
    srs = Srs.unsafe_setup(k, tau=0x5EED, device=dev)
    pk, vk = keygen(MiniCircuit(), k, srs, device=dev)
    proof = prove(pk, MiniCircuit(), [[1]], srs, rng=np.random.default_rng(42),
                  device=dev, mesh=group)
    return proof, verify(vk, [[1]], proof)


N_ROWS = 16


class MiniCircuit(Circuit):
    """Exercises every sharded prover op: a gate, a copy constraint
    (permutation grand product), a classic lookup (prefix product), a
    logUp lookup (prefix sum + batch-inverse helpers)."""

    def configure(self, cs: ConstraintSystem):
        self.q = cs.fixed_column()
        self.tbl = cs.fixed_column()
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.c = cs.advice_column()
        self.inst = cs.instance_column()
        cs.create_gate(
            "add",
            Fixed(self.q) * (Advice(self.a) + Advice(self.b) - Advice(self.c)),
        )
        cs.lookup("rng16", [(Advice(self.b), Fixed(self.tbl))])
        cs.lookup_logup("rng16_logup", [[Advice(self.a)]], [Fixed(self.tbl)])
        cs.enable_equality("advice", self.a)
        cs.enable_equality("instance", self.inst)

    def _witness(self, n):
        a = [(i % 8) + 1 if i < N_ROWS else 0 for i in range(n)]
        b = [(3 * i) % 16 if i < N_ROWS else 0 for i in range(n)]
        c = [x + y for x, y in zip(a, b)]
        return a, b, c

    def fixed_columns(self, n):
        q = [1 if i < N_ROWS else 0 for i in range(n)]
        tbl = [i if i < 16 else 0 for i in range(n)]
        return np.stack([_mont(q), _mont(tbl)])

    def copy_constraints(self, n):
        return [(Cell("instance", self.inst, 0), Cell("advice", self.a, 0))]

    def synthesize(self, phase, n, challenges, instances):
        a, b, c = self._witness(n)
        return {self.a: _mont(a), self.b: _mont(b), self.c: _mont(c)}

