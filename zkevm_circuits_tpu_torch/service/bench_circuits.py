"""Per-circuit prove benchmark at reference degrees (port of
zkevm_circuits_tpu/service/bench_circuits.py).

`state_prove_bench(k)` builds a synthetic but constraint-complete RW
workload that fills the usable rows of 2^k (memory write/read pairs over
several call frames, so every lexicographic-ordering, range-decomposition
and tag-rule path of the State circuit runs), then the real pipeline: SRS,
keygen, prove (full SHPLONK proof), verify, with per-phase wall-clock.

`evm_prove_bench(k, seed)` does the same for the EVM circuit over a
seeded workload of looping contracts (`evm_workload`), traced by the
port's Interpreter and replayed by its CircuitInputBuilder.

`partner_prove_bench(name, k, seed)` does the same for the EVM's table
partners at their default (full-width) parameters: the Exp circuit over
the ExpEvents of a seeded EXP program (`exp_workload`), the Copy circuit
over the copy events of one transaction's CALLDATACOPY, CODECOPY and LOG
data (`copy_workload`), and the Bytecode circuit over seeded bytecodes
(`bytecode_workload`), each filling at least PARTNER_FILL of the usable
rows of 2^k.

`precompile_prove_bench(name, k, seed)` does the same for the precompile
circuits at their default parameters (`precompile_circuit`): the Sig
circuit over one seeded ECDSA (`sig_workload`), the ECC circuit over one
seeded EcMul and seeded EcAdds (`ecc_workload`), the ModExp circuit over
seeded 256-bit events (`modexp_workload`) and the SHA-256 circuit over
seeded messages (`sha256_workload`), each but Sig filling at least
PRECOMPILE_FILL of the usable rows of 2^k.

`mpt_prove_bench(which, k, workload)` proves one of the two MPT circuits
of a seeded two-level state transition (`mpt_workload`: the
storage-subtrie circuit, filling at least MPT_FILL of the usable rows of
2^k, or the account-trie circuit), and `poseidon_prove_bench(k, events)` the Poseidon
circuit over every block of 2^k, both under the Poseidon transcript, the
production prover's transcript for inner proofs.

`super_prove_bench(k, seed)` proves a chunk through the production
prover, service/prover.py's ChunkProver: the SuperCircuit over seeded
signed transactions of looping contracts that also run CALLDATACOPY,
EXP, MULMOD/ADDMOD and SHA3 (`super_workload`), the fullest of its
regions (`super_rows`) filling at least SUPER_FILL of its rows.

`super_full_prove_bench(k, seed)` proves the chunk's whole statement:
the SuperCircuit with the PI circuit and its instance, the two-level MPT
whose roots PI's state-root bytes are bound to, and every transaction's
signature verified in-circuit, over `super_full_workload` (its regions
counted by `super_full_rows`), under the Poseidon transcript.
"""

from __future__ import annotations

import copy
import os
import tempfile
import time

import numpy as np
import torch

from ..circuits.bytecode import BytecodeCircuit
from ..circuits.copy import CopyCircuit
from ..circuits.ecc import EV_ROWS as ECC_EV_ROWS
from ..circuits.ecc import EcAddEvent, EccCircuit, EcMulEvent
from ..circuits.evm import EvmCircuit, EvmParams
from ..circuits.exp import ExpCircuit, ExpParams
from ..circuits.keccak import ROWS_PER_PERM, Z_PER_ROW
from ..circuits.modexp import ModExpCircuit, ModExpEvent, modexp_steps
from ..circuits.mpt import MptCircuit
from ..circuits.pi import N_PADDED, N_PI_BYTES, PublicData
from ..circuits.poseidon import PoseidonCircuit
from ..circuits.rlp import RlpCircuit
from ..circuits.sha256 import ROWS_PER_BLOCK, Sha256Circuit
from ..circuits.sig import EV_ROWS as SIG_EV_ROWS
from ..circuits.sig import SigCircuit, SigEvent
from ..circuits.state import StateCircuit, StateParams
from ..circuits.super_circuit import SuperCircuit, SuperParams
from ..circuits.tx import FIXED_TAGS, TxParams
from ..crypto import secp256k1
from ..crypto.curve import host_g1_add, host_g1_mul
from ..crypto.keccak import keccak256
from ..crypto.params import FQ_MODULUS, FR_MODULUS, G1_GEN
from ..device import resolve
from ..plonk.circuit import ConstraintSystem, usable_rows
from ..plonk.keygen import keygen, quotient_degree
from ..plonk.prover import prove
from ..plonk.verifier import verify
from ..poly.kzg import Srs
from ..poly.transcript import PoseidonReader, PoseidonTranscript
from ..tracer import Account, Interpreter, StateDB, Tx
from ..types import Bytecode
from ..types.evm import OpcodeId
from ..types.transaction import Transaction
from ..utils.stats import circuit_stats
from ..witness.builder import AccountState, CircuitInputBuilder
from ..witness.mpt import AccountFields, two_level_updates_from_rws
from ..witness.rw import AccountField, Rw, RwTag
from .prover import ChunkProver


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


# ---------------------------------------------------------------------------
# EVM workload: looping contracts over the opcodes the standalone EVM
# circuit proves (no opcode that needs another circuit's table)
EVM_SENDER = 0xCAFE
EVM_CONTRACT_BASE = 0xC0DE0000
# (name, pops, pushes) of value-typed operations: no operand is ever a
# memory offset or a jump target
EVM_VALUE_OPS = [
    ("ADD", 2, 1), ("SUB", 2, 1), ("MUL", 2, 1), ("DIV", 2, 1),
    ("MOD", 2, 1), ("LT", 2, 1), ("GT", 2, 1), ("SLT", 2, 1),
    ("SGT", 2, 1), ("EQ", 2, 1), ("ISZERO", 1, 1), ("AND", 2, 1),
    ("OR", 2, 1), ("XOR", 2, 1), ("NOT", 1, 1), ("BYTE", 2, 1),
    ("SHL", 2, 1), ("SHR", 2, 1), ("SAR", 2, 1), ("SIGNEXTEND", 2, 1),
    ("POP", 1, 0), ("CALLER", 0, 1), ("ADDRESS", 0, 1),
    ("CALLVALUE", 0, 1), ("CALLDATASIZE", 0, 1), ("PC", 0, 1),
    ("GAS", 0, 1), ("MSIZE", 0, 1),
]
EVM_MAX_DEPTH = 12  # stack items the loop body keeps above its counter
EVM_FILL = 0.9  # the least share of the usable rows the RW rows fill


def evm_witness(code: bytes, sender: int, contract: int, calldata: bytes = b"",
                gas: int = 1_000_000) -> CircuitInputBuilder:
    """One transaction from `sender` calling `contract` (which holds
    `code`) with `calldata` and no value, traced and replayed."""
    state = StateDB({sender: Account(balance=10**18), contract: Account(code=code)})
    trace = Interpreter(state).run_tx(Tx(from_addr=sender, to=contract, gas=gas,
                                         data=calldata))
    if trace.failed:
        raise ValueError("the transaction failed in the tracer")
    b = CircuitInputBuilder()
    b.handle_tx(dict(from_addr=sender, to_addr=contract, value=0,
                     calldata=calldata), trace, code_db={contract: code})
    return b


def evm_loop_program(rng: np.random.Generator, iters: int,
                     n_snippets: int, partners: bool = False,
                     sha3: bool = False) -> Bytecode:
    """A contract that runs a seeded body of `n_snippets` snippets
    `iters` times: PUSH2 iters, JUMPDEST, body, counter - 1, DUP1,
    PUSH2 loop, JUMPI, POP, STOP.  The body leaves the stack as it found
    it and never touches the counter beneath it; memory offsets stay
    below 512 and storage keys below 8.

    `partners` adds snippets whose opcodes read another circuit's table:
    CALLDATACOPY (the Copy circuit), EXP with a one- or two-byte exponent
    (Exp), MULMOD and ADDMOD (MulMod).  `sha3` adds, after the loop, a
    SHA3 of up to 32 bytes of memory (Keccak).  With both False the rng
    draws, and so the program, are those of the standalone EVM
    workload."""
    bc = Bytecode().push(2, iters)
    loop = len(bc.code)
    bc.op("JUMPDEST")
    depth = 0  # items above the counter

    def push_word():
        nonlocal depth
        nb = int(rng.choice([1, 1, 2, 4, 8, 16, 32]))
        bc.push(nb, int.from_bytes(rng.bytes(nb), "big"))
        depth += 1

    def push_small(hi):
        nonlocal depth
        v = int(rng.integers(0, hi))
        bc.push(2 if v > 0xFF else 1, v)
        depth += 1

    def ensure(n):
        while depth < n:
            push_word()

    def value_op():
        nonlocal depth
        name, pops, pushes = EVM_VALUE_OPS[int(rng.integers(len(EVM_VALUE_OPS)))]
        ensure(pops)
        bc.op(name)
        depth += pushes - pops

    def dup_swap():
        nonlocal depth
        ensure(2)
        if rng.random() < 0.5:
            bc.op(f"DUP{int(rng.integers(1, min(depth, 16) + 1))}")
            depth += 1
        else:
            bc.op(f"SWAP{int(rng.integers(1, min(depth - 1, 16) + 1))}")

    def memory():
        nonlocal depth
        kind = ("MSTORE", "MSTORE8", "MLOAD")[int(rng.integers(3))]
        if kind != "MLOAD":
            ensure(1)
        push_small(480)
        bc.op(kind)
        depth -= 0 if kind == "MLOAD" else 2

    def storage():
        nonlocal depth
        if rng.random() < 0.5:
            push_small(8)
            bc.op("SLOAD")
        else:
            ensure(1)
            push_small(8)
            bc.op("SSTORE")
            depth -= 2

    def jump():
        if rng.random() < 0.5:  # taken: to the JUMPDEST right after
            bc.push(2, len(bc.code) + 4).op("JUMP").op("JUMPDEST")
        else:  # not taken
            bc.push(1, 0).push(2, int(rng.integers(1 << 16))).op("JUMPI")

    def calldatacopy():
        nonlocal depth
        push_small(33)  # length
        push_small(72)  # calldata offset, some past its end
        push_small(448)  # memory offset
        bc.op("CALLDATACOPY")
        depth -= 3

    def exp():
        nonlocal depth
        nb = int(rng.choice([1, 2]))
        bc.push(nb, int.from_bytes(rng.bytes(nb), "big"))  # exponent
        depth += 1
        push_word()  # base
        bc.op("EXP")
        depth -= 1

    def mulmod():
        nonlocal depth
        ensure(2)
        push_word()  # modulus
        bc.op(("MULMOD", "ADDMOD")[int(rng.integers(2))])
        depth -= 2

    kinds = [value_op] * 10 + [dup_swap] * 3 + [memory] * 3 + [storage] * 2 + [jump]
    if partners:
        kinds += [calldatacopy, exp, mulmod]
    for _ in range(n_snippets):
        kinds[int(rng.integers(len(kinds)))]()
        while depth > EVM_MAX_DEPTH:
            bc.op("POP")
            depth -= 1
    for _ in range(depth):
        bc.op("POP")
    bc.push(1, 1).op("SWAP1").op("SUB")  # counter - 1
    bc.op("DUP1").push(2, loop).op("JUMPI").op("POP")
    if sha3:
        bc.push(1, int(rng.integers(1, 33))).push(2, int(rng.integers(0, 448)))
        bc.op("SHA3").op("POP")
    return bc.op("STOP")


def evm_workload(seed: int, k: int):
    """Transactions, each calling a fresh looping contract
    (`evm_loop_program`), until the RW rows reach EVM_FILL of the usable
    rows of 2^k.  A transaction that would overflow the rows is drawn
    again with half the iterations and snippets, at most 8 times.
    Returns (builder, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    state = StateDB({EVM_SENDER: Account(balance=10**18)})
    b = CircuitInputBuilder(accounts={EVM_SENDER: AccountState(balance=10**18)})
    txs = 0
    while len(b.rws.rws) < EVM_FILL * cap:
        addr = EVM_CONTRACT_BASE + txs
        iters, snippets = int(rng.integers(4, 16)), int(rng.integers(8, 40))
        for _ in range(8):
            code = evm_loop_program(rng, iters, snippets).to_bytes()
            code_hash = int.from_bytes(keccak256(code), "big")
            calldata = rng.bytes(int(rng.integers(0, 64)))
            value = int(rng.integers(0, 1000))
            st, bb = copy.deepcopy(state), copy.deepcopy(b)
            st.accounts[addr] = Account(code=code)
            bb.accounts[addr] = AccountState(code_hash=code_hash)
            tr = Interpreter(st).run_tx(Tx(from_addr=EVM_SENDER, to=addr,
                                           gas=3_000_000, value=value,
                                           data=calldata))
            assert not tr.failed, "workload transaction failed"
            bb.handle_tx(dict(from_addr=EVM_SENDER, to_addr=addr, value=value,
                              calldata=calldata, code_hash=code_hash),
                         tr, code_db={addr: code})
            if len(bb.rws.rws) <= cap and len(bb.steps) <= cap:
                break
            iters, snippets = max(1, iters // 2), max(1, snippets // 2)
        else:
            break
        state, b = st, bb
        txs += 1
    stats = {"txs": txs, "steps": len(b.steps), "rw_rows": len(b.rws.rws),
             "usable_rows": cap, "rw_fill": len(b.rws.rws) / cap}
    return b, stats


def _prove_verify(make_circuit, k: int, dev, poseidon: bool = False,
                  instances: list | None = None) -> dict:
    """SRS, keygen, prove and verify of make_circuit() at degree `k` on
    `dev`, each timed (the device synchronised after the SRS); under the
    Poseidon transcript when `poseidon`, else Blake2b; `instances` (the
    circuit's instance columns, none by default) go to both prove and
    verify.

    Returns {"k", "k_ext", "srs_s", "keygen_s", "prove_s", "verify_s",
    "ok", "proof_bytes", "proof", "vk", "keygen_phases", "prove_phases",
    "cs"}."""
    instances = instances or []
    t0 = time.perf_counter()
    srs = Srs.unsafe_setup(k, tau=0xB_E2C4, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    srs_s = time.perf_counter() - t0
    keygen_phases: dict = {}
    t0 = time.perf_counter()
    pk, vk = keygen(make_circuit(), k, srs, device=dev, timings=keygen_phases)
    keygen_s = time.perf_counter() - t0
    prove_phases: dict = {}
    t0 = time.perf_counter()
    proof = prove(pk, make_circuit(), instances, srs, rng=np.random.default_rng(7),
                  device=dev, timings=prove_phases,
                  transcript=PoseidonTranscript() if poseidon else None)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = verify(vk, instances, proof,
                transcript=PoseidonReader(proof) if poseidon else None)
    verify_s = time.perf_counter() - t0
    return {
        "k": k, "k_ext": pk.k_ext, "srs_s": srs_s, "keygen_s": keygen_s,
        "prove_s": prove_s, "verify_s": verify_s, "ok": bool(ok),
        "proof_bytes": len(proof), "proof": proof, "vk": vk, "cs": pk.vk.cs,
        "keygen_phases": keygen_phases, "prove_phases": prove_phases,
    }


def evm_prove_bench(k: int = 14, seed: int = 7, device=None, log=print) -> dict:
    """Workload, SRS, keygen, prove, verify of the EVM circuit at degree
    `k`, full width (`EvmParams()`: step and RW targets = usable rows).

    Returns {"k", "workload", "srs_s", "keygen_s", "prove_s", "verify_s",
    "ok", "proof_bytes", "proof", "keygen_phases", "prove_phases", "cs"}."""
    t0 = time.perf_counter()
    b, stats = evm_workload(seed, k)
    stats["workload_s"] = time.perf_counter() - t0
    log(f"[evm_bench k={k}] workload {stats}")
    r = _prove_verify(lambda: EvmCircuit(b.steps, b.rws.rws, EvmParams()), k,
                      resolve(device))
    return {**r, "workload": stats}


# ---------------------------------------------------------------------------
# the EVM's table partners at full width
PARTNER_FILL = 0.9  # the least share of the usable rows a workload fills
PARTNER_GAS = 30_000_000


def _exp_rows(exponent: int) -> int:
    """The Exp circuit's rows for one EXP: its square-and-multiply steps."""
    return 0 if exponent < 2 else exponent.bit_length() + bin(exponent).count("1") - 2


def exp_workload(seed: int, k: int):
    """One contract running PUSH32 exponent, PUSH32 base, EXP, POP over
    seeded 256-bit bases and exponents (0 and 1 among both, and exponents
    of every width) until the ExpEvents' steps fill the usable rows of 2^k
    but for less than one EXP's steps.  Returns (builder, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    word = lambda: int.from_bytes(rng.bytes(32), "big")
    pairs, rows = [], 0
    for base, e in ((word(), 0), (word(), 1), (word(), 2), (0, word()),
                    (1, word()), (word(), (1 << 256) - 1)):
        if rows + _exp_rows(e) <= cap:
            pairs.append((base, e))
            rows += _exp_rows(e)
    while True:
        nb = int(rng.integers(1, 33))  # exponent width in bytes
        e = int.from_bytes(rng.bytes(nb), "big")
        if rows + _exp_rows(e) > cap:
            break
        pairs.append((word(), e))
        rows += _exp_rows(e)
    code = Bytecode()
    for base, e in pairs:
        code.push(32, e).push(32, base).op("EXP").op("POP")
    b = evm_witness(code.op("STOP").to_bytes(), EVM_SENDER, EVM_CONTRACT_BASE,
                    gas=PARTNER_GAS)
    for (base, e), ev in zip([p for p in pairs if p[1] >= 2], b.exp_events):
        assert (ev.base, ev.exponent) == (base, e)
    rows = sum(len(ev.steps) for ev in b.exp_events)
    return b, {"exps": len(pairs), "events": len(b.exp_events), "rows": rows,
               "usable_rows": cap, "fill": rows / cap}


COPY_CALLDATA = 4096  # calldata bytes of the copy workload's transaction


def copy_workload(seed: int, k: int):
    """One transaction with up to COPY_CALLDATA seeded calldata bytes (a
    sixteenth of the usable rows at most) whose contract runs CALLDATACOPY
    (some reads past the end of the calldata, so padded bytes appear),
    CODECOPY and LOG0-LOG2 data copies of seeded offsets and lengths until
    the copied bytes pass (PARTNER_FILL + 0.05) of the usable rows of 2^k,
    or the next copy would leave fewer than 64 usable rows for the copy
    rows or for the memory and TxLog RW rows (the circuit's standalone RW
    table).  That table is the builder's RW rows, the calldata's (tx_id,
    index, byte) rows the TxTable.  Returns (builder, tx_rows, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    data_len = min(COPY_CALLDATA, cap // 16)
    calldata = rng.bytes(data_len)
    code = Bytecode()
    copied = mem_rows = 0
    kinds = ["calldata"] * 6 + ["code"] * 3 + ["log"]
    while copied < (PARTNER_FILL + 0.05) * cap:
        kind = kinds[int(rng.integers(len(kinds)))]
        n = int(rng.integers(1, max(2, min(1024, cap // 32))))
        dst = int(rng.integers(0, 4096))
        if kind == "log":
            n = min(n, 256)
            extra = 2 * n + 3  # memory reads, TxLog data and topic rows
        else:
            extra = n
        if copied + n > cap - 64 or mem_rows + extra > cap - 64:
            break
        if kind == "calldata":
            src = int(rng.integers(0, data_len + data_len // 8))
            code.push(2, n).push(2, src).push(2, dst).op("CALLDATACOPY")
        elif kind == "code":
            src = int(rng.integers(0, 4096))
            code.push(2, n).push(2, src).push(2, dst).op("CODECOPY")
        else:
            topics = int(rng.integers(0, 3))
            for _ in range(topics):
                code.push(32, int.from_bytes(rng.bytes(32), "big"))
            code.push(2, n).push(2, dst).op(f"LOG{topics}")
        copied += n
        mem_rows += extra
    b = evm_witness(code.op("STOP").to_bytes(), EVM_SENDER, EVM_CONTRACT_BASE,
                    calldata=calldata, gas=PARTNER_GAS)
    tx_rows = [(1, i, byte) for i, byte in enumerate(calldata)]
    rows = sum(ev.length for ev in b.copy_events)
    kinds_ = sorted({(ev.src_type, ev.dst_type) for ev in b.copy_events})
    pads = sum(max(0, ev.src_addr + ev.length - max(ev.src_len, ev.src_addr))
               for ev in b.copy_events if ev.src_type == "calldata")
    return b, tx_rows, {
        "events": len(b.copy_events), "rows": rows, "usable_rows": cap,
        "fill": rows / cap, "calldata": data_len, "padded_bytes": pads,
        "kinds": [f"{s}->{d}" for s, d in kinds_],
        "memory_rw_rows": sum(1 for r in b.rws.rws
                              if r.tag in (RwTag.Memory, RwTag.TxLog))}


_PLAIN_OPS = [int(op) for op in OpcodeId
              if not (0x60 <= int(op) <= 0x7F)]


def bytecode_workload(seed: int, k: int):
    """Seeded bytecodes of PUSH1-PUSH32 with their immediates among plain
    opcodes, the first one empty, seeded lengths (some cut through a
    PUSH's immediate), until their rows (one a byte, one header a code)
    fill the usable rows of 2^k but for less than one code.  Returns
    (bytecodes, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    codes = [Bytecode()]
    rows = 1
    while rows < cap:
        length = min(int(rng.integers(1, 4097)), cap - rows - 1)
        if length <= 0:
            break
        bc = Bytecode()
        while len(bc) < length:
            if rng.random() < 0.3:
                nb = int(rng.integers(1, 33))
                bc.append(bytes([0x5F + nb]) + rng.bytes(nb))
            else:
                bc.append(bytes([_PLAIN_OPS[int(rng.integers(len(_PLAIN_OPS)))]]))
        codes.append(Bytecode(bc.to_bytes()[:length]))
        rows += 1 + length
    return codes, {"codes": len(codes), "bytes": sum(len(c) for c in codes),
                   "rows": rows, "usable_rows": cap, "fill": rows / cap}


def partner_circuit(name: str, k: int, seed: int):
    """(circuit, stats) of the `name` workload ("exp", "copy" or
    "bytecode") at degree `k`, the circuit at its default parameters; the
    stats carry the host seconds of the workload as "workload_s"."""
    t0 = time.perf_counter()
    if name == "exp":
        b, stats = exp_workload(seed, k)
        circuit = ExpCircuit(b.exp_events)
    elif name == "copy":
        b, tx_rows, stats = copy_workload(seed, k)
        circuit = CopyCircuit(b.copy_events, rw_rows=b.rws.rws, tx_rows=tx_rows)
    elif name == "bytecode":
        codes, stats = bytecode_workload(seed, k)
        circuit = BytecodeCircuit(codes)
    else:
        raise KeyError(name)
    stats["workload_s"] = time.perf_counter() - t0
    return circuit, stats


def partner_prove_bench(name: str, k: int = 16, seed: int = 7, device=None,
                        log=print) -> dict:
    """Workload, SRS, keygen, prove, verify of a table partner (see
    partner_circuit) at degree `k`.

    Returns {"k", "workload", "srs_s", "keygen_s", "prove_s", "verify_s",
    "ok", "proof_bytes", "proof", "keygen_phases", "prove_phases", "cs"}."""
    circuit, stats = partner_circuit(name, k, seed)
    log(f"[{name}_bench k={k}] workload {stats}")
    return {**_prove_verify(lambda: circuit, k, resolve(device)),
            "workload": stats}


# ---------------------------------------------------------------------------
# the precompile circuits at full width
PRECOMPILE_FILL = 0.9  # the least share of the usable rows a workload fills
SHA256_EDGE_LENGTHS = (0, 55, 56, 64)  # the padding's edges: 1, 1, 2, 2 blocks


def _sha256_blocks(n: int) -> int:
    return (n + 9 + 63) // 64


def sha256_workload(seed: int, k: int):
    """The edge lengths, then seeded messages of 0-300 bytes while their
    72-row blocks fit the usable rows of 2^k; the last ones shrink to fill
    the whole blocks that fit exactly.  Returns (messages, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    max_blocks = cap // ROWS_PER_BLOCK
    msgs = [rng.bytes(n) for n in SHA256_EDGE_LENGTHS]
    blocks = sum(_sha256_blocks(n) for n in SHA256_EDGE_LENGTHS)
    while blocks < max_blocks:
        n = int(rng.integers(0, 301))
        room = max_blocks - blocks
        if _sha256_blocks(n) > room:
            n = int(rng.integers(0, 64 * room - 8))
        msgs.append(rng.bytes(n))
        blocks += _sha256_blocks(n)
    rows = blocks * ROWS_PER_BLOCK
    return msgs, {"messages": len(msgs), "blocks": blocks, "rows": rows,
                  "usable_rows": cap, "fill": rows / cap}


def _mm_rows(events) -> int:
    return sum(len(ev.mulmod_events()) for ev in events)


def _fill_stats(rows: int, mulmod_rows: int, cap: int) -> dict:
    """The circuit's own rows and its embedded MulMod circuit's rows (its
    events and one padding row) share the usable rows; the fill is the
    share of whichever uses more.  The MulMod rows stop one short of the
    usable rows: the circuit's disabled rows look up the all-zero tuple,
    which only a disabled MulMod row holds (its padding row is enabled)."""
    return {"rows": rows, "mulmod_rows": mulmod_rows, "usable_rows": cap,
            "fill": max(rows, mulmod_rows) / cap}


def ecc_workload(seed: int, k: int):
    """One seeded EcMul (a seeded multiple of G, a seeded 256-bit scalar),
    then the EcAdd cases P = O, Q = O, P = -Q, P = Q and O + O, then EcAdds
    of seeded points until the next one's MulMod rows would not fit the
    usable rows of 2^k (see _fill_stats).  Returns (add_events, mul_events, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    scalar = lambda: int.from_bytes(rng.bytes(32), "big")  # noqa: E731
    point = lambda: host_g1_mul(G1_GEN, scalar() % (FR_MODULUS - 1) + 1)  # noqa: E731
    O = (0, 0)
    aff = lambda p: O if p is None else p  # noqa: E731
    P, e = point(), scalar()
    muls = [EcMulEvent(p=P, k=e, r=aff(host_g1_mul(P, e)))]
    mm = 1 + _mm_rows(muls)
    P, Q = point(), point()
    cases = [EcAddEvent(p=O, q=Q, r=Q), EcAddEvent(p=P, q=O, r=P),
             EcAddEvent(p=P, q=(P[0], -P[1] % FQ_MODULUS), r=O),
             EcAddEvent(p=P, q=P, r=aff(host_g1_add(P, P))),
             EcAddEvent(p=O, q=O, r=O)]
    adds = []
    while True:
        if cases:
            ev = cases.pop(0)
        else:
            P, Q = point(), point()
            ev = EcAddEvent(p=P, q=Q, r=aff(host_g1_add(P, Q)))
        rows = _mm_rows([ev])
        if mm + rows >= cap or len(adds) + 1 + ECC_EV_ROWS * len(muls) > cap:
            break
        adds.append(ev)
        mm += rows
    return adds, muls, {"adds": len(adds), "muls": len(muls),
                        **_fill_stats(len(adds) + ECC_EV_ROWS * len(muls),
                                      mm, cap)}


def modexp_workload(seed: int, k: int):
    """ModExp events of seeded 256-bit bases and moduli: exponent 0,
    exponent 1 and modulus 0 first, then seeded 256-bit exponents while
    their square-and-multiply steps fit, then shorter exponents that fill
    the usable rows of 2^k (see _fill_stats).  Each step is one row of the
    circuit and one of its MulMod circuit (which adds a padding row).
    Returns (events, stats)."""
    rng = np.random.default_rng(seed)
    cap = usable_rows(1 << k)
    word = lambda: int.from_bytes(rng.bytes(32), "big")  # noqa: E731
    events, rows = [], 0

    def add(base, e, n):
        nonlocal rows
        steps, result = modexp_steps(base, e, n)
        events.append(ModExpEvent(base=base, exponent=e, modulus=n,
                                  result=result))
        rows += len(steps)

    for base, e, n in ((word(), 0, word()), (word(), 1, word()),
                       (word(), word(), 0)):
        add(base, e, n)
    while rows + 2 < cap:
        # a b-bit exponent takes at most 2 (b - 1) steps (one for b = 1)
        bits = min(256, (cap - 2 - rows) // 2 + 1)
        e = (word() >> (256 - bits)) | (1 << (bits - 1))
        add(word(), e, word())
    return events, {"events": len(events), **_fill_stats(rows, rows + 1, cap)}


def sig_workload(seed: int, k: int):
    """One ECDSA signature of a seeded message hash by a seeded key: the
    rows one signature takes, not padded.  Returns (events, stats)."""
    rng = np.random.default_rng(seed)
    sk = int.from_bytes(rng.bytes(32), "big") % (secp256k1.N - 1) + 1
    z = rng.bytes(32)
    r, s, _ = secp256k1.sign(sk, z)
    events = [SigEvent(msg_hash=int.from_bytes(z, "big"), r=r, s=s,
                       pubkey=secp256k1.pubkey(sk))]
    cap = usable_rows(1 << k)
    return events, {"signatures": len(events),
                    **_fill_stats(SIG_EV_ROWS * len(events),
                                  1 + _mm_rows(events), cap)}


def precompile_circuit(name: str, k: int, seed: int):
    """(circuit, stats) of the `name` workload ("sig", "ecc", "modexp" or
    "sha256") at degree `k`, the circuit at its default parameters; the
    stats carry the host seconds of the workload as "workload_s"."""
    t0 = time.perf_counter()
    if name == "sig":
        events, stats = sig_workload(seed, k)
        circuit = SigCircuit(events)
    elif name == "ecc":
        adds, muls, stats = ecc_workload(seed, k)
        circuit = EccCircuit(add_events=adds, mul_events=muls)
    elif name == "modexp":
        events, stats = modexp_workload(seed, k)
        circuit = ModExpCircuit(events)
    elif name == "sha256":
        msgs, stats = sha256_workload(seed, k)
        circuit = Sha256Circuit(msgs)
    else:
        raise KeyError(name)
    stats["workload_s"] = time.perf_counter() - t0
    return circuit, stats


def precompile_prove_bench(name: str, k: int = 13, seed: int = 7, device=None,
                           log=print) -> dict:
    """Workload, SRS, keygen, prove, verify of a precompile circuit (see
    precompile_circuit) at degree `k`.

    Returns {"k", "workload", "srs_s", "keygen_s", "prove_s", "verify_s",
    "ok", "proof_bytes", "proof", "keygen_phases", "prove_phases", "cs"}."""
    circuit, stats = precompile_circuit(name, k, seed)
    log(f"[{name}_bench k={k}] workload {stats}")
    return {**_prove_verify(lambda: circuit, k, resolve(device)),
            "workload": stats}


# ---------------------------------------------------------------------------
# the Poseidon chain: MPT circuits of a two-level state transition, and
# the Poseidon circuit, at full width
MPT_FILL = 0.9  # the least share of the usable rows the storage circuit fills
MPT_ACCOUNTS = 4  # accounts writing storage; one more only receives value


def _mpt_usage(c: MptCircuit) -> tuple[int, int]:
    """(path rows, rows of its own Poseidon table) of a standalone MPT
    circuit: one row per path node, one table row per permutation."""
    rows = sum(u.depth + 1 for u in c.updates)
    return rows, len(c.poseidon_events())


def _mpt_rws(seed: int, n_slots: int):
    """Storage and Account RW rows of a seeded block: MPT_ACCOUNTS accounts
    writing n_slots slots between them (round-robin), about half of them
    committed before the block; a final word is 0 for one slot in ten
    (a delete of a committed slot, or a read of an empty one); each
    account bumps its nonce and pays into one fresh account.  Returns
    (rws, accounts_before)."""
    rng = np.random.default_rng(seed)
    word = lambda: int.from_bytes(rng.bytes(32), "big")  # noqa: E731
    addrs = [int.from_bytes(rng.bytes(20), "big") for _ in range(MPT_ACCOUNTS)]
    fresh = int.from_bytes(rng.bytes(20), "big")
    before = {a: AccountFields(nonce=int(rng.integers(0, 1 << 16)),
                               code_size=int(rng.integers(1, 24577)),
                               balance=word() >> 128, code_hash=word())
              for a in addrs}
    rws, ctr = [], 0

    def push(**kw):
        nonlocal ctr
        ctr += 1
        rws.append(Rw(rw_counter=ctr, is_write=True, id=1, **kw))

    for i in range(n_slots):
        committed = word() if rng.random() < 0.5 else 0
        final = 0 if rng.random() < 0.1 else word()
        push(tag=RwTag.Storage, address=addrs[i % MPT_ACCOUNTS],
             storage_key=word(), value=final, value_prev=committed)
    paid = 0
    for a in addrs:
        f, v = before[a], int(rng.integers(1, 1 << 40))
        push(tag=RwTag.Account, address=a, field_tag=int(AccountField.Nonce),
             value=f.nonce + 1, value_prev=f.nonce)
        push(tag=RwTag.Account, address=a,
             field_tag=int(AccountField.Balance), value=f.balance - v,
             value_prev=f.balance)
        push(tag=RwTag.Account, address=fresh,
             field_tag=int(AccountField.Balance), value=paid + v,
             value_prev=paid)
        paid += v
    return rws, before


def _mpt_circuits(seed: int, n_slots: int):
    storage, groups, accounts, _ = two_level_updates_from_rws(
        *_mpt_rws(seed, n_slots))
    stor = MptCircuit(storage=storage, two_level=True,
                      chain_groups=[g[1] for g in groups])
    return stor, MptCircuit(accounts=accounts)


def mpt_workload(seed: int, k: int):
    """The two MPT circuits of a seeded two-level state transition
    (`_mpt_rws` -> two_level_updates_from_rws), built as the SuperCircuit
    builds them: the storage-subtrie circuit (two_level=True, one root
    chain per account) and the account-trie circuit, each standalone with
    its own Poseidon table.  Slots are added until the storage circuit
    fills at least MPT_FILL of the usable rows of 2^k: its Poseidon table
    (about two rows per path row: each path hashes its old and new side)
    is the longer of its two regions, so it sets the fill.  Returns
    (storage_circuit, account_circuit, stats); the stats carry the host
    seconds as "workload_s"."""
    t0 = time.perf_counter()
    cap = usable_rows(1 << k)
    n_slots = max(8, cap // 28)  # a first guess below the fill: ~20 rows a slot
    while True:
        stor, acct = _mpt_circuits(seed, n_slots)
        used = max(_mpt_usage(stor))
        if used > cap:
            n_slots -= (used - cap) // 20 + 1
        elif used < MPT_FILL * cap:
            n_slots += int(MPT_FILL * cap - used) // 30 + 1
        else:
            break
    rows, table = _mpt_usage(stor)
    a_rows, a_table = _mpt_usage(acct)
    stats = {"slots": n_slots, "storage_updates": len(stor.updates),
             "accounts": len(acct.updates), "path_rows": rows,
             "poseidon_rows": table, "account_path_rows": a_rows,
             "account_poseidon_rows": a_table, "usable_rows": cap,
             "fill": max(rows, table) / cap,
             "max_depth": max(u.depth for u in stor.updates),
             "splits": sum(u.is_split for u in stor.updates),
             "absences": sum(u.new_empty for u in stor.updates),
             "workload_s": time.perf_counter() - t0}
    return stor, acct, stats


def mpt_prove_bench(which: str, k: int, workload, device=None) -> dict:
    """SRS, keygen, prove (Poseidon transcript) and verify (PoseidonReader)
    at degree `k` of the "storage" or "account" circuit of `workload` (an
    mpt_workload result, built once for both).

    Returns {"k", "workload", "srs_s", "keygen_s", "prove_s", "verify_s",
    "ok", "proof_bytes", "proof", "keygen_phases", "prove_phases", "cs"}."""
    stor, acct, stats = workload
    circuit = {"storage": stor, "account": acct}[which]
    return {**_prove_verify(lambda: circuit, k, resolve(device), poseidon=True),
            "workload": stats}


def poseidon_prove_bench(k: int, events, device=None) -> dict:
    """SRS, keygen, prove (Poseidon transcript) and verify (PoseidonReader)
    of the Poseidon circuit over the first events that fill every block
    of 2^k (all of them if fewer)."""
    c = PoseidonCircuit([])
    blocks = c.n_blocks(1 << k)
    c.events = list(events[:blocks])
    r = _prove_verify(lambda: c, k, resolve(device), poseidon=True)
    return {**r, "workload": {"events": len(c.events), "blocks": blocks,
                              "fill": len(c.events) / blocks}}


# ---------------------------------------------------------------------------
# the SuperCircuit's chunk: the production prover's workload
SUPER_FILL = 0.85  # the least share of its rows the fullest region fills
SUPER_CHAIN_ID = 1337
SUPER_CALLDATA = 55  # calldata bytes a transaction carries at most (the
#                      RLP circuit walks short-form strings only)
SUPER_GAS = 3_000_000


def super_params(txs) -> SuperParams:
    """The chunk's SuperParams: the EVM steps and the Exp rows uncapped
    (usable rows, exact step count), the Tx circuit sized to `txs`, the
    others at their defaults."""
    return SuperParams(
        evm=EvmParams(target_steps=0), exp=ExpParams(target_rows=0),
        tx=TxParams(max_txs=len(txs),
                    max_calldata=sum(len(tx.data) for tx in txs)))


def super_rows(b: CircuitInputBuilder, codes, txs, k: int,
               keccak_extra: list | None = None) -> dict:
    """{region: (rows used, rows it may use)} of the SuperCircuit over
    the witness (b, codes, txs) under super_params(txs) at degree `k`,
    each counted as that sub-circuit's own fit check counts it.  Keccak
    is on when the builder hashed anything with SHA3, or when
    `keccak_extra` (the messages other sub-circuits hash) is given; it
    then hashes every code, each transaction's sign payload and signed
    envelope, the SHA3 inputs and `keccak_extra`, 200 rows a
    permutation."""
    cap = usable_rows(1 << k)
    keccak = bool(b.sha3_inputs) or keccak_extra is not None
    pad = (lambda n: 136 - n % 136) if keccak else (lambda n: 0)
    rows = {
        "state": (len(b.rws.rws), cap - 8),
        "evm": (len(b.steps), cap),
        "bytecode": (sum(1 + len(c) + pad(len(c)) for c in codes), cap),
        "tx": (len(txs) * len(FIXED_TAGS) + sum(len(tx.data) for tx in txs), cap),
        "rlp": (len(RlpCircuit(txs).rows) if txs else 0, cap),
        "copy": (sum(ev.length for ev in b.copy_events), cap),
        "exp": (sum(len(ev.steps) for ev in b.exp_events), cap),
        "mulmod": (len(b.mulmod_events) + 1 if b.mulmod_events else 0, cap),
    }
    if keccak:
        msgs = [c.to_bytes() for c in codes]
        msgs += [tx.sign_payload() for tx in txs] + [tx.rlp_signed() for tx in txs]
        msgs += list(b.sha3_inputs) + list(keccak_extra or [])
        perms = sum(len(m) // 136 + 1 for m in msgs)
        rows["keccak"] = (perms * ROWS_PER_PERM, cap - 64 // Z_PER_ROW)
    return rows


def _call_fresh_contract(state, b, sender: int, addr: int, code, value: int,
                         calldata: bytes):
    """Copies of the StateDB `state` and the builder `b` after `sender`,
    holding 10**18 wei, calls a fresh contract at `addr` holding `code`
    with `value` and `calldata` (traced, then replayed with the code hash
    carried).  Returns (state, builder, code hash)."""
    raw = code.to_bytes()
    code_hash = int.from_bytes(keccak256(raw), "big")
    st, bb = copy.deepcopy(state), copy.deepcopy(b)
    st.accounts[sender] = Account(balance=10**18)
    st.accounts[addr] = Account(code=raw)
    bb.accounts[sender] = AccountState(balance=10**18)
    bb.accounts[addr] = AccountState(code_hash=code_hash)
    tr = Interpreter(st).run_tx(Tx(from_addr=sender, to=addr, gas=SUPER_GAS,
                                   value=value, data=calldata))
    assert not tr.failed, "workload transaction failed"
    bb.handle_tx(dict(from_addr=sender, to_addr=addr, value=value,
                      calldata=calldata, code_hash=code_hash),
                 tr, code_db={addr: raw})
    return st, bb, code_hash


def _super_stats(b: CircuitInputBuilder, txs, k: int, rows: dict) -> dict:
    """The workload's transactions, steps, RW rows, usable rows, each
    region's rows and fill, and the builder's event counts."""
    return {
        "txs": len(txs), "steps": len(b.steps), "rw_rows": len(b.rws.rws),
        "usable_rows": usable_rows(1 << k),
        "rows": {name: used for name, (used, _) in rows.items()},
        "fill": {name: used / room for name, (used, room) in rows.items()},
        "sha3": len(b.sha3_inputs), "copy_events": len(b.copy_events),
        "exp_events": len(b.exp_events), "mulmod_events": len(b.mulmod_events),
    }


def super_workload(seed: int, k: int):
    """Seeded signed transactions, each from its own seeded key with
    seeded calldata of up to SUPER_CALLDATA bytes and a seeded value,
    each calling a fresh looping contract (evm_loop_program with the
    CALLDATACOPY, EXP and MULMOD/ADDMOD snippets, and the SHA3 after the
    loop) with its code hash carried, until the fullest region of the
    SuperCircuit (super_rows) reaches SUPER_FILL of its rows.  A
    transaction that would overflow a region is drawn again without the
    SHA3, then with half the iterations and snippets, at most 8 times.

    Returns (builder, bytecodes, txs, params, stats); stats has the
    transactions, steps, RW rows, usable rows, and each region's rows and
    fill."""
    rng = np.random.default_rng(seed)
    state = StateDB({})
    b = CircuitInputBuilder(accounts={})
    codes: list = []
    txs: list = []

    def fullest(rows):
        return max(used / room for used, room in rows.values())

    while not txs or fullest(super_rows(b, codes, txs, k)) < SUPER_FILL:
        addr = EVM_CONTRACT_BASE + len(txs)
        sk = int.from_bytes(rng.bytes(32), "big") % (secp256k1.N - 1) + 1
        calldata = rng.bytes(int(rng.integers(0, SUPER_CALLDATA + 1)))
        value = int(rng.integers(0, 1000))
        tx = Transaction(nonce=0, gas=SUPER_GAS, to=addr, value=value,
                         data=calldata, chain_id=SUPER_CHAIN_ID).sign(sk)
        sender = tx.recover_sender()
        iters, snippets = int(rng.integers(8, 24)), int(rng.integers(16, 48))
        for _ in range(8):
            fits = False
            for sha3 in (True, False):
                code = evm_loop_program(rng, iters, snippets, partners=True,
                                        sha3=sha3)
                st, bb, _ = _call_fresh_contract(state, b, sender, addr, code,
                                                 value, calldata)
                rows = super_rows(bb, codes + [code], txs + [tx], k)
                if all(used <= room for used, room in rows.values()):
                    fits = True
                    break
            if fits:
                break
            iters, snippets = max(1, iters // 2), max(1, snippets // 2)
        else:
            break
        state, b = st, bb
        codes.append(code)
        txs.append(tx)
    stats = _super_stats(b, txs, k, super_rows(b, codes, txs, k))
    stats["fullest"] = max(stats["fill"], key=stats["fill"].get)
    return b, codes, txs, super_params(txs), stats


def super_prove_bench(k: int = 13, seed: int = 7, device=None, log=print) -> dict:
    """The chunk prover over super_workload(seed, k): ChunkProver's SRS,
    keys, gen_chunk_proof (Poseidon transcript) and verify_chunk_proof,
    each timed, then gen_chunk_proof again on the same witness, which
    must come from the prover's proof cache.  The prover's params_dir
    and output_dir are in a temporary directory.

    Returns {"k", "k_ext", "workload", "shapes" (circuit_stats and the
    quotient degree), "srs_s", "keygen_s", "prove_s", "verify_s", "ok",
    "proof_bytes", "proof", "vk", "instances" (the chunk proof's, for the
    recursion layers), "prove_phases", "cached" ({"s", "equal",
    "launches"}: the second call's seconds, whether its proof equals the
    first's, the kernel launches it made), "resident_gb", "peak_gb" (the
    device memory allocated before the SRS, and the peak; None on the
    CPU)}."""
    from ..ops import cuda_field

    dev = resolve(device)
    cuda = dev.type == "cuda"

    def now():
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = time.perf_counter()
    b, codes, txs, params, stats = super_workload(seed, k)
    stats["workload_s"] = time.perf_counter() - t0
    log(f"[super_bench k={k}] workload {stats}")
    cs = ConstraintSystem()
    SuperCircuit(b, codes, txs, params).configure(cs)
    shapes = {**circuit_stats(cs), "quotient_degree": quotient_degree(cs)}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) / 2**30 if cuda else None
    with tempfile.TemporaryDirectory() as tmp:
        cp = ChunkProver(os.path.join(tmp, "params"), os.path.join(tmp, "out"),
                         params=params, k=k, device=dev)
        t0 = now()
        cp.srs()
        t1 = now()
        pk, vk = cp.keys(SuperCircuit(b, codes, txs, params))
        t2 = now()
        prove_phases: dict = {}
        proof = cp.gen_chunk_proof(b, codes, txs, timings=prove_phases)
        t3 = now()
        ok = cp.verify_chunk_proof(proof)
        t4 = now()
        before = sum(cuda_field.LAUNCHES.values())
        again = cp.gen_chunk_proof(b, codes, txs)
        t5 = now()
        launches = sum(cuda_field.LAUNCHES.values()) - before
    return {
        "k": k, "k_ext": pk.k_ext, "workload": stats, "shapes": shapes,
        "srs_s": t1 - t0, "keygen_s": t2 - t1, "prove_s": t3 - t2,
        "verify_s": t4 - t3, "ok": bool(ok), "proof_bytes": len(proof.proof),
        "proof": proof.proof, "vk": vk, "instances": proof.instances,
        "prove_phases": prove_phases,
        "cached": {"s": t5 - t4, "equal": again.proof == proof.proof,
                   "launches": launches},
        "resident_gb": resident,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
    }


# ---------------------------------------------------------------------------
# the chunk's whole statement: the PI circuit and its instance, with the
# state roots bound to the two-level MPT, and every transaction's
# signature verified in-circuit
def super_full_rows(b: CircuitInputBuilder, codes, txs, k: int,
                    accounts_before: dict) -> dict:
    """super_rows's regions of the SuperCircuit with `public_data`,
    `accounts_before` and `with_sig` on, and the regions these add, read
    from the sub-circuits of SuperCircuit(..., with_sig=True,
    accounts_before=accounts_before): Sig (EV_ROWS a signature), the
    MulMod rows of every signature in the shared MulMod region, the path
    rows of the storage-subtrie and account-trie MPT circuits (the
    account circuit's four exposure rows an account included) and the
    rows of each one's Poseidon table, the PI circuit's padded header,
    and in Keccak each signer's public key and PI's header."""
    cap = usable_rows(1 << k)
    c = SuperCircuit(b, codes, txs, super_params(txs), with_sig=True,
                     accounts_before=accounts_before)
    sigs = c.sig.events if c.sig is not None else []
    rows = super_rows(b, codes, txs, k, keccak_extra=[
        ev.pubkey_bytes() for ev in sigs] + [bytes(N_PI_BYTES)])
    mm = len(c.mulmod.events) if c.mulmod is not None else 0
    rows["mulmod"] = (mm + 1 if mm else 0, cap)
    rows["sig"] = (len(sigs) * SIG_EV_ROWS, cap)
    stor = _mpt_usage(c.mpt_stor) if c.mpt_stor is not None else (0, 0)
    acct = _mpt_usage(c.mpt_acct)
    rows["mpt_storage"] = (stor[0], cap)
    rows["mpt_account"] = (acct[0] + 4 * len(c.mpt_acct.accounts), cap)
    rows["poseidon_storage"] = (stor[1], cap)
    rows["poseidon_account"] = (acct[1], cap)
    rows["pi"] = (N_PADDED, cap)
    return rows


def super_full_workload(seed: int, k: int):
    """super_workload's transactions for the chunk's whole statement:
    the fullest region of super_full_rows at SUPER_FILL or more of its
    rows.  Transactions are drawn as super_workload draws them, until one
    does not fit; the chunk ends at once when the MulMod rows of one more
    signature would overflow their region (at k=13 one signature's leave
    no room for a second).  If the fullest region is then below SUPER_FILL, the
    last transaction runs again with more loop iterations (its body
    unchanged): the least count at which the fullest region reaches
    SUPER_FILL, if that count fits.

    Returns (builder, bytecodes, txs, params, public_data,
    accounts_before, stats): accounts_before holds every sender and
    contract (witness.mpt.AccountFields, as the builder starts them);
    public_data has SUPER_CHAIN_ID, the account trie's roots before and
    after the chunk (SuperCircuit.state_roots) and a seeded withdraw root
    and data hash; stats are super_workload's over super_full_rows, with
    the signatures, the storage and account updates and the roots."""
    rng = np.random.default_rng(seed)
    state = StateDB({})
    b = CircuitInputBuilder(accounts={})
    codes: list = []
    txs: list = []
    before: dict = {}

    def fullest(rows):
        return max(used / room for used, room in rows.values())

    def fits(rows):
        return all(used <= room for used, room in rows.values())

    def run(chunk, tx, body, iters, snippets, sha3):
        """The chunk (state, builder, codes, txs, accounts_before) with
        `tx` calling a fresh contract of evm_loop_program(body, ...)."""
        state0, b0, codes0, txs0, before0 = chunk
        sender, addr = tx.recover_sender(), tx.to
        code = evm_loop_program(body, iters, snippets, partners=True, sha3=sha3)
        st, bb, code_hash = _call_fresh_contract(state0, b0, sender, addr, code,
                                                 tx.value, tx.data)
        bf = {**before0, sender: AccountFields(balance=10**18),
              addr: AccountFields(code_hash=code_hash,
                                  code_size=len(code.to_bytes()))}
        rows = super_full_rows(bb, codes0 + [code], txs0 + [tx], k, bf)
        return (st, bb, codes0 + [code], txs0 + [tx], bf), rows

    rows: dict = {}
    last = None  # (chunk before it, tx, body rng, iters, snippets, sha3)
    while not txs or fullest(rows) < SUPER_FILL:
        if txs:  # a signature's MulMod rows: the same for every signature
            used, room = rows["mulmod"]
            if used + (used - 1 - len(b.mulmod_events)) // len(txs) > room:
                break
        addr = EVM_CONTRACT_BASE + len(txs)
        sk = int.from_bytes(rng.bytes(32), "big") % (secp256k1.N - 1) + 1
        calldata = rng.bytes(int(rng.integers(0, SUPER_CALLDATA + 1)))
        value = int(rng.integers(0, 1000))
        tx = Transaction(nonce=0, gas=SUPER_GAS, to=addr, value=value,
                         data=calldata, chain_id=SUPER_CHAIN_ID).sign(sk)
        iters, snippets = int(rng.integers(8, 24)), int(rng.integers(16, 48))
        chunk = (state, b, codes, txs, before)
        got = None
        for _ in range(8):
            for sha3 in (True, False):
                body = copy.deepcopy(rng)
                nxt, nrows = run(chunk, tx, rng, iters, snippets, sha3)
                if fits(nrows):
                    got = (nxt, nrows, (chunk, tx, body, iters, snippets, sha3))
                    break
            if got:
                break
            iters, snippets = max(1, iters // 2), max(1, snippets // 2)
        else:
            break
        (state, b, codes, txs, before), rows, last = got

    if last is not None and fullest(rows) < SUPER_FILL:
        # the least iteration count with the fullest region at SUPER_FILL
        # or over its room (both grow with the count), by doubling, then
        # bisection; taken if it fits
        chunk, tx, body, lo, snippets, sha3 = last

        def at(iters):
            return run(chunk, tx, copy.deepcopy(body), iters, snippets, sha3)

        hi, got = lo, None
        while hi < 0xFFFF:
            hi = min(2 * hi, 0xFFFF)
            got = at(hi)
            if not fits(got[1]) or fullest(got[1]) >= SUPER_FILL:
                break
            lo, got = hi, None
        while got is not None and hi - lo > 1:
            mid = (lo + hi) // 2
            r = at(mid)
            if not fits(r[1]) or fullest(r[1]) >= SUPER_FILL:
                hi, got = mid, r
            else:
                lo = mid
        if got is not None and fits(got[1]):
            (state, b, codes, txs, before), rows = got

    probe = SuperCircuit(b, codes, txs, super_params(txs), accounts_before=before)
    prev_root, post_root = probe.state_roots
    pd = PublicData(chain_id=SUPER_CHAIN_ID,
                    prev_state_root=prev_root.to_bytes(32, "big"),
                    post_state_root=post_root.to_bytes(32, "big"),
                    withdraw_root=rng.bytes(32), data_hash=rng.bytes(32))
    stats = {
        **_super_stats(b, txs, k, rows), "signatures": len(txs),
        "storage_updates": len(probe.mpt_stor.updates) if probe.mpt_stor else 0,
        "account_updates": len(probe.mpt_acct.updates),
        "state_roots": [hex(prev_root), hex(post_root)],
    }
    stats["fullest"] = max(stats["fill"], key=stats["fill"].get)
    return b, codes, txs, super_params(txs), pd, before, stats


def super_full_prove_bench(k: int = 13, seed: int = 7, device=None,
                           log=print) -> dict:
    """The chunk's whole statement over super_full_workload(seed, k): the
    SuperCircuit with public_data, accounts_before and with_sig on, its
    SRS, keygen, prove under the Poseidon transcript (the chunk proofs')
    and verify with the PI instance, each timed (_prove_verify).

    Returns {"k", "k_ext", "workload", "shapes" (circuit_stats and the
    quotient degree), "regions" (whether Sig, both MPT circuits, their
    Poseidon tables and PI are on), "srs_s", "keygen_s", "prove_s",
    "verify_s", "ok", "proof_bytes", "proof", "vk", "instance",
    "public_data", "keygen_phases", "prove_phases", "resident_gb",
    "peak_gb" (the device memory allocated before the SRS, and the peak;
    None on the CPU)}."""
    dev = resolve(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    b, codes, txs, params, pd, before, stats = super_full_workload(seed, k)
    stats["workload_s"] = time.perf_counter() - t0
    log(f"[super_full_bench k={k}] workload {stats}")

    def make():
        return SuperCircuit(b, codes, txs, params, public_data=pd,
                            accounts_before=before, with_sig=True)

    c, cs = make(), ConstraintSystem()
    c.configure(cs)
    shapes = {**circuit_stats(cs), "quotient_degree": quotient_degree(cs)}
    rows = stats["rows"]
    regions = {
        "sig": c.sig is not None and c.with_sig_txs,
        "mpt": c.mpt_stor is not None and c.mpt_acct is not None,
        "poseidon": rows["poseidon_storage"] > 0 and rows["poseidon_account"] > 0,
        "pi": c.pi is not None and cs.num_instance == 1,
    }
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) / 2**30 if cuda else None
    r = _prove_verify(make, k, dev, poseidon=True, instances=[pd.instance()])
    return {
        **r, "workload": stats, "shapes": shapes, "regions": regions,
        "instance": pd.instance(), "public_data": pd, "resident_gb": resident,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
    }
