"""CircuitInputBuilder — trace replay into RW operations + exec steps.

Equivalent of the reference's `bus-mapping/src/circuit_input_builder.rs`
(`CircuitInputBuilder.handle_block/handle_tx` + the per-opcode `Opcode`
impls under `bus-mapping/src/evm/opcodes/`, SURVEY.md §2.1 item 5 and
§3.1 HOT LOOP 1).  Replays a geth-schema trace step list, emitting RW
records (witness/rw.py) and an ExecStep table.

Design differences from the reference (documented):
  * Opcode dispatch is CLASS-based: any pure-stack opcode (arithmetic,
    bitwise, comparison, push/pop, context reads) is handled by ONE
    generic handler driven by (pops, pushes) and the next step's stack —
    the reference hand-writes ~115 opcode files; the generic handler
    covers the same RW semantics for the stack family.
  * DUP/SWAP keep the reference's minimal RW pattern (1r1w / 2r2w).
Round-1 scope: single-frame transactions (no nested calls yet); memory
(MLOAD/MSTORE/MSTORE8), storage (SLOAD/SSTORE) specials.

Port of zkevm_circuits_tpu/witness/builder.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..types.evm import OpcodeId
from .rw import AccountField, CallContextField, Rw, RwMap, RwTag
from .trace import GethExecStep, GethExecTrace

STACK_BASE = 1024


@dataclasses.dataclass
class ExecStep:
    exec_state: str  # opcode name or BeginTx/EndTx
    pc: int
    op: OpcodeId | None
    gas: int
    gas_cost: int
    call_id: int
    stack_pointer: int
    rw_counter_start: int
    rw_indices: list[int] = dataclasses.field(default_factory=list)
    error: str | None = None
    tx_id: int = 0
    callee: int = 0  # executing contract address
    code_hash: int = 0  # keccak of the executing bytecode (big-endian int)
    log_id: int = 0  # logs emitted in this tx BEFORE this step
    rev_count: int = 0  # reversion rows appended to this step's rws
    mem_words: int = 0  # memory size in 32-byte words BEFORE this step
    is_create_ret: bool = False  # RET terminating an init-code frame
    is_err_ret: bool = False  # RET unwinding an errored nested frame
    persistent: bool = True  # frame chain commits (LOG reversion gating)
    al_count: int = 0  # BeginTx: EIP-2930 prewarm rows (addrs + keys)
    al_gas: int = 0  # BeginTx: access-list intrinsic gas
    # ERR_JUMP aux: (code_len, byte_at_dest, is_code_at_dest, oor) —
    # witness-fill inputs the circuit binds via bytecode-table lookups;
    # ERR_INVALID_OP aux: the raw undefined opcode byte
    err_aux: tuple | int | None = None


@dataclasses.dataclass
class CopyEvent:
    """One byte-accurate copy (reference bus-mapping CopyEvent,
    circuit_input_builder/execution.rs; SURVEY.md §2.1 item 5)."""

    src_type: str  # 'calldata' | 'memory' | 'bytecode' | 'returndata'
    src_id: int  # tx_id / call_id / code-hash int (bytecode source)
    src_addr: int
    dst_type: str
    dst_id: int
    dst_addr: int
    length: int
    rw_counter_start: int
    bytes_: bytes
    src_len: int = -1  # source length for pad detection (-1 = n/a)
    code_marks: bytes = b""  # is_code flags per copied byte (bytecode src)


@dataclasses.dataclass
class ExpEvent:
    """One EXP opcode's exponentiation-by-squaring trace (reference
    bus-mapping `ExpEvent`, circuit_input_builder/execution.rs:871;
    steps generated as in bus-mapping/src/evm/opcodes/exp.rs:12-34)."""

    identifier: int  # rw_counter at the EXP step (unique per event)
    base: int
    exponent: int
    exponentiation: int  # base**exponent mod 2^256
    steps: list[tuple[int, int, int]]  # (a, b, d): d = a*b mod 2^256


M256 = 1 << 256


def exp_by_squaring(base: int, exponent: int, steps: list) -> int:
    """Recursive square-and-multiply; appends (a, b, d) mul steps in
    computation order (the circuit consumes them reversed)."""
    if exponent == 0:
        return 1
    if exponent == 1:
        return base
    q, odd = divmod(exponent, 2)
    exp1 = exp_by_squaring(base, q, steps)
    exp2 = exp1 * exp1 % M256
    steps.append((exp1, exp1, exp2))
    if not odd:
        return exp2
    out = exp2 * base % M256
    steps.append((exp2, base, out))
    return out


@dataclasses.dataclass
class TxContext:
    """Per-call-frame context (the root frame doubles as tx context).

    `to_addr` is the EXECUTING address (storage/self); `from_addr` the
    caller address (msg.sender).  Restoration fields mirror the
    CallContext rows the CALL step writes."""

    tx_id: int
    call_id: int
    from_addr: int
    to_addr: int
    value: int
    calldata: bytes
    code_hash: int = 0  # keccak(executing bytecode); 0 in dev witnesses
    code: bytes = b""  # executing bytecode (CODECOPY source)
    is_root: bool = True
    is_static: bool = False
    is_create: bool = False  # frame executes init code (CREATE/CREATE2)
    caller_id: int = 0
    ret_pc: int = 0  # caller pc after the call opcode
    ret_sp: int = 0  # caller stack slot receiving the success flag
    ret_offset: int = 0
    ret_length: int = 0
    parent_callee: int = 0  # caller's executing address
    parent_code_hash: int = 0
    cd_offset: int = 0  # nested frames: args offset in CALLER memory
    sstore_count: int = 0  # writes inside this frame (revert tracking)
    log_mark: int = 0  # tx log count at frame entry (revert tracking)
    gas: int = 0  # root frames: the tx gas limit (0 = derive from trace)
    gas_price: int = 0
    # EIP-2930: [(address, [storage_key, ...]), ...] prewarmed at BeginTx
    access_list: list = dataclasses.field(default_factory=list)
    journal_mark: int = 0  # reversible-write journal length at frame entry
    # last-callee return data bookkeeping (RETURNDATASIZE/COPY)
    last_callee_id: int = 0
    last_ret_off: int = 0
    last_ret_data: bytes = b""


# context opcodes handled by one generic path: opcode -> (CallContext
# field read at the step's own rw counter, value from the tx context)
CONTEXT_OPS = {
    OpcodeId.CALLER: (CallContextField.CallerAddress, lambda c: c.from_addr),
    OpcodeId.ADDRESS: (CallContextField.CalleeAddress, lambda c: c.to_addr),
    OpcodeId.CALLVALUE: (CallContextField.Value, lambda c: c.value),
    OpcodeId.CALLDATASIZE: (
        CallContextField.CallDataLength, lambda c: len(c.calldata)
    ),
    OpcodeId.RETURNDATASIZE: (
        CallContextField.LastCalleeReturnDataLength,
        lambda c: len(c.last_ret_data),
    ),
}


@dataclasses.dataclass
class AccountState:
    """Mutable per-address account view the builder replays (reference
    bus-mapping StateDB, state_db.rs:126).  All values are raw ints;
    balance math wraps mod 2^256 (dev witnesses may start from zeros)."""

    nonce: int = 0
    balance: int = 0
    code_hash: int = 0


class CircuitInputBuilder:
    """Replays traces; accumulates the block-wide witness tables."""

    def __init__(self, accounts: dict | None = None, coinbase: int = 0,
                 base_fee: int = 7):
        """accounts: {addr: AccountState | (nonce, balance, code_hash)}
        pre-block state; missing addresses start zeroed.  coinbase /
        base_fee mirror the tracer's BlockEnv defaults for the EndTx
        reward row."""
        self.accounts: dict[int, AccountState] = {}
        for a, st in (accounts or {}).items():
            self.accounts[a] = (
                st if isinstance(st, AccountState) else AccountState(*st)
            )
        self.coinbase = coinbase
        self.base_fee = base_fee
        self.rws = RwMap()
        self.steps: list[ExecStep] = []
        self.txs: list[TxContext] = []
        self.copy_events: list[CopyEvent] = []
        self.exp_events: list[ExpEvent] = []
        self.mulmod_events: list = []  # circuits.mulmod.MulModEvent
        self.sig_events: list = []  # circuits.sig.SigEvent (ecrecover)
        self.ecadd_events: list = []  # circuits.ecc.EcAddEvent
        self.ecmul_events: list = []  # circuits.ecc.EcMulEvent
        self.modexp_events: list = []  # circuits.modexp.ModExpEvent
        self.sha3_inputs: list[bytes] = []  # keccak preimages (SHA3 opcode)
        self.sha256_inputs: list[bytes] = []  # sha256 precompile inputs
        self._next_call_id = 1
        self._tx_log_count = 0  # logs emitted in the current tx
        self._cum_gas = 0  # block-cumulative gas used (TxReceipt rows)

    def _acct(self, addr: int) -> AccountState:
        if addr not in self.accounts:
            self.accounts[addr] = AccountState()
        return self.accounts[addr]

    def _account_read_adopt(self, addr: int, field, traced_value: int):
        """Account read whose value comes from the TRACE (the pushed
        word).  Fresh addresses adopt it as the committed value; already-
        tracked fields must agree — otherwise the caller forgot to seed
        `CircuitInputBuilder(accounts=...)` with the pre-state."""
        fresh = addr not in self.accounts
        st = self._acct(addr)
        if field == AccountField.Balance:
            if fresh:
                st.balance = traced_value
            assert st.balance == traced_value, (
                f"account 0x{addr:x} balance mismatch: builder has "
                f"{st.balance}, trace pushed {traced_value} — seed "
                "CircuitInputBuilder(accounts=...) with the pre-state"
            )
        elif field == AccountField.CodeHash:
            if not st.code_hash:
                st.code_hash = traced_value
            assert st.code_hash == traced_value or traced_value == 0, (
                f"account 0x{addr:x} code-hash mismatch"
            )
        # CodeSize: no running state; repeated reads chain in the state
        # circuit (same group, consistent values by construction)
        return self.rws.account_read(addr, field, traced_value)

    def _balance_add(self, addr: int, delta: int, journal=None):
        """Emit an Account.Balance write of +delta (mod 2^256)."""
        st = self._acct(addr)
        prev = st.balance
        st.balance = (st.balance + delta) % M256
        rw = self.rws.account_write(addr, AccountField.Balance,
                                    st.balance, prev)
        if journal is not None:
            journal.append(rw)
        return rw

    # ------------------------------------------------------------------
    def handle_tx(self, tx_ctx_args: dict, trace: GethExecTrace,
                  committed_storage: dict | None = None,
                  code_hashes: dict | None = None,
                  code_db: dict | None = None):
        """tx_ctx_args: from_addr/to_addr/value/calldata ints+bytes (plus
        optional code_hash for the root frame).
        committed_storage: {(addr, key): value} pre-tx committed values
        (for storage value_prev tracking).
        code_hashes: {address: keccak_int} for nested-call code binding
        (0 when absent — dev witnesses leave the binding off).
        code_db: {address: code bytes} — enables CODECOPY replay."""
        tx_id = len(self.txs) + 1
        call_id = self._next_call_id
        self._next_call_id += 1
        ctx = TxContext(tx_id=tx_id, call_id=call_id, **tx_ctx_args)
        self.txs.append(ctx)
        storage = dict(committed_storage or {})
        hashes = dict(code_hashes or {})
        hashes.setdefault(ctx.to_addr, ctx.code_hash)
        self._hashes = hashes
        self._code_db = dict(code_db or {})
        ctx.code = self._code_db.get(ctx.to_addr, b"")
        self._tx_log_count = 0

        logs = trace.struct_logs
        # resolve the tx gas limit BEFORE BeginTx: the fee-purchase
        # Account row needs it.  The first traced step starts at
        # limit - intrinsic (EIP-2028 calldata pricing).
        intrinsic = 21000 + sum(4 if b == 0 else 16 for b in ctx.calldata)
        # EIP-2930 access-list intrinsic gas (reference
        # eth-types tx_access_list_gas_cost)
        intrinsic += sum(
            2400 + 1900 * len(keys) for _, keys in ctx.access_list
        )
        if logs:
            derived = logs[0].gas + intrinsic
            if ctx.gas == 0:
                ctx.gas = derived
            else:
                assert ctx.gas == derived, (
                    "tx gas limit inconsistent with trace"
                )
        elif ctx.gas == 0:
            ctx.gas = intrinsic
        # reversible-write journal (reference bus-mapping reversion
        # groups, operation.rs:113): entries are undone — inverse writes
        # emitted, internal state restored — when a frame reverts/errors
        # or the whole tx fails
        self._tx_journal: list = []
        self._storage = storage
        # EIP-2929 warm-address set (builder view: origin + callee warm
        # from BeginTx; coinbase warmth is the tracer's, unbound here)
        self._warm_addrs = {ctx.from_addr, ctx.to_addr}
        self._begin_tx(ctx, intrinsic)
        # persistence pre-scan: a step is persistent iff neither its own
        # frame nor any enclosing frame (incl. the tx root) reverts or
        # errors.  LOG writes in doomed frames are never emitted to the
        # TxLog table (reference bus-mapping gates TxLog ops on
        # call.is_persistent, src/evm/opcodes/logs.rs).
        persistent = self._scan_persistence(logs, trace.failed)
        frames = [ctx]
        for i, step in enumerate(logs):
            fr = frames[-1]
            self._step_persistent = persistent[i]
            assert step.depth == len(frames), (
                f"depth mismatch at step {i}: {step.depth} vs {len(frames)}"
            )
            nxt = logs[i + 1] if i + 1 < len(logs) else None
            op = step.op
            if step.error is not None and step.error != "revert":
                # errored step: terminal for its frame (reference
                # bus-mapping error_* opcode modules).  Root frames are
                # followed by END_TX; nested frames unwind to the caller
                # through an error-RET step (reference CommonErrorGadget
                # restore_context)
                self._handle_error_step(fr, step)
                if len(frames) > 1:
                    self._handle_error_unwind(fr, frames[-2], step)
                    frames.pop()
                continue
            if op.is_call and nxt is not None and nxt.depth == step.depth + 1:
                frames.append(self._handle_call(fr, step, hashes))
            elif op.is_create and nxt is not None \
                    and nxt.depth == step.depth + 1:
                frames.append(self._handle_create(fr, step, hashes))
            elif op.is_call and not op == OpcodeId.CALLCODE and (
                (step.stack[-2] & ((1 << 160) - 1)) in (1, 2, 4, 5, 6, 7)
            ):
                self._handle_precompile(fr, step, nxt)
            elif op.is_call and (
                nxt is not None and nxt.depth == step.depth
                and not step.error
                # precompile addresses are codeless but RETURN data: they
                # must never take the plain-transfer shape
                and not 1 <= (step.stack[-2] & ((1 << 160) - 1)) <= 9
                and len(nxt.stack) == len(step.stack)
                - (7 if op in (OpcodeId.CALL, OpcodeId.CALLCODE) else 6) + 1
                and nxt.stack[-1] == 1
            ):
                # codeless callee: no frame descends, value transfers
                # (CALL; CALLCODE self-transfers), 1 pushes (reference
                # callop.rs empty-code path, all four variants)
                self._handle_call_nodescend(fr, step, nxt)
            elif op.is_call and (
                nxt is not None and nxt.depth == step.depth
                and not step.error
                and not 1 <= (step.stack[-2] & ((1 << 160) - 1)) <= 9
                and len(nxt.stack) == len(step.stack)
                - (7 if op in (OpcodeId.CALL, OpcodeId.CALLCODE) else 6) + 1
                and nxt.stack[-1] == 0
            ):
                # depth-limit / insufficient-balance abort: 0 pushes, no
                # frame enters (reference callop.rs is_depth_ok /
                # insufficient_balance branches)
                self._handle_call_abort(fr, step, nxt)
            elif op.is_call or op.is_create:
                raise NotImplementedError(
                    "calls/creates that do not descend past the codeless-"
                    "callee and abort cases (failed precompiles, CREATE "
                    "aborts) land later"
                )
            elif len(frames) > 1 and (
                op in (OpcodeId.STOP, OpcodeId.RETURN, OpcodeId.REVERT)
                or (nxt is not None and nxt.depth == step.depth - 1)
            ):
                self._handle_frame_end(fr, frames[-2], step)
                frames.pop()
            else:
                self._handle_step(fr, step, nxt, storage)
        self._end_tx(ctx, trace)

    def _begin_tx(self, ctx: TxContext, intrinsic: int):
        """BeginTx rows (reference execution/begin_tx.rs): 6 call-context
        reads, EIP-2929 access-list warming of caller + callee, the
        caller nonce bump, gas fee purchase, the value transfer pair
        (reversible), and the callee code-hash read."""
        start = self.rws.counter + 1
        es = ExecStep(
            exec_state="BeginTx", pc=0, op=None, gas=ctx.gas,
            gas_cost=intrinsic,
            call_id=ctx.call_id, stack_pointer=STACK_BASE,
            rw_counter_start=start, tx_id=ctx.tx_id, callee=ctx.to_addr,
            code_hash=ctx.code_hash, log_id=self._tx_log_count,
        )
        rws = [
            self.rws.call_context_read(ctx.call_id, CallContextField.TxId, ctx.tx_id),
            self.rws.call_context_read(
                ctx.call_id, CallContextField.CalleeAddress, ctx.to_addr
            ),
            self.rws.call_context_read(
                ctx.call_id, CallContextField.CallerAddress, ctx.from_addr
            ),
            self.rws.call_context_read(
                ctx.call_id, CallContextField.Value, ctx.value
            ),
            self.rws.call_context_read(ctx.call_id, CallContextField.IsRoot, 1),
            self.rws.call_context_read(
                ctx.call_id, CallContextField.CallDataLength, len(ctx.calldata)
            ),
        ]
        # EIP-2929: tx origin + callee start warm (per-tx set => prev 0)
        rws.append(self.rws.access_list_account_write(
            ctx.tx_id, ctx.from_addr, 1, 0
        ))
        rws.append(self.rws.access_list_account_write(
            ctx.tx_id, ctx.to_addr, 1, 0
        ))
        # caller nonce bump (not reversible)
        caller = self._acct(ctx.from_addr)
        rws.append(self.rws.account_write(
            ctx.from_addr, AccountField.Nonce, caller.nonce + 1,
            caller.nonce,
        ))
        caller.nonce += 1
        # gas fee purchase (not reversible)
        rws.append(self._balance_add(
            ctx.from_addr, -(ctx.gas * ctx.gas_price)
        ))
        # value transfer (reversible)
        rws.append(self._balance_add(
            ctx.from_addr, -ctx.value, journal=None
        ))
        self._tx_journal.append(("balance", ctx.from_addr, -ctx.value))
        rws.append(self._balance_add(ctx.to_addr, ctx.value))
        self._tx_journal.append(("balance", ctx.to_addr, ctx.value))
        # callee code binding
        callee = self._acct(ctx.to_addr)
        if ctx.code_hash and not callee.code_hash:
            callee.code_hash = ctx.code_hash
        rws.append(self.rws.account_read(
            ctx.to_addr, AccountField.CodeHash, callee.code_hash
        ))
        # EIP-2930 access-list prewarm rows, after the 13 fixed accesses
        # (reference execution/begin_tx.rs access-list section +
        # bus-mapping begin_tx warming): one TxAccessListAccount write
        # per listed address, one TxAccessListAccountStorage write per
        # listed key.  Count carried on the step (al_count) for the
        # BEGIN_TX rwc transition.
        al_rows = 0
        warm_slots: set = set()
        for al_addr, al_keys in ctx.access_list:
            was_warm = int(al_addr in self._warm_addrs)
            rws.append(self.rws.access_list_account_write(
                ctx.tx_id, al_addr, 1, was_warm
            ))
            self._warm_addrs.add(al_addr)
            al_rows += 1
            for k in al_keys:
                rws.append(self.rws.access_list_storage_write(
                    ctx.tx_id, al_addr, k, 1,
                    int((al_addr, k) in warm_slots),
                ))
                warm_slots.add((al_addr, k))
                al_rows += 1
        es.al_count = al_rows
        es.al_gas = sum(
            2400 + 1900 * len(keys) for _, keys in ctx.access_list
        )
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    # tracer VmError name -> circuit execution state (reference
    # evm_circuit/step.rs error states; v1 covers the stack family and
    # constant-cost OOG, error_stack.rs / error_oog_constant.rs)
    ERROR_STATES = {
        "stack underflow": "ERR_STACK",
        "stack overflow": "ERR_STACK",
        "out of gas": "ERR_OOG",
        "gas uint64 overflow": "ERR_OOG",
        "invalid jump destination": "ERR_JUMP",
        "return data out of bounds": "ERR_RDOOB",
        "write protection": "ERR_WRITE_PROT",
        "invalid opcode": "ERR_INVALID_OP",
    }

    # dynamic-OOG families: op -> (kind, read-positions)
    # kind: mem32/mem1 (MLOAD/MSTORE/MSTORE8: pure expansion), sha (6 per
    # word), copy (3 per word, extent = dst+len), span (RETURN/REVERT:
    # expansion only), log (8 per byte + expansion)
    OOG_DYN = {
        OpcodeId.MLOAD: "mem32", OpcodeId.MSTORE: "mem32",
        OpcodeId.MSTORE8: "mem1", OpcodeId.SHA3: "sha",
        OpcodeId.CALLDATACOPY: "copy", OpcodeId.CODECOPY: "copy",
        OpcodeId.RETURNDATACOPY: "copy",
        OpcodeId.RETURN: "span", OpcodeId.REVERT: "span",
        OpcodeId.LOG0: "log", OpcodeId.LOG1: "log", OpcodeId.LOG2: "log",
        OpcodeId.LOG3: "log", OpcodeId.LOG4: "log",
    }

    @staticmethod
    def _oog_dyn_required(kind: str, op: OpcodeId, addr: int, size: int,
                          mem_words: int) -> int:
        """Required gas for a dynamic-family op (reference gas formulas,
        memory_gadget.rs / gas_create.rs): constant + per-word/byte +
        memory expansion from `mem_words` to cover the touched extent."""
        width = {"mem32": 32, "mem1": 1}.get(kind, size)
        extent = (addr + width) if width else 0
        m = (extent + 31) // 32
        memexp = 0
        if m > mem_words:
            memexp = (3 * (m - mem_words)
                      + (m * m - mem_words * mem_words) // 512)
        words = (size + 31) // 32
        wcoef = 6 if kind == "sha" else 3 if kind == "copy" else 0
        bcoef = 8 if kind == "log" else 0
        topic_gas = 375 * (int(op) - 0xA0) if kind == "log" else 0
        return (op.constant_gas + topic_gas + wcoef * words
                + bcoef * size + memexp)

    def _handle_oog_dyn(self, fr: TxContext, step: GethExecStep,
                        kind: str):
        """ERR_OOG_DYN: out-of-gas on a dynamic-cost op of the memory /
        hash / copy / log / return family.  The failing operands are read
        on the bus and the circuit RECOMPUTES the required gas (constant
        + per-word/byte + memory expansion) and proves
        gas_left < required (reference error_oog_memory_copy.rs,
        error_oog_sha3.rs, error_oog_log.rs, ...)."""
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="ERR_OOG_DYN", pc=step.pc, op=step.op,
            gas=step.gas, gas_cost=0, call_id=fr.call_id,
            stack_pointer=sp, mem_words=len(step.memory) // 32,
            rw_counter_start=self.rws.counter + 1, tx_id=fr.tx_id,
            callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count, error=step.error,
        )
        rws: list[Rw] = []
        if kind in ("mem32", "mem1"):
            addr, size = step.stack[-1], 0
            rws.append(self.rws.stack_read(fr.call_id, sp, addr))
        elif kind == "copy":
            addr, size = step.stack[-1], step.stack[-3]
            for j in range(3):
                rws.append(self.rws.stack_read(
                    fr.call_id, sp + j, step.stack[-1 - j]
                ))
        else:  # sha / span / log: (offset, size)
            addr, size = step.stack[-1], step.stack[-2]
            rws.append(self.rws.stack_read(fr.call_id, sp, addr))
            rws.append(self.rws.stack_read(fr.call_id, sp + 1, size))
        if max(addr, size) >= (1 << 32):
            # u64-overflow shape (geth ErrGasUintOverflow / the absurd-
            # operand OOGs): the circuit proves the offending word has a
            # nonzero high part and gas_left < 2^40 — required gas for
            # >= 2^27 expansion words exceeds 2^41 (circuit fov branch)
            assert step.gas < (1 << 40), "gas beyond the u40 ovf bound"
            es.err_aux = (kind, addr, size, "ovf")
        else:
            required = self._oog_dyn_required(
                kind, step.op, addr, size, es.mem_words
            )
            assert step.gas < required, (
                f"OOG step with gas {step.gas} >= required {required}"
            )
            es.err_aux = (kind, addr, size, required)
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _handle_error_step(self, fr: TxContext, step: GethExecStep):
        state = self.ERROR_STATES.get(step.error)
        if state is None:
            raise NotImplementedError(f"error state {step.error!r} pending")
        if state == "ERR_OOG" and step.gas >= step.op.constant_gas:
            kind = self.OOG_DYN.get(step.op)
            if kind is None:
                raise NotImplementedError(
                    f"dynamic-cost OOG for {step.op.name} (call family / "
                    "EXTCODECOPY access costs) lands later"
                )
            self._handle_oog_dyn(fr, step, kind)
            return
        es = ExecStep(
            exec_state=state, pc=step.pc, op=step.op, gas=step.gas,
            gas_cost=0, call_id=fr.call_id,
            stack_pointer=STACK_BASE - len(step.stack),
            mem_words=len(step.memory) // 32,
            rw_counter_start=self.rws.counter + 1, tx_id=fr.tx_id,
            callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count, error=step.error,
        )
        rws: list[Rw] = []
        sp = es.stack_pointer
        if state == "ERR_JUMP":
            # pop the offending destination (+ the taken condition for
            # JUMPI; geth only errors on taken branches) — reference
            # execution/error_invalid_jump.rs
            rws.append(self.rws.stack_read(
                fr.call_id, sp, step.stack[-1]
            ))
            if step.op == OpcodeId.JUMPI:
                rws.append(self.rws.stack_read(
                    fr.call_id, sp + 1, step.stack[-2]
                ))
            from ..types import Bytecode as _BC

            code = fr.code
            dest = step.stack[-1]
            oor = int(dest >= len(code))
            b_at = code[dest] if not oor else 0
            ic_at = (int(_BC(code).is_code_marks()[dest])
                     if not oor else 0)
            es.err_aux = (len(code), b_at, ic_at, oor)
        elif state == "ERR_RDOOB":
            # RETURNDATACOPY pops + the return-data length bookkeeping
            # read proving the out-of-bounds claim (reference
            # execution/error_return_data_oo_bound.rs)
            for j in range(3):
                rws.append(self.rws.stack_read(
                    fr.call_id, sp + j, step.stack[-1 - j]
                ))
            rws.append(self.rws.call_context_read(
                fr.call_id, CallContextField.LastCalleeReturnDataLength,
                len(fr.last_ret_data),
            ))
        elif state == "ERR_WRITE_PROT":
            # prove the frame is static + (CALL family) a nonzero value
            # (reference execution/error_write_protection.rs)
            rws.append(self.rws.call_context_read(
                fr.call_id, CallContextField.IsStatic, 1
            ))
            if step.op == OpcodeId.CALL:
                rws.append(self.rws.stack_read(
                    fr.call_id, sp + 2, step.stack[-3]
                ))
        elif state == "ERR_INVALID_OP":
            # no bus accesses; record the raw undefined byte (the tracer
            # normalizes unknown bytes to OpcodeId.INVALID) — reference
            # execution/error_invalid_opcode.rs
            es.err_aux = fr.code[step.pc]
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _handle_error_unwind(self, fr: TxContext, parent: TxContext,
                             step: GethExecStep):
        """Error-RET step unwinding an errored nested frame: restore the
        caller context, push 0, expose no return data, and undo the
        frame's reversible writes (reference CommonErrorGadget's
        restore_context, evm_circuit/execution/error_*.rs)."""
        assert self._tx_log_count == fr.log_mark, (
            "persistence pre-scan must have gated LOGs in this doomed frame"
        )
        es = ExecStep(
            exec_state="RET", pc=step.pc, op=OpcodeId.STOP,
            gas=step.gas, gas_cost=0, call_id=fr.call_id,
            stack_pointer=STACK_BASE - len(step.stack),
            mem_words=len(step.memory) // 32,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count, is_err_ret=True,
            is_create_ret=fr.is_create,
        )
        CCF = CallContextField
        r_ = self.rws.call_context_read
        rws = [
            r_(fr.call_id, CCF.CallerId, fr.caller_id),
            r_(fr.call_id, CCF.ReturnPc, fr.ret_pc),
            r_(fr.call_id, CCF.ReturnSp, fr.ret_sp),
            r_(fr.call_id, CCF.ParentCalleeAddress, fr.parent_callee),
            r_(fr.call_id, CCF.ParentCodeHash, fr.parent_code_hash),
            r_(fr.call_id, CCF.RetOffset, fr.ret_offset),
            r_(fr.call_id, CCF.RetLength, fr.ret_length),
            r_(fr.call_id, CCF.IsCreate, int(fr.is_create)),
        ]
        w_ = self.rws.call_context_write
        rws += [
            w_(parent.call_id, CCF.LastCalleeId, fr.call_id),
            w_(parent.call_id, CCF.LastCalleeReturnDataOffset, 0),
            w_(parent.call_id, CCF.LastCalleeReturnDataLength, 0),
        ]
        parent.last_callee_id = fr.call_id
        parent.last_ret_off = 0
        parent.last_ret_data = b""
        rws.append(self.rws.stack_write(parent.call_id, fr.ret_sp, 0))
        undo = self._undo_journal(fr.journal_mark)
        es.rev_count = len(undo)
        rws += undo
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _undo_journal(self, mark: int) -> list[Rw]:
        """Emit inverse writes for journal entries past `mark`, newest
        first (reference bus-mapping reversion groups)."""
        out = []
        while len(self._tx_journal) > mark:
            kind, *rest = self._tx_journal.pop()
            if kind == "balance":
                addr, delta = rest
                out.append(self._balance_add(addr, -delta))
            elif kind == "storage":
                tx_id, addr, key, old, new = rest
                out.append(
                    self.rws.storage_write(tx_id, addr, key, old, new)
                )
                self._storage[(addr, key)] = old
            elif kind == "nonce":
                addr, old = rest
                st = self._acct(addr)
                prev = st.nonce
                st.nonce = old
                out.append(self.rws.account_write(
                    addr, AccountField.Nonce, old, prev
                ))
            elif kind == "codehash":
                addr, old = rest
                st = self._acct(addr)
                prev = st.code_hash
                st.code_hash = old
                out.append(self.rws.account_write(
                    addr, AccountField.CodeHash, old, prev
                ))
            elif kind == "warm":
                tx_id, addr, was_warm = rest
                out.append(self.rws.access_list_account_write(
                    tx_id, addr, was_warm, 1
                ))
                if not was_warm:
                    self._warm_addrs.discard(addr)
            else:  # pragma: no cover
                raise AssertionError(f"unknown journal entry {kind}")
        return out

    def _end_tx(self, ctx: TxContext, trace: GethExecTrace):
        """EndTx rows (reference execution/end_tx.rs): IsSuccess read,
        refund counter, unused-gas refund to the caller, coinbase reward —
        then (failed txs) the reversion writes undoing the journal."""
        start = self.rws.counter + 1
        # gas left after the terminal step: the chain gate constrains
        # END_TX.gas = prev.gas - prev.gas_cost
        prev = self.steps[-1]
        es = ExecStep(
            exec_state="EndTx", pc=0, op=None,
            gas=prev.gas - prev.gas_cost, gas_cost=0,
            mem_words=prev.mem_words,
            call_id=ctx.call_id, stack_pointer=STACK_BASE,
            rw_counter_start=start, tx_id=ctx.tx_id, callee=ctx.to_addr,
            code_hash=ctx.code_hash, log_id=self._tx_log_count,
        )
        rws = [self.rws.call_context_read(
            ctx.call_id, CallContextField.IsSuccess, int(not trace.failed)
        )]
        gas_left = prev.gas - prev.gas_cost
        refund = (ctx.gas - trace.gas) - gas_left  # EIP-3529-capped counter
        rws.append(self.rws.tx_refund_write(ctx.tx_id, refund, 0))
        # unused gas (incl. refund) back to the caller; coinbase tip
        rws.append(self._balance_add(
            ctx.from_addr, (ctx.gas - trace.gas) * ctx.gas_price
        ))
        tip = max(0, ctx.gas_price - self.base_fee)
        rws.append(self._balance_add(self.coinbase, trace.gas * tip))
        # TxReceipt rows (reference operation.rs:113 TxReceiptOp +
        # execution/end_tx.rs): status, cumulative gas, log count
        from .rw import TxReceiptField as TRF

        self._cum_gas += trace.gas
        rws.append(self.rws.tx_receipt_write(
            ctx.tx_id, TRF.PostStateOrStatus, int(not trace.failed)
        ))
        rws.append(self.rws.tx_receipt_write(
            ctx.tx_id, TRF.CumulativeGasUsed, self._cum_gas
        ))
        rws.append(self.rws.tx_receipt_write(
            ctx.tx_id, TRF.LogLength, self._tx_log_count
        ))
        if trace.failed:
            undo = self._undo_journal(0)
            es.rev_count = len(undo)
            rws += undo
        else:
            self._tx_journal.clear()
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    # ------------------------------------------------------------------
    def _handle_call(self, fr: TxContext, step: GethExecStep,
                     hashes: dict) -> TxContext:
        """CALL/CALLCODE/DELEGATECALL/STATICCALL that descends into a new
        frame (reference bus-mapping src/evm/opcodes/callop.rs).  Emits
        the stack pops + the new frame's CallContext writes; returns the
        new frame context."""
        op = step.op
        call_id = fr.call_id
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="CALL", pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []
        has_value = op in (OpcodeId.CALL, OpcodeId.CALLCODE)
        npops = 7 if has_value else 6
        vals = [step.stack[-1 - i] for i in range(npops)]
        for i, v in enumerate(vals):
            rws.append(self.rws.stack_read(call_id, sp + i, v))
        gas_w, addr = vals[0], vals[1] & ((1 << 160) - 1)
        value = vals[2] if has_value else (
            fr.value if op == OpcodeId.DELEGATECALL else 0
        )
        args_off, args_len, ret_off, ret_len = vals[npops - 4 : npops]
        calldata = bytes(step.memory[args_off : args_off + args_len]) \
            .ljust(args_len, b"\x00")

        if op == OpcodeId.DELEGATECALL:
            exec_addr, caller_addr = fr.to_addr, fr.from_addr
        elif op == OpcodeId.CALLCODE:
            exec_addr, caller_addr = fr.to_addr, fr.to_addr
        else:
            exec_addr, caller_addr = addr, fr.to_addr
        code_hash = hashes.get(addr, 0)
        code_bytes = self._code_db.get(addr, b"")
        new_id = self.rws.counter + 1  # first context write's rw counter
        new = TxContext(
            tx_id=fr.tx_id, call_id=new_id, from_addr=caller_addr,
            to_addr=exec_addr, value=value, calldata=calldata,
            code_hash=code_hash, code=code_bytes, is_root=False,
            is_static=fr.is_static or op == OpcodeId.STATICCALL,
            caller_id=call_id, ret_pc=step.pc + 1,
            ret_sp=sp + npops - 1, ret_offset=ret_off, ret_length=ret_len,
            parent_callee=fr.to_addr, parent_code_hash=fr.code_hash,
            log_mark=self._tx_log_count,
            journal_mark=len(self._tx_journal),
            cd_offset=args_off,
        )
        self._next_call_id = max(self._next_call_id, new_id + 1)
        CCF = CallContextField
        w = self.rws.call_context_write
        rws += [
            w(new_id, CCF.CallerId, call_id),
            w(new_id, CCF.ReturnPc, new.ret_pc),
            w(new_id, CCF.ReturnSp, new.ret_sp),
            w(new_id, CCF.RetOffset, ret_off),
            w(new_id, CCF.RetLength, ret_len),
            w(new_id, CCF.ParentCalleeAddress, fr.to_addr),
            w(new_id, CCF.ParentCodeHash, fr.code_hash),
            w(new_id, CCF.TxId, fr.tx_id),
            w(new_id, CCF.CalleeAddress, exec_addr),
            w(new_id, CCF.CallerAddress, caller_addr),
            w(new_id, CCF.Value, value),
            w(new_id, CCF.CallDataLength, args_len),
            w(new_id, CCF.CallDataOffset, args_off),
            w(new_id, CCF.CodeHash, code_hash),
            w(new_id, CCF.IsStatic, int(new.is_static)),
            w(new_id, CCF.IsRoot, 0),
            w(new_id, CCF.IsCreate, 0),
        ]
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)
        return new

    def _handle_create(self, fr: TxContext, step: GethExecStep,
                       hashes: dict) -> TxContext:
        """CREATE/CREATE2 that descends into an init-code frame
        (reference bus-mapping src/evm/opcodes/create.rs +
        zkevm-circuits execution/create.rs).  Emits the stack pops, the
        creator nonce bump, the created-address access-list warm, the
        value-transfer pair, the created account's nonce init (EIP-161),
        and the new frame's CallContext writes.  Registers the keccak
        address-derivation preimage so the EVM circuit can bind the
        created address to the KeccakTable."""
        from ..crypto.keccak import keccak256
        from ..types import rlp as _rlp

        op = step.op
        call_id = fr.call_id
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="CREATE", pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        npops = 4 if op == OpcodeId.CREATE2 else 3
        vals = [step.stack[-1 - i] for i in range(npops)]
        value, off, size = vals[0], vals[1], vals[2]
        salt = vals[3] if op == OpcodeId.CREATE2 else 0
        initcode = bytes(step.memory[off : off + size]).ljust(size, b"\x00")
        init_hash = int.from_bytes(keccak256(initcode), "big")

        creator = self._acct(fr.to_addr)
        nonce = creator.nonce
        if op == OpcodeId.CREATE:
            # variable-length RLP nonce: 23 + nl bytes (the circuit's
            # CREATE preimage selects the matching branch via o_{nl})
            preimage = _rlp.encode([fr.to_addr.to_bytes(20, "big"), nonce])
            assert 23 <= len(preimage) <= 31
        else:
            preimage = (b"\xff" + fr.to_addr.to_bytes(20, "big")
                        + salt.to_bytes(32, "big") + keccak256(initcode))
            self.sha3_inputs.append(initcode)
        new_addr = int.from_bytes(keccak256(preimage)[12:], "big")
        self.sha3_inputs.append(preimage)

        rws: list[Rw] = []
        for i, v in enumerate(vals):
            rws.append(self.rws.stack_read(call_id, sp + i, v))
        # creator nonce bump — persists when the INIT frame reverts, but
        # reverts with outer frames (journaled before the child's mark)
        rws.append(self.rws.account_write(
            fr.to_addr, AccountField.Nonce, nonce + 1, nonce
        ))
        creator.nonce = nonce + 1
        self._tx_journal.append(("nonce", fr.to_addr, nonce))
        # EIP-2929: the created address is warmed at the CALLER's journal
        # level (geth warms before the child snapshot): it stays warm
        # across the init frame's own revert, but unwinds if an enclosing
        # frame reverts — hence journaled BEFORE the
        # child's mark, like the nonce bump.
        was_warm = int(new_addr in self._warm_addrs)
        self._warm_addrs.add(new_addr)
        rws.append(self.rws.access_list_account_write(
            fr.tx_id, new_addr, 1, was_warm
        ))
        self._tx_journal.append(("warm", fr.tx_id, new_addr, was_warm))
        mark = len(self._tx_journal)
        # endowment transfer (reversible with the init frame)
        rws.append(self._balance_add(fr.to_addr, -value))
        self._tx_journal.append(("balance", fr.to_addr, -value))
        rws.append(self._balance_add(new_addr, value))
        self._tx_journal.append(("balance", new_addr, value))
        # created account starts at nonce 1 (EIP-161)
        created = self._acct(new_addr)
        rws.append(self.rws.account_write(
            new_addr, AccountField.Nonce, 1, created.nonce
        ))
        self._tx_journal.append(("nonce", new_addr, created.nonce))
        created.nonce = 1

        hashes[new_addr] = 0  # no deployed code yet (set at deposit)
        new_id = self.rws.counter + 1  # first context write's rw counter
        new = TxContext(
            tx_id=fr.tx_id, call_id=new_id, from_addr=fr.to_addr,
            to_addr=new_addr, value=value, calldata=b"",
            code_hash=init_hash, code=initcode, is_root=False,
            is_static=fr.is_static, is_create=True,
            caller_id=call_id, ret_pc=step.pc + 1,
            ret_sp=sp + npops - 1, ret_offset=0, ret_length=0,
            parent_callee=fr.to_addr, parent_code_hash=fr.code_hash,
            log_mark=self._tx_log_count,
            journal_mark=mark,
        )
        self._next_call_id = max(self._next_call_id, new_id + 1)
        CCF = CallContextField
        w = self.rws.call_context_write
        rws += [
            w(new_id, CCF.CallerId, call_id),
            w(new_id, CCF.ReturnPc, new.ret_pc),
            w(new_id, CCF.ReturnSp, new.ret_sp),
            w(new_id, CCF.RetOffset, 0),
            w(new_id, CCF.RetLength, 0),
            w(new_id, CCF.ParentCalleeAddress, fr.to_addr),
            w(new_id, CCF.ParentCodeHash, fr.code_hash),
            w(new_id, CCF.TxId, fr.tx_id),
            w(new_id, CCF.CalleeAddress, new_addr),
            w(new_id, CCF.CallerAddress, fr.to_addr),
            w(new_id, CCF.Value, value),
            w(new_id, CCF.CallDataLength, 0),
            w(new_id, CCF.CallDataOffset, 0),
            w(new_id, CCF.CodeHash, init_hash),
            w(new_id, CCF.IsStatic, int(new.is_static)),
            w(new_id, CCF.IsRoot, 0),
            w(new_id, CCF.IsCreate, 1),
        ]
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)
        return new

    def _handle_call_nodescend(self, fr: TxContext, step: GethExecStep,
                               nxt: GethExecStep):
        """CALL/STATICCALL to a CODELESS account (the plain-transfer
        shape): stack pops, EIP-2929 warm write, an empty-CodeHash
        account read proving the callee has no code, the value-transfer
        balance pair (CALL), and the success-1 push — no frame descends
        (reference execution/callop.rs is_empty_code_hash branch)."""
        op = step.op
        call_id = fr.call_id
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="CALL", pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []
        has_value = op in (OpcodeId.CALL, OpcodeId.CALLCODE)
        npops = 7 if has_value else 6
        vals = [step.stack[-1 - i] for i in range(npops)]
        for i, v in enumerate(vals):
            rws.append(self.rws.stack_read(call_id, sp + i, v))
        addr = vals[1] & ((1 << 160) - 1)
        value = vals[2] if has_value else 0
        acct = self._acct(addr)
        assert acct.code_hash == 0 and not self._code_db.get(addr), (
            "no-descend call to an account WITH code (abort case) is "
            "staged"
        )
        warm_prev = int(addr in self._warm_addrs)
        self._warm_addrs.add(addr)
        rws.append(self.rws.access_list_account_write(
            fr.tx_id, addr, 1, warm_prev
        ))
        self._tx_journal.append(("warm", fr.tx_id, addr, warm_prev))
        rws.append(self.rws.account_read(addr, AccountField.CodeHash, 0))
        if has_value:
            # CALL transfers caller -> callee; CALLCODE transfers to
            # SELF (a balance-checked no-op, reference callop.rs)
            credit = fr.to_addr if op == OpcodeId.CALLCODE else addr
            rws.append(self._balance_add(fr.to_addr, -value))
            self._tx_journal.append(("balance", fr.to_addr, -value))
            rws.append(self._balance_add(credit, value))
            self._tx_journal.append(("balance", credit, value))
        rws.append(self.rws.stack_write(call_id, sp + npops - 1, 1))
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _handle_call_abort(self, fr: TxContext, step: GethExecStep,
                           nxt: GethExecStep):
        """CALL-family abort: the call never starts — depth == 1024 or
        (value variants) caller balance < value.  Pops + EIP-2929 warm
        write + (value variants) a caller Balance read justifying the
        abort + the failure-0 push (reference callop.rs is_depth_ok /
        insufficient_balance; the cause flag is witness-carried in v1,
        like the CALL gadget's static flag — the balance it would compare
        against is pinned on the bus)."""
        op = step.op
        call_id = fr.call_id
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="CALL", pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []
        has_value = op in (OpcodeId.CALL, OpcodeId.CALLCODE)
        npops = 7 if has_value else 6
        vals = [step.stack[-1 - i] for i in range(npops)]
        for i, v in enumerate(vals):
            rws.append(self.rws.stack_read(call_id, sp + i, v))
        addr = vals[1] & ((1 << 160) - 1)
        value = vals[2] if has_value else 0
        assert step.depth >= 1024 or (
            has_value and self._acct(fr.to_addr).balance < value
        ), "abort shape without an abort cause"
        warm_prev = int(addr in self._warm_addrs)
        self._warm_addrs.add(addr)
        rws.append(self.rws.access_list_account_write(
            fr.tx_id, addr, 1, warm_prev
        ))
        self._tx_journal.append(("warm", fr.tx_id, addr, warm_prev))
        if has_value:
            rws.append(self.rws.account_read(
                fr.to_addr, AccountField.Balance,
                self._acct(fr.to_addr).balance,
            ))
        rws.append(self.rws.stack_write(call_id, sp + npops - 1, 0))
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _handle_precompile(self, fr: TxContext, step: GethExecStep,
                           nxt: GethExecStep | None):
        """ECRECOVER (0x01), IDENTITY (0x04), ECADD (0x06), ECMUL (0x07)
        called in-line (no frame descent): pops + fixed-shape input
        memory reads + output writes + bookkeeping + success push, with
        the semantic statement delegated to the Sig / Ecc / Copy
        circuits (reference evm_circuit/execution/precompiles/)."""
        op = step.op
        call_id = fr.call_id
        sp = STACK_BASE - len(step.stack)
        has_value = op == OpcodeId.CALL
        npops = 7 if has_value else 6
        vals = [step.stack[-1 - i] for i in range(npops)]
        addr = vals[1] & ((1 << 160) - 1)
        args_off, args_len, ret_off, ret_len = vals[npops - 4 : npops]
        success = nxt.stack[-1] if nxt is not None else 0
        assert success == 1, "failed precompile calls land later"
        data = bytes(step.memory[args_off : args_off + args_len]) \
            .ljust(args_len, b"\x00")

        names = {1: "ECRECOVER", 2: "SHA256", 4: "IDENTITY",
                 5: "MODEXP", 6: "ECADD", 7: "ECMUL"}
        in_fixed = {1: 128, 6: 128, 7: 96}
        out_fixed = {1: 32, 6: 64, 7: 64}
        if addr == 2:
            assert ret_len == 32, "sha256 needs retLen 32"
        if addr in in_fixed:
            assert args_len == in_fixed[addr], (
                f"precompile 0x{addr:x} needs exact-size args"
            )
            assert ret_len == out_fixed[addr], (
                f"precompile 0x{addr:x} needs exact-size return"
            )
        es = ExecStep(
            exec_state=names[addr], pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []
        for i, v in enumerate(vals):
            rws.append(self.rws.stack_read(call_id, sp + i, v))

        # compute the output + record the statement event
        if addr == 1:
            from ..circuits.sig import SigEvent
            from ..crypto import secp256k1 as secp
            from ..crypto.keccak import keccak256

            h, v = data[:32], int.from_bytes(data[32:64], "big")
            r = int.from_bytes(data[64:96], "big")
            s = int.from_bytes(data[96:128], "big")
            pub = secp.recover(h, r, s, v - 27)
            assert pub is not None, "unrecoverable sig lands later"
            pb = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
            out = b"\x00" * 12 + keccak256(pb)[12:]
            self.sig_events.append(SigEvent(
                msg_hash=int.from_bytes(h, "big"), r=r, s=s, pubkey=pub,
            ))
        elif addr == 2:
            import hashlib

            out = hashlib.sha256(data).digest()
            self.sha256_inputs.append(data)
        elif addr == 5:
            from ..circuits.modexp import ModExpEvent

            # variable operand lengths up to the reference cap
            # (MODEXP_SIZE_LIMIT=32, bus-mapping/src/precompile.rs:231;
            # the l2geth fork fails larger calls).  Scope: the caller
            # passes exactly 96+BL+EL+ML arg bytes and retLen == ML >= 1
            # (implicit zero-extension of a short region lands later).
            hdr = [int.from_bytes(data[i : i + 32], "big")
                   for i in (0, 32, 64)]
            if max(hdr) > 32:
                raise NotImplementedError(
                    "modexp operands beyond the 32-byte reference cap "
                    "(the reference circuit fails these calls)"
                )
            bl_, el_, ml_ = hdr
            if args_len != 96 + bl_ + el_ + ml_:
                raise NotImplementedError(
                    "modexp with implicitly zero-extended / over-long "
                    "args region lands later"
                )
            assert ml_ >= 1, "modexp with empty modulus output"
            assert ret_len == ml_, "modexp retLen must equal Mlen"
            b_ = int.from_bytes(data[96 : 96 + bl_], "big")
            e_ = int.from_bytes(data[96 + bl_ : 96 + bl_ + el_], "big")
            m_ = int.from_bytes(data[96 + bl_ + el_ :], "big")
            res = pow(b_, e_, m_) if m_ else 0
            out = res.to_bytes(ml_, "big")
            self.modexp_events.append(
                ModExpEvent(base=b_, exponent=e_, modulus=m_, result=res)
            )
        elif addr == 4:
            out = data[: min(args_len, ret_len)]
        else:
            from ..circuits.ecc import EcAddEvent, EcMulEvent
            from ..tracer.evm import _bn254_point

            if addr == 6:
                p = _bn254_point(data[:64])
                q_ = _bn254_point(data[64:128])
                from ..crypto.curve import host_g1_add

                r_pt = host_g1_add(p, q_)
                aff = lambda x: (0, 0) if x is None else x
                self.ecadd_events.append(
                    EcAddEvent(p=aff(p), q=aff(q_), r=aff(r_pt))
                )
            else:
                p = _bn254_point(data[:64])
                k = int.from_bytes(data[64:96], "big")
                from ..crypto.curve import host_g1_mul

                r_pt = host_g1_mul(p, k) if p and k else None
                aff = lambda x: (0, 0) if x is None else x
                self.ecmul_events.append(
                    EcMulEvent(p=aff(p), k=k, r=aff(r_pt))
                )
            r_aff = (0, 0) if r_pt is None else r_pt
            out = r_aff[0].to_bytes(32, "big") + r_aff[1].to_bytes(32, "big")

        if addr == 2:
            if args_len:
                self.copy_events.append(CopyEvent(
                    src_type="memory", src_id=call_id, src_addr=args_off,
                    dst_type="rlc", dst_id=0, dst_addr=0, length=args_len,
                    rw_counter_start=self.rws.counter + 1, bytes_=data,
                ))
                for j in range(args_len):
                    rws.append(
                        self.rws.memory_read(call_id, args_off + j, data[j])
                    )
            self.copy_events.append(CopyEvent(
                src_type="rlc", src_id=0, src_addr=0,
                dst_type="memory", dst_id=call_id, dst_addr=ret_off,
                length=32, rw_counter_start=self.rws.counter + 1,
                bytes_=out,
            ))
            for j, byte in enumerate(out):
                rws.append(self.rws.memory_write(call_id, ret_off + j, byte))
        elif addr == 4:
            la = min(args_len, ret_len)
            ev = CopyEvent(
                src_type="memory", src_id=call_id, src_addr=args_off,
                dst_type="memory", dst_id=call_id, dst_addr=ret_off,
                length=la, rw_counter_start=self.rws.counter + 1,
                bytes_=out,
            )
            for j, byte in enumerate(out):
                rws.append(self.rws.memory_read(call_id, args_off + j, byte))
                rws.append(self.rws.memory_write(call_id, ret_off + j, byte))
            if la:
                self.copy_events.append(ev)
        else:
            ilen = in_fixed.get(addr, args_len)
            self.copy_events.append(CopyEvent(
                src_type="memory", src_id=call_id, src_addr=args_off,
                dst_type="rlc", dst_id=0, dst_addr=0,
                length=ilen,
                rw_counter_start=self.rws.counter + 1, bytes_=data[:ilen],
            ))
            for j in range(ilen):
                rws.append(
                    self.rws.memory_read(call_id, args_off + j, data[j])
                )
            self.copy_events.append(CopyEvent(
                src_type="rlc", src_id=0, src_addr=0,
                dst_type="memory", dst_id=call_id, dst_addr=ret_off,
                length=len(out),
                rw_counter_start=self.rws.counter + 1, bytes_=out,
            ))
            for j, byte in enumerate(out):
                rws.append(self.rws.memory_write(call_id, ret_off + j, byte))
        CCF = CallContextField
        w = self.rws.call_context_write
        rws += [
            w(call_id, CCF.LastCalleeId, 0),
            w(call_id, CCF.LastCalleeReturnDataOffset, 0),
            w(call_id, CCF.LastCalleeReturnDataLength, len(out)),
        ]
        # precompile return data is not re-readable via RETURNDATACOPY
        # (no callee memory space to read from)
        fr.last_callee_id = 0
        fr.last_ret_off = 0
        fr.last_ret_data = b""
        rws.append(
            self.rws.stack_write(call_id, sp + npops - 1, success)
        )
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    def _handle_frame_end(self, fr: TxContext, parent: TxContext,
                          step: GethExecStep):
        """Nested STOP/RETURN/REVERT: copy return data into the caller's
        memory, restore the caller context, push the success flag
        (reference execution/return_revert.rs)."""
        op = step.op
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state="RET", pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=fr.call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=fr.tx_id, callee=fr.to_addr, code_hash=fr.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []
        success = int(op != OpcodeId.REVERT and not step.error)
        assert success or self._tx_log_count == fr.log_mark, (
            "persistence pre-scan must have gated LOGs in this doomed frame"
        )
        if op in (OpcodeId.RETURN, OpcodeId.REVERT):
            off, length = step.stack[-1], step.stack[-2]
            rws.append(self.rws.stack_read(fr.call_id, sp, off))
            rws.append(self.rws.stack_read(fr.call_id, sp + 1, length))
        else:
            off, length = 0, 0
        la = min(length, fr.ret_length)
        if la:
            data = bytes(step.memory[off : off + la]).ljust(la, b"\x00")
            ev = CopyEvent(
                src_type="memory", src_id=fr.call_id, src_addr=off,
                dst_type="memory", dst_id=parent.call_id,
                dst_addr=fr.ret_offset, length=la,
                rw_counter_start=self.rws.counter + 1, bytes_=data,
            )
            for j, byte in enumerate(data):
                rws.append(self.rws.memory_read(fr.call_id, off + j, byte))
                rws.append(
                    self.rws.memory_write(
                        parent.call_id, fr.ret_offset + j, byte
                    )
                )
            self.copy_events.append(ev)
        CCF = CallContextField
        r_ = self.rws.call_context_read
        rws += [
            r_(fr.call_id, CCF.CallerId, fr.caller_id),
            r_(fr.call_id, CCF.ReturnPc, fr.ret_pc),
            r_(fr.call_id, CCF.ReturnSp, fr.ret_sp),
            r_(fr.call_id, CCF.ParentCalleeAddress, fr.parent_callee),
            r_(fr.call_id, CCF.ParentCodeHash, fr.parent_code_hash),
            r_(fr.call_id, CCF.RetOffset, fr.ret_offset),
            r_(fr.call_id, CCF.RetLength, fr.ret_length),
            r_(fr.call_id, CCF.IsCreate, int(fr.is_create)),
        ]
        # record the callee's return data on the CALLER's context
        # (RETURNDATASIZE/RETURNDATACOPY read these back).  Successful
        # creates return NO data (the returned bytes are the deployed
        # code); reverting creates expose their revert data.
        full = bytes(step.memory[off : off + length]).ljust(length, b"\x00") \
            if op in (OpcodeId.RETURN, OpcodeId.REVERT) else b""
        if fr.is_create and success:
            bk_off, bk_len, bk_data = 0, 0, b""
        else:
            bk_off, bk_len, bk_data = off, length, full
        w_ = self.rws.call_context_write
        rws += [
            w_(parent.call_id, CCF.LastCalleeId, fr.call_id),
            w_(parent.call_id, CCF.LastCalleeReturnDataOffset, bk_off),
            w_(parent.call_id, CCF.LastCalleeReturnDataLength, bk_len),
        ]
        parent.last_callee_id = fr.call_id
        parent.last_ret_off = bk_off
        parent.last_ret_data = bk_data
        if fr.is_create:
            es.is_create_ret = True
            pushed = fr.to_addr if success else 0
        else:
            pushed = success
        rws.append(
            self.rws.stack_write(parent.call_id, fr.ret_sp, pushed)
        )
        if fr.is_create and success and op == OpcodeId.RETURN:
            # code deposit (reference execution/return_revert.rs create
            # path): the returned bytes become the created account's code
            from ..crypto.keccak import keccak256

            deployed = full
            # empty deploys normalize to the repo's 0-for-empty code-hash
            # convention so RETURN-with-size-0 and STOP agree (the
            # reference deposits keccak('') in both cases)
            dep_hash = (
                int.from_bytes(keccak256(deployed), "big") if deployed else 0
            )
            created = self._acct(fr.to_addr)
            prev_hash = created.code_hash
            rws.append(self.rws.account_write(
                fr.to_addr, AccountField.CodeHash, dep_hash, prev_hash
            ))
            self._tx_journal.append(("codehash", fr.to_addr, prev_hash))
            created.code_hash = dep_hash
            self._code_db[fr.to_addr] = deployed
            self._hashes[fr.to_addr] = dep_hash
            self.sha3_inputs.append(deployed)
        if not success:
            # undo this frame's reversible writes (storage / balances):
            # inverse writes restore the pre-frame values (reference
            # bus-mapping reversion groups, operation.rs:113).  Appended
            # LAST so the RET gadget's fixed bus indices stay stable.
            undo = self._undo_journal(fr.journal_mark)
            es.rev_count = len(undo)
            rws += undo
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)

    # ------------------------------------------------------------------
    def _scan_persistence(self, logs, tx_failed: bool) -> list[bool]:
        """Per-step persistence: True iff neither the step's own frame
        nor any enclosing frame (incl. the tx root) reverts or errors.
        Mirrors the main loop's frame push/pop rules exactly."""
        doomed = {0: bool(tx_failed)}
        stack = [0]
        chains: list[list[int]] = []
        nid = 1
        for i, step in enumerate(logs):
            assert step.depth == len(stack)
            nxt = logs[i + 1] if i + 1 < len(logs) else None
            chains.append(list(stack))
            if step.error is not None or step.op == OpcodeId.REVERT:
                doomed[stack[-1]] = True
            if step.error is not None and step.error != "revert":
                if len(stack) > 1:
                    stack.pop()
                continue
            op = step.op
            if (op.is_call or op.is_create) and nxt is not None \
                    and nxt.depth == step.depth + 1:
                doomed[nid] = False
                stack.append(nid)
                nid += 1
            elif len(stack) > 1 and (
                op in (OpcodeId.STOP, OpcodeId.RETURN, OpcodeId.REVERT)
                or (nxt is not None and nxt.depth == step.depth - 1)
            ):
                stack.pop()
        return [not any(doomed[f] for f in ch) for ch in chains]

    def _handle_step(self, ctx, step: GethExecStep, nxt: GethExecStep | None,
                     storage: dict):
        op = step.op
        call_id = ctx.call_id
        sp = STACK_BASE - len(step.stack)
        es = ExecStep(
            exec_state=op.name, pc=step.pc, op=op, gas=step.gas,
            mem_words=len(step.memory) // 32,
            gas_cost=step.gas_cost, call_id=call_id, stack_pointer=sp,
            rw_counter_start=self.rws.counter + 1, error=step.error,
            tx_id=ctx.tx_id, callee=ctx.to_addr, code_hash=ctx.code_hash,
            log_id=self._tx_log_count,
        )
        rws: list[Rw] = []

        def stack_val(n):  # n-th from top
            return step.stack[-1 - n]

        if op.is_dup:
            n = op - 0x7F
            v = stack_val(n - 1)
            rws.append(self.rws.stack_read(call_id, sp + n - 1, v))
            rws.append(self.rws.stack_write(call_id, sp - 1, v))
        elif op.is_swap:
            n = op - 0x8F
            top, deep = stack_val(0), stack_val(n)
            rws.append(self.rws.stack_read(call_id, sp, top))
            rws.append(self.rws.stack_read(call_id, sp + n, deep))
            rws.append(self.rws.stack_write(call_id, sp + n, top))
            rws.append(self.rws.stack_write(call_id, sp, deep))
        elif op == OpcodeId.MLOAD:
            addr = stack_val(0)
            rws.append(self.rws.stack_read(call_id, sp, addr))
            word = (nxt.stack[-1] if nxt else 0) if not step.error else 0
            wb = word.to_bytes(32, "big")
            for j in range(32):
                rws.append(self.rws.memory_read(call_id, addr + j, wb[j]))
            rws.append(self.rws.stack_write(call_id, sp, word))
        elif op == OpcodeId.MSTORE or op == OpcodeId.MSTORE8:
            addr, val = stack_val(0), stack_val(1)
            rws.append(self.rws.stack_read(call_id, sp, addr))
            rws.append(self.rws.stack_read(call_id, sp + 1, val))
            if op == OpcodeId.MSTORE:
                wb = val.to_bytes(32, "big")
                for j in range(32):
                    rws.append(self.rws.memory_write(call_id, addr + j, wb[j]))
            else:
                rws.append(self.rws.memory_write(call_id, addr, val & 0xFF))
        elif op == OpcodeId.SLOAD:
            key = stack_val(0)
            rws.append(self.rws.stack_read(call_id, sp, key))
            val = nxt.stack[-1] if nxt and not step.error else 0
            rws.append(
                self.rws.storage_read(
                    ctx.tx_id, ctx.to_addr, key, val,
                    storage.get((ctx.to_addr, key), 0),
                )
            )
            rws.append(self.rws.stack_write(call_id, sp, val))
        elif op == OpcodeId.SELFBALANCE:
            # Account.Balance read of the executing address (reference
            # bus-mapping opcodes/selfbalance.rs)
            val = nxt.stack[-1] if nxt and not step.error else 0
            rws.append(self._account_read_adopt(
                ctx.to_addr, AccountField.Balance, val
            ))
            rws.append(self.rws.stack_write(call_id, sp - 1, val))
        elif op in (OpcodeId.BALANCE, OpcodeId.EXTCODESIZE,
                    OpcodeId.EXTCODEHASH):
            # pop address; EIP-2929 warm write; Account field read; push
            # (reference bus-mapping opcodes/balance.rs, extcodesize.rs,
            # extcodehash.rs)
            addr_w = stack_val(0)
            addr = addr_w & ((1 << 160) - 1)
            rws.append(self.rws.stack_read(call_id, sp, addr_w))
            warm = addr in self._warm_addrs
            self._warm_addrs.add(addr)
            rws.append(self.rws.access_list_account_write(
                ctx.tx_id, addr, 1, int(warm)
            ))
            self._tx_journal.append(("warm", ctx.tx_id, addr, int(warm)))
            val = nxt.stack[-1] if nxt and not step.error else 0
            fld = {
                OpcodeId.BALANCE: AccountField.Balance,
                OpcodeId.EXTCODESIZE: AccountField.CodeSize,
                OpcodeId.EXTCODEHASH: AccountField.CodeHash,
            }[op]
            rws.append(self._account_read_adopt(addr, fld, val))
            rws.append(self.rws.stack_write(call_id, sp, val))
        elif op == OpcodeId.SSTORE:
            key, val = stack_val(0), stack_val(1)
            rws.append(self.rws.stack_read(call_id, sp, key))
            rws.append(self.rws.stack_read(call_id, sp + 1, val))
            prev = storage.get((ctx.to_addr, key), 0)
            rws.append(
                self.rws.storage_write(ctx.tx_id, ctx.to_addr, key, val, prev)
            )
            storage[(ctx.to_addr, key)] = val
            self._tx_journal.append(
                ("storage", ctx.tx_id, ctx.to_addr, key, prev, val)
            )
            ctx.sstore_count += 1
        elif op == OpcodeId.CALLDATALOAD:
            # stack offset pop, IsRoot + CallDataLength ctx reads, then:
            # root frames push straight from the TxTable-bound calldata;
            # NESTED frames also read CallDataOffset + CallerId and pull
            # each in-range byte from the CALLER's memory (reference
            # bus-mapping src/evm/opcodes/calldataload.rs, both paths)
            offset = stack_val(0)
            cdlen = len(ctx.calldata)
            rws.append(self.rws.stack_read(call_id, sp, offset))
            rws.append(
                self.rws.call_context_read(
                    call_id, CallContextField.IsRoot, int(ctx.is_root)
                )
            )
            rws.append(
                self.rws.call_context_read(
                    call_id, CallContextField.CallDataLength, cdlen
                )
            )
            if not ctx.is_root:
                rws.append(
                    self.rws.call_context_read(
                        call_id, CallContextField.CallDataOffset,
                        ctx.cd_offset,
                    )
                )
                rws.append(
                    self.rws.call_context_read(
                        call_id, CallContextField.CallerId, ctx.caller_id
                    )
                )
                m = min(32, max(0, cdlen - offset)) \
                    if offset < (1 << 32) else 0
                for j in range(m):
                    rws.append(self.rws.memory_read(
                        ctx.caller_id, ctx.cd_offset + offset + j,
                        ctx.calldata[offset + j],
                    ))
            word = nxt.stack[-1] if nxt and not step.error else 0
            rws.append(self.rws.stack_write(call_id, sp, word))
        elif op == OpcodeId.CALLDATACOPY:
            dst, src, ln = stack_val(0), stack_val(1), stack_val(2)
            rws.append(self.rws.stack_read(call_id, sp, dst))
            rws.append(self.rws.stack_read(call_id, sp + 1, src))
            rws.append(self.rws.stack_read(call_id, sp + 2, ln))
            cdlen = len(ctx.calldata)
            rws.append(
                self.rws.call_context_read(
                    call_id, CallContextField.IsRoot, int(ctx.is_root)
                )
            )
            rws.append(
                self.rws.call_context_read(
                    call_id, CallContextField.CallDataLength, cdlen
                )
            )
            # copies past the calldata end zero-pad the tail; the copy
            # event's src_addr is normalized to min(src, cdlen) and its
            # src_len declares the pad boundary (the circuit's monotone
            # pad + boundary bind, circuits/copy.py)
            m = min(ln, max(0, cdlen - src)) if src < (1 << 32) else 0
            if ctx.is_root:
                data = ctx.calldata[src : src + ln]
                chunk = bytes(data).ljust(ln, b"\x00")
                ev = CopyEvent(
                    src_type="calldata", src_id=ctx.tx_id,
                    src_addr=min(src, cdlen),
                    dst_type="memory", dst_id=call_id, dst_addr=dst,
                    length=ln, rw_counter_start=self.rws.counter + 1,
                    bytes_=chunk, src_len=cdlen,
                )
                for j, byte in enumerate(chunk):
                    rws.append(self.rws.memory_write(call_id, dst + j, byte))
                if ln:  # zero-length copies produce no event rows
                    self.copy_events.append(ev)
            else:
                # nested: the frame's calldata IS caller memory at
                # [cd_offset, cd_offset+cdlen) — a memory->memory copy
                # event from the caller's frame, padded past cdlen
                rws.append(
                    self.rws.call_context_read(
                        call_id, CallContextField.CallDataOffset,
                        ctx.cd_offset,
                    )
                )
                rws.append(
                    self.rws.call_context_read(
                        call_id, CallContextField.CallerId, ctx.caller_id
                    )
                )
                chunk = bytes(ctx.calldata[src : src + m]).ljust(ln, b"\x00")
                if ln:
                    ev = CopyEvent(
                        src_type="memory", src_id=ctx.caller_id,
                        src_addr=ctx.cd_offset + min(src, cdlen),
                        dst_type="memory", dst_id=call_id, dst_addr=dst,
                        length=ln, rw_counter_start=self.rws.counter + 1,
                        bytes_=chunk, src_len=ctx.cd_offset + cdlen,
                    )
                    for j, byte in enumerate(chunk):
                        if j < m:
                            rws.append(self.rws.memory_read(
                                ctx.caller_id, ctx.cd_offset + src + j, byte
                            ))
                        rws.append(self.rws.memory_write(
                            call_id, dst + j, byte
                        ))
                    self.copy_events.append(ev)
        elif op == OpcodeId.SHA3:
            # pops (offset, size); reads size memory bytes into a
            # memory->RLC copy event; pushes keccak(mem[off:off+size])
            # (reference bus-mapping src/evm/opcodes/sha3.rs)
            off, size = stack_val(0), stack_val(1)
            rws.append(self.rws.stack_read(call_id, sp, off))
            rws.append(self.rws.stack_read(call_id, sp + 1, size))
            data = bytes(step.memory[off : off + size]).ljust(size, b"\x00")
            ev = CopyEvent(
                src_type="memory", src_id=call_id, src_addr=off,
                dst_type="rlc", dst_id=0, dst_addr=0, length=size,
                rw_counter_start=self.rws.counter + 1, bytes_=data,
            )
            for j, byte in enumerate(data):
                rws.append(self.rws.memory_read(call_id, off + j, byte))
            if size:
                self.copy_events.append(ev)
            self.sha3_inputs.append(data)
            digest = nxt.stack[-1] if nxt and not step.error else 0
            rws.append(self.rws.stack_write(call_id, sp + 1, digest))
        elif op == OpcodeId.CODECOPY:
            # pops (dst, src, len); the executing code's bytes (zero-
            # padded past the end) land in memory
            dst, src_, ln = stack_val(0), stack_val(1), stack_val(2)
            rws.append(self.rws.stack_read(call_id, sp, dst))
            rws.append(self.rws.stack_read(call_id, sp + 1, src_))
            rws.append(self.rws.stack_read(call_id, sp + 2, ln))
            code = ctx.code
            chunk = bytes(code[src_ : src_ + ln]).ljust(ln, b"\x00")
            from ..types import Bytecode as _BC

            marks = _BC(code).is_code_marks()
            ev = CopyEvent(
                src_type="bytecode", src_id=ctx.code_hash, src_addr=src_,
                dst_type="memory", dst_id=call_id, dst_addr=dst,
                length=ln, rw_counter_start=self.rws.counter + 1,
                bytes_=chunk, src_len=len(code) if src_ < len(code) else src_,
                code_marks=bytes(
                    int(marks[src_ + j]) if src_ + j < len(code) else 0
                    for j in range(ln)
                ),
            )
            for j, byte in enumerate(chunk):
                rws.append(self.rws.memory_write(call_id, dst + j, byte))
            if ln:
                self.copy_events.append(ev)
        elif op == OpcodeId.EXTCODECOPY:
            # pops (addr, dst, src, len); EIP-2929 warm write; the
            # EXTERNAL account's code (zero-padded) lands in memory via a
            # bytecode->memory copy keyed by its code hash (reference
            # bus-mapping src/evm/opcodes/extcodecopy.rs)
            addr_w = stack_val(0)
            xaddr = addr_w & ((1 << 160) - 1)
            dst, src_, ln = stack_val(1), stack_val(2), stack_val(3)
            rws.append(self.rws.stack_read(call_id, sp, addr_w))
            rws.append(self.rws.stack_read(call_id, sp + 1, dst))
            rws.append(self.rws.stack_read(call_id, sp + 2, src_))
            rws.append(self.rws.stack_read(call_id, sp + 3, ln))
            warm = xaddr in self._warm_addrs
            self._warm_addrs.add(xaddr)
            rws.append(self.rws.access_list_account_write(
                ctx.tx_id, xaddr, 1, int(warm)
            ))
            self._tx_journal.append(("warm", ctx.tx_id, xaddr, int(warm)))
            xcode = self._code_db.get(xaddr, b"")
            xhash = self._hashes.get(xaddr, self._acct(xaddr).code_hash)
            rws.append(self._account_read_adopt(
                xaddr, AccountField.CodeHash, xhash
            ))
            chunk = bytes(xcode[src_: src_ + ln]).ljust(ln, b"\x00")
            from ..types import Bytecode as _BC

            marks = _BC(xcode).is_code_marks()
            ev = CopyEvent(
                src_type="bytecode", src_id=xhash, src_addr=src_,
                dst_type="memory", dst_id=call_id, dst_addr=dst,
                length=ln, rw_counter_start=self.rws.counter + 1,
                bytes_=chunk, src_len=len(xcode) if src_ < len(xcode) else src_,
                code_marks=bytes(
                    int(marks[src_ + j]) if src_ + j < len(xcode) else 0
                    for j in range(ln)
                ),
            )
            for j, byte in enumerate(chunk):
                rws.append(self.rws.memory_write(call_id, dst + j, byte))
            if ln:
                self.copy_events.append(ev)
        elif op == OpcodeId.RETURNDATACOPY:
            # pops (dst, src, len); reads the last callee's return data
            # from ITS memory, writes into this frame's memory
            # (reference bus-mapping src/evm/opcodes/returndatacopy.rs)
            dst, src, ln = stack_val(0), stack_val(1), stack_val(2)
            rws.append(self.rws.stack_read(call_id, sp, dst))
            rws.append(self.rws.stack_read(call_id, sp + 1, src))
            rws.append(self.rws.stack_read(call_id, sp + 2, ln))
            assert src + ln <= len(ctx.last_ret_data), "tracer enforces"
            CCF = CallContextField
            rws.append(self.rws.call_context_read(
                call_id, CCF.LastCalleeId, ctx.last_callee_id
            ))
            rws.append(self.rws.call_context_read(
                call_id, CCF.LastCalleeReturnDataOffset, ctx.last_ret_off
            ))
            rws.append(self.rws.call_context_read(
                call_id, CCF.LastCalleeReturnDataLength,
                len(ctx.last_ret_data),
            ))
            data = ctx.last_ret_data[src : src + ln]
            ev = CopyEvent(
                src_type="memory", src_id=ctx.last_callee_id,
                src_addr=ctx.last_ret_off + src,
                dst_type="memory", dst_id=call_id, dst_addr=dst,
                length=ln, rw_counter_start=self.rws.counter + 1,
                bytes_=data,
            )
            for j, byte in enumerate(data):
                rws.append(self.rws.memory_read(
                    ctx.last_callee_id, ctx.last_ret_off + src + j, byte
                ))
                rws.append(self.rws.memory_write(call_id, dst + j, byte))
            if ln:
                self.copy_events.append(ev)
        elif op == OpcodeId.EXP:
            base, exponent = stack_val(0), stack_val(1)
            rws.append(self.rws.stack_read(call_id, sp, base))
            rws.append(self.rws.stack_read(call_id, sp + 1, exponent))
            result = pow(base, exponent, M256)
            rws.append(self.rws.stack_write(call_id, sp + 1, result))
            steps: list[tuple[int, int, int]] = []
            calc = exp_by_squaring(base, exponent, steps)
            assert calc == result
            if steps:  # exponent >= 2: provable by the Exp circuit; the
                # EVM gadget handles exponent 0/1 arithmetically instead
                self.exp_events.append(
                    ExpEvent(
                        identifier=es.rw_counter_start, base=base,
                        exponent=exponent, exponentiation=result, steps=steps,
                    )
                )
        elif op in (OpcodeId.MULMOD, OpcodeId.ADDMOD):
            # pops a, b, n; pushes (a op b) mod n (0 when n == 0); the
            # modular identity is proven by the MulMod circuit, recorded
            # here as an event (reference execution/{mulmod,addmod}.rs)
            from ..circuits.mulmod import MulModEvent

            a, bb_, nn = stack_val(0), stack_val(1), stack_val(2)
            rws.append(self.rws.stack_read(call_id, sp, a))
            rws.append(self.rws.stack_read(call_id, sp + 1, bb_))
            rws.append(self.rws.stack_read(call_id, sp + 2, nn))
            result = nxt.stack[-1] if nxt and not step.error else 0
            rws.append(self.rws.stack_write(call_id, sp + 2, result))
            self.mulmod_events.append(
                MulModEvent(a=a, b=bb_, n=nn, r=result,
                            is_add=op == OpcodeId.ADDMOD)
            )
        elif op.is_log:
            # LOGn: pops (offset, size, topic_0..topic_{n-1}); TxLog rows
            # for address + topics; a memory->TxLog copy for the data
            # (reference bus-mapping src/evm/opcodes/logs.rs)
            from .rw import TxLogField

            ntop = op - 0xA0
            off, size = stack_val(0), stack_val(1)
            topics = [stack_val(2 + j) for j in range(ntop)]
            rws.append(self.rws.stack_read(call_id, sp, off))
            rws.append(self.rws.stack_read(call_id, sp + 1, size))
            for j, t in enumerate(topics):
                rws.append(self.rws.stack_read(call_id, sp + 2 + j, t))
            if not getattr(self, "_step_persistent", True):
                # doomed frame: pops + gas only — no TxLog writes, no
                # copy event, log counter unchanged (reference
                # bus-mapping skips TxLog ops when !call.is_persistent,
                # src/evm/opcodes/logs.rs)
                es.persistent = False
            else:
                log_id = self._tx_log_count + 1
                self._tx_log_count = log_id
                rws.append(
                    self.rws.tx_log_write(
                        ctx.tx_id, log_id, TxLogField.Address, 0,
                        ctx.to_addr
                    )
                )
                for j, t in enumerate(topics):
                    rws.append(
                        self.rws.tx_log_write(
                            ctx.tx_id, log_id, TxLogField.Topic, j, t
                        )
                    )
                data = bytes(step.memory[off : off + size]) \
                    .ljust(size, b"\x00")
                ev = CopyEvent(
                    src_type="memory", src_id=call_id, src_addr=off,
                    dst_type="txlog", dst_id=ctx.tx_id,
                    dst_addr=(int(TxLogField.Data) << 32) + (log_id << 48),
                    length=size, rw_counter_start=self.rws.counter + 1,
                    bytes_=data,
                )
                for j, byte in enumerate(data):
                    rws.append(self.rws.memory_read(call_id, off + j, byte))
                    rws.append(
                        self.rws.push(
                            is_write=True, tag=RwTag.TxLog, id=ctx.tx_id,
                            address=j + (int(TxLogField.Data) << 32)
                            + (log_id << 48),
                            value=byte,
                        )
                    )
                if size:
                    self.copy_events.append(ev)
        elif op in CONTEXT_OPS:
            # context opcodes: a fresh CallContext read at this step's own
            # rw counter (reference bus-mapping src/evm/opcodes/caller.rs
            # etc.) + the stack push; the state circuit ties all reads of
            # a (call_id, field) group together, and the EVM circuit's
            # BeginTx gadget anchors the group to the TxTable.
            field, getter = CONTEXT_OPS[op]
            v = getter(ctx)
            rws.append(self.rws.call_context_read(call_id, field, v))
            if nxt is not None and not step.error:
                new_sp = STACK_BASE - len(nxt.stack)
                rws.append(self.rws.stack_write(call_id, new_sp, nxt.stack[-1]))
        elif op.is_call or op.is_create:
            raise NotImplementedError("nested calls land with the call opcodes")
        else:
            # generic pure-stack opcode: pops reads + pushes writes
            for n in range(op.pops):
                rws.append(self.rws.stack_read(call_id, sp + n, stack_val(n)))
            if op.pushes and nxt is not None and not step.error:
                new_sp = STACK_BASE - len(nxt.stack)
                for n in range(op.pushes):
                    rws.append(
                        self.rws.stack_write(call_id, new_sp + n, nxt.stack[-1 - n])
                    )
        es.rw_indices = [r.rw_counter for r in rws]
        self.steps.append(es)
