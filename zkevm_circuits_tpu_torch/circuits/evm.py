"""EVM circuit — proves the execution trace step by step.

Equivalent of the reference's `zkevm-circuits/src/evm_circuit/` (SURVEY.md
§2.2 "EVM"): each execution step constrains its state transition
(pc / gas / rw_counter / stack_pointer) and its bus accesses against the
RW table.

Design (vs the reference's 141-col x 21-row step regions +
CellManager):
  * ONE row per execution step; every gadget's cells are dedicated
    columns on that row.  Witness assignment is a single columnar numpy
    pass over all steps (the reference's per-step `assign_exec_step`
    rayon loop becomes table construction, SURVEY.md §7.1).
  * Execution states are one-hot indicator columns; each gadget's
    constraints are gated by its indicator — so the quotient pass
    evaluates every gadget exactly once over the whole column, fully
    vectorized.
  * Bus accesses ride ONE logUp argument whose table is the RW table
    (provided as witness columns here, exactly like the reference's dev
    mode loads the RwTable; the SuperCircuit ties it to the State circuit
    by sharing the actual columns).

Gadget coverage: BeginTx/EndTx (internal states; call-context anchored to
the TxTable), PUSHn, POP, ADD, SUB (AddWords ripple-carry), MUL, DIV,
MOD (MulAddWords 512-bit limb products + carry banks, zero-divisor
semantics), LT, GT (LtWord borrow split), EQ, ISZERO (inverse witness),
NOT (bytewise complement), DUPn, SWAPn, PC, JUMPDEST, MLOAD, MSTORE
(per-byte memory bus), CALLER, ADDRESS, CALLVALUE, CALLDATASIZE (call-
context reads), SLOAD, SSTORE (storage bus rows keyed by the stack
word's RLC), STOP.  Stack values are byte-RLC words under the phase-0
challenge.

Port of zkevm_circuits_tpu/circuits/evm.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Expression, Fixed
from ..types.evm import OpcodeId, opcode_from_byte
from ..witness.builder import ExecStep, STACK_BASE
from ..witness.rw import AccountField, CallContextField, Rw, RwTag
from .state import rw_value_encoding, word_rlc

F = fr()

# implemented execution states, in gate order.  BEGIN_TX / END_TX are the
# internal states bracketing each transaction (reference
# evm_circuit/step.rs:39: BeginTx/EndTx), anchoring call-context values to
# the TxTable.
GADGETS = [
    "BEGIN_TX", "END_TX", "PUSH", "POP", "ADD", "SUB", "MUL", "DIV", "MOD",
    "LT", "GT", "EQ", "ISZERO", "NOT", "AND", "OR", "XOR", "BYTE", "SHL",
    "SHR", "MULMOD", "ADDMOD", "EXP", "CALLDATACOPY", "CALLDATALOAD",
    "SDIV", "SMOD", "SIGNEXTEND", "SAR", "RETURNDATASIZE",
    "RETURNDATACOPY", "CODECOPY",
    "ECRECOVER", "IDENTITY", "ECADD", "ECMUL", "SHA256", "MODEXP",
    "SHA3", "CALL", "CREATE", "RET", "RETURN", "REVERT", "LOG",
    "TIMESTAMP", "NUMBER", "COINBASE", "GASLIMIT", "CHAINID", "BASEFEE",
    "DIFFICULTY", "GASPRICE", "ORIGIN", "DUP", "SWAP",
    "SLT", "SGT", "GAS", "MSIZE", "CODESIZE", "BLOCKHASH", "EXTCODECOPY",
    "PC", "JUMP", "JUMPI", "JUMPDEST", "MLOAD", "MSTORE", "MSTORE8",
    "CALLER", "ADDRESS", "CALLVALUE", "CALLDATASIZE", "SLOAD", "SSTORE",
    "BALANCE", "SELFBALANCE", "EXTCODESIZE", "EXTCODEHASH",
    "ERR_STACK", "ERR_OOG", "ERR_JUMP", "ERR_RDOOB",
    "ERR_WRITE_PROT", "ERR_INVALID_OP", "ERR_OOG_DYN",
    "STOP",
]

# gadget -> opcode byte, for the bytecode-table opcode binding.  PUSH /
# DUP / SWAP are families: their byte is the base + the length/depth
# column (handled in configure).  BEGIN_TX / END_TX / STOP are excluded
# (internal states; STOP can also be the implicit stop past code end,
# reference execution/stop.rs checks pc >= code length instead).
OPCODE_BYTE = {
    g: int(OpcodeId[g]) for g in GADGETS
    if g not in ("BEGIN_TX", "END_TX", "STOP", "PUSH", "DUP", "SWAP",
                 "CALL", "CREATE", "RET", "LOG", "ECRECOVER", "IDENTITY",
                 "ECADD", "ECMUL", "SHA256", "MODEXP", "ERR_STACK",
                 "ERR_OOG", "ERR_JUMP", "ERR_RDOOB", "ERR_WRITE_PROT",
                 "ERR_INVALID_OP", "ERR_OOG_DYN")
}


@dataclasses.dataclass
class EvmParams:
    target_steps: int = 0  # 0 => usable rows
    rw_target: int = 0


class EvmCircuit(Circuit):
    """Standalone EVM circuit over (steps, rws) witness.

    `steps`: list of ExecStep from the builder (only implemented opcodes).
    `rws`: the RW records the steps reference (chronological by counter).
    """

    def __init__(self, steps: list[ExecStep], rws: list[Rw],
                 params: EvmParams | None = None, block_number: int = 1):
        self.steps = list(steps)
        self.rw_by_counter = {r.rw_counter: r for r in rws}
        self.params = params or EvmParams()
        # current block number (BLOCKHASH validity window; bound to the
        # BlockTable's Number row when composed)
        self.block_number = block_number

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, rw_table=None, challenge=None,
                  exp_table=None, copy_table=None, tx_table=None,
                  bytecode_table=None, mulmod_table=None, keccak_table=None,
                  block_table=None, sig_table=None, ecc_table=None,
                  sha256_table=None, modexp_table=None,
                  bytecode_len_table=None, copy_bound_table=None):
        """`rw_table`: optional 8 expressions (rw_counter, is_write, tag,
        id, address, field_tag, storage_key_rlc, value) — the SuperCircuit
        passes the State circuit's recomposed columns; standalone mode
        allocates its own table.
        `challenge`: optional shared word-RLC challenge.
        `exp_table` / `copy_table`: the Exp/Copy circuits' exposed tables;
        the EXP / CALLDATACOPY gadgets are only usable when given (their
        steps are rejected at synthesis otherwise).
        `tx_table`: the Tx circuit's (tx_id, tag, index, value) exprs —
        when given, the BEGIN_TX gadget binds the call context (callee,
        caller, value, calldata length) to the TxTable (reference
        execution/begin_tx.rs lookups); standalone mode leaves the
        context anchored only by state-circuit consistency (dev mode).
        `bytecode_table`: the Bytecode circuit's (is_enabled,
        code_hash_rlc, index, value, is_code) exprs — when given, every
        opcode step is bound to its bytecode byte, PUSH immediates are
        read from the code, and JUMP/JUMPI destinations must be is_code
        JUMPDEST bytes (reference execution/push.rs, jump.rs,
        jumpi.rs)."""
        self.standalone = rw_table is None
        self.exp_table = exp_table
        self.copy_table = copy_table
        self.copy_bound_table = copy_bound_table
        self.tx_table = tx_table
        self.bytecode_table = bytecode_table
        self.bytecode_len_table = bytecode_len_table
        self.mulmod_table = mulmod_table
        self.keccak_table = keccak_table
        self.block_table = block_table
        self.sig_table = sig_table
        self.ecc_table = ecc_table
        self.sha256_table = sha256_table
        self.modexp_table = modexp_table
        self.q_step = cs.fixed_column()
        if self.standalone:
            self.q_rw = cs.fixed_column()

        # step columns
        self.c_ind = {g: cs.advice_column() for g in GADGETS}
        self.c_pc = cs.advice_column()
        self.c_gas_cost = cs.advice_column()
        self.c_gas_left = cs.advice_column()  # gas remaining BEFORE the step
        self.c_gas_aux = cs.advice_column()  # gas helper (PUSH0 inverse etc.)
        self.c_gas_limit = cs.advice_column()  # tx gas limit (carried)
        self.c_cum_gas = cs.advice_column()  # block-cumulative gas used
        self.q_first = cs.fixed_column()  # 1 on row 0
        self.c_mw = cs.advice_column()  # memory words BEFORE the step
        # memory-expansion gas cells (reference memory_gadget.rs):
        # [m, rem, e, d0..d3, t_new, s0, s1, t_old, so0, so1] for the
        # MLOAD family; the dynamic-gas family (copies/SHA3/LOG/RETURN)
        # reuses 0..12 and adds [nz, size_inv, mw', wcnt, wrem] in 13..17
        # (one-hot rows are disjoint, so the banks share cells)
        self.c_gx = [cs.advice_column() for _ in range(18)]
        self.c_rwc = cs.advice_column()  # rw_counter at step start
        self.c_sp = cs.advice_column()  # stack pointer (1024 = empty)
        self.c_call_id = cs.advice_column()
        self.c_tx_id = cs.advice_column()
        self.c_callee = cs.advice_column()  # executing contract (raw addr)
        self.c_push_len = cs.advice_column()  # for PUSHn: n (1..32)
        self.c_depth_n = cs.advice_column()  # for DUPn/SWAPn: n
        self.c_val_a = cs.advice_column(phase=1)  # operand / result RLCs
        self.c_val_b = cs.advice_column(phase=1)
        self.c_val_c = cs.advice_column(phase=1)
        # word gadget cells (reference math_gadget/{add_words,mul_add_words,
        # lt_word}.rs): byte decompositions of up to four words + a carry
        # bank whose meaning is per-gadget (ADD/SUB: 32 ripple carry bits;
        # MUL/DIV/MOD: 9+9 carry bytes + borrow bit; LT/GT: borrow bit)
        self.c_bytes_a = [cs.advice_column() for _ in range(32)]
        self.c_bytes_b = [cs.advice_column() for _ in range(32)]
        self.c_bytes_c = [cs.advice_column() for _ in range(32)]
        self.c_bytes_d = [cs.advice_column() for _ in range(32)]
        self.c_bytes_e = [cs.advice_column() for _ in range(32)]  # SHR diff
        self.c_bytes_f = [cs.advice_column() for _ in range(32)]  # SDIV rem
        self.c_bytes_g = [cs.advice_column() for _ in range(32)]  # SDIV diff
        self.c_carry = [cs.advice_column() for _ in range(32)]
        # code-hash RLC of the executing bytecode (fold of digest bytes
        # under r, matching BytecodeCircuit's hash encoding); carried
        # across a call frame like callee
        self.c_code_hash = cs.advice_column(phase=1)
        # per-tx log counter (logs emitted BEFORE this step)
        self.c_log_id = cs.advice_column()
        self.c_inv = cs.advice_column(phase=1)  # IsZero inverse witness
        self.c_inv2 = cs.advice_column(phase=1)  # second inverse (EXP/CDC)
        self.c_ez = cs.advice_column()  # EXP: exponent==0; CDC: length==0
        self.c_eo = cs.advice_column()  # EXP: exponent==1
        # memory-bus cells: the word crossing memory (big-endian byte j ->
        # address addr+j) + a 4-byte decomposition of the address word
        self.c_mem = [cs.advice_column() for _ in range(32)]
        self.c_addr = [cs.advice_column() for _ in range(4)]
        self.tbl_byte = cs.fixed_column()
        # nibble-pair bitwise tables: row i < 256 encodes the pair
        # (x, y) = (i >> 4, i & 15); tbl_byte doubles as the pair key
        # (reference FixedTableTag::BitwiseAnd/Or/Xor, scaled to nibbles so
        # the table fits any domain >= 256 instead of 2^16 rows)
        self.tbl_and = cs.fixed_column()
        self.tbl_or = cs.fixed_column()
        self.tbl_xor = cs.fixed_column()
        # pow2 table: row s < 256 holds the 128-bit halves of 2^s; the
        # 0/1 selector makes the gated-off (all-zero) input tuple a valid
        # row — unlike the byte/bitwise tables, pow2 has no natural zero
        # row (2^0 = 1)
        # opcode-properties table: row i < 256 holds (pops, pushes,
        # constant_gas) of opcode byte i (tbl_byte is the key column) —
        # the reference's responsible-opcode/gas fixed tables
        # (evm_circuit/table.rs FixedTableTag), backing the error states
        self.tbl_op_pops = cs.fixed_column()
        self.tbl_op_pushes = cs.fixed_column()
        self.tbl_op_gas = cs.fixed_column()
        # 1 for undefined opcode bytes (+ 0xFE, the designated INVALID) —
        # the reference's FixedTableTag::ResponsibleOpcode rows for
        # ErrorInvalidOpcode (evm_circuit/execution/error_invalid_opcode.rs)
        self.tbl_op_invalid = cs.fixed_column()
        self.tbl_sel256 = cs.fixed_column()
        self.tbl_pow2_lo = cs.fixed_column()
        self.tbl_pow2_hi = cs.fixed_column()
        # keccak pad-power table: row p-1 (p in 1..136) carries
        # (p, r^p, r^(p-1) + 128) — r^p bridges a message RLC to the
        # padded-message RLC the KeccakTable commits to:
        #   acc_padded = acc_msg * r^p + pad_rlc(p),
        #   pad_rlc(p) = 1*r^(p-1) + 0x80  (0x81 when p == 1: same byte).
        # The columns are phase-1 advice chained off the challenge.
        self.q_padt = cs.fixed_column()
        self.q_padt0 = cs.fixed_column()
        self.c_rp = cs.advice_column(phase=1)
        self.c_prlc = cs.advice_column(phase=1)
        # SHA3 gadget phase-1 cells: message RLC + its pad-table reads
        self.c_acc_m = cs.advice_column(phase=1)
        self.c_rpl = cs.advice_column(phase=1)
        self.c_prl = cs.advice_column(phase=1)

        if self.standalone:
            # in-circuit RW table columns (the SuperCircuit points these
            # lookups at the State circuit's columns instead)
            self.t_rwc = cs.advice_column()
            self.t_is_write = cs.advice_column()
            self.t_tag = cs.advice_column()
            self.t_id = cs.advice_column()
            self.t_addr = cs.advice_column()
            self.t_field = cs.advice_column()
            self.t_key = cs.advice_column(phase=1)
            self.t_val = cs.advice_column(phase=1)

        self.r_word = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )

        q = Fixed(self.q_step)
        ind = {g: Advice(c) for g, c in self.c_ind.items()}
        pc, pc_n = Advice(self.c_pc), Advice(self.c_pc, 1)
        rwc, rwc_n = Advice(self.c_rwc), Advice(self.c_rwc, 1)
        sp, sp_n = Advice(self.c_sp), Advice(self.c_sp, 1)
        plen = Advice(self.c_push_len)
        va, vb, vc = (
            Advice(self.c_val_a), Advice(self.c_val_b), Advice(self.c_val_c)
        )
        q_n = Fixed(self.q_step, 1)  # next row is still a step

        # indicators boolean + exactly one active per step row
        sum_ind: Expression | None = None
        for g, e in ind.items():
            cs.create_gate(f"ind {g} bool", q * e * (e - 1))
            sum_ind = e if sum_ind is None else sum_ind + e
        cs.create_gate("one gadget per step", q * (sum_ind - 1))

        def transition(indicator, d_pc, d_rwc, d_sp):
            """Common state-transition constraints, gated to rows whose
            successor is also a step row (the last step ends the chain)."""
            gate = q * q_n * indicator
            cs.create_gate("pc step", gate * (pc_n - pc - d_pc))
            cs.create_gate("rwc step", gate * (rwc_n - rwc - d_rwc))
            cs.create_gate("sp step", gate * (sp_n - sp - d_sp))

        # PUSH: writes one stack value (va) at sp-1; pc += 1 + plen
        gate_push = q * q_n * ind["PUSH"]
        cs.create_gate("PUSH pc", gate_push * (pc_n - pc - 1 - plen))
        cs.create_gate("PUSH rwc", gate_push * (rwc_n - rwc - 1))
        cs.create_gate("PUSH sp", gate_push * (sp_n - sp + 1))
        # POP: reads one value; sp += 1, rwc += 1, pc += 1
        transition(ind["POP"], 1, 1, 1)
        # binary word ops: read two, write one; sp += 1, rwc += 3, pc += 1
        for g in ("ADD", "SUB", "MUL", "DIV", "MOD", "SDIV", "SMOD",
                  "SIGNEXTEND", "SAR", "LT", "GT", "EQ", "EXP",
                  "AND", "OR", "XOR", "BYTE", "SHL", "SHR"):
            transition(ind[g], 1, 3, 1)
        # unary word ops: read one, write one; sp 0, rwc += 2, pc += 1
        transition(ind["ISZERO"], 1, 2, 0)
        transition(ind["NOT"], 1, 2, 0)
        # DUPn: 1 read + 1 write; sp -= 1, rwc += 2, pc += 1
        transition(ind["DUP"], 1, 2, -1)
        # SWAPn: 2 reads + 2 writes; sp unchanged, rwc += 4, pc += 1
        transition(ind["SWAP"], 1, 4, 0)
        # PC: pushes the pc value; sp -= 1, rwc += 1
        transition(ind["PC"], 1, 1, -1)
        # PC semantics: the pushed word equals pc (< 2^16 here => its RLC
        # is pc_lo + r*pc_hi; bind bytes via the shared byte cells)
        gpc = q * ind["PC"]
        cs.create_gate(
            "PC value",
            gpc * (Advice(self.c_bytes_a[0])
                   + 256 * Advice(self.c_bytes_a[1]) - pc),
        )
        cs.create_gate(
            "PC rlc",
            gpc * (Advice(self.c_bytes_a[0])
                   + self.r_word * Advice(self.c_bytes_a[1]) - va),
        )
        # JUMPDEST: no-op; pc += 1
        transition(ind["JUMPDEST"], 1, 0, 0)
        # JUMP: pop dest; pc_next = dest (4-byte c_addr decomposition);
        # dest must be an is_code JUMPDEST byte (lookup below)
        jdest4 = [Advice(c) for c in self.c_addr]
        jdest_int = (jdest4[0] + jdest4[1] * 256 + jdest4[2] * 65536
                     + jdest4[3] * 16777216)
        jdest_rlc = (jdest4[0] + jdest4[1] * self.r_word
                     + jdest4[2] * self.r_word * self.r_word
                     + jdest4[3] * self.r_word * self.r_word * self.r_word)
        gj = q * ind["JUMP"]
        gjn = q * q_n * ind["JUMP"]
        cs.create_gate("JUMP dest rlc", gj * (jdest_rlc - va))
        cs.create_gate("JUMP pc", gjn * (pc_n - jdest_int))
        cs.create_gate("JUMP rwc", gjn * (rwc_n - rwc - 1))
        cs.create_gate("JUMP sp", gjn * (sp_n - sp - 1))
        # JUMPI: pop dest + cond; branch flag b = (cond != 0) via the
        # inv2 inverse witness; pc_next = b ? dest : pc + 1
        gji = q * ind["JUMPI"]
        gjin = q * q_n * ind["JUMPI"]
        jb = Advice(self.c_eo)
        jinv = Advice(self.c_inv2)
        cs.create_gate("JUMPI b bool", gji * jb * (jb - 1))
        cs.create_gate("JUMPI b def", gji * (vb * jinv - jb))
        cs.create_gate("JUMPI b kill", gji * vb * (1 - jb))
        cs.create_gate("JUMPI dest rlc", gji * (jdest_rlc - va))
        cs.create_gate(
            "JUMPI pc",
            gjin * (pc_n - jb * jdest_int - (1 - jb) * (pc + 1)),
        )
        cs.create_gate("JUMPI rwc", gjin * (rwc_n - rwc - 2))
        cs.create_gate("JUMPI sp", gjin * (sp_n - sp - 2))
        # MLOAD: read addr, read 32 mem bytes, write word; sp 0, rwc += 34
        transition(ind["MLOAD"], 1, 34, 0)
        # MSTORE: read addr, read value, write 32 mem bytes; sp += 2
        transition(ind["MSTORE"], 1, 34, 2)
        # MSTORE8: read addr, read value, write 1 mem byte; sp += 2
        transition(ind["MSTORE8"], 1, 3, 2)
        # MULMOD/ADDMOD: 3 pops + 1 push; sp += 2, rwc += 4
        transition(ind["MULMOD"], 1, 4, 2)
        transition(ind["ADDMOD"], 1, 4, 2)
        # CALLDATALOAD transitions live in its gadget section (the rwc
        # delta depends on the is_root flag + in-range byte count)
        # context reads: 1 ctx read + 1 stack push; sp -= 1, rwc += 2
        for g in ("CALLER", "ADDRESS", "CALLVALUE", "CALLDATASIZE"):
            transition(ind[g], 1, 2, -1)
        # block/tx context pushes: 1 stack write only
        for g in ("TIMESTAMP", "NUMBER", "COINBASE", "GASLIMIT", "CHAINID",
                  "BASEFEE", "DIFFICULTY", "GASPRICE", "ORIGIN"):
            transition(ind[g], 1, 1, -1)
        # SLOAD: key pop + storage read + value push; sp 0, rwc += 3
        transition(ind["SLOAD"], 1, 3, 0)
        # account opcodes (reference execution/balance.rs, extcodesize.rs,
        # extcodehash.rs, selfbalance.rs)
        transition(ind["SELFBALANCE"], 1, 2, -1)
        for g in ("BALANCE", "EXTCODESIZE", "EXTCODEHASH"):
            transition(ind[g], 1, 4, 0)
        # SSTORE: key + value pops + storage write; sp += 2, rwc += 3
        transition(ind["SSTORE"], 1, 3, 2)
        # BEGIN_TX: 6 ctx reads; next row starts at pc 0, empty stack
        txid, txid_n = Advice(self.c_tx_id), Advice(self.c_tx_id, 1)
        callee, callee_n = Advice(self.c_callee), Advice(self.c_callee, 1)
        cid_n = Advice(self.c_call_id, 1)
        bt, bt_n = ind["BEGIN_TX"], Advice(self.c_ind["BEGIN_TX"], 1)
        et = ind["END_TX"]
        gbt = q * bt
        cs.create_gate("BEGIN_TX pc0", gbt * pc)
        cs.create_gate("BEGIN_TX sp empty", gbt * (sp - STACK_BASE))
        # root frames: call_id == tx_id (nested calls land with CALL*)
        cs.create_gate("BEGIN_TX cid", gbt * (Advice(self.c_call_id) - txid))
        # 6 ctx reads + 2 access-list warms + nonce bump + fee purchase +
        # value-transfer pair + callee code-hash read, plus the EIP-2930
        # prewarm rows (count in c_gas_aux, anchored to the TxTable's
        # AccessListRows commitment below) — execution/begin_tx.rs.
        # STAGED: the prewarm rows are bound by COUNT + aggregate gas
        # only; the per-entry addresses/keys of the TxAccessListAccount
        # (Storage) rws are not yet tied to the tx's declared access list
        # (the reference binds them via an access-list copy event,
        # copy_circuit.rs CopyDataType::AccessListAddresses).  Exact
        # per-entry binding lands with the access-list copy kind; until
        # the AL value_prev gas binding lands this is latent (warm/cold
        # gas is itself membership-only above).
        gate_bt_n = q * q_n * bt
        al_n_cell = Advice(self.c_gas_aux)
        cs.create_gate("BEGIN_TX pc step", gate_bt_n * (pc_n - pc))
        cs.create_gate(
            "BEGIN_TX rwc step", gate_bt_n * (rwc_n - rwc - 13 - al_n_cell)
        )
        cs.create_gate("BEGIN_TX sp step", gate_bt_n * (sp_n - sp))
        # END_TX: IsSuccess read + TxRefund + caller gas refund + coinbase
        # reward, plus rev reversion writes on failed txs (the count cell
        # c_gas_aux; exact binding lands with the reversible-write counter)
        get_n = q * q_n * et
        rev_e = Advice(self.c_gas_aux)
        cs.create_gate("END_TX pc", get_n * (pc_n - pc))
        cs.create_gate("END_TX sp", get_n * (sp_n - sp))
        cs.create_gate(
            "END_TX rwc", get_n * (rwc_n - rwc - 7 - rev_e)
        )
        # context continuity: tx_id / callee / call_id carry over unless
        # the NEXT row begins a new transaction or THIS row switches call
        # frames (CALL descends, RET returns).  A no-descend CALL
        # (codeless callee, flag carry[25]) does NOT switch frames, so
        # continuity applies to it.
        g_cont = q * q_n * (1 - bt_n)
        fnd_e = Advice(self.c_carry[25]) + Advice(self.c_carry[26])
        g_frame = g_cont * (
            1 - ind["CALL"] * (1 - fnd_e) - ind["CREATE"] - ind["RET"]
        )
        cs.create_gate("tx id continuity", g_cont * (txid_n - txid))
        cs.create_gate("callee continuity", g_frame * (callee_n - callee))
        cs.create_gate(
            "call id continuity", g_frame * (cid_n - Advice(self.c_call_id))
        )
        chash = Advice(self.c_code_hash)
        chash_n = Advice(self.c_code_hash, 1)
        cs.create_gate(
            "code hash continuity", g_frame * (chash_n - chash)
        )
        # consecutive transactions: END_TX -> BEGIN_TX increments tx_id
        cs.create_gate(
            "next tx id", q * q_n * et * bt_n * (txid_n - txid - 1)
        )
        # STOP: terminal — no transition constraints

        # ---- gas accounting (reference evm_circuit/step.rs gas_left
        # transition + per-gadget gas_cost, execution/*.rs) --------------
        gas_e, gas_n = Advice(self.c_gas_left), Advice(self.c_gas_left, 1)
        cost_e = Advice(self.c_gas_cost)
        # universal chain: next gas = gas - cost.  Excluded transitions:
        # into a new tx (BEGIN_TX resets to the next tx's limit) and out
        # of frame switches (CALL allocates callee gas, RET restores the
        # caller's — their exact 63/64ths gas rules land with the account
        # state machine work).
        g_gaschain = q * q_n * (1 - bt_n) \
            * (1 - ind["CALL"] - ind["CREATE"] - ind["RET"])
        cs.create_gate("gas chain", g_gaschain * (gas_n - gas_e + cost_e))
        # tx gas limit: pinned at BEGIN_TX to the tx's opening gas, then
        # carried to END_TX — with the refund counter this yields the
        # tx's gas_used for the TxReceipt cumulative chain (reference
        # execution/end_tx.rs + TxReceiptFieldTag, table.rs:503)
        lim_e = Advice(self.c_gas_limit)
        lim_n = Advice(self.c_gas_limit, 1)
        cum_e = Advice(self.c_cum_gas)
        cum_n = Advice(self.c_cum_gas, 1)
        refund_e = Advice(self.c_ez)
        cs.create_gate("gas limit pin", q * bt * (lim_e - gas_e))
        cs.create_gate(
            "gas limit carry", q * q_n * (1 - bt_n) * (lim_n - lim_e)
        )
        used_e = lim_e - gas_e - refund_e
        cs.create_gate("cum gas first", Fixed(self.q_first) * cum_e)
        cs.create_gate(
            "cum gas step", q * q_n * (cum_n - cum_e - et * used_e)
        )
        # constant-cost opcodes (reference eth-types GasCost constants;
        # execution/error_oog_constant.rs pairs these with OOG checks)
        GAS_CONST = {
            "ADD": 3, "SUB": 3, "LT": 3, "GT": 3, "EQ": 3, "ISZERO": 3,
            "NOT": 3, "AND": 3, "OR": 3, "XOR": 3, "BYTE": 3, "SHL": 3,
            "SHR": 3, "CALLDATALOAD": 3, "MUL": 5, "DIV": 5, "MOD": 5,
            "SDIV": 5, "SMOD": 5, "SIGNEXTEND": 5, "SAR": 3, "ADDMOD": 8,
            "MULMOD": 8, "POP": 2, "PC": 2, "JUMPDEST": 1, "JUMP": 8,
            "JUMPI": 10, "DUP": 3, "SWAP": 3, "CALLER": 2, "ADDRESS": 2,
            "CALLVALUE": 2, "CALLDATASIZE": 2, "RETURNDATASIZE": 2,
            "TIMESTAMP": 2, "NUMBER": 2, "COINBASE": 2, "GASLIMIT": 2,
            "CHAINID": 2, "BASEFEE": 2, "DIFFICULTY": 2, "GASPRICE": 2,
            "ORIGIN": 2, "STOP": 0, "END_TX": 0, "SELFBALANCE": 5,
            "SLT": 3, "SGT": 3, "GAS": 2, "MSIZE": 2, "CODESIZE": 2,
            "BLOCKHASH": 20,
        }
        for gname, c0 in GAS_CONST.items():
            cs.create_gate(f"{gname} gas", q * ind[gname] * (cost_e - c0))
        # PUSH: 3 gas, except PUSH0 (immediate length 0) costs 2.  With
        # z := 3 - cost: z boolean, z = (plen == 0) via the inverse in
        # c_gas_aux (IsZero pattern, reference gadgets is_zero.rs)
        z_p = 3 - cost_e
        inv_p = Advice(self.c_gas_aux)
        g_pu = q * ind["PUSH"]
        cs.create_gate("PUSH gas bool", g_pu * z_p * (z_p - 1))
        cs.create_gate("PUSH gas zdef", g_pu * (plen * inv_p - (1 - z_p)))
        cs.create_gate("PUSH gas zkill", g_pu * z_p * plen)
        # EIP-2929 account access: warm 100 / cold 2600 (membership until
        # the AL value_prev binding lands)
        for gname in ("BALANCE", "EXTCODESIZE", "EXTCODEHASH"):
            cs.create_gate(
                f"{gname} gas",
                q * ind[gname] * (cost_e - 100) * (cost_e - 2600),
            )
        # SLOAD: warm 100 / cold 2100 (EIP-2929; exact warm/cold binding
        # lands with TxAccessList rows — membership constrains the claim
        # to the legal set meanwhile)
        cs.create_gate(
            "SLOAD gas", q * ind["SLOAD"] * (cost_e - 100) * (cost_e - 2100)
        )
        # SSTORE: {no-op 100, reset 2900, set 20000} x {+0 warm, +2100 cold}
        # (EIP-2929 + EIP-3529 values)
        g_ss = q * ind["SSTORE"]
        poly_ss = None
        for v in (100, 2900, 20000, 2200, 5000, 22100):
            term = cost_e - v
            poly_ss = term if poly_ss is None else poly_ss * term
        cs.create_gate("SSTORE gas", g_ss * poly_ss)

        # ---- memory-expansion gas (reference memory_gadget.rs
        # MemoryExpansionGadget): MLOAD/MSTORE/MSTORE8 track the memory
        # word size and charge 3 + 3*(mw' - mw) + (mw'^2 - mw^2)/512 -----
        mw_e, mw_n = Advice(self.c_mw), Advice(self.c_mw, 1)
        gx = [Advice(c) for c in self.c_gx]
        (m_e, rem_e, e_fl, d0, d1, d2, d3, t_new, s0, s1,
         t_old, so0, so1) = gx[:13]
        mem_ops = ind["MLOAD"] + ind["MSTORE"] + ind["MSTORE8"]
        g3 = q * mem_ops
        g3n = q * q_n * mem_ops
        width = 32 * (ind["MLOAD"] + ind["MSTORE"]) + ind["MSTORE8"]
        addr_e = None
        for i in range(4):
            term = Advice(self.c_addr[i]) * (1 << (8 * i))
            addr_e = term if addr_e is None else addr_e + term
        # m = ceil((addr + width) / 32): 32m = addr + width + rem, rem < 32
        cs.create_gate("memgas m def",
                       g3 * (32 * m_e - addr_e - width - rem_e))
        # mw' = max(mw, m): flag e + ranged distance d
        d_e = d0 + 256 * d1 + 65536 * d2 + 16777216 * d3
        cs.create_gate("memgas e bool", g3 * e_fl * (e_fl - 1))
        cs.create_gate("memgas next hi", g3n * e_fl * (mw_n - m_e))
        cs.create_gate("memgas next lo", g3n * (1 - e_fl) * (mw_n - mw_e))
        cs.create_gate(
            "memgas order",
            g3 * (e_fl * (m_e - mw_e - d_e)
                  + (1 - e_fl) * (mw_e - m_e - 1 - d_e)),
        )
        # quadratic terms: mw^2 = 512 t + s, s < 512 (byte + bit)
        cs.create_gate("memgas s1 bool", g3 * s1 * (s1 - 1))
        cs.create_gate("memgas so1 bool", g3 * so1 * (so1 - 1))
        cs.create_gate(
            "memgas quad new",
            g3n * (mw_n * mw_n - 512 * t_new - s0 - 256 * s1),
        )
        cs.create_gate(
            "memgas quad old",
            g3 * (mw_e * mw_e - 512 * t_old - so0 - 256 * so1),
        )
        cs.create_gate(
            "memgas cost",
            g3n * (cost_e - 3 - 3 * (mw_n - mw_e) - (t_new - t_old)),
        )
        # memory size continuity: carries across steps except memory-
        # touching ops (their own rules; the not-yet-constrained movers
        # keep witness tracking only) and frame switches / tx boundaries
        movers = (mem_ops + ind["SHA3"] + ind["CALLDATACOPY"]
                  + ind["CODECOPY"] + ind["RETURNDATACOPY"]
                  + ind["EXTCODECOPY"] + ind["RETURN"]
                  + ind["REVERT"] + ind["LOG"] + ind["CALL"]
                  + ind["CREATE"] + ind["RET"]
                  + ind["ECRECOVER"] + ind["IDENTITY"] + ind["ECADD"]
                  + ind["ECMUL"] + ind["SHA256"] + ind["MODEXP"])
        cs.create_gate(
            "mw continuity",
            q * q_n * (1 - bt_n) * (1 - movers) * (mw_n - mw_e),
        )
        # a fresh frame starts with empty memory
        cs.create_gate("mw tx start", q * q_n * bt * mw_n)

        # ---- error states (reference execution/error_stack.rs,
        # error_oog_constant.rs).  Cells on an error row: the failing
        # opcode byte in c_depth_n, its (pops, pushes, constant_gas) in
        # (c_ez, c_eo, c_push_len) — bound to the opcode-properties fixed
        # table — plus per-kind witnesses below.  Error steps emit no RW
        # rows, keep rw_counter, and must be followed by END_TX (root
        # frames; nested-frame error unwinding lands with the account
        # state machine). ------------------------------------------------
        e_any = ind["ERR_STACK"] + ind["ERR_OOG"] + ind["ERR_INVALID_OP"]
        e_all = e_any + ind["ERR_JUMP"] + ind["ERR_RDOOB"] \
            + ind["ERR_WRITE_PROT"] + ind["ERR_OOG_DYN"]
        self._e_all = e_all
        g_eany = q * e_any
        g_eall = q * e_all
        opb_e = Advice(self.c_depth_n)
        pops_e = Advice(self.c_ez)
        pushes_e = Advice(self.c_eo)
        g0_e = Advice(self.c_push_len)
        # the 5th column pins ERR_INVALID_OP rows to undefined opcode
        # bytes (their table rows carry invalid=1 and zero properties;
        # defined opcodes carry invalid=0, so neither state can borrow
        # the other's rows)
        cs.lookup_logup(
            "opcode properties",
            [[g_eall * opb_e, g_eall * pops_e, g_eall * pushes_e,
              g_eall * g0_e, q * ind["ERR_INVALID_OP"]]],
            [Fixed(self.tbl_byte), Fixed(self.tbl_op_pops),
             Fixed(self.tbl_op_pushes), Fixed(self.tbl_op_gas),
             Fixed(self.tbl_op_invalid)],
        )
        # terminal: next row is END_TX (root frames) or an error-unwind
        # RET row (nested frames; reference CommonErrorGadget's
        # is_root branch, evm_circuit/execution/error_*.rs).  Gas
        # carries over (cost forced 0); the rw counter carries for the
        # no-bus kinds and advances by the pop/bookkeeping count for
        # ERR_JUMP / ERR_RDOOB / ERR_WRITE_PROT (gates below)
        et_n = Advice(self.c_ind["END_TX"], 1)
        ret_err_n = Advice(self.c_ind["RET"], 1) * Advice(self.c_carry[25], 1)
        cs.create_gate(
            "error terminal", q * q_n * e_all * (1 - et_n - ret_err_n)
        )
        cs.create_gate("error rwc", q * q_n * e_any * (rwc_n - rwc))
        cs.create_gate("error gas cost", g_eall * cost_e)
        # ERR_STACK: underflow (sp + pops > 1024) or overflow (the net
        # push exceeds free slots: pushes - pops > sp).  u/o flags live in
        # carry bank cells 0/1 (free on error rows); the underflow
        # distance sp + pops - 1025 in c_gas_aux is byte-range-checked
        # (<= 16 genuinely; lookup added to the byte-ranges argument).
        g_es = q * ind["ERR_STACK"]
        u_e = Advice(self.c_carry[0])
        o_e = Advice(self.c_carry[1])
        cs.create_gate("ERR_STACK u bool", g_es * u_e * (u_e - 1))
        cs.create_gate("ERR_STACK o bool", g_es * o_e * (o_e - 1))
        cs.create_gate("ERR_STACK one kind", g_es * (u_e + o_e - 1))
        cs.create_gate(
            "ERR_STACK under dist",
            g_es * u_e * (sp + pops_e - 1025 - Advice(self.c_gas_aux)),
        )
        cs.create_gate("ERR_STACK over sp", g_es * o_e * sp)
        cs.create_gate(
            "ERR_STACK over net", g_es * o_e * (pushes_e - pops_e - 1)
        )
        # ERR_OOG (constant-cost opcodes): gas_left < constant_gas, with
        # constant_gas > 0 guaranteed by the 2-byte decomposition of
        # g0 - gas - 1 in bytes_a[0..1] (dynamic-cost opcodes have g0 = 0
        # in the table, which makes the decomposition unsatisfiable —
        # their OOG gadgets land with the memory-expansion work)
        g_eo2 = q * ind["ERR_OOG"]
        cs.create_gate(
            "ERR_OOG dist",
            g_eo2 * (g0_e - gas_e - 1 - Advice(self.c_bytes_a[0])
                     - 256 * Advice(self.c_bytes_a[1])),
        )
        # ERR_WRITE_PROT (reference execution/error_write_protection.rs):
        # a state-mutating opcode inside a static call frame.  One-hot
        # family flags live in carry cells 0..9: SSTORE, LOG0..4,
        # CREATE(+CREATE2 modifier), SELFDESTRUCT, CALL-with-value.  The
        # gadget reads IsStatic == 1 from the call context (bus access
        # below) and, for the CALL case, the value word from the stack
        # with a nonzero witness inverse in c_acc_m (phase 1).
        g_wp = q * ind["ERR_WRITE_PROT"]
        wp_cr = [Advice(self.c_carry[i]) for i in range(10)]
        (wp_sst, wp_l0, wp_l1, wp_l2, wp_l3, wp_l4, wp_crt, wp_c2,
         wp_sd, wp_cv) = wp_cr
        wp_flags = [wp_sst, wp_l0, wp_l1, wp_l2, wp_l3, wp_l4, wp_crt,
                    wp_sd, wp_cv]
        wp_sum = None
        for j, f_ in enumerate(wp_cr):
            cs.create_gate(f"ERR_WP flag {j} bool", g_wp * f_ * (f_ - 1))
        for f_ in wp_flags:
            wp_sum = f_ if wp_sum is None else wp_sum + f_
        cs.create_gate("ERR_WP one family", g_wp * (wp_sum - 1))
        cs.create_gate("ERR_WP c2 implies create", g_wp * wp_c2 * (1 - wp_crt))
        wp_byte = (wp_sst * 0x55 + wp_l0 * 0xA0 + wp_l1 * 0xA1
                   + wp_l2 * 0xA2 + wp_l3 * 0xA3 + wp_l4 * 0xA4
                   + wp_crt * 0xF0 + wp_c2 * 5 + wp_sd * 0xFF
                   + wp_cv * 0xF1)
        cs.create_gate("ERR_WP op byte", g_wp * (opb_e - wp_byte))
        # CALL family: the transferred value must be nonzero (zero-value
        # CALLs are allowed in static frames, EIP-214)
        cs.create_gate(
            "ERR_WP call value nonzero",
            g_wp * wp_cv * (Advice(self.c_val_a) * Advice(self.c_acc_m) - 1),
        )
        cs.create_gate(
            "ERR_WP rwc",
            q * q_n * ind["ERR_WRITE_PROT"] * (rwc_n - rwc - 1 - wp_cv),
        )
        self._wp_cv = wp_cv

        # ---- word-sum gadget (AddWords): x + y = z mod 2^256 over byte
        # cells, shared by ADD (va+vb=vc) and SUB (vc+vb=va) ----------------
        gw = q * (ind["ADD"] + ind["SUB"])
        ba = [Advice(c) for c in self.c_bytes_a]
        bb = [Advice(c) for c in self.c_bytes_b]
        bc = [Advice(c) for c in self.c_bytes_c]
        cr = [Advice(c) for c in self.c_carry]
        # byte-wise ripple: x_i + y_i + carry_in = z_i + 256*carry_out
        for i in range(32):
            cin = cr[i - 1] if i else 0
            cs.create_gate(
                f"ADD byte {i}",
                gw * (ba[i] + bb[i] + cin - bc[i] - 256 * cr[i]),
            )
            cs.create_gate(f"ADD carry {i} bool", gw * cr[i] * (cr[i] - 1))
        # bind byte cells to the RLC operands (challenge powers are
        # degree-0, so these stay linear in the advice)
        def rlc_expr(bytes_):
            expr = None
            rpow = None
            for i, b in enumerate(bytes_):
                term = b if i == 0 else b * rpow
                expr = term if expr is None else expr + term
                rpow = self.r_word if rpow is None else rpow * self.r_word
            return expr

        ga = q * ind["ADD"]
        gs = q * ind["SUB"]
        cs.create_gate("ADD a rlc", ga * (rlc_expr(ba) - va))
        cs.create_gate("ADD b rlc", ga * (rlc_expr(bb) - vb))
        cs.create_gate("ADD c rlc", ga * (rlc_expr(bc) - vc))
        # SUB: va - vb = vc  <=>  bytes hold (x=vc, y=vb, z=va)
        cs.create_gate("SUB x rlc", gs * (rlc_expr(ba) - vc))
        cs.create_gate("SUB y rlc", gs * (rlc_expr(bb) - vb))
        cs.create_gate("SUB z rlc", gs * (rlc_expr(bc) - va))

        # ---- MulAddWords gadget (reference math_gadget/mul_add_words.rs):
        # x * y + z = w over 64-bit limbs of the byte cells, with 9-byte
        # carry banks in c_carry[0..8] (lo) and c_carry[9..17] (hi) --------
        bd = [Advice(c) for c in self.c_bytes_d]
        L64, L128 = 1 << 64, 1 << 128

        def limb64(bytes_, k):
            expr = None
            for i in range(8):
                term = bytes_[8 * k + i] * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def half128(bytes_, lo: bool):
            base = 0 if lo else 16
            expr = None
            for i in range(16):
                term = bytes_[base + i] * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def carry_bank(lo: bool):
            base = 0 if lo else 9
            expr = None
            for i in range(9):
                term = cr[base + i] * (1 << (8 * i))
                expr = term if expr is None else expr + term
            return expr

        def mul_t(x_bytes, y_bytes):
            lx = [limb64(x_bytes, k) for k in range(4)]
            ly = [limb64(y_bytes, k) for k in range(4)]
            t = []
            for k in range(7):
                expr = None
                for i in range(4):
                    j = k - i
                    if 0 <= j < 4:
                        term = lx[i] * ly[j]
                        expr = term if expr is None else expr + term
                t.append(expr)
            return t

        cl, ch = carry_bank(True), carry_bank(False)
        # MUL: a * b = c (mod 2^256); overflow limbs discarded
        gm = q * ind["MUL"]
        tm = mul_t(ba, bb)
        cs.create_gate(
            "MUL lo", gm * (tm[0] + tm[1] * L64 - half128(bc, True) - cl * L128)
        )
        cs.create_gate(
            "MUL hi",
            gm * (tm[2] + tm[3] * L64 + cl - half128(bc, False) - ch * L128),
        )
        cs.create_gate("MUL a rlc", gm * (rlc_expr(ba) - va))
        cs.create_gate("MUL b rlc", gm * (rlc_expr(bb) - vb))
        cs.create_gate("MUL c rlc", gm * (rlc_expr(bc) - vc))

        # DIV/MOD: dividend a (bytes_a), divisor b (bytes_b), quotient q
        # (bytes_c), remainder r (bytes_d): q*b + r = a with NO 2^256
        # overflow, r < b when b != 0; pushed value is q (DIV) / r (MOD),
        # forced to 0 when the divisor is zero (EVM semantics).
        inv = Advice(self.c_inv)
        gdm = q * (ind["DIV"] + ind["MOD"])
        td = mul_t(bc, bb)
        cs.create_gate(
            "DIVMOD lo",
            gdm * (td[0] + td[1] * L64 + half128(bd, True)
                   - half128(ba, True) - cl * L128),
        )
        cs.create_gate(
            "DIVMOD hi",
            gdm * (td[2] + td[3] * L64 + half128(bd, False) + cl
                   - half128(ba, False) - ch * L128),
        )
        # q*b + r == a exactly: everything above bit 255 vanishes
        cs.create_gate("DIVMOD no overflow", gdm * (ch + td[4] + td[5] + td[6]))
        cs.create_gate("DIVMOD a rlc", gdm * (rlc_expr(ba) - va))
        cs.create_gate("DIVMOD b rlc", gdm * (rlc_expr(bb) - vb))
        # divisor-is-zero flag: bz = 1 - vb*inv with vb*bz = 0
        nz = vb * inv  # 1 iff divisor != 0 (given the gate below)
        cs.create_gate("DIVMOD divisor iszero", gdm * vb * (1 - nz))
        cs.create_gate(
            "DIV result", q * ind["DIV"] * (vc - nz * rlc_expr(bc))
        )
        cs.create_gate(
            "MOD result", q * ind["MOD"] * (vc - nz * rlc_expr(bd))
        )
        # r < b when b != 0: diff = r - b + 2^256 held in c_mem bytes
        mem_b = [Advice(c) for c in self.c_mem]
        bor2 = cr[18]
        cs.create_gate("DIVMOD borrow bool", gdm * bor2 * (bor2 - 1))
        cs.create_gate(
            "DIVMOD r<b lo",
            gdm * nz * (half128(bd, True) - half128(bb, True)
                        + bor2 * L128 - half128(mem_b, True)),
        )
        cs.create_gate(
            "DIVMOD r<b hi",
            gdm * nz * (half128(bd, False) - half128(bb, False) - bor2
                        + L128 - half128(mem_b, False)),
        )

        # LT/GT (reference math_gadget/lt_word.rs): result = x < y with
        # diff = x - y + result*2^256 in bytes_c; GT swaps the operands.
        glt, ggt = q * ind["LT"], q * ind["GT"]
        gcmp = q * (ind["LT"] + ind["GT"])
        bor1 = cr[0]
        cs.create_gate("CMP result bool", gcmp * vc * (vc - 1))
        cs.create_gate("CMP borrow bool", gcmp * bor1 * (bor1 - 1))
        cs.create_gate(
            "CMP diff lo",
            gcmp * (half128(ba, True) - half128(bb, True) + bor1 * L128
                    - half128(bc, True)),
        )
        cs.create_gate(
            "CMP diff hi",
            gcmp * (half128(ba, False) - half128(bb, False) - bor1
                    + vc * L128 - half128(bc, False)),
        )
        cs.create_gate("LT x rlc", glt * (rlc_expr(ba) - va))
        cs.create_gate("LT y rlc", glt * (rlc_expr(bb) - vb))
        cs.create_gate("GT x rlc", ggt * (rlc_expr(ba) - vb))
        cs.create_gate("GT y rlc", ggt * (rlc_expr(bb) - va))

        # SLT/SGT (reference execution/signed_comparator.rs): split each
        # operand's MSB into a sign bit + 7-bit rest (byte-range checks on
        # 2*rest ride the "byte ranges" logUp below), run the unsigned
        # borrow split into an internal flag, then select: signs differ ->
        # x's sign decides; same sign -> the unsigned comparison stands.
        gslt, gsgt = q * ind["SLT"], q * ind["SGT"]
        gsc = q * (ind["SLT"] + ind["SGT"])
        ltf_sc = Advice(self.c_ez)       # unsigned x < y
        sa_sc = Advice(self.c_gx[0])     # sign of x
        sb_sc = Advice(self.c_gx[1])     # sign of y
        bor_sc = cr[0]
        cs.create_gate("SCMP sa bool", gsc * sa_sc * (sa_sc - 1))
        cs.create_gate("SCMP sb bool", gsc * sb_sc * (sb_sc - 1))
        cs.create_gate("SCMP lt bool", gsc * ltf_sc * (ltf_sc - 1))
        cs.create_gate("SCMP borrow bool", gsc * bor_sc * (bor_sc - 1))
        cs.create_gate(
            "SCMP diff lo",
            gsc * (half128(ba, True) - half128(bb, True) + bor_sc * L128
                   - half128(bc, True)),
        )
        cs.create_gate(
            "SCMP diff hi",
            gsc * (half128(ba, False) - half128(bb, False) - bor_sc
                   + ltf_sc * L128 - half128(bc, False)),
        )
        res_sc = sa_sc * (1 - sb_sc) \
            + (1 - sa_sc - sb_sc + 2 * sa_sc * sb_sc) * ltf_sc
        cs.create_gate("SCMP result", gsc * (vc - res_sc))
        cs.create_gate("SLT x rlc", gslt * (rlc_expr(ba) - va))
        cs.create_gate("SLT y rlc", gslt * (rlc_expr(bb) - vb))
        cs.create_gate("SGT x rlc", gsgt * (rlc_expr(ba) - vb))
        cs.create_gate("SGT y rlc", gsgt * (rlc_expr(bb) - va))
        for g in ("SLT", "SGT"):
            transition(ind[g], 1, 3, 1)

        # GAS (reference execution/gas.rs): pushes gas_left after the 2-gas
        # charge; 8-byte decomposition binds the pushed word to the gas
        # chain (N_BYTES_GAS = 8, upper word bytes are zero).
        gga = q * ind["GAS"]
        gas8_int = None
        gas8_rlc = None
        rp_ = None
        for i in range(8):
            t_i = ba[i] * (1 << (8 * i))
            gas8_int = t_i if gas8_int is None else gas8_int + t_i
            tr_ = ba[i] if i == 0 else ba[i] * rp_
            gas8_rlc = tr_ if gas8_rlc is None else gas8_rlc + tr_
            rp_ = self.r_word if rp_ is None else rp_ * self.r_word
        cs.create_gate("GAS value", gga * (gas8_int - gas_e + 2))
        cs.create_gate("GAS rlc", gga * (gas8_rlc - va))
        transition(ind["GAS"], 1, 1, -1)

        # MSIZE (reference execution/msize.rs): pushes 32 * memory word
        # size; 4-byte decomposition against the tracked c_mw column.
        gms = q * ind["MSIZE"]
        sz4_int = (ba[0] + ba[1] * 256 + ba[2] * 65536
                   + ba[3] * 16777216)
        sz4_rlc = (ba[0] + ba[1] * self.r_word
                   + ba[2] * self.r_word * self.r_word
                   + ba[3] * self.r_word * self.r_word * self.r_word)
        cs.create_gate("MSIZE value", gms * (sz4_int - 32 * mw_e))
        cs.create_gate("MSIZE rlc", gms * (sz4_rlc - va))
        transition(ind["MSIZE"], 1, 1, -1)

        # CODESIZE (reference execution/codesize.rs): pushes the executing
        # bytecode's length — bound to the Bytecode circuit's header row
        # via the length table when composed.
        gcs2 = q * ind["CODESIZE"]
        cs.create_gate("CODESIZE rlc", gcs2 * (sz4_rlc - va))
        transition(ind["CODESIZE"], 1, 1, -1)

        # EQ / ISZERO: result from an IsZero inverse witness (reference
        # math_gadget/is_zero.rs); operands compared as word RLCs
        geq = q * ind["EQ"]
        cs.create_gate("EQ result", geq * (vc - 1 + (va - vb) * inv))
        cs.create_gate("EQ kill", geq * (va - vb) * vc)
        giz = q * ind["ISZERO"]
        cs.create_gate("ISZERO result", giz * (vc - 1 + va * inv))
        cs.create_gate("ISZERO kill", giz * va * vc)

        # NOT: bytewise complement
        gnot = q * ind["NOT"]
        for i in range(32):
            cs.create_gate(f"NOT byte {i}", gnot * (ba[i] + bc[i] - 255))
        cs.create_gate("NOT a rlc", gnot * (rlc_expr(ba) - va))
        cs.create_gate("NOT c rlc", gnot * (rlc_expr(bc) - vc))

        # ---- AND / OR / XOR: per-byte nibble-pair lookups (reference
        # execution/bitwise.rs + FixedTableTag Bitwise*).  Low nibbles are
        # witness cells (carries = a_lo, mem = b_lo, bytes_d = c_lo); high
        # nibbles are the derived expressions (byte - lo)/16 — the table
        # membership simultaneously range-checks both halves. ------------
        INV16 = pow(16, -1, R)
        mem_c = [Advice(c) for c in self.c_mem]
        for opname, tblcol in (
            ("AND", self.tbl_and), ("OR", self.tbl_or), ("XOR", self.tbl_xor)
        ):
            g_op = q * ind[opname]
            cs.create_gate(f"{opname} a rlc", g_op * (rlc_expr(ba) - va))
            cs.create_gate(f"{opname} b rlc", g_op * (rlc_expr(bb) - vb))
            cs.create_gate(f"{opname} c rlc", g_op * (rlc_expr(bc) - vc))
            pairs = []
            for i in range(32):
                alo, blo, clo = cr[i], mem_c[i], bd[i]
                ahi = (ba[i] - alo) * INV16
                bhi = (bb[i] - blo) * INV16
                chi = (bc[i] - clo) * INV16
                pairs.append((alo * 16 + blo, clo))
                pairs.append((ahi * 16 + bhi, chi))
            cs.lookup_logup(
                f"{opname} nibbles",
                [[g_op * k, g_op * r_] for k, r_ in pairs],
                [Fixed(self.tbl_byte), Fixed(tblcol)],
            )

        # ---- BYTE: result = big-endian byte i of x, 0 when i >= 32
        # (reference execution/byte.rs).  One-hot selector in the carry
        # bank picks le byte 31-i; out-of-range is proven by ba[0] >= 32
        # (ez flag + byte-table shift) or a nonzero high byte. -----------
        gby = q * ind["BYTE"]
        s_sum = None
        sel_idx = None
        for j in range(32):
            cs.create_gate(f"BYTE sel {j} bool", gby * cr[j] * (cr[j] - 1))
            s_sum = cr[j] if s_sum is None else s_sum + cr[j]
            t_ = cr[j] * j
            sel_idx = t_ if sel_idx is None else sel_idx + t_
        s_hi_a = None
        for k in range(1, 32):
            s_hi_a = ba[k] if s_hi_a is None else s_hi_a + ba[k]
        cs.create_gate("BYTE sel sum bool", gby * s_sum * (s_sum - 1))
        cs.create_gate("BYTE sel index", gby * (sel_idx - s_sum * ba[0]))
        cs.create_gate("BYTE in-range high zero", gby * s_sum * s_hi_a)
        picked_b = None
        for j in range(32):
            t_ = cr[j] * bb[31 - j]
            picked_b = t_ if picked_b is None else picked_b + t_
        cs.create_gate("BYTE result", gby * (Advice(self.c_bytes_c[0]) - picked_b))
        s_hi_c = None
        for k in range(1, 32):
            s_hi_c = bc[k] if s_hi_c is None else s_hi_c + bc[k]
        cs.create_gate("BYTE result high zero", gby * s_hi_c)
        cs.create_gate("BYTE vc", gby * (vc - Advice(self.c_bytes_c[0])))
        cs.create_gate("BYTE a rlc", gby * (rlc_expr(ba) - va))
        cs.create_gate("BYTE b rlc", gby * (rlc_expr(bb) - vb))
        inv_e = Advice(self.c_inv)
        ez_e = Advice(self.c_ez)
        # out of range: ez => ba[0] >= 32 (lookup of ba[0]-32 below);
        # !ez => some high byte nonzero (s_hi_a * inv == 1)
        cs.create_gate(
            "BYTE out of range",
            gby * (1 - s_sum) * (1 - ez_e) * (s_hi_a * inv_e - 1),
        )

        # ---- SHL: result = value * 2^shift mod 2^256 (reference
        # execution/shl_shr.rs, multiplication side).  bytes_d holds the
        # 2^shift word via the pow2 table; shift >= 256 (nonzero high
        # bytes) forces result 0. ----------------------------------------
        gshl = q * ind["SHL"]
        z_ge = s_hi_a * inv_e  # 1 iff shift >= 256 (given kill gate)
        cs.create_gate("SHL ge kill", gshl * s_hi_a * (1 - z_ge))
        glt = gshl * (1 - z_ge)
        ts = mul_t(bb, bd)
        cs.create_gate(
            "SHL lo", glt * (ts[0] + ts[1] * L64 - half128(bc, True) - cl * L128)
        )
        cs.create_gate(
            "SHL hi",
            glt * (ts[2] + ts[3] * L64 + cl - half128(bc, False) - ch * L128),
        )
        cs.create_gate("SHL a rlc", gshl * (rlc_expr(ba) - va))
        cs.create_gate("SHL b rlc", gshl * (rlc_expr(bb) - vb))
        cs.create_gate("SHL c rlc", glt * (rlc_expr(bc) - vc))
        cs.create_gate("SHL ge result", gshl * z_ge * vc)

        # ---- SHR: value >> shift (reference execution/shl_shr.rs,
        # division side).  quotient * 2^shift + remainder = value exactly
        # (no 2^256 overflow), remainder < 2^shift.  Banks: a = shift
        # word, b = value, c = quotient (= result), d = 2^shift (pow2
        # table), mem = remainder, e = remainder-compare diff.  Shares
        # the SHL machinery: z_ge (shift >= 256 => result 0), carry
        # banks, borrow bit cr[18]. --------------------------------------
        gshr = q * ind["SHR"]
        be_ = [Advice(c) for c in self.c_bytes_e]
        cs.create_gate("SHR ge kill", gshr * s_hi_a * (1 - z_ge))
        glr = gshr * (1 - z_ge)
        tshr = mul_t(bc, bd)
        cs.create_gate(
            "SHR lo",
            glr * (tshr[0] + tshr[1] * L64 + half128(mem_c, True)
                   - half128(bb, True) - cl * L128),
        )
        cs.create_gate(
            "SHR hi",
            glr * (tshr[2] + tshr[3] * L64 + half128(mem_c, False) + cl
                   - half128(bb, False) - ch * L128),
        )
        cs.create_gate(
            "SHR no overflow", glr * (ch + tshr[4] + tshr[5] + tshr[6])
        )
        # remainder < 2^shift: diff = r - p + 2^256 in bank e with the
        # borrow bit forced to 1 (r < p <=> the 2^256 add is needed)
        bor3 = cr[18]
        cs.create_gate("SHR borrow bool", gshr * bor3 * (bor3 - 1))
        cs.create_gate(
            "SHR r<p lo",
            glr * (half128(mem_c, True) - half128(bd, True) + bor3 * L128
                   - half128(be_, True)),
        )
        cs.create_gate(
            "SHR r<p hi",
            glr * (half128(mem_c, False) - half128(bd, False) - bor3
                   + L128 - half128(be_, False)),
        )
        cs.create_gate("SHR a rlc", gshr * (rlc_expr(ba) - va))
        cs.create_gate("SHR b rlc", gshr * (rlc_expr(bb) - vb))
        cs.create_gate("SHR c rlc", glr * (rlc_expr(bc) - vc))
        cs.create_gate("SHR ge result", gshr * z_ge * vc)
        g_pow2 = glt + glr
        cs.lookup_logup(
            "pow2 shifts",
            [[g_pow2, g_pow2 * ba[0], g_pow2 * half128(bd, True),
              g_pow2 * half128(bd, False)]],
            [Fixed(self.tbl_sel256), Fixed(self.tbl_byte),
             Fixed(self.tbl_pow2_lo), Fixed(self.tbl_pow2_hi)],
        )

        # ---- SAR (reference execution/sar.rs): arithmetic right shift
        # via the unsigned split x = q*2^s + rem (SHR machinery: q in the
        # mem bank, 2^s in bank d, rem in bank f, rem<2^s diff in bank g)
        # plus the negative fill  r = q + sx*(2^256 - 2^(256-s))  with
        # 2^(256-s) (bank e halves) from a second pow2-table read.
        # s >= 256 gives all-ones/zero by sign; s = 0 gives r = x. ------
        gsar = q * ind["SAR"]
        M128_C = (1 << 128) - 1
        inv2 = Advice(self.c_inv2)
        bme = [Advice(c) for c in self.c_mem]
        bfs = [Advice(c) for c in self.c_bytes_f]
        bgs = [Advice(c) for c in self.c_bytes_g]
        sar_sx = cr[19]
        sar_car = cr[20]
        sar_c2 = cr[21]
        sar_sxp = cr[22]
        sar_rest = Advice(self.c_addr[0])
        for nm, flag in (("sx", sar_sx), ("car", sar_car), ("c2", sar_c2),
                         ("sxp", sar_sxp)):
            cs.create_gate(f"SAR {nm} bool", gsar * flag * (flag - 1))
        cs.create_gate("SAR sx top", gsar * (bb[31] - sar_sx * 128 - sar_rest))
        # zge: shift >= 256 (nonzero high bytes of s); z0: s == 0
        sar_shi = None
        for k in range(1, 32):
            sar_shi = ba[k] if sar_shi is None else sar_shi + ba[k]
        sar_ssum = sar_shi + ba[0]
        sar_zge = Advice(self.c_ez)
        sar_z0 = Advice(self.c_eo)
        cs.create_gate("SAR zge bool", gsar * sar_zge * (sar_zge - 1))
        cs.create_gate("SAR z0 bool", gsar * sar_z0 * (sar_z0 - 1))
        cs.create_gate("SAR zge kill", gsar * sar_zge * (sar_shi * inv - 1))
        cs.create_gate(
            "SAR zge complete", gsar * (1 - sar_zge) * sar_shi
        )
        cs.create_gate("SAR z0 kill", gsar * sar_z0 * sar_ssum)
        cs.create_gate(
            "SAR z0 complete",
            gsar * (1 - sar_z0) * (sar_ssum * inv2 - 1),
        )
        # unsigned split (gated shift < 256)
        gsl_ = gsar * (1 - sar_zge)
        tsar = mul_t(bme, bd)
        cs.create_gate(
            "SAR id lo",
            gsl_ * (tsar[0] + tsar[1] * L64 + half128(bfs, True)
                    - half128(bb, True) - cl * L128),
        )
        cs.create_gate(
            "SAR id hi",
            gsl_ * (tsar[2] + tsar[3] * L64 + half128(bfs, False) + cl
                    - half128(bb, False) - ch * L128),
        )
        cs.create_gate(
            "SAR no overflow", gsl_ * (ch + tsar[4] + tsar[5] + tsar[6])
        )
        sar_bor = cr[18]
        cs.create_gate("SAR bor bool", gsar * sar_bor * (sar_bor - 1))
        cs.create_gate(
            "SAR rem<p lo",
            gsl_ * (half128(bfs, True) - half128(bd, True) + sar_bor * L128
                    - half128(bgs, True)),
        )
        cs.create_gate(
            "SAR rem<p hi",
            gsl_ * (half128(bfs, False) - half128(bd, False) - sar_bor
                    + L128 - half128(bgs, False)),
        )
        # sign-fill: sxp = sx * (1-z0) * (1-zge); fill = r - q must equal
        # sxp * (2^256 - pinv) with pinv = 2^(256-s) in bank e halves
        cs.create_gate(
            "SAR sxp def",
            gsar * (sar_sxp - sar_sx * (1 - sar_z0) * (1 - sar_zge)),
        )
        pinv_lo, pinv_hi = half128(be_, True), half128(be_, False)
        fill_lo = half128(bc, True) - half128(bme, True) + sar_car * L128
        fill_hi = half128(bc, False) - half128(bme, False) - sar_car
        cs.create_gate(
            "SAR fill lo",
            gsl_ * (fill_lo + sar_sxp * pinv_lo - sar_c2 * L128),
        )
        cs.create_gate(
            "SAR fill hi",
            gsl_ * (fill_hi + sar_sxp * pinv_hi + sar_c2 - sar_sxp * L128),
        )
        # shift >= 256: result is the sign fill alone
        gz_ = gsar * sar_zge
        cs.create_gate(
            "SAR zge lo", gz_ * (half128(bc, True) - sar_sx * M128_C)
        )
        cs.create_gate(
            "SAR zge hi", gz_ * (half128(bc, False) - sar_sx * M128_C)
        )
        cs.create_gate("SAR a rlc", gsar * (rlc_expr(ba) - va))
        cs.create_gate("SAR b rlc", gsar * (rlc_expr(bb) - vb))
        cs.create_gate("SAR c rlc", gsar * (rlc_expr(bc) - vc))
        g_pw = gsl_
        cs.lookup_logup(
            "SAR pow2 reads",
            [
                [g_pw, g_pw * ba[0], g_pw * half128(bd, True),
                 g_pw * half128(bd, False)],
                [g_pw * (1 - sar_z0), g_pw * (1 - sar_z0) * (256 - ba[0]),
                 g_pw * (1 - sar_z0) * pinv_lo,
                 g_pw * (1 - sar_z0) * pinv_hi],
            ],
            [Fixed(self.tbl_sel256), Fixed(self.tbl_byte),
             Fixed(self.tbl_pow2_lo), Fixed(self.tbl_pow2_hi)],
        )

        # ---- SDIV / SMOD (reference execution/sdiv_smod.rs): two's-
        # complement via |a| (bank d), |b| (bank e) with top-bit-bound
        # sign flags; unsigned identity q*|b| + r = |a| (q in mem bank,
        # r in bank f, r<|b| diff in bank g); result = +-q (SDIV, sign
        # sa xor sb) / +-r (SMOD, sign sa), zero divisor gives 0. -------
        bf_ = [Advice(c) for c in self.c_bytes_f]
        bg_ = [Advice(c) for c in self.c_bytes_g]
        inv2 = Advice(self.c_inv2)
        gsd, gsm = q * ind["SDIV"], q * ind["SMOD"]
        gsx = gsd + gsm
        sa, sb_ = cr[19], cr[20]
        c0a, c0b, c0c = cr[21], cr[22], cr[23]
        rest_a, rest_b = Advice(self.c_addr[0]), Advice(self.c_addr[1])
        for nm, flag in (("sa", sa), ("sb", sb_), ("c0a", c0a),
                         ("c0b", c0b), ("c0c", c0c)):
            cs.create_gate(f"SDIV {nm} bool", gsx * flag * (flag - 1))
        # sign flags ARE the operands' top bits
        cs.create_gate("SDIV sa top", gsx * (ba[31] - sa * 128 - rest_a))
        cs.create_gate("SDIV sb top", gsx * (bb[31] - sb_ * 128 - rest_b))
        # |a|: equal when non-negative, complement identity when negative
        for (sgn, c0, src, dst, nm) in (
            (sa, c0a, ba, bd, "a"), (sb_, c0b, bb, be_, "b"),
        ):
            for lo_half in (True, False):
                s_src = half128(src, lo_half)
                s_dst = half128(dst, lo_half)
                cs.create_gate(
                    f"SDIV abs {nm} eq {lo_half}",
                    gsx * (1 - sgn) * (s_dst - s_src),
                )
            cs.create_gate(
                f"SDIV abs {nm} neg lo",
                gsx * sgn * (half128(src, True) + half128(dst, True)
                             - c0 * L128),
            )
            cs.create_gate(
                f"SDIV abs {nm} neg hi",
                gsx * sgn * (half128(src, False) + half128(dst, False)
                             + c0 - L128),
            )
        # zero-divisor flag over |b|'s half sum
        sbv = half128(be_, True) + half128(be_, False)
        nzb = sbv * inv
        cs.create_gate("SDIV nzb kill", gsx * sbv * (1 - nzb))
        cs.create_gate("SDIV zero divisor", gsx * (1 - nzb) * vc)
        gnz = gsx * nzb
        # unsigned identity on the magnitudes
        tsd = mul_t(mem_b, be_)
        cs.create_gate(
            "SDIV id lo",
            gnz * (tsd[0] + tsd[1] * L64 + half128(bf_, True)
                   - half128(bd, True) - cl * L128),
        )
        cs.create_gate(
            "SDIV id hi",
            gnz * (tsd[2] + tsd[3] * L64 + half128(bf_, False) + cl
                   - half128(bd, False) - ch * L128),
        )
        cs.create_gate(
            "SDIV no overflow", gnz * (ch + tsd[4] + tsd[5] + tsd[6])
        )
        borq = cr[18]
        cs.create_gate("SDIV bor bool", gsx * borq * (borq - 1))
        cs.create_gate(
            "SDIV r<b lo",
            gnz * (half128(bf_, True) - half128(be_, True) + borq * L128
                   - half128(bg_, True)),
        )
        cs.create_gate(
            "SDIV r<b hi",
            gnz * (half128(bf_, False) - half128(be_, False) - borq
                   + L128 - half128(bg_, False)),
        )
        # result: select |q| (SDIV) / |r| (SMOD), negate by the op's sign
        res_sign_sd = sa + sb_ - 2 * sa * sb_
        for g_op, val_bank, rsign, nm in (
            (gsd, mem_b, res_sign_sd, "sdiv"), (gsm, bf_, sa, "smod"),
        ):
            v_lo, v_hi = half128(val_bank, True), half128(val_bank, False)
            sv = v_lo + v_hi
            zv = Advice(self.c_ez)
            cs.create_gate(f"{nm} zv bool", g_op * zv * (zv - 1))
            cs.create_gate(f"{nm} zv kill", g_op * zv * sv)
            cs.create_gate(
                f"{nm} zv complete",
                g_op * nzb * (1 - zv) * (sv * inv2 - 1),
            )
            cs.create_gate(f"{nm} zero result", g_op * zv * vc)
            neg = rsign * (1 - zv)
            for lo_half in (True, False):
                cs.create_gate(
                    f"{nm} res eq {lo_half}",
                    g_op * nzb * (1 - neg)
                    * (half128(bc, lo_half) - half128(val_bank, lo_half)),
                )
            cs.create_gate(
                f"{nm} res neg lo",
                g_op * nzb * neg * (v_lo + half128(bc, True) - c0c * L128),
            )
            cs.create_gate(
                f"{nm} res neg hi",
                g_op * nzb * neg * (v_hi + half128(bc, False) + c0c - L128),
            )
        cs.create_gate("SDIV a rlc", gsx * (rlc_expr(ba) - va))
        cs.create_gate("SDIV b rlc", gsx * (rlc_expr(bb) - vb))
        cs.create_gate("SDIV c rlc", gsx * nzb * (rlc_expr(bc) - vc))

        # ---- SIGNEXTEND (reference execution/signextend.rs): keep-mask
        # bits m_j (carry bank) monotone non-increasing from byte 0; the
        # drop position is the index operand; dropped bytes become the
        # selected byte's sign fill. ------------------------------------
        gse = q * ind["SIGNEXTEND"]
        m_bits = cr
        for j in range(32):
            cs.create_gate(
                f"SEXT m{j} bool", gse * m_bits[j] * (m_bits[j] - 1)
            )
        cs.create_gate("SEXT m0", gse * (m_bits[0] - 1))
        s_hi_i = None
        for k in range(1, 32):
            s_hi_i = ba[k] if s_hi_i is None else s_hi_i + ba[k]
        drops = []
        for j in range(31):
            e_j = m_bits[j] - m_bits[j + 1]
            drops.append(e_j)
            cs.create_gate(f"SEXT e{j} bool", gse * e_j * (e_j - 1))
            cs.create_gate(f"SEXT e{j} at i", gse * e_j * (ba[0] - j))
            cs.create_gate(f"SEXT e{j} small i", gse * e_j * s_hi_i)
        # keep-all requires i >= 31 (ez + byte lookup) or i >= 2^8
        sext_ez = Advice(self.c_ez)
        cs.create_gate("SEXT ez bool", gse * sext_ez * (sext_ez - 1))
        cs.create_gate(
            "SEXT keep-all big i",
            gse * m_bits[31] * (1 - sext_ez) * (s_hi_i * inv - 1),
        )
        sel_byte = None
        for j in range(31):
            term = drops[j] * bb[j]
            sel_byte = term if sel_byte is None else sel_byte + term
        sgn_se = Advice(self.c_eo)
        rest_se = Advice(self.c_addr[2])
        cs.create_gate("SEXT sgn bool", gse * sgn_se * (sgn_se - 1))
        cs.create_gate(
            "SEXT sign split", gse * (sel_byte - sgn_se * 128 - rest_se)
        )
        for j in range(32):
            cs.create_gate(
                f"SEXT res {j}",
                gse * (bc[j] - m_bits[j] * bb[j]
                       - (1 - m_bits[j]) * sgn_se * 255),
            )
        cs.create_gate("SEXT a rlc", gse * (rlc_expr(ba) - va))
        cs.create_gate("SEXT b rlc", gse * (rlc_expr(bb) - vb))
        cs.create_gate("SEXT c rlc", gse * (rlc_expr(bc) - vc))

        # ---- EXP: lookup into the Exp circuit's table (reference
        # evm_circuit/execution/exp.rs); exponent 0/1 handled arithmetically
        # (the Exp circuit only proves exponent >= 2 events) ---------------
        inv2 = Advice(self.c_inv2)
        ez, eo = Advice(self.c_ez), Advice(self.c_eo)
        ge = q * ind["EXP"]
        gc = q * ind["CALLDATACOPY"]
        cs.create_gate(
            "flag ez bool", (ge + gc + q * ind["BYTE"]) * ez * (ez - 1)
        )
        cs.create_gate("flag eo bool", ge * eo * (eo - 1))
        cs.create_gate("EXP ez kill", ge * ez * vb)
        cs.create_gate("EXP eo kill", ge * eo * (vb - 1))
        cs.create_gate(
            "EXP flags complete",
            ge * (1 - ez - eo) * (vb * (vb - 1) * inv2 - 1),
        )
        cs.create_gate("EXP zero result", ge * ez * (vc - 1))  # x^0 = 1
        cs.create_gate("EXP one result", ge * eo * (vc - va))  # x^1 = x
        cs.create_gate("EXP base rlc", ge * (rlc_expr(ba) - va))
        cs.create_gate("EXP exponent rlc", ge * (rlc_expr(bb) - vb))
        cs.create_gate("EXP result rlc", ge * (rlc_expr(bc) - vc))
        if self.exp_table is not None:
            gt = ge * (1 - ez - eo)
            cs.lookup_logup(
                "EXP table",
                [[
                    gt, gt * half128(ba, True), gt * half128(ba, False),
                    gt * half128(bb, True), gt * half128(bb, False),
                    gt * half128(bc, True), gt * half128(bc, False),
                ]],
                self.exp_table,
            )

        # ---- CALLDATACOPY: 3 stack pops (dst, src, len) + a Copy circuit
        # event covering the per-byte memory writes (reference
        # evm_circuit/execution/calldatacopy.rs).  Addresses/length are
        # 4-byte words: dst in c_addr, src in bytes_a[0:4], len in
        # bytes_b[0:4].  src_id == call_id (root-call frames; nested calls
        # land with the call opcodes). ------------------------------------
        ab4 = [Advice(c) for c in self.c_addr]

        def fold4_rlc(cells):
            e = cells[0] + cells[1] * self.r_word
            e = e + cells[2] * self.r_word * self.r_word
            return e + cells[3] * self.r_word * self.r_word * self.r_word

        def fold4_int(cells):
            return (cells[0] + cells[1] * 256 + cells[2] * 65536
                    + cells[3] * 16777216)

        cs.create_gate("CDC dst rlc", gc * (fold4_rlc(ab4) - va))
        cs.create_gate("CDC src rlc", gc * (fold4_rlc(ba) - vb))
        cs.create_gate("CDC len rlc", gc * (fold4_rlc(bb) - vc))
        cs.create_gate("CDC len zero kill", gc * ez * vc)
        cs.create_gate("CDC len nonzero", gc * (1 - ez) * (vc * inv2 - 1))
        # is_root flag (ctx-read-bound below): root frames copy from the
        # TxTable-backed calldata; NESTED frames from CALLER memory at
        # cd_offset+src (reference bus-mapping calldatacopy.rs internal
        # path).  Copies past the calldata end are allowed: the tail is
        # zero-PADDED (reference memory_gadget.rs copy pads).  Case flags
        # fov (src >= cdlen: fully padded) and fpart (src < cdlen <
        # src+len: partial tail) are bound by u32 slack decompositions in
        # bd[12:16] / bd[16:20]; the in-range byte count
        # m = min(len, max(0, cdlen - src)) then drives the rw-counter
        # accounting, and the event's pad boundary (src_end) is pinned in
        # the Copy circuit's bound table.
        cdc_irf = cr[24]
        fov, fpart = cr[26], cr[27]
        cs.create_gate("CDC isroot bool", gc * cdc_irf * (cdc_irf - 1))
        cs.create_gate("CDC fov bool", gc * fov * (fov - 1))
        cs.create_gate("CDC fpart bool", gc * fpart * (fpart - 1))
        cs.create_gate("CDC fov/fpart excl", gc * fov * fpart)
        cdc_cdlen = (bd[0] + bd[1] * 256 + bd[2] * 65536
                     + bd[3] * 16777216)
        cdc_cdoff = (bd[4] + bd[5] * 256 + bd[6] * 65536
                     + bd[7] * 16777216)
        cdc_caller = (bd[8] + bd[9] * 256 + bd[10] * 65536
                      + bd[11] * 16777216)
        cdc_slack_a = (bd[12] + bd[13] * 256 + bd[14] * 65536
                       + bd[15] * 16777216)
        cdc_slack_b = (bd[16] + bd[17] * 256 + bd[18] * 65536
                       + bd[19] * 16777216)
        src4_c, len4_c = fold4_int(ba), fold4_int(bb)
        gcz = gc * (1 - ez)
        cs.create_gate(
            "CDC fov case", gcz * fov * (src4_c - cdc_cdlen - cdc_slack_a)
        )
        cs.create_gate(
            "CDC fpart case lo",
            gcz * (1 - fov) * fpart
            * (cdc_cdlen - src4_c - 1 - cdc_slack_a),
        )
        cs.create_gate(
            "CDC fpart case hi",
            gcz * (1 - fov) * fpart
            * (src4_c + len4_c - cdc_cdlen - 1 - cdc_slack_b),
        )
        cs.create_gate(
            "CDC in-range case",
            gcz * (1 - fov) * (1 - fpart)
            * (cdc_cdlen - src4_c - len4_c - cdc_slack_a),
        )
        # in-range byte count m (reads skipped for the padded tail)
        cdc_m = (1 - fov) * (fpart * (cdc_cdlen - src4_c)
                             + (1 - fpart) * len4_c)
        # transitions: pc += 1, sp += 3; rwc: root [3 pops, IsRoot,
        # CDLen, len writes] = 5 + len; nested [3 pops, IsRoot, CDLen,
        # CDOff, CallerId, m reads + len writes] = 7 + len + m
        gcn = q * q_n * ind["CALLDATACOPY"]
        cs.create_gate("CDC pc", gcn * (pc_n - pc - 1))
        cs.create_gate("CDC sp", gcn * (sp_n - sp - 3))
        cs.create_gate(
            "CDC rwc",
            gcn * (rwc_n - rwc - 5 - fold4_int(bb)
                   - (1 - cdc_irf) * (2 + cdc_m)),
        )
        if self.copy_table is not None:
            gl = gc * (1 - ez)
            glr = gl * cdc_irf
            gln = gl * (1 - cdc_irf)
            # normalized event source start: min(src, cdlen) (+ cd_offset
            # for nested) — full-pad events start AT the boundary so the
            # copy circuit's first-row pad gate closes
            src_norm = (1 - fov) * src4_c + fov * cdc_cdlen
            ev_rwc = glr * (rwc + 5) + gln * (rwc + 7)
            # (enable, is_rlc, is_mm, is_log, is_code, is_wr, src_id,
            #  src_addr, dst_id, dst_addr, len, rwc, acc) — root events
            # are calldata->memory (all kind flags 0), nested events are
            # memory->memory (is_mm = 1) from the caller's frame
            cs.lookup_logup(
                "CDC copy event",
                [[
                    gl, gl * 0, gln, gl * 0, gl * 0, gl * 0,
                    glr * Advice(self.c_call_id) + gln * cdc_caller,
                    glr * src_norm + gln * (cdc_cdoff + src_norm),
                    gl * Advice(self.c_call_id),
                    gl * fold4_int(ab4), gl * fold4_int(bb),
                    ev_rwc, gl * 0,
                ]],
                self.copy_table,
            )
            # pad boundary pin: src_end = cdlen (root, tx-index units) or
            # cd_offset + cdlen (nested, caller-memory units)
            if self.copy_bound_table is not None:
                cs.lookup_logup(
                    "CDC copy bound",
                    [[
                        gl, gl * Advice(self.c_call_id),
                        gl * fold4_int(ab4), ev_rwc,
                        glr * cdc_cdlen + gln * (cdc_cdoff + cdc_cdlen),
                    ]],
                    self.copy_bound_table,
                )
        self._cdc_exprs = (cdc_irf, cdc_cdlen, cdc_cdoff, cdc_caller)

        # ---- MULMOD / ADDMOD (reference execution/mulmod.rs, addmod.rs):
        # the modular identity is proven by the MulMod circuit; here the
        # four stack words (a, b, n, r in banks a, b, c, d) just ride a
        # lookup into its table.  Stack bus values bind via byte-fold
        # expressions, so no val columns are consumed. --------------------
        gmm = q * ind["MULMOD"]
        gam = q * ind["ADDMOD"]
        if self.mulmod_table is not None:
            gmod = gmm + gam
            cs.lookup_logup(
                "mulmod table",
                [[
                    gmod, gam,
                    gmod * half128(ba, True), gmod * half128(ba, False),
                    gmod * half128(bb, True), gmod * half128(bb, False),
                    gmod * half128(bc, True), gmod * half128(bc, False),
                    gmod * half128(bd, True), gmod * half128(bd, False),
                ]],
                self.mulmod_table,
            )

        # ---- CALLDATALOAD (reference execution/calldataload.rs, BOTH call
        # kinds): pop offset (word in bank a), push the 32 calldata bytes
        # at [offset, offset+32) big-endian (bank b), zero-padded past the
        # calldata end.  sel_j (carry bank) = 1 iff offset+j < cdlen; the
        # boundary is pinned by two 4-byte range decompositions in bank e:
        #   sel_0 = 1  =>  cdlen - offset - m in [0, 2^32)   (m = sum sel)
        #   sel_31 = 0 =>  offset + m - cdlen in [0, 2^32)
        # offset >= 2^32 (nonzero bytes a[4:]) forces an all-zero word via
        # the inverse witness z4.  The is_root flag (c_ez, ctx-read-bound)
        # selects the byte source: root frames look the in-range bytes up
        # in the TxTable's calldata rows; NESTED frames read them from the
        # CALLER's memory at cd_offset+offset+j (reference bus-mapping
        # calldataload.rs internal-call path) — cd_offset/caller_id ride
        # ctx reads into bank-d cells bd[4:8]/bd[8:12]. -------------------
        gcdl = q * ind["CALLDATALOAD"]
        cdl_irf = Advice(self.c_ez)
        cs.create_gate("CDL isroot bool", gcdl * cdl_irf * (cdl_irf - 1))
        off_int = (ba[0] + ba[1] * 256 + ba[2] * 65536 + ba[3] * 16777216)
        s_hi4 = None
        for k in range(4, 32):
            s_hi4 = ba[k] if s_hi4 is None else s_hi4 + ba[k]
        z4 = s_hi4 * Advice(self.c_inv)
        cs.create_gate("CDL offset rlc", gcdl * (rlc_expr(ba) - va))
        cs.create_gate("CDL ge kill", gcdl * s_hi4 * (1 - z4))
        sel_sum_l = None
        for j in range(32):
            cs.create_gate(f"CDL sel {j} bool", gcdl * cr[j] * (cr[j] - 1))
            if j:
                cs.create_gate(
                    f"CDL sel {j} monotone", gcdl * cr[j] * (1 - cr[j - 1])
                )
            cs.create_gate(f"CDL pad {j} zero", gcdl * (1 - cr[j]) * bb[j])
            sel_sum_l = cr[j] if sel_sum_l is None else sel_sum_l + cr[j]
        cs.create_gate("CDL ge empty", gcdl * z4 * cr[0])
        # loaded word RLC: LE byte i of the pushed word is bb[31-i]
        def word_rlc_from(bank):
            expr = None
            rpow = None
            for i in range(32):
                b_ = bank[31 - i]
                term = b_ if i == 0 else b_ * rpow
                expr = term if expr is None else expr + term
                rpow = self.r_word if rpow is None else rpow * self.r_word
            return expr

        cs.create_gate("CDL word rlc", gcdl * (word_rlc_from(bb) - vb))
        cdlen_e = (bd[0] + bd[1] * 256 + bd[2] * 65536 + bd[3] * 16777216)
        diff_a = (be_[0] + be_[1] * 256 + be_[2] * 65536
                  + be_[3] * 16777216)
        diff_b = (be_[8] + be_[9] * 256 + be_[10] * 65536
                  + be_[11] * 16777216)
        cs.create_gate(
            "CDL in-range boundary",
            gcdl * cr[0] * (cdlen_e - off_int - sel_sum_l - diff_a),
        )
        cs.create_gate(
            "CDL out-range boundary",
            gcdl * (1 - z4) * (1 - cr[31])
            * (off_int + sel_sum_l - cdlen_e - diff_b),
        )
        # transitions: pc += 1, sp 0; rwc: root [pop, IsRoot, CDLen,
        # push] = 4; nested adds [CDOff, CallerId] + one caller-memory
        # read per in-range byte = 6 + m
        gcdln = q * q_n * ind["CALLDATALOAD"]
        cs.create_gate("CDL pc", gcdln * (pc_n - pc - 1))
        cs.create_gate("CDL sp", gcdln * (sp_n - sp))
        cs.create_gate(
            "CDL rwc",
            gcdln * (rwc_n - rwc - 4
                     - (1 - cdl_irf) * (2 + sel_sum_l)),
        )
        if self.tx_table is not None:
            from .tx import TxFieldTag as _TT

            cdl_inputs = []
            for j in range(32):
                gl = gcdl * cdl_irf * cr[j]
                cdl_inputs.append([
                    gl * txid, gl * int(_TT.CallData), gl * (off_int + j),
                    gl * bb[j],
                ])
            cs.lookup_logup("CDL calldata", cdl_inputs, self.tx_table)
        self._cdl_exprs = (cdl_irf, off_int, sel_sum_l)

        # ---- keccak pad-power table rows -----------------------------------
        qp = Fixed(self.q_padt)
        qp0 = Fixed(self.q_padt0)
        rp, rp_p = Advice(self.c_rp), Advice(self.c_rp, -1)
        prlc = Advice(self.c_prlc)
        cs.create_gate("padt seed rp", qp0 * (rp - self.r_word))
        cs.create_gate("padt seed prlc", qp0 * (prlc - 129))
        qpc = qp * (1 - qp0)
        cs.create_gate("padt chain rp", qpc * (rp - rp_p * self.r_word))
        cs.create_gate("padt chain prlc", qpc * (prlc - rp_p - 128))
        pad_table = [qp, qp * (Fixed(self.tbl_byte) + 1), qp * rp, qp * prlc]

        # ---- SHA3 (reference execution/sha3.rs): pop (offset, size), read
        # the memory range through a memory->RLC copy event, extend the
        # message RLC over the pad10*1 suffix via the pad-power table, and
        # look the padded RLC + digest up in the KeccakTable.  Cells:
        # offset in c_addr, size in bytes_a[0:4], q136 in bytes_b[0:4],
        # digest bytes (output order) in bytes_c, pad length in c_push_len.
        gsha = q * ind["SHA3"]
        size4 = ba[0] + ba[1] * 256 + ba[2] * 65536 + ba[3] * 16777216
        size4_rlc = (ba[0] + ba[1] * self.r_word
                     + ba[2] * self.r_word * self.r_word
                     + ba[3] * self.r_word * self.r_word * self.r_word)
        for k in range(4, 32):
            cs.create_gate(f"SHA3 size byte {k} zero", gsha * ba[k])
        cs.create_gate("SHA3 offset rlc", gsha * (jdest_rlc - va))
        cs.create_gate("SHA3 size rlc", gsha * (size4_rlc - vb))
        cs.create_gate("SHA3 ez kill", gsha * ez * size4)
        cs.create_gate(
            "SHA3 ez complete", gsha * (1 - ez) * (size4 * inv - 1)
        )
        acc_m = Advice(self.c_acc_m)
        rpl, prl = Advice(self.c_rpl), Advice(self.c_prl)
        pl = Advice(self.c_push_len)
        q136 = bb[0] + bb[1] * 256 + bb[2] * 65536 + bb[3] * 16777216
        cs.create_gate("SHA3 pad mod", gsha * (size4 + pl - 136 * q136))
        cs.create_gate("SHA3 empty acc", gsha * ez * acc_m)
        cs.lookup_logup(
            "SHA3 pad powers",
            [[gsha, gsha * pl, gsha * rpl, gsha * prl]],
            pad_table,
        )
        # digest bytes: bytes_c[i] is DIGEST byte i (output order); the
        # pushed stack word's LE byte j is digest byte 31-j, so the word
        # RLC is the plain rlc_expr fold read in reverse — i.e. the
        # digest-order fold sum bc[i]*r^(31-i)... the stack convention
        # folds LE bytes with r^j, giving sum_j bc[31-j]*r^j.
        stack_hash_rlc = None
        rpow = None
        for j in range(32):
            term = bc[31 - j] if j == 0 else bc[31 - j] * rpow
            stack_hash_rlc = term if stack_hash_rlc is None \
                else stack_hash_rlc + term
            rpow = self.r_word if rpow is None else rpow * self.r_word
        cs.create_gate("SHA3 digest word", gsha * (stack_hash_rlc - vc))
        if self.keccak_table is not None:
            # KeccakTable output_rlc folds digest bytes msb-first:
            # sum bc[i] * r^i with digest byte 0 taking r^0
            out_rlc = rlc_expr(bc)
            acc_pad = acc_m * rpl + prl
            cs.lookup_logup(
                "SHA3 keccak",
                [[gsha, gsha * acc_pad, gsha * out_rlc]],
                self.keccak_table,
            )
        if self.copy_table is not None:
            glm = gsha * (1 - ez)
            cs.lookup_logup(
                "SHA3 copy event",
                [[
                    glm, glm, glm * 0, glm * 0, glm * 0, glm * 0,
                    glm * Advice(self.c_call_id),
                    glm * jdest_int, glm * 0, glm * 0,
                    glm * size4, glm * (rwc + 2), glm * acc_m,
                ]],
                self.copy_table,
            )
        cs.create_gate("SHA3 ez bool", gsha * ez * (ez - 1))
        transition(ind["SHA3"], 1, 3 + size4, 1)
        self._sha3_size4 = size4  # rw-bus accesses added below

        # ---- CALL / CALLCODE / DELEGATECALL / STATICCALL (reference
        # execution/callop.rs, heavily restructured): pops the call words,
        # writes the NEW frame's CallContext restoration + identity rows,
        # and hands control to the callee (next row: pc 0, empty stack,
        # call_id = first context write's rw counter).  Variant one-hot
        # flags live in carry cells 20..23.  v1 gaps (documented): the
        # callee code hash, DELEGATECALL's caller/value, and the static
        # flag are witness-carried (binding them needs the Account circuit
        # / parent-context reads, reference begin_tx.rs account lookups).
        gcall = q * ind["CALL"]
        gcalln = q * q_n * ind["CALL"]
        f1, f2, fdg, fsa = cr[20], cr[21], cr[22], cr[23]
        cs.create_gate(
            "CALL variant one-hot", gcall * (f1 + f2 + fdg + fsa - 1)
        )
        hv = f1 + f2  # variant carries a value word
        npops = 6 + hv
        addr_raw = None
        for i in range(20):
            term = ba[i] * (1 << (8 * i))
            addr_raw = term if addr_raw is None else addr_raw + term
        cs.create_gate("CALL to rlc", gcall * (rlc_expr(ba) - vb))
        args_off4, args_len4 = fold4_int(ab4), fold4_int(bb)
        ret_off4, ret_len4 = fold4_int(bd), fold4_int(be_)
        # no-descend flag (codeless callee: the plain-transfer shape,
        # reference callop.rs is_empty_code_hash branch, all four
        # variants); the callee's empty code is proven by an
        # Account.CodeHash read of 0 on the bus (builder convention:
        # code_hash 0 = no code).  CALLCODE's value moves caller->caller
        # (balance-checked no-op); DELEGATECALL/STATICCALL move nothing.
        fnd = cr[25]
        cs.create_gate("CALL nd bool", gcall * fnd * (fnd - 1))
        # abort flag (carry 26): depth == 1024 or insufficient balance —
        # the call never starts, 0 pushes, same frame continues
        # (reference callop.rs is_depth_ok / insufficient_balance).  The
        # CAUSE is witness-carried in v1 (documented, like the static
        # flag); value variants pin the caller balance on the bus.
        fab = cr[26]
        cs.create_gate("CALL ab bool", gcall * fab * (fab - 1))
        cs.create_gate("CALL nd/ab excl", gcall * fnd * fab)
        gdesc = gcalln * (1 - fnd - fab)
        gnd = gcalln * fnd
        gab = gcalln * fab
        cs.create_gate("CALL ab pc", gab * (pc_n - pc - 1))
        cs.create_gate("CALL ab sp", gab * (sp_n - sp - npops + 1))
        cs.create_gate(
            "CALL ab rwc", gab * (rwc_n - rwc - npops - 2 - hv)
        )
        # next row enters the callee frame (descend only)
        new_id = rwc + npops
        cs.create_gate("CALL callee pc0", gdesc * pc_n)
        cs.create_gate("CALL callee sp", gdesc * (sp_n - STACK_BASE))
        cs.create_gate("CALL callee id", gdesc * (cid_n - new_id))
        cs.create_gate("CALL rwc", gdesc * (rwc_n - rwc - npops - 17))
        cs.create_gate(
            "CALL callee addr",
            gdesc * (callee_n - (f1 + fsa) * addr_raw
                     - (f2 + fdg) * callee),
        )
        # no-descend transitions: same frame continues past the call
        # (callee/call_id/code-hash continuity comes from g_frame)
        cs.create_gate("CALL nd pc", gnd * (pc_n - pc - 1))
        cs.create_gate("CALL nd sp", gnd * (sp_n - sp - npops + 1))
        cs.create_gate(
            "CALL nd rwc", gnd * (rwc_n - rwc - npops - 3 - 2 * hv)
        )
        # caller address: own executing address, except DELEGATECALL which
        # inherits the parent's caller (witness cells in c_mem[0:20])
        caller20 = None
        for i in range(20):
            term = mem_c[i] * (1 << (8 * i))
            caller20 = term if caller20 is None else caller20 + term
        caller_val = (1 - fdg) * callee + fdg * caller20
        static_cell = Advice(self.c_ez)
        value_val = hv * vc + fdg * Advice(self.c_acc_m)
        self._call_ctx_writes = [
            (int(CallContextField.CallerId), Advice(self.c_call_id)),
            (int(CallContextField.ReturnPc), pc + 1),
            (int(CallContextField.ReturnSp), sp + npops - 1),
            (int(CallContextField.RetOffset), ret_off4),
            (int(CallContextField.RetLength), ret_len4),
            (int(CallContextField.ParentCalleeAddress), callee),
            (int(CallContextField.ParentCodeHash), chash),
            (int(CallContextField.TxId), txid),
            (int(CallContextField.CalleeAddress),
             (f1 + fsa) * addr_raw + (f2 + fdg) * callee),
            (int(CallContextField.CallerAddress), caller_val),
            (int(CallContextField.Value), value_val),
            (int(CallContextField.CallDataLength), args_len4),
            (int(CallContextField.CallDataOffset), args_off4),
            (int(CallContextField.CodeHash), chash_n),
            (int(CallContextField.IsStatic), static_cell),
            (int(CallContextField.IsRoot), 0),
            (int(CallContextField.IsCreate), 0),
        ]
        self._call_npops = npops
        self._call_new_id = new_id
        self._call_addr_raw = addr_raw

        # ---- CREATE / CREATE2 (reference execution/create.rs, heavily
        # restructured): pops (value, offset, size[, salt]), bumps the
        # creator nonce, warms + endows the created account, initializes
        # its nonce to 1 (EIP-161), writes the init frame's CallContext
        # rows, and hands control to the init code.  The created address
        # is DERIVED IN-CIRCUIT: the keccak preimage — rlp([sender,
        # nonce]) for CREATE (23 bytes, nonce <= 0x7f v1 scope) or
        # 0xff ++ sender ++ salt ++ keccak(init) for CREATE2 (85 bytes) —
        # is folded from constrained byte cells and looked up in the
        # KeccakTable with the digest whose low 20 bytes become the
        # callee.  Cells: fc2 (is-CREATE2) cr[20], nonce-zero flag fz
        # cr[21], creator nonce byte bytes_f[0], sender LE bytes
        # c_mem[0:20], salt LE bytes bank d, init-code-hash BE bytes
        # bank e, address-digest BE bytes bank c, pad length c_push_len.
        gcr = q * ind["CREATE"]
        gcrn = q * q_n * ind["CREATE"]
        fc2, fz = cr[20], cr[21]
        nz_c = bf_[0]
        cs.create_gate("CREATE fc2 bool", gcr * fc2 * (fc2 - 1))
        cs.create_gate("CREATE fz bool", gcr * fz * (fz - 1))
        cs.create_gate("CREATE fz kill", gcr * fz * nz_c)
        # completeness direction: fz MUST be 1 when nz = 0,
        # else the prover could emit RLP tail byte 0x00 for a nonce-0
        # creator and forge the created address.  IsZero pattern with the
        # inverse witness in c_ez (free on CREATE rows).
        nz_inv_c = Advice(self.c_ez)
        cs.create_gate(
            "CREATE fz complete", gcr * (1 - fz) * (nz_c * nz_inv_c - 1)
        )
        npe = 3 + fc2
        # sender bytes bind to the executing address
        sender_sum = None
        for i in range(20):
            term = mem_c[i] * (1 << (8 * i))
            sender_sum = term if sender_sum is None else sender_sum + term
        cs.create_gate("CREATE sender bytes", gcr * (sender_sum - callee))
        sender_be = [mem_c[19 - j] for j in range(20)]
        # CREATE preimage: rlp([sender, nonce]) with VARIABLE nonce
        # length (witness/mpt nonce > 0x7F):
        #   nl=0:    0xd6 0x94 ++ sender ++ (0x80 | nonce)     23 bytes
        #   nl=j>=1: (0xd6+j) 0x94 ++ sender ++ (0x80+j)
        #            ++ nonce_be[0..j)                         23+j bytes
        # One-hot o_1..o_8 (mem_c[20..27], free on CREATE rows) selects
        # the branch; nonce bytes live big-endian in bytes_f[1..8].
        # Canonical-encoding byte rows below forbid non-minimal witness
        # RLP (a longer encoding would derive a forged address).
        o_cells = [mem_c[20 + j] for j in range(8)]  # o_1..o_8
        s_sum = None
        nl_sum = None
        for j, o in enumerate(o_cells):
            cs.create_gate(f"CREATE o{j+1} bool", gcr * o * (o - 1))
            s_sum = o if s_sum is None else s_sum + o
            t_nl = o * (j + 1)
            nl_sum = t_nl if nl_sum is None else nl_sum + t_nl
        cs.create_gate("CREATE nl one-hot", gcr * s_sum * (s_sum - 1))
        # multi-byte nonce is >= 0x80, never zero
        cs.create_gate("CREATE fz multi kill", gcr * fz * s_sum)
        # nonce VALUE recomposition (feeds the bump access row)
        nonce_val = (1 - s_sum) * nz_c
        for j in range(1, 9):
            acc_nv = None
            for i in range(j):
                t_v = bf_[1 + i] * (1 << (8 * (j - 1 - i)))
                acc_nv = t_v if acc_nv is None else acc_nv + t_v
            nonce_val = nonce_val + o_cells[j - 1] * acc_nv
        self._create_nv = nonce_val
        last_byte = fz * 0x80 + nz_c
        nl_folds = []
        for j in range(9):
            if j == 0:
                seq = [0xd6, 0x94] + sender_be + [last_byte]
            else:
                seq = ([0xd6 + j, 0x94] + sender_be + [0x80 + j]
                       + [bf_[1 + i] for i in range(j)])
            accj = None
            for b_e in seq:
                accj = b_e if accj is None else accj * self.r_word + b_e
            nl_folds.append(accj)
        acc1 = (1 - s_sum) * nl_folds[0]
        for j in range(1, 9):
            acc1 = acc1 + o_cells[j - 1] * nl_folds[j]
        # CREATE2 preimage: 0xff ++ sender ++ salt(be) ++ keccak(init)
        salt_be = [bd[31 - j] for j in range(32)]
        kec_init = [be_[i] for i in range(32)]
        acc2 = None
        for b_e in [0xff] + sender_be + salt_be + kec_init:
            acc2 = b_e if acc2 is None else acc2 * self.r_word + b_e
        # the init-code hash bytes ARE the child frame's code hash (next
        # row / ctx CodeHash write): BE byte i takes r^i in the encoding
        cs.create_gate(
            "CREATE2 init hash bytes", gcrn * fc2 * (rlc_expr(be_) - chash_n)
        )
        # pad-power read: pad = 113 - nl for CREATE (23+nl byte msg),
        # fixed 51 for CREATE2 (85 bytes)
        pl_c = Advice(self.c_push_len)
        rpl_c, prl_c = Advice(self.c_rpl), Advice(self.c_prl)
        cs.create_gate(
            "CREATE pad len",
            gcr * (pl_c - (1 - fc2) * (113 - nl_sum) - fc2 * 51),
        )
        cs.lookup_logup(
            "CREATE pad powers",
            [[gcr, gcr * pl_c, gcr * rpl_c, gcr * prl_c]],
            pad_table,
        )
        acc_sel = acc1 + fc2 * (acc2 - acc1)
        acc_pad_c = acc_sel * rpl_c + prl_c
        if self.keccak_table is not None:
            cs.lookup_logup(
                "CREATE keccak address",
                [[gcr, gcr * acc_pad_c, gcr * rlc_expr(bc)]],
                self.keccak_table,
            )
        # created address = low 20 bytes of the digest (big-endian)
        create_addr = None
        for i in range(12, 32):
            term = bc[i] * (1 << (8 * (31 - i)))
            create_addr = term if create_addr is None \
                else create_addr + term
        # next row enters the init frame
        new_id_c = rwc + npe + 5
        cs.create_gate("CREATE callee pc0", gcrn * pc_n)
        cs.create_gate("CREATE callee sp", gcrn * (sp_n - STACK_BASE))
        cs.create_gate("CREATE callee id", gcrn * (cid_n - new_id_c))
        cs.create_gate("CREATE rwc", gcrn * (rwc_n - rwc - npe - 22))
        cs.create_gate("CREATE callee addr", gcrn * (callee_n - create_addr))
        self._create_ctx_writes = [
            (int(CallContextField.CallerId), Advice(self.c_call_id)),
            (int(CallContextField.ReturnPc), pc + 1),
            (int(CallContextField.ReturnSp), sp + npe - 1),
            (int(CallContextField.RetOffset), 0),
            (int(CallContextField.RetLength), 0),
            (int(CallContextField.ParentCalleeAddress), callee),
            (int(CallContextField.ParentCodeHash), chash),
            (int(CallContextField.TxId), txid),
            (int(CallContextField.CalleeAddress), create_addr),
            (int(CallContextField.CallerAddress), callee),
            (int(CallContextField.Value), va),
            (int(CallContextField.CallDataLength), 0),
            (int(CallContextField.CallDataOffset), 0),
            (int(CallContextField.CodeHash), chash_n),
            (int(CallContextField.IsStatic), 0),
            (int(CallContextField.IsRoot), 0),
            (int(CallContextField.IsCreate), 1),
        ]
        self._create_npops = npe
        self._create_new_id = new_id_c
        self._create_addr = create_addr
        self._create_fc2 = fc2
        self._create_nz = nz_c
        self._create_sel0 = 1 - s_sum
        self._create_o = o_cells
        self._create_lead = bf_[1]

        # ---- RET: nested STOP / RETURN / REVERT (reference
        # execution/return_revert.rs): copy return data into the caller's
        # memory (min(len, declared)), restore the caller frame from the
        # CallContext rows the CALL wrote, push the success flag.  Variant
        # flags rtn/stp/rvt + the min-selector live in carry cells 20..23.
        gret = q * ind["RET"]
        gretn = q * q_n * ind["RET"]
        rtn, stp, rvt, fmin = cr[20], cr[21], cr[22], cr[23]
        cs.create_gate("RET variant one-hot", gret * (rtn + stp + rvt - 1))
        # error-unwind modifier (carry cell 25): the frame ended on an
        # error row, not on a terminator opcode — rides the STOP variant
        # (no pops, no return data, no bytecode binding) but pushes 0 to
        # the caller and exposes no return data (reference
        # CommonErrorGadget restore_context, execution/error_*.rs).  A
        # ferr row must directly follow an error-state row.
        ferr = cr[25]
        cs.create_gate("RET ferr bool", gret * ferr * (ferr - 1))
        cs.create_gate("RET ferr variant", gret * ferr * (1 - stp))
        e_all_prev = None
        for ek in ("ERR_STACK", "ERR_OOG", "ERR_JUMP", "ERR_RDOOB",
                   "ERR_WRITE_PROT", "ERR_INVALID_OP", "ERR_OOG_DYN"):
            t_ = Advice(self.c_ind[ek], -1)
            e_all_prev = t_ if e_all_prev is None else e_all_prev + t_
        cs.create_gate("RET ferr prev error", gret * ferr * (1 - e_all_prev))
        # init-frame return flag (create path of return_revert.rs): the
        # parent receives the created ADDRESS (success) / 0 (revert)
        # instead of a success bit, successful creates expose no return
        # data, and a RETURN deposits the code (CodeHash account write).
        # The created address = this frame's own callee, decomposed into
        # bank c (LE).
        fcr = cr[24]
        cs.create_gate("RET fcr bool", gret * fcr * (fcr - 1))
        caddr_sum = None
        caddr_rlc = None
        rpow_c = None
        for i in range(20):
            term = bc[i] * (1 << (8 * i))
            caddr_sum = term if caddr_sum is None else caddr_sum + term
            t2 = bc[i] if i == 0 else bc[i] * rpow_c
            caddr_rlc = t2 if caddr_rlc is None else caddr_rlc + t2
            rpow_c = self.r_word if rpow_c is None \
                else rpow_c * self.r_word
        cs.create_gate(
            "RET create addr bytes", gret * fcr * (caddr_sum - callee)
        )
        has_data = rtn + rvt
        npp = 2 * has_data
        off4 = fold4_int(ab4)
        len4 = fold4_int(bb)
        retoff4 = fold4_int(ba)
        retlen4 = fold4_int(be_)
        la4 = fold4_int(bd)
        diff4 = mem_c[0] + mem_c[1] * 256 + mem_c[2] * 65536 \
            + mem_c[3] * 16777216
        gd = gret * has_data
        cs.create_gate("RET off rlc", gd * (fold4_rlc(ab4) - va))
        cs.create_gate(
            "RET len rlc",
            gd * (bb[0] + bb[1] * self.r_word
                  + bb[2] * self.r_word * self.r_word
                  + bb[3] * self.r_word * self.r_word * self.r_word - vb),
        )
        # la = min(len, declared retlen) via the min-selector + range diff
        cs.create_gate(
            "RET min pick", gd * (la4 - fmin * len4 - (1 - fmin) * retlen4)
        )
        cs.create_gate(
            "RET min lo", gd * fmin * (retlen4 - len4 - diff4)
        )
        cs.create_gate(
            "RET min hi", gd * (1 - fmin) * (len4 - retlen4 - diff4)
        )
        cs.create_gate("RET stop no data", gret * stp * la4)
        cs.create_gate("RET min bool", gd * fmin * (fmin - 1))
        cs.create_gate("CALL static bool", gcall * static_cell
                       * (static_cell - 1))
        # la == 0 flag (skips the copy lookup; ez/inv are free on RET rows)
        laz = Advice(self.c_ez)
        cs.create_gate("RET laz bool", gret * laz * (laz - 1))
        cs.create_gate("RET laz kill", gret * laz * la4)
        cs.create_gate(
            "RET laz complete", gret * (1 - laz) * (la4 * inv - 1)
        )
        if self.copy_table is not None:
            glc = gret * (1 - laz)
            cs.lookup_logup(
                "RET copy event",
                [[
                    glc, glc * 0, glc, glc * 0, glc * 0, glc * 0,
                    glc * Advice(self.c_call_id),
                    glc * off4, glc * cid_n, glc * retoff4, glc * la4,
                    glc * (rwc + npp), glc * 0,
                ]],
                self.copy_table,
            )
        cs.create_gate(
            "RET rwc",
            gretn * (rwc_n - rwc - npp - 2 * la4 - 12 - fcr * rtn
                     - Advice(self.c_gas_aux)),
        )
        self._ret_npp = npp
        self._ret_la4 = la4
        self._ret_off4 = off4
        self._ret_len4 = len4
        self._ret_flags = (rtn, stp, rvt)
        self._ret_retoff4 = retoff4
        self._ret_retlen4 = retlen4
        self._ret_fcr = fcr
        self._ret_ferr = ferr
        self._ret_caddr_rlc = caddr_rlc

        # ---- LOG0..LOG4 (reference execution/logs.rs): pops (offset,
        # size, topics); TxLog rows for the address + topics; a memory->
        # TxLog copy event for the data.  Topic-count one-hot flags in
        # carry cells 24..28; topic word RLCs in the four spare phase-1
        # cells (vc, acc_m, rpl, prl — free on LOG rows). ----------------
        glog = q * ind["LOG"]
        glogn = q * q_n * ind["LOG"]
        lflags = [cr[24 + j] for j in range(5)]
        lsum = None
        n_e = None
        for j, lf in enumerate(lflags):
            lsum = lf if lsum is None else lsum + lf
            if j:
                term = lf * j
                n_e = term if n_e is None else n_e + term
        n_e = n_e if n_e is not None else 0
        cs.create_gate("LOG ntopics one-hot", glog * (lsum - 1))
        lid = Advice(self.c_log_id)
        lid_n = Advice(self.c_log_id, 1)
        lid1 = lid + 1
        L32, L48 = 1 << 32, 1 << 48
        cs.create_gate("LOG offset rlc", glog * (fold4_rlc(ab4) - va))
        size_rlc_l = (bb[0] + bb[1] * self.r_word
                      + bb[2] * self.r_word * self.r_word
                      + bb[3] * self.r_word * self.r_word * self.r_word)
        size4_l = fold4_int(bb)
        cs.create_gate("LOG size rlc", glog * (size_rlc_l - vb))
        cs.create_gate("LOG ez bool", glog * ez * (ez - 1))
        cs.create_gate("LOG ez kill", glog * ez * size4_l)
        cs.create_gate(
            "LOG ez complete", glog * (1 - ez) * (size4_l * inv - 1)
        )
        addr20 = None
        for i in range(20):
            term = ba[i] * (1 << (8 * i))
            addr20 = term if addr20 is None else addr20 + term
        cs.create_gate("LOG addr bind", glog * (addr20 - callee))
        for i in range(20, 32):
            cs.create_gate(f"LOG addr byte {i} zero", glog * ba[i])
        # persistence flag (carry cell 29): 0 when the frame chain is
        # doomed — the LOG then pops + charges gas but emits NO TxLog
        # rows / copy event and the log counter stays (reference
        # bus-mapping gates TxLog ops on call.is_persistent,
        # src/evm/opcodes/logs.rs; v1 gap, documented like the CALL
        # gadget's witness-carried static flag: fp is witness-carried —
        # binding it needs the CallContext IsPersistent plumbing).
        fp_log = cr[29]
        cs.create_gate("LOG fp bool", glog * fp_log * (fp_log - 1))
        if self.copy_table is not None:
            gll = glog * (1 - ez) * fp_log
            cs.lookup_logup(
                "LOG copy event",
                [[
                    gll, gll * 0, gll * 0, gll, gll * 0, gll * 0,
                    gll * Advice(self.c_call_id), gll * fold4_int(ab4),
                    gll * txid, gll * (3 * L32 + lid1 * L48),
                    gll * size4_l, gll * (rwc + 3 + 2 * n_e), gll * 0,
                ]],
                self.copy_table,
            )
        transition(
            ind["LOG"], 1,
            fp_log * (3 + 2 * n_e + 2 * size4_l)
            + (1 - fp_log) * (2 + n_e),
            2 + n_e,
        )
        # log counter walk: +1 on PERSISTENT LOG rows, reset at BEGIN_TX
        cs.create_gate("log id begin", q * bt * lid)
        cs.create_gate(
            "log id walk",
            q * q_n * (1 - bt_n) * (lid_n - lid - ind["LOG"] * fp_log),
        )
        self._log_topic_cells = [
            vc, Advice(self.c_acc_m), Advice(self.c_rpl), Advice(self.c_prl)
        ]
        self._log_flags = lflags
        self._log_n = n_e
        self._log_lid1 = lid1

        # ---- dynamic gas: copies / SHA3 / LOG / RETURN / REVERT ----------
        # (reference memory_gadget.rs MemoryExpansionGadget +
        # MemoryCopierGasGadget; execution/{calldatacopy,codecopy,
        # returndatacopy,sha3,logs,return_revert}.rs).  cost = base +
        # word_mult*ceil(size/32) + byte_mult*size + memexp(start, size),
        # with memexp active only when size != 0.  start sits in c_addr
        # for every family member; size in bytes_a for SHA3, bytes_b
        # elsewhere.  Root RETURN/REVERT get 4-byte off/len bindings here
        # (their gadget only reads the word RLCs).
        grr_ = q * (ind["RETURN"] + ind["REVERT"])
        cs.create_gate("RR off bytes", grr_ * (fold4_rlc(ab4) - va))
        cs.create_gate("RR len bytes", grr_ * (fold4_rlc(bb) - vb))
        dyn_ops = (ind["CALLDATACOPY"] + ind["CODECOPY"]
                   + ind["RETURNDATACOPY"] + ind["SHA3"] + ind["LOG"]
                   + ind["RETURN"] + ind["REVERT"] + ind["EXTCODECOPY"])
        g_dy = q * dyn_ops
        start_dy = fold4_int(ab4)
        size_dy = (ind["SHA3"] * fold4_int(ba)
                   + (dyn_ops - ind["SHA3"]) * fold4_int(bb))
        copies3 = (ind["CALLDATACOPY"] + ind["CODECOPY"]
                   + ind["RETURNDATACOPY"])
        # EXTCODECOPY's base is the EIP-2929 account access (warm 100 /
        # cold 2600), a membership-checked cell (c_eo, free on its rows)
        xcc_base = Advice(self.c_eo)
        gxc_ = q * ind["EXTCODECOPY"]
        cs.create_gate(
            "XCC base membership",
            gxc_ * (xcc_base - 100) * (xcc_base - 2600),
        )
        base_dy = 3 * copies3 + 30 * ind["SHA3"] \
            + ind["LOG"] * (375 + 375 * n_e) \
            + ind["EXTCODECOPY"] * xcc_base
        wm_dy = 3 * (copies3 + ind["EXTCODECOPY"]) + 6 * ind["SHA3"]
        bm_dy = 8 * ind["LOG"]
        (dm, drem, de, dd0, dd1, dd2, dd3, dtn, ds0, ds1, dto, dso0,
         dso1) = gx[:13]
        d_nz = Advice(self.c_gx[13])
        d_szinv = Advice(self.c_gx[14])
        d_mwp = Advice(self.c_gx[15])
        d_wcnt = Advice(self.c_gx[16])
        d_wrem = Advice(self.c_gx[17])
        # nz = (size != 0), complete both ways via the inverse witness
        cs.create_gate("dyngas nz bool", g_dy * d_nz * (d_nz - 1))
        cs.create_gate("dyngas nz def", g_dy * (d_nz - size_dy * d_szinv))
        cs.create_gate("dyngas nz kill", g_dy * (1 - d_nz) * size_dy)
        # word count: 32*wcnt = size + wrem, wrem < 32
        cs.create_gate(
            "dyngas words", g_dy * (32 * d_wcnt - size_dy - d_wrem)
        )
        # end words m = ceil((start + size)/32), only bound when nz
        cs.create_gate(
            "dyngas m def",
            g_dy * d_nz * (32 * dm - start_dy - size_dy - drem),
        )
        # mw' = nz ? max(mw, m) : mw
        dd4 = dd0 + 256 * dd1 + 65536 * dd2 + 16777216 * dd3
        cs.create_gate("dyngas e bool", g_dy * de * (de - 1))
        cs.create_gate("dyngas mwp hi", g_dy * d_nz * de * (d_mwp - dm))
        cs.create_gate(
            "dyngas mwp lo", g_dy * (1 - d_nz * de) * (d_mwp - mw_e)
        )
        cs.create_gate(
            "dyngas order",
            g_dy * d_nz * (de * (dm - mw_e - dd4)
                           + (1 - de) * (mw_e - dm - dd4)),
        )
        # quadratic terms: t = mw^2 // 512 with s < 512 remainders
        cs.create_gate("dyngas s1 bool", g_dy * ds1 * (ds1 - 1))
        cs.create_gate("dyngas so1 bool", g_dy * dso1 * (dso1 - 1))
        cs.create_gate(
            "dyngas quad new",
            g_dy * d_nz * (d_mwp * d_mwp - 512 * dtn - ds0 - 256 * ds1),
        )
        cs.create_gate(
            "dyngas quad old",
            g_dy * d_nz * (mw_e * mw_e - 512 * dto - dso0 - 256 * dso1),
        )
        cs.create_gate(
            "dyngas cost",
            g_dy * (cost_e - base_dy - wm_dy * d_wcnt - bm_dy * size_dy
                    - d_nz * (3 * (d_mwp - mw_e) + dtn - dto)),
        )
        # the expanded size becomes the next step's memory words (root
        # RETURN/REVERT are terminal: no successor constraint)
        cs.create_gate(
            "dyngas mw step",
            q * q_n * (dyn_ops - ind["RETURN"] - ind["REVERT"])
            * (mw_n - d_mwp),
        )

        # ---- ERR_OOG_DYN (reference error_oog_memory_copy.rs,
        # error_oog_sha3.rs, error_oog_log.rs, error_oog_dynamic_memory
        # _expansion.rs, error_oog_static_memory_expansion.rs): out of
        # gas on a dynamic-cost op of the memory / hash / copy / log /
        # return family.  The failing operands are READ on the bus (addr
        # word in bytes_a/c_addr u32, size word in bytes_b u32), the
        # required gas is RECOMPUTED in-circuit — constant (props table)
        # + topic gas (LOG) + per-word (SHA3 6, copies 3) + per-byte
        # (LOG 8) + memory expansion vs the carried mem-words column —
        # and gas_left < required via a u64 slack in bytes_f.  Family
        # one-hot flags in carry cells 2..7; expansion cells reuse the
        # dyngas gx layout (free on error rows). ------------------------
        g_eod = q * ind["ERR_OOG_DYN"]
        eo_f = {name: cr[2 + i] for i, name in enumerate(
            ("m32", "m1", "sha", "copy", "log", "span")
        )}
        eo_sum = None
        for fl in eo_f.values():
            cs.create_gate("EOD flag bool", g_eod * fl * (fl - 1))
            eo_sum = fl if eo_sum is None else eo_sum + fl
        cs.create_gate("EOD one family", g_eod * (eo_sum - 1))
        # family <-> opcode byte binding
        cs.create_gate("EOD m32 op", g_eod * eo_f["m32"]
                       * (opb_e - 0x51) * (opb_e - 0x52))
        cs.create_gate("EOD m1 op", g_eod * eo_f["m1"] * (opb_e - 0x53))
        cs.create_gate("EOD sha op", g_eod * eo_f["sha"] * (opb_e - 0x20))
        cs.create_gate("EOD copy op", g_eod * eo_f["copy"]
                       * (opb_e - 0x37) * (opb_e - 0x39) * (opb_e - 0x3E))
        eo_logop = None
        for i in range(5):
            term = (opb_e - 0xA0 - i)
            eo_logop = term if eo_logop is None else eo_logop * term
        cs.create_gate("EOD log op", g_eod * eo_f["log"] * eo_logop)
        cs.create_gate("EOD span op", g_eod * eo_f["span"]
                       * (opb_e - 0xF3) * (opb_e - 0xFD))
        # u64-overflow sub-shape (reference error_gas_uint_overflow /
        # geth ErrGasUintOverflow + the "absurd operand" OOGs): when an
        # extent operand does not fit u32, the required gas trivially
        # exceeds any real gas budget.  Flag fov (carry 8) selects it:
        # the offending WORD (addr, or size when fhi=1) binds to the
        # full bank-c decomposition whose high-byte sum is proven
        # nonzero (inverse in gx[15]), and gas_left is bound < 2^40 by
        # a 5-byte bank-d decomposition — 3*2^27 expansion words alone
        # cost > 2^41.  The normal required-gas machinery is gated off
        # under fov.
        fov, fhi = cr[8], cr[9]
        cs.create_gate("EOD fov bool", g_eod * fov * (fov - 1))
        cs.create_gate("EOD fhi bool", g_eod * fhi * (fhi - 1))
        cs.create_gate("EOD fhi needs fov", g_eod * (1 - fov) * fhi)
        eo_w_rlc = rlc_expr(bc)
        cs.create_gate(
            "EOD ovf word bind",
            g_eod * fov * (eo_w_rlc - va - fhi * (vb - va)),
        )
        eo_hi_sum = None
        for i in range(4, 32):
            eo_hi_sum = bc[i] if eo_hi_sum is None else eo_hi_sum + bc[i]
        cs.create_gate(
            "EOD ovf high nonzero", g_eod * fov * (eo_hi_sum * gx[15] - 1)
        )
        eo_gas40 = None
        for i in range(5):
            term = bd[i] * (1 << (8 * i))
            eo_gas40 = term if eo_gas40 is None else eo_gas40 + term
        cs.create_gate("EOD ovf gas u40", g_eod * fov * (gas_e - eo_gas40))
        g_eodn = g_eod * (1 - fov)
        # operand bindings (addr always; size for non-mem families; the
        # u32 folds force the read words < 2^32)
        eo_mem = eo_f["m32"] + eo_f["m1"]
        cs.create_gate("EOD addr rlc", g_eodn * (fold4_rlc(ab4) - va))
        cs.create_gate(
            "EOD size rlc", g_eodn * (1 - eo_mem) * (fold4_rlc(bb) - vb)
        )
        eo_size = fold4_int(bb)
        cs.create_gate("EOD mem size zero", g_eodn * eo_mem * eo_size)
        # expansion: active for mem families always, others when size != 0
        (edm, edrem, ede, edd0, edd1, edd2, edd3, edtn, eds0, eds1,
         edto, edso0, edso1) = gx[:13]
        eo_nz, eo_szinv = gx[13], gx[14]
        eo_wcnt, eo_wrem = gx[16], gx[17]
        cs.create_gate("EOD nz bool", g_eod * eo_nz * (eo_nz - 1))
        cs.create_gate("EOD nz def", g_eodn * (eo_nz - eo_size * eo_szinv))
        cs.create_gate("EOD nz kill", g_eodn * (1 - eo_nz) * eo_size)
        eo_act = (eo_mem + (1 - eo_mem) * eo_nz) * (1 - fov)
        eo_extent = (fold4_int(ab4) + 32 * eo_f["m32"] + eo_f["m1"]
                     + (1 - eo_mem) * eo_size)
        cs.create_gate(
            "EOD m def",
            g_eod * eo_act * (32 * edm - eo_extent - edrem),
        )
        edd4 = edd0 + 256 * edd1 + 65536 * edd2 + 16777216 * edd3
        cs.create_gate("EOD e bool", g_eod * ede * (ede - 1))
        cs.create_gate(
            "EOD order",
            g_eod * eo_act * (ede * (edm - mw_e - edd4)
                              + (1 - ede) * (mw_e - edm - edd4)),
        )
        cs.create_gate("EOD s1 bool", g_eod * eds1 * (eds1 - 1))
        cs.create_gate("EOD so1 bool", g_eod * edso1 * (edso1 - 1))
        eo_exp = g_eod * eo_act * ede
        cs.create_gate(
            "EOD quad new",
            eo_exp * (edm * edm - 512 * edtn - eds0 - 256 * eds1),
        )
        cs.create_gate(
            "EOD quad old",
            eo_exp * (mw_e * mw_e - 512 * edto - edso0 - 256 * edso1),
        )
        # word count for the per-word families
        eo_wfam = eo_f["sha"] + eo_f["copy"]
        cs.create_gate(
            "EOD words", g_eodn * eo_wfam * (32 * eo_wcnt - eo_size
                                             - eo_wrem)
        )
        eo_required = (
            g0_e
            + eo_f["log"] * 375 * (opb_e - 0xA0)
            + (6 * eo_f["sha"] + 3 * eo_f["copy"]) * eo_wcnt
            + 8 * eo_f["log"] * eo_size
            + eo_act * ede * (3 * (edm - mw_e) + edtn - edto)
        )
        eo_slack = None
        for i in range(8):
            term = bf_[i] * (1 << (8 * i))
            eo_slack = term if eo_slack is None else eo_slack + term
        cs.create_gate(
            "EOD insufficient",
            g_eodn * (eo_required - gas_e - 1 - eo_slack),
        )
        # rw-counter transition: the operand reads advance it
        eo_nre = 1 + (eo_f["sha"] + eo_f["log"] + eo_f["span"]) \
            + 2 * eo_f["copy"]
        cs.create_gate(
            "EOD rwc", q * q_n * ind["ERR_OOG_DYN"]
            * (rwc_n - rwc - eo_nre)
        )
        self._eod_flags = eo_f
        # ---- ERR_JUMP (reference execution/error_invalid_jump.rs): a
        # JUMP (or taken JUMPI) whose destination is invalid — out of the
        # code range (oor=1: high word bytes nonzero, or dest >= length)
        # or an in-range byte that is not an is_code JUMPDEST (oor=0).
        # Cells: dest bytes in bytes_a; fj (is JUMPI) cr[0]; hz cr[1];
        # oor cr[2]; hz_inv gx[1]; e4 gx[3..6]; length gx[7]; target byte
        # gx[8]; is_code gx[9]; byte!=0x5B flag gx[10] + inverse gx[11].
        g_ej = q * ind["ERR_JUMP"]
        ej_fj = cr[0]
        ej_hz = cr[1]
        ej_oor = cr[2]
        ej_hzinv = gx[1]
        ej_e4 = (gx[3] + 256 * gx[4] + 65536 * gx[5]
                 + 16777216 * gx[6])
        ej_len = gx[7]
        ej_b = gx[8]
        ej_ic = gx[9]
        ej_neq = gx[10]
        ej_binv = gx[11]
        dest4_ej = fold4_int(ba)
        s28_ej = None
        for i in range(4, 32):
            s28_ej = ba[i] if s28_ej is None else s28_ej + ba[i]
        cs.create_gate("ERR_JUMP dest rlc", g_ej * (rlc_expr(ba) - va))
        cs.create_gate("ERR_JUMP fj bool", g_ej * ej_fj * (ej_fj - 1))
        cs.create_gate("ERR_JUMP op byte", g_ej * (opb_e - 0x56 - ej_fj))
        # taken JUMPI: the popped condition is nonzero
        cs.create_gate("ERR_JUMP cond", g_ej * ej_fj * (vb * inv2 - 1))
        cs.create_gate("ERR_JUMP hz bool", g_ej * ej_hz * (ej_hz - 1))
        cs.create_gate(
            "ERR_JUMP hz def", g_ej * (ej_hz - 1 + s28_ej * ej_hzinv)
        )
        cs.create_gate("ERR_JUMP hz kill", g_ej * ej_hz * s28_ej)
        cs.create_gate("ERR_JUMP oor bool", g_ej * ej_oor * (ej_oor - 1))
        # oor with in-word dest: dest4 >= length (4-byte distance)
        cs.create_gate(
            "ERR_JUMP oor dist",
            g_ej * ej_oor * ej_hz * (dest4_ej - ej_len - ej_e4),
        )
        # in-range: high bytes must be zero and the target byte must not
        # be an is_code JUMPDEST
        cs.create_gate(
            "ERR_JUMP inrange hz", g_ej * (1 - ej_oor) * (1 - ej_hz)
        )
        cs.create_gate("ERR_JUMP neq bool", g_ej * ej_neq * (ej_neq - 1))
        cs.create_gate(
            "ERR_JUMP neq def",
            g_ej * (ej_neq - (ej_b - 0x5B) * ej_binv),
        )
        cs.create_gate(
            "ERR_JUMP neq kill", g_ej * (1 - ej_neq) * (ej_b - 0x5B)
        )
        cs.create_gate(
            "ERR_JUMP not jumpdest",
            g_ej * (1 - ej_oor) * ej_ic * (1 - ej_neq),
        )
        gejn = q * q_n * ind["ERR_JUMP"]
        cs.create_gate("ERR_JUMP rwc", gejn * (rwc_n - rwc - 1 - ej_fj))

        # ---- ERR_RDOOB (reference execution/error_return_data_oo_bound
        # .rs): RETURNDATACOPY with src + len > return-data length.  src
        # bytes in bytes_a[0:4], len in bytes_b[0:4], rdlen in c_addr,
        # overshoot distance e4 in gx[3..6].
        g_rd = q * ind["ERR_RDOOB"]
        rd_e4 = ej_e4
        cs.create_gate("ERR_RDOOB src rlc", g_rd * (fold4_rlc(ba) - vb))
        cs.create_gate("ERR_RDOOB len rlc", g_rd * (fold4_rlc(bb) - vc))
        cs.create_gate(
            "ERR_RDOOB overshoot",
            g_rd * (fold4_int(ba) + fold4_int(bb) - fold4_int(ab4)
                    - 1 - rd_e4),
        )
        gerdn = q * q_n * ind["ERR_RDOOB"]
        cs.create_gate("ERR_RDOOB rwc", gerdn * (rwc_n - rwc - 4))

        # ---- RETURNDATASIZE / RETURNDATACOPY (reference execution/
        # returndatasize.rs, returndatacopy.rs): read the last callee's
        # bookkeeping context rows; RDC copies from the CALLEE's memory
        # via a memory->memory event, with src+len <= rdlen enforced. ----
        grds = q * ind["RETURNDATASIZE"]
        cs.create_gate("RDS rlc", grds * (fold4_rlc(ab4) - va))
        transition(ind["RETURNDATASIZE"], 1, 2, -1)
        grdc = q * ind["RETURNDATACOPY"]
        grdcn = q * q_n * ind["RETURNDATACOPY"]
        rdc_src4 = fold4_int(ba)
        rdc_len4 = fold4_int(bb)
        rdc_off4 = (bd[0] + bd[1] * 256 + bd[2] * 65536
                    + bd[3] * 16777216)
        rdc_rdl4 = (be_[0] + be_[1] * 256 + be_[2] * 65536
                    + be_[3] * 16777216)
        rdc_diff4 = (bf_[0] + bf_[1] * 256 + bf_[2] * 65536
                     + bf_[3] * 16777216)
        rdc_lcid = Advice(self.c_push_len)
        cs.create_gate("RDC dst rlc", grdc * (fold4_rlc(ab4) - va))
        cs.create_gate("RDC src rlc", grdc * (fold4_rlc(ba[:4]) - vb))
        cs.create_gate("RDC len rlc", grdc * (fold4_rlc(bb[:4]) - vc))
        cs.create_gate(
            "RDC bound", grdc * (rdc_rdl4 - rdc_src4 - rdc_len4 - rdc_diff4)
        )
        cs.create_gate("RDC ez bool", grdc * ez * (ez - 1))
        cs.create_gate("RDC ez kill", grdc * ez * rdc_len4)
        cs.create_gate(
            "RDC ez complete", grdc * (1 - ez) * (rdc_len4 * inv - 1)
        )
        if self.copy_table is not None:
            glr2 = grdc * (1 - ez)
            cs.lookup_logup(
                "RDC copy event",
                [[
                    glr2, glr2 * 0, glr2, glr2 * 0, glr2 * 0, glr2 * 0,
                    glr2 * rdc_lcid, glr2 * (rdc_off4 + rdc_src4),
                    glr2 * Advice(self.c_call_id), glr2 * fold4_int(ab4),
                    glr2 * rdc_len4, glr2 * (rwc + 6), glr2 * 0,
                ]],
                self.copy_table,
            )
        cs.create_gate("RDC pc", grdcn * (pc_n - pc - 1))
        cs.create_gate("RDC sp", grdcn * (sp_n - sp - 3))
        cs.create_gate(
            "RDC rwc", grdcn * (rwc_n - rwc - 6 - 2 * rdc_len4)
        )
        self._rdc_lcid = rdc_lcid
        self._rdc_off4 = rdc_off4
        self._rdc_rdl4 = rdc_rdl4

        # ---- CODECOPY (reference execution/codecopy.rs): pops (dst,
        # src, len); the executing bytecode's bytes land in memory via a
        # bytecode->memory copy event keyed by the step's code hash. ----
        gcc = q * ind["CODECOPY"]
        gccn = q * q_n * ind["CODECOPY"]
        cc_src4 = fold4_int(ba)
        cc_len4 = fold4_int(bb)
        cs.create_gate("CODECOPY dst rlc", gcc * (fold4_rlc(ab4) - va))
        cs.create_gate("CODECOPY src rlc", gcc * (fold4_rlc(ba[:4]) - vb))
        cs.create_gate("CODECOPY len rlc", gcc * (fold4_rlc(bb[:4]) - vc))
        cs.create_gate("CODECOPY ez bool", gcc * ez * (ez - 1))
        cs.create_gate("CODECOPY ez kill", gcc * ez * cc_len4)
        cs.create_gate(
            "CODECOPY ez complete", gcc * (1 - ez) * (cc_len4 * inv - 1)
        )
        if self.copy_table is not None:
            glcc = gcc * (1 - ez)
            cs.lookup_logup(
                "CODECOPY copy event",
                [[
                    glcc, glcc * 0, glcc * 0, glcc * 0, glcc, glcc * 0,
                    glcc * chash, glcc * cc_src4,
                    glcc * Advice(self.c_call_id), glcc * fold4_int(ab4),
                    glcc * cc_len4, glcc * (rwc + 3), glcc * 0,
                ]],
                self.copy_table,
            )
        cs.create_gate("CODECOPY pc", gccn * (pc_n - pc - 1))
        cs.create_gate("CODECOPY sp", gccn * (sp_n - sp - 3))
        cs.create_gate(
            "CODECOPY rwc", gccn * (rwc_n - rwc - 3 - cc_len4)
        )

        # ---- EXTCODECOPY (reference execution/extcodecopy.rs): pops
        # (addr, dst, src, len); EIP-2929 warm write + the external
        # account's CodeHash read keying a bytecode->memory copy event.
        # Banks: addr word in bytes_a, dst in c_addr, src in bytes_d,
        # len in bytes_b; ext code hash (BE fold) in the acc_m cell.
        gxc = q * ind["EXTCODECOPY"]
        gxcn = q * q_n * ind["EXTCODECOPY"]
        xcc_len4 = fold4_int(bb)
        cs.create_gate("XCC addr rlc", gxc * (rlc_expr(ba) - va))
        cs.create_gate("XCC dst rlc", gxc * (fold4_rlc(ab4) - vb))
        cs.create_gate("XCC src rlc", gxc * (fold4_rlc(bd[:4]) - vc))
        cs.create_gate("XCC pc", gxcn * (pc_n - pc - 1))
        cs.create_gate("XCC sp", gxcn * (sp_n - sp - 4))
        cs.create_gate("XCC rwc", gxcn * (rwc_n - rwc - 6 - xcc_len4))
        if self.copy_table is not None:
            glx = gxc * Advice(self.c_gx[13])  # len != 0 (dyn nz flag)
            cs.lookup_logup(
                "XCC copy event",
                [[
                    glx, glx * 0, glx * 0, glx * 0, glx, glx * 0,
                    glx * Advice(self.c_acc_m), glx * fold4_int(bd),
                    glx * Advice(self.c_call_id), glx * fold4_int(ab4),
                    glx * xcc_len4, glx * (rwc + 6), glx * 0,
                ]],
                self.copy_table,
            )

        # ---- precompile calls: ECRECOVER (0x01), IDENTITY (0x04),
        # ECADD (0x06), ECMUL (0x07) — inline, no frame descent
        # (reference evm_circuit/execution/precompiles/).  Input/output
        # bytes ride TWO RLC-bound copy events (memory->RLC read and
        # RLC->memory write); the semantic statement is one lookup into
        # the Sig / Ecc table (IDENTITY: one memory->memory event). ------
        pf1, pfd, pfa = cr[20], cr[22], cr[23]
        p_in_acc = Advice(self.c_acc_m)
        p_out_acc = Advice(self.c_rpl)
        self._pc_skel = {}

        def be_word_rlc(bank):
            """Stack/word RLC of a BE-stored 32-byte bank."""
            e = None
            rp_ = None
            for j in range(32):
                b_ = bank[31 - j]
                term = b_ if j == 0 else b_ * rp_
                e = term if e is None else e + term
                rp_ = self.r_word if rp_ is None else rp_ * self.r_word
            return e

        def be_halves(bank):
            hi = None
            lo = None
            for i in range(16):
                th = bank[i] * (1 << (8 * (15 - i)))
                tl = bank[16 + i] * (1 << (8 * (15 - i)))
                hi = th if hi is None else hi + th
                lo = tl if lo is None else lo + tl
            return lo, hi

        def horner(seq):
            e = seq[0]
            for x in seq[1:]:
                e = e * self.r_word + x
            return e

        def precompile_skeleton(gname, addr_const, in_expr, out_expr,
                                rwc_extra):
            g_ = q * ind[gname]
            gn_ = q * q_n * ind[gname]
            cs.create_gate(
                f"{gname} variant one-hot", g_ * (pf1 + pfd + pfa - 1)
            )
            hv_ = pf1
            npops_ = 6 + hv_
            cs.create_gate(f"{gname} pc", gn_ * (pc_n - pc - 1))
            cs.create_gate(f"{gname} sp", gn_ * (sp_n - sp - npops_ + 1))
            cs.create_gate(
                f"{gname} rwc", gn_ * (rwc_n - rwc - npops_ - rwc_extra)
            )
            self._pc_skel[gname] = (
                g_, hv_, npops_, addr_const, in_expr, out_expr
            )
            return g_, hv_, npops_

        a_off_rlc = fold4_rlc(ab4)
        a_off_int = fold4_int(ab4)
        r_off4 = [Advice(self.c_mem[4 + i]) for i in range(4)]
        r_off_rlc = (r_off4[0] + r_off4[1] * self.r_word
                     + r_off4[2] * self.r_word * self.r_word
                     + r_off4[3] * self.r_word * self.r_word * self.r_word)
        r_off_int = (r_off4[0] + r_off4[1] * 256 + r_off4[2] * 65536
                     + r_off4[3] * 16777216)

        # ECRECOVER: banks a=hash, b=r, c=s, d[0]=v, e[0:20]=address out
        g_ecr, _, _ = precompile_skeleton(
            "ECRECOVER", 1, 128, 32, 128 + 32 + 4
        )
        v_cell = bd[0]
        cs.create_gate(
            "ECRECOVER v 27/28", g_ecr * (v_cell - 27) * (v_cell - 28)
        )
        ecr_in_seq = ([ba[i] for i in range(32)] + [0] * 31 + [v_cell]
                      + [bb[i] for i in range(32)]
                      + [bc[i] for i in range(32)])
        cs.create_gate(
            "ECRECOVER in acc", g_ecr * (horner(ecr_in_seq) - p_in_acc)
        )
        ecr_out_seq = [0] * 12 + [be_[i] for i in range(20)]
        cs.create_gate(
            "ECRECOVER out acc", g_ecr * (horner(ecr_out_seq) - p_out_acc)
        )
        if self.sig_table is not None:
            z_fold = None
            rp_ = None
            for i in range(32):
                term = ba[i] if i == 0 else ba[i] * rp_
                z_fold = term if z_fold is None else z_fold + term
                rp_ = self.r_word if rp_ is None else rp_ * self.r_word
            addr20 = None
            for j in range(20):
                term = be_[j] * (1 << (8 * (19 - j)))
                addr20 = term if addr20 is None else addr20 + term
            cs.lookup_logup(
                "ECRECOVER sig",
                [[g_ecr, g_ecr * z_fold, g_ecr * be_word_rlc(bb),
                  g_ecr * be_word_rlc(bc), g_ecr * addr20]],
                self.sig_table,
            )

        # ECADD: a=x1, b=y1, c=x2, d=y2 -> e=x3, f=y3
        g_ea, _, _ = precompile_skeleton("ECADD", 6, 128, 64, 128 + 64 + 4)
        ea_in = ([ba[i] for i in range(32)] + [bb[i] for i in range(32)]
                 + [bc[i] for i in range(32)] + [bd[i] for i in range(32)])
        ea_out = ([be_[i] for i in range(32)] + [bf_[i] for i in range(32)])
        cs.create_gate("ECADD in acc", g_ea * (horner(ea_in) - p_in_acc))
        cs.create_gate("ECADD out acc", g_ea * (horner(ea_out) - p_out_acc))

        # ECMUL: a=x, b=y, c=k -> e=rx, f=ry
        g_em, _, _ = precompile_skeleton("ECMUL", 7, 96, 64, 96 + 64 + 4)
        em_in = ([ba[i] for i in range(32)] + [bb[i] for i in range(32)]
                 + [bc[i] for i in range(32)])
        cs.create_gate("ECMUL in acc", g_em * (horner(em_in) - p_in_acc))
        cs.create_gate("ECMUL out acc", g_em * (horner(ea_out) - p_out_acc))
        if self.ecc_table is not None:
            from .ecc import TAG_ADD, TAG_MUL

            x1l, x1h = be_halves(ba)
            y1l, y1h = be_halves(bb)
            x2l, x2h = be_halves(bc)
            y2l, y2h = be_halves(bd)
            rxl, rxh = be_halves(be_)
            ryl, ryh = be_halves(bf_)
            cs.lookup_logup(
                "precompile ecc",
                [
                    [g_ea, g_ea * TAG_ADD, g_ea * x1l, g_ea * x1h,
                     g_ea * y1l, g_ea * y1h, g_ea * x2l, g_ea * x2h,
                     g_ea * y2l, g_ea * y2h, g_ea * rxl, g_ea * rxh,
                     g_ea * ryl, g_ea * ryh],
                    [g_em, g_em * TAG_MUL, g_em * x1l, g_em * x1h,
                     g_em * y1l, g_em * y1h, g_em * x2l, g_em * x2h,
                     g_em * 0, g_em * 0, g_em * rxl, g_em * rxh,
                     g_em * ryl, g_em * ryh],
                ],
                self.ecc_table,
            )

        # IDENTITY: one memory->memory copy of min(argsLen, retLen)
        id_len4 = [Advice(self.c_mem[i]) for i in range(4)]
        id_rlen4 = [Advice(self.c_mem[8 + i]) for i in range(4)]
        id_len_i = (id_len4[0] + id_len4[1] * 256 + id_len4[2] * 65536
                    + id_len4[3] * 16777216)
        id_len_r = (id_len4[0] + id_len4[1] * self.r_word
                    + id_len4[2] * self.r_word * self.r_word
                    + id_len4[3] * self.r_word * self.r_word * self.r_word)
        id_rlen_i = (id_rlen4[0] + id_rlen4[1] * 256
                     + id_rlen4[2] * 65536 + id_rlen4[3] * 16777216)
        id_rlen_r = (id_rlen4[0] + id_rlen4[1] * self.r_word
                     + id_rlen4[2] * self.r_word * self.r_word
                     + id_rlen4[3] * self.r_word * self.r_word
                     * self.r_word)
        id_la4 = fold4_int(bd)
        id_diff = (bg_[0] + bg_[1] * 256 + bg_[2] * 65536
                   + bg_[3] * 16777216)
        id_fmin = cr[24]
        g_id = q * ind["IDENTITY"]
        gn_id = q * q_n * ind["IDENTITY"]
        cs.create_gate(
            "IDENTITY variant one-hot", g_id * (pf1 + pfd + pfa - 1)
        )
        id_hv = pf1
        id_npops = 6 + id_hv
        cs.create_gate("IDENTITY pc", gn_id * (pc_n - pc - 1))
        cs.create_gate("IDENTITY sp", gn_id * (sp_n - sp - id_npops + 1))
        cs.create_gate(
            "IDENTITY rwc",
            gn_id * (rwc_n - rwc - id_npops - 2 * id_la4 - 4),
        )
        cs.create_gate("IDENTITY min bool", g_id * id_fmin * (id_fmin - 1))
        cs.create_gate(
            "IDENTITY min pick",
            g_id * (id_la4 - id_fmin * id_len_i - (1 - id_fmin) * id_rlen_i),
        )
        cs.create_gate(
            "IDENTITY min lo", g_id * id_fmin * (id_rlen_i - id_len_i - id_diff)
        )
        cs.create_gate(
            "IDENTITY min hi",
            g_id * (1 - id_fmin) * (id_len_i - id_rlen_i - id_diff),
        )
        id_laz = Advice(self.c_ez)
        cs.create_gate("IDENTITY laz bool", g_id * id_laz * (id_laz - 1))
        cs.create_gate("IDENTITY laz kill", g_id * id_laz * id_la4)
        cs.create_gate(
            "IDENTITY laz complete",
            g_id * (1 - id_laz) * (id_la4 * inv - 1),
        )
        if self.copy_table is not None:
            gidc = g_id * (1 - id_laz)
            cs.lookup_logup(
                "IDENTITY copy",
                [[
                    gidc, gidc * 0, gidc, gidc * 0, gidc * 0, gidc * 0,
                    gidc * Advice(self.c_call_id), gidc * a_off_int,
                    gidc * Advice(self.c_call_id), gidc * r_off_int,
                    gidc * id_la4, gidc * (rwc + id_npops), gidc * 0,
                ]],
                self.copy_table,
            )

        # SHA256 precompile (0x02): dynamic-length input via the
        # memory->RLC copy event, SHA-256 pad bridge (0x80 ‖ zeros ‖
        # 64-bit BE bit length, total = 0 mod 64) using the shared
        # challenge-power table, digest bound to the SHA256Table.
        gs2 = q * ind["SHA256"]
        gs2n = q * q_n * ind["SHA256"]
        cs.create_gate("SHA256 variant one-hot", gs2 * (pf1 + pfd + pfa - 1))
        s2_hv = pf1
        s2_npops = 6 + s2_hv
        s2_len4 = [Advice(self.c_mem[i]) for i in range(4)]
        s2_len_i = (s2_len4[0] + s2_len4[1] * 256 + s2_len4[2] * 65536
                    + s2_len4[3] * 16777216)
        s2_len_r = (s2_len4[0] + s2_len4[1] * self.r_word
                    + s2_len4[2] * self.r_word * self.r_word
                    + s2_len4[3] * self.r_word * self.r_word * self.r_word)
        s2_q64 = [Advice(self.c_mem[8 + i]) for i in range(4)]
        s2_q64_i = (s2_q64[0] + s2_q64[1] * 256 + s2_q64[2] * 65536
                    + s2_q64[3] * 16777216)
        s2_p = Advice(self.c_push_len)
        s2_rp1 = Advice(self.c_prl)
        cs.create_gate("SHA256 pc", gs2n * (pc_n - pc - 1))
        cs.create_gate("SHA256 sp", gs2n * (sp_n - sp - s2_npops + 1))
        cs.create_gate(
            "SHA256 rwc",
            gs2n * (rwc_n - rwc - s2_npops - s2_len_i - 32 - 4),
        )
        cs.create_gate(
            "SHA256 pad mod", gs2 * (s2_len_i + s2_p - 64 * s2_q64_i)
        )
        # 64-bit BE bit length (8 * msglen) in bytes_b[0:8]
        s2_bits = None
        for i in range(8):
            term = bb[i] * (1 << (8 * (7 - i)))
            s2_bits = term if s2_bits is None else s2_bits + term
        cs.create_gate("SHA256 bit length", gs2 * (s2_bits - 8 * s2_len_i))
        cs.lookup_logup(
            "SHA256 pad power",
            [[gs2, gs2 * s2_p, gs2 * s2_rp1 * self.r_word,
              gs2 * (s2_rp1 + 128)]],
            pad_table,
        )
        s2_tail = None
        rp_t = None
        for i in range(7, -1, -1):  # len8[i] * r^(7-i)
            term = bb[i] if rp_t is None else bb[i] * rp_t
            s2_tail = term if s2_tail is None else s2_tail + term
            rp_t = self.r_word if rp_t is None else rp_t * self.r_word
        s2_acc_pad = (p_in_acc * s2_rp1 * self.r_word + 128 * s2_rp1
                      + s2_tail)
        s2_ez = Advice(self.c_ez)
        cs.create_gate("SHA256 ez bool", gs2 * s2_ez * (s2_ez - 1))
        cs.create_gate("SHA256 ez kill", gs2 * s2_ez * s2_len_i)
        cs.create_gate(
            "SHA256 ez complete", gs2 * (1 - s2_ez) * (s2_len_i * inv - 1)
        )
        cs.create_gate("SHA256 empty acc", gs2 * s2_ez * p_in_acc)
        s2_out_fold = None
        rp_o = None
        for i in range(32):
            term = ba[i] if i == 0 else ba[i] * rp_o
            s2_out_fold = term if s2_out_fold is None else s2_out_fold + term
            rp_o = self.r_word if rp_o is None else rp_o * self.r_word
        if self.sha256_table is not None:
            cs.lookup_logup(
                "SHA256 precompile",
                [[gs2, gs2 * s2_acc_pad, gs2 * s2_out_fold]],
                self.sha256_table,
            )
        cs.create_gate(
            "SHA256 out acc", gs2 * (horner([ba[i] for i in range(32)])
                                     - p_out_acc)
        )
        if self.copy_table is not None:
            gin2 = gs2 * (1 - s2_ez)
            cs.lookup_logup(
                "SHA256 io copies",
                [
                    [gin2, gin2, gin2 * 0, gin2 * 0, gin2 * 0, gin2 * 0,
                     gin2 * Advice(self.c_call_id), gin2 * a_off_int,
                     gin2 * 0, gin2 * 0, gin2 * s2_len_i,
                     gin2 * (rwc + s2_npops), gin2 * p_in_acc],
                    [gs2, gs2 * 0, gs2 * 0, gs2 * 0, gs2 * 0, gs2,
                     gs2 * 0, gs2 * 0, gs2 * Advice(self.c_call_id),
                     gs2 * r_off_int, gs2 * 32,
                     gs2 * (rwc + s2_npops + s2_len_i), gs2 * p_out_acc],
                ],
                self.copy_table,
            )
        self._s2_len_r = s2_len_r
        self._s2_len_i = s2_len_i
        self._s2_p = s2_p

        # MODEXP precompile (0x05), VARIABLE operand lengths up to the
        # reference's 32-byte cap (MODEXP_SIZE_LIMIT,
        # bus-mapping/src/precompile.rs:231; gadget
        # execution/precompiles/modexp.rs): input stream is
        # hdrB ‖ hdrE ‖ hdrM (32 bytes each) ‖ B[BL] ‖ E[EL] ‖ M[ML],
        # args_len == 96+BL+EL+ML exactly (implicit zero-extension of a
        # short caller region stays a documented builder raise).
        # Operands live RIGHT-ALIGNED in banks a/b/c (out in e) so the
        # full-bank msb-first horner equals the BL-byte stream fold as
        # long as the leading cells are zero — enforced by monotone
        # leading-zero masks zB/zE/zM in banks d/f/g.  BL = 32 - sum(zB)
        # feeds the headers, the rw-count walk and the copy lengths; the
        # challenge powers r^BL needed to splice the stream folds are
        # single cells bound through the keccak pad-power table via
        # (BL+1, r*pB, pB+128) — no zero-length special case.
        zB = [bd[i] for i in range(32)]
        zE = [bf_[i] for i in range(32)]
        zM = [bg_[i] for i in range(32)]
        g_mx0 = q * ind["MODEXP"]
        mx_lens = []
        for zname, zz, banks in (
            ("B", zB, [ba]), ("E", zE, [bb]), ("M", zM, [bc, be_]),
        ):
            ssum = None
            for i in range(32):
                cs.create_gate(
                    f"MODEXP z{zname}{i} bool", g_mx0 * zz[i] * (zz[i] - 1)
                )
                for bank in banks:
                    cs.create_gate(
                        f"MODEXP z{zname}{i} kill", g_mx0 * zz[i] * bank[i]
                    )
                ssum = zz[i] if ssum is None else ssum + zz[i]
            for i in range(31):
                d_ = zz[i] - zz[i + 1]
                cs.create_gate(
                    f"MODEXP z{zname}{i} mono", g_mx0 * d_ * (d_ - 1)
                )
            mx_lens.append(32 - ssum)
        mx_bl, mx_el, mx_ml = mx_lens
        mx_al = 96 + mx_bl + mx_el + mx_ml
        g_mx, _, _ = precompile_skeleton(
            "MODEXP", 5, mx_al, mx_ml, mx_al + mx_ml + 4
        )
        self._mx_al, self._mx_ml = mx_al, mx_ml
        # challenge powers r^BL / r^EL / r^ML (cells: prl / inv / inv2)
        mx_pB = Advice(self.c_prl)
        mx_pE = Advice(self.c_inv)
        mx_pM = Advice(self.c_inv2)
        cs.lookup_logup(
            "MODEXP len powers",
            [
                [g_mx, g_mx * (mx_bl + 1), g_mx * mx_pB * self.r_word,
                 g_mx * (mx_pB + 128)],
                [g_mx, g_mx * (mx_el + 1), g_mx * mx_pE * self.r_word,
                 g_mx * (mx_pE + 128)],
                [g_mx, g_mx * (mx_ml + 1), g_mx * mx_pM * self.r_word,
                 g_mx * (mx_pM + 128)],
            ],
            pad_table,
        )
        r32 = None
        for _ in range(32):
            r32 = self.r_word if r32 is None else r32 * self.r_word
        mx_hdr = mx_bl * r32 * r32 + mx_el * r32 + mx_ml
        mx_in_acc = (
            (mx_hdr * mx_pB + horner([ba[i] for i in range(32)])) * mx_pE
            + horner([bb[i] for i in range(32)])
        ) * mx_pM + horner([bc[i] for i in range(32)])
        cs.create_gate("MODEXP in acc", g_mx * (mx_in_acc - p_in_acc))
        mx_out = [be_[i] for i in range(32)]
        cs.create_gate("MODEXP out acc", g_mx * (horner(mx_out) - p_out_acc))
        if self.modexp_table is not None:
            bl_, bh_ = be_halves(ba)
            el_, eh_ = be_halves(bb)
            ml_, mh_ = be_halves(bc)
            rl_, rh_ = be_halves(be_)
            cs.lookup_logup(
                "MODEXP statement",
                [[g_mx, g_mx * bl_, g_mx * bh_, g_mx * el_, g_mx * eh_,
                  g_mx * ml_, g_mx * mh_, g_mx * rl_, g_mx * rh_]],
                self.modexp_table,
            )

        if self.copy_table is not None:
            # fixed precompiles: input read event + output write event
            for gname in ("ECRECOVER", "ECADD", "ECMUL", "MODEXP"):
                g_, hv_, npops_, addrc, in_l, out_l = self._pc_skel[gname]
                cs.lookup_logup(
                    f"{gname} io copies",
                    [
                        [g_, g_, g_ * 0, g_ * 0, g_ * 0, g_ * 0,
                         g_ * Advice(self.c_call_id), g_ * a_off_int,
                         g_ * 0, g_ * 0, g_ * in_l, g_ * (rwc + npops_),
                         g_ * p_in_acc],
                        [g_, g_ * 0, g_ * 0, g_ * 0, g_ * 0, g_,
                         g_ * 0, g_ * 0, g_ * Advice(self.c_call_id),
                         g_ * r_off_int, g_ * out_l,
                         g_ * (rwc + npops_ + in_l), g_ * p_out_acc],
                    ],
                    self.copy_table,
                )

        self._p_aoff_rlc = a_off_rlc
        self._p_roff_rlc = r_off_rlc
        self._id_la4 = id_la4
        self._id_len_r = id_len_r
        self._id_rlen_r = id_rlen_r

        # ---- block/tx context opcodes (reference execution/block_ctx.rs,
        # gasprice.rs, origin.rs): one stack push bound to the BlockTable
        # or TxTable.  Small fields decompose into bytes_a[0:8] (raw +
        # word-RLC folds); address fields into bytes_a[0:20]. ------------
        from .block import BlockFieldTag as BT

        def fold_n(cells, nbytes, use_r):
            e = None
            rpow = None
            for i in range(nbytes):
                mulr = rpow if use_r else (1 << (8 * i))
                term = cells[i] if (use_r and i == 0) else cells[i] * mulr
                e = term if e is None else e + term
                if use_r:
                    rpow = self.r_word if rpow is None else rpow * self.r_word
            return e

        raw8, rlc8 = fold_n(ba, 8, False), fold_n(ba, 8, True)
        raw20, rlc20 = fold_n(ba, 20, False), fold_n(ba, 20, True)
        SMALL_BLOCK_OPS = {
            "TIMESTAMP": int(BT.Timestamp), "NUMBER": int(BT.Number),
            "GASLIMIT": int(BT.GasLimit), "CHAINID": int(BT.ChainId),
            "BASEFEE": int(BT.BaseFee),
        }
        block_inputs = []
        for gname, btag in SMALL_BLOCK_OPS.items():
            gb_ = q * ind[gname]
            cs.create_gate(f"{gname} rlc", gb_ * (rlc8 - va))
            block_inputs.append([gb_, gb_ * btag, gb_ * 0, gb_ * raw8])
        gcb = q * ind["COINBASE"]
        cs.create_gate("COINBASE rlc", gcb * (rlc20 - va))
        block_inputs.append(
            [gcb, gcb * int(BT.Coinbase), gcb * 0, gcb * raw20]
        )
        gdf = q * ind["DIFFICULTY"]
        block_inputs.append(
            [gdf, gdf * int(BT.Difficulty), gdf * 0, gdf * va]
        )

        # ---- BLOCKHASH (reference execution/blockhash.rs): pop number,
        # push the ancestor hash when number is one of the 256 most recent
        # blocks, else 0.  Validity flag z with BOTH directions proven:
        #   z=1: high word bytes zero (h=1) and diff = cur-1-num in [0,255]
        #   z=0: h=0 (some high byte nonzero), or num >= cur (w=1), or
        #        num <= cur-257 (w=0), distance e byte-decomposed.
        # Cells: z=c_ez, h=c_gx[0], h_inv=c_gx[1], d=c_gx[2], w=c_gx[3],
        # e bytes=c_gx[4..12), cur=c_gx[12] (bound via a Number-row lookup).
        gbh = q * ind["BLOCKHASH"]
        bh_z = Advice(self.c_ez)
        bh_h = Advice(self.c_gx[0])
        bh_hinv = Advice(self.c_gx[1])
        bh_d = Advice(self.c_gx[2])
        bh_w = Advice(self.c_gx[3])
        bh_e = None
        for i in range(8):
            t_ = Advice(self.c_gx[4 + i]) * (1 << (8 * i))
            bh_e = t_ if bh_e is None else bh_e + t_
        bh_cn = Advice(self.c_gx[12])
        s24 = None
        for i in range(8, 32):
            s24 = ba[i] if s24 is None else s24 + ba[i]
        cs.create_gate("BLOCKHASH num rlc", gbh * (rlc_expr(ba) - va))
        cs.create_gate("BLOCKHASH z bool", gbh * bh_z * (bh_z - 1))
        cs.create_gate("BLOCKHASH w bool", gbh * bh_w * (bh_w - 1))
        # h = IsZero(sum of high bytes): complete in both directions
        # (bytes are range-checked, so the integer sum is 0 iff all are)
        cs.create_gate("BLOCKHASH h def", gbh * (bh_h - 1 + s24 * bh_hinv))
        cs.create_gate("BLOCKHASH h kill", gbh * bh_h * s24)
        # valid: high part zero and cur-1-num = d (byte-ranged below)
        cs.create_gate("BLOCKHASH z needs h", gbh * bh_z * (1 - bh_h))
        cs.create_gate(
            "BLOCKHASH valid dist", gbh * bh_z * (bh_cn - 1 - raw8 - bh_d)
        )
        # invalid with h=1: num >= cur (w=1) or num <= cur-257 (w=0)
        g_inv_h = gbh * (1 - bh_z) * bh_h
        cs.create_gate(
            "BLOCKHASH inval ge", g_inv_h * bh_w * (raw8 - bh_cn - bh_e)
        )
        cs.create_gate(
            "BLOCKHASH inval lt",
            g_inv_h * (1 - bh_w) * (bh_cn - 257 - raw8 - bh_e),
        )
        # out-of-range pushes zero
        cs.create_gate("BLOCKHASH zero push", gbh * (1 - bh_z) * vb)
        block_inputs.append(
            [gbh, gbh * int(BT.Number), gbh * 0, gbh * bh_cn]
        )
        gbh_z = gbh * bh_z
        block_inputs.append(
            [gbh_z, gbh_z * int(BT.BlockHash), gbh_z * raw8, gbh_z * vb]
        )
        transition(ind["BLOCKHASH"], 1, 2, 0)
        if self.block_table is not None:
            cs.lookup_logup("block context", block_inputs, self.block_table)
        ggp = q * ind["GASPRICE"]
        gor = q * ind["ORIGIN"]
        cs.create_gate("ORIGIN rlc", gor * (rlc20 - va))
        if self.tx_table is not None:
            from .tx import TxFieldTag as _TTB

            cs.lookup_logup(
                "tx context ops",
                [
                    [ggp * txid, ggp * int(_TTB.GasPrice), ggp * 0,
                     ggp * va],
                    [gor * txid, gor * int(_TTB.CallerAddress), gor * 0,
                     gor * raw20],
                ],
                self.tx_table,
            )

        # ---- PUSH immediate decomposition (reference execution/push.rs):
        # bytes_a holds the pushed word LE; the carry bank holds is_pushed
        # selector bits (sel_i = 1 iff LE byte i is inside the n-byte
        # immediate: bool, monotone non-increasing, summing to push_len);
        # bytes beyond the immediate are zero.  With the bytecode table,
        # each selected byte is read from the code at pc + n - i (BE
        # immediate layout), marking it push DATA (is_code = 0). ----------
        gpu = q * ind["PUSH"]
        sel_sum_p = None
        for i in range(32):
            cs.create_gate(f"PUSH sel {i} bool", gpu * cr[i] * (cr[i] - 1))
            if i:
                cs.create_gate(
                    f"PUSH sel {i} monotone", gpu * cr[i] * (1 - cr[i - 1])
                )
            cs.create_gate(f"PUSH pad {i} zero", gpu * (1 - cr[i]) * ba[i])
            sel_sum_p = cr[i] if sel_sum_p is None else sel_sum_p + cr[i]
        cs.create_gate("PUSH sel sum", gpu * (sel_sum_p - plen))
        cs.create_gate("PUSH value rlc", gpu * (rlc_expr(ba) - va))

        if self.bytecode_table is not None:
            # opcode binding: the step's opcode byte — reconstructed from
            # the one-hot indicators (+ length/depth for the PUSH/DUP/SWAP
            # families) — is the is_code byte at (code_hash, pc)
            nd_e = Advice(self.c_depth_n)
            op_expr = ind["PUSH"] * (plen + 0x5F) \
                + ind["DUP"] * (nd_e + 0x7F) \
                + ind["SWAP"] * (nd_e + 0x8F) \
                + ind["CALL"] * (f1 * 0xF1 + f2 * 0xF2 + fdg * 0xF4
                                 + fsa * 0xFA) \
                + ind["CREATE"] * (0xF0 + self._create_fc2 * 5) \
                + ind["RET"] * (rtn * 0xF3 + rvt * 0xFD) \
                + ind["LOG"] * (self._log_n + 0xA0)
            pc_fam = (ind["ECRECOVER"] + ind["IDENTITY"] + ind["ECADD"]
                      + ind["ECMUL"] + ind["SHA256"] + ind["MODEXP"])
            op_expr = op_expr + pc_fam * (
                cr[20] * 0xF1 + cr[22] * 0xF4 + cr[23] * 0xFA
            )
            g_code = ind["PUSH"] + ind["DUP"] + ind["SWAP"] + ind["CALL"] \
                + ind["CREATE"] + ind["RET"] * (rtn + rvt) + ind["LOG"] \
                + pc_fam
            # error rows: the failing opcode byte (c_depth_n) is the code
            # byte at pc, like any executed opcode
            err_any = (ind["ERR_STACK"] + ind["ERR_OOG"]
                       + ind["ERR_JUMP"] + ind["ERR_RDOOB"]
                       + ind["ERR_WRITE_PROT"] + ind["ERR_INVALID_OP"]
                       + ind["ERR_OOG_DYN"])
            op_expr = op_expr + err_any * nd_e
            g_code = g_code + err_any
            for g, byte in OPCODE_BYTE.items():
                op_expr = op_expr + ind[g] * byte
                g_code = g_code + ind[g]
            g_code = q * g_code
            inputs_bc = [[
                g_code, g_code * chash, g_code * pc, q * op_expr, g_code,
            ]]
            # PUSH immediate bytes
            for i in range(32):
                gl = gpu * cr[i]
                inputs_bc.append([
                    gl, gl * chash, gl * (pc + plen - i), gl * ba[i], gl * 0,
                ])
            # JUMP / taken-JUMPI destinations must be is_code JUMPDEST
            gjd = gj + gji * jb
            inputs_bc.append([
                gjd, gjd * chash, gjd * jdest_int, gjd * 0x5B, gjd,
            ])
            # ERR_JUMP in-range target byte: (dest, byte, is_code) must be
            # a real bytecode row of the executing code
            g_ejr = g_ej * (1 - ej_oor)
            inputs_bc.append([
                g_ejr, g_ejr * chash, g_ejr * dest4_ej, g_ejr * ej_b,
                g_ejr * ej_ic,
            ])
            cs.lookup_logup("bytecode binding", inputs_bc,
                            self.bytecode_table)
        if self.bytecode_len_table is not None:
            # CODESIZE: the pushed 4-byte length is the executing code's
            # header-row length (reference execution/codesize.rs);
            # ERR_JUMP's length cell binds the same way
            cs.lookup_logup(
                "codesize length",
                [[gcs2, gcs2 * chash, gcs2 * sz4_int],
                 [g_ej, g_ej * chash, g_ej * ej_len]],
                self.bytecode_len_table,
            )

        # byte range checks: every word-gadget byte cell rides one logUp
        # argument, gated by q alone (padding/unused cells are 0 = valid)
        all_byte_cols = (
            self.c_bytes_a + self.c_bytes_b + self.c_bytes_c
            + self.c_bytes_d + self.c_bytes_e + self.c_bytes_f
            + self.c_bytes_g + self.c_carry + self.c_mem + self.c_addr
        )
        byte_inputs = [[q * Advice(c)] for c in all_byte_cols]
        # BYTE out-of-range path: ez proves index byte >= 32 (byte-range
        # membership of ba[0]-32 given ba[0] < 256)
        byte_inputs.append([q * ind["BYTE"] * Advice(self.c_ez)
                            * (Advice(self.c_bytes_a[0]) - 32)])
        # SDIV/SMOD sign rests < 128 (2*rest stays a byte)
        byte_inputs.append([gsx * 2 * rest_a])
        byte_inputs.append([gsx * 2 * rest_b])
        # SLT/SGT MSB sign splits: byte31 = 128*sign + rest, rest < 128
        byte_inputs.append([gsc * 2 * (ba[31] - 128 * sa_sc)])
        byte_inputs.append([gsc * 2 * (bb[31] - 128 * sb_sc)])
        # BLOCKHASH: valid-range distance d and invalid-distance e bytes
        byte_inputs.append([gbh * bh_z * bh_d])
        for i in range(8):
            byte_inputs.append([gbh * Advice(self.c_gx[4 + i])])
        # dynamic-gas cells: rem/wrem < 32, the max-distance bytes, and
        # the quadratic remainders' low bytes
        byte_inputs.append([g_dy * 8 * Advice(self.c_gx[1])])
        byte_inputs.append([g_dy * 8 * Advice(self.c_gx[17])])
        for ci in (3, 4, 5, 6, 8, 11):
            byte_inputs.append([g_dy * Advice(self.c_gx[ci])])
        # ERR_JUMP / ERR_RDOOB distance bytes
        for ci in (3, 4, 5, 6):
            byte_inputs.append([(g_ej + g_rd) * Advice(self.c_gx[ci])])
        # ERR_OOG_DYN: rem/wrem < 32, m-vs-mw distance bytes, quadratic
        # remainders' low bytes
        byte_inputs.append([g_eod * 8 * Advice(self.c_gx[1])])
        byte_inputs.append([g_eod * 8 * Advice(self.c_gx[17])])
        for ci in (3, 4, 5, 6, 8, 11):
            byte_inputs.append([g_eod * Advice(self.c_gx[ci])])
        # SIGNEXTEND: 2*rest < 256 and the keep-all i >= 31 proof
        byte_inputs.append([gse * 2 * rest_se])
        byte_inputs.append([gse * m_bits[31] * sext_ez * (ba[0] - 31)])
        # SHA256 pad length p in [9, 72]
        byte_inputs.append([gs2 * (self._s2_p - 9)])
        byte_inputs.append([gs2 * (72 - self._s2_p)])
        # ERR_STACK underflow distance sp + pops - 1025 (a byte; <= 16
        # genuinely); 0 on overflow rows
        byte_inputs.append([q * ind["ERR_STACK"] * Advice(self.c_gas_aux)])
        # CREATE: the single-byte RLP nonce stays < 128 (single-byte
        # branch only; CREATE2 allows the full byte in branch 0)
        byte_inputs.append([
            q * ind["CREATE"] * (1 - self._create_fc2)
            * self._create_sel0 * 2 * self._create_nz
        ])
        # canonical multi-byte nonce RLP: nl=1 needs the byte >= 0x80
        # (else the single-byte form applies), nl>=2 a nonzero leading
        # byte (no zero-padded encodings)
        byte_inputs.append([
            q * ind["CREATE"] * self._create_o[0]
            * (self._create_lead - 128)
        ])
        _o_multi = None
        for _oc in self._create_o[1:]:
            _o_multi = _oc if _o_multi is None else _o_multi + _oc
        byte_inputs.append([
            q * ind["CREATE"] * _o_multi * (self._create_lead - 1)
        ])
        # memory-expansion gas cells: rem < 32 (8*rem is a byte), the
        # max-distance bytes, and the quadratic remainders' low bytes
        g_mem3 = q * (ind["MLOAD"] + ind["MSTORE"] + ind["MSTORE8"])
        byte_inputs.append([g_mem3 * 8 * Advice(self.c_gx[1])])
        for ci in (3, 4, 5, 6, 8, 11):
            byte_inputs.append([g_mem3 * Advice(self.c_gx[ci])])
        cs.lookup_logup("byte ranges", byte_inputs, [Fixed(self.tbl_byte)])

        # ---- bus accesses via one logUp into the rw table -----------------
        if self.standalone:
            tq = Fixed(self.q_rw)
            table = [
                tq * Advice(self.t_rwc),
                tq * Advice(self.t_is_write),
                tq * Advice(self.t_tag),
                tq * Advice(self.t_id),
                tq * Advice(self.t_addr),
                tq * Advice(self.t_field),
                tq * Advice(self.t_key),
                tq * Advice(self.t_val),
            ]
        else:
            table = rw_table
        cid = Advice(self.c_call_id)
        stack = int(RwTag.Stack)
        ctxtag = int(RwTag.CallContext)
        CCF = CallContextField
        gbin = None
        for g in ("ADD", "SUB", "MUL", "DIV", "MOD", "SDIV", "SMOD",
                  "SIGNEXTEND", "SAR", "LT", "GT", "SLT", "SGT", "EQ",
                  "EXP", "AND", "OR", "XOR", "BYTE", "SHL", "SHR"):
            gbin = ind[g] if gbin is None else gbin + ind[g]
        gbin = q * gbin
        gun = q * (ind["ISZERO"] + ind["NOT"])
        gcdc = q * ind["CALLDATACOPY"]

        def access(gate, d_rwc, is_write, addr_expr, val_expr,
                   tag: int = stack, id_expr=None, field: int = 0, key=0):
            return [
                gate * (rwc + d_rwc),
                gate * is_write,
                gate * tag,
                gate * (cid if id_expr is None else id_expr),
                gate * addr_expr,
                gate * field,
                gate * key,
                gate * val_expr,
            ]

        nd = Advice(self.c_depth_n)
        inputs = [
            # PUSH: write va at sp-1
            access(q * ind["PUSH"], 0, 1, sp - 1, va),
            # POP: read va at sp
            access(q * ind["POP"], 0, 0, sp, va),
            # binary ops: read va@sp, read vb@sp+1, write vc@sp+1
            access(gbin, 0, 0, sp, va),
            access(gbin, 1, 0, sp + 1, vb),
            access(gbin, 2, 1, sp + 1, vc),
            # unary ops: read va@sp, write vc@sp
            access(gun, 0, 0, sp, va),
            access(gun, 1, 1, sp, vc),
            # CALLDATACOPY: read dst@sp, src@sp+1, len@sp+2 (ctx reads
            # appended after the inputs list below)
            access(gcdc, 0, 0, sp, va),
            access(gcdc, 1, 0, sp + 1, vb),
            access(gcdc, 2, 0, sp + 2, vc),
            # DUPn: read va@(sp+n-1), write va@(sp-1)
            access(q * ind["DUP"], 0, 0, sp + nd - 1, va),
            access(q * ind["DUP"], 1, 1, sp - 1, va),
            # SWAPn: read va@sp, read vb@(sp+n), write va@(sp+n), write vb@sp
            access(q * ind["SWAP"], 0, 0, sp, va),
            access(q * ind["SWAP"], 1, 0, sp + nd, vb),
            access(q * ind["SWAP"], 2, 1, sp + nd, va),
            access(q * ind["SWAP"], 3, 1, sp, vb),
            # PC: write va at sp-1
            access(q * ind["PC"], 0, 1, sp - 1, va),
            # GAS / MSIZE / CODESIZE: write va at sp-1
            access(q * (ind["GAS"] + ind["MSIZE"] + ind["CODESIZE"]),
                   0, 1, sp - 1, va),
            # BLOCKHASH: read number@sp, write hash@sp
            access(q * ind["BLOCKHASH"], 0, 0, sp, va),
            access(q * ind["BLOCKHASH"], 1, 1, sp, vb),
            # ERR_JUMP: read dest@sp (+ taken condition for JUMPI)
            access(g_ej, 0, 0, sp, va),
            access(g_ej * ej_fj, 1, 0, sp + 1, vb),
            # ERR_RDOOB: the three RETURNDATACOPY pops + the return-data
            # length bookkeeping read
            access(g_rd, 0, 0, sp, va),
            access(g_rd, 1, 0, sp + 1, vb),
            access(g_rd, 2, 0, sp + 2, vc),
            access(g_rd, 3, 0, 0, fold4_int(ab4), tag=ctxtag,
                   field=int(CCF.LastCalleeReturnDataLength)),
            # ERR_OOG_DYN: the addr/offset pop (all families), the size
            # pop (sha/log/span at sp+1, copies at sp+2), the copies'
            # src pop (value free in vc)
            access(q * ind["ERR_OOG_DYN"], 0, 0, sp, va),
            access(
                q * ind["ERR_OOG_DYN"]
                * (self._eod_flags["sha"] + self._eod_flags["log"]
                   + self._eod_flags["span"]),
                1, 0, sp + 1, vb,
            ),
            access(q * ind["ERR_OOG_DYN"] * self._eod_flags["copy"],
                   1, 0, sp + 1, vc),
            access(q * ind["ERR_OOG_DYN"] * self._eod_flags["copy"],
                   2, 0, sp + 2, vb),
            # ERR_WRITE_PROT: the frame's IsStatic flag must be 1; the
            # CALL family additionally proves the value word is nonzero
            # (stack slot sp+2: gas, to, value, ...)
            access(q * ind["ERR_WRITE_PROT"], 0, 0, 0, 1, tag=ctxtag,
                   field=int(CCF.IsStatic)),
            access(q * ind["ERR_WRITE_PROT"] * self._wp_cv, 1, 0, sp + 2,
                   va),
            # block/tx context pushes: write va at sp-1
            access(
                q * (ind["TIMESTAMP"] + ind["NUMBER"] + ind["COINBASE"]
                     + ind["GASLIMIT"] + ind["CHAINID"] + ind["BASEFEE"]
                     + ind["DIFFICULTY"] + ind["GASPRICE"] + ind["ORIGIN"]),
                0, 1, sp - 1, va,
            ),
            # JUMP: read dest@sp; JUMPI: read dest@sp + cond@sp+1
            access(gj, 0, 0, sp, va),
            access(gji, 0, 0, sp, va),
            access(gji, 1, 0, sp + 1, vb),
            # SHA3: read offset@sp, size@sp+1; write hash@sp+1 after the
            # size memory reads (dynamic rw offset)
            access(q * ind["SHA3"], 0, 0, sp, va),
            access(q * ind["SHA3"], 1, 0, sp + 1, vb),
            access(q * ind["SHA3"], 2 + self._sha3_size4, 1, sp + 1, vc),
            # root RETURN / REVERT: read offset@sp, length@sp+1 (terminal)
            access(q * (ind["RETURN"] + ind["REVERT"]), 0, 0, sp, va),
            access(q * (ind["RETURN"] + ind["REVERT"]), 1, 0, sp + 1, vb),
        ]
        # ---- CALL accesses: pops + the new frame's CallContext writes ----
        gcall_b = q * ind["CALL"]
        call_hv = Advice(self.c_carry[20]) + Advice(self.c_carry[21])
        call_npops = self._call_npops
        inputs.append(access(gcall_b, 0, 0, sp, va))           # gas
        inputs.append(access(gcall_b, 1, 0, sp + 1, vb))       # to
        inputs.append(access(gcall_b * call_hv, 2, 0, sp + 2, vc))  # value
        for j, bank in enumerate(
            (self.c_addr, self.c_bytes_b, self.c_bytes_d, self.c_bytes_e)
        ):
            cells = [Advice(c) for c in bank[:4]]
            val_rlc = (cells[0] + cells[1] * self.r_word
                       + cells[2] * self.r_word * self.r_word
                       + cells[3] * self.r_word * self.r_word * self.r_word)
            inputs.append(
                access(gcall_b, 2 + call_hv + j, 0, sp + 2 + call_hv + j,
                       val_rlc)
            )
        call_fnd = cr[25]
        gcall_d = gcall_b * (1 - call_fnd - cr[26])
        for k, (field, val) in enumerate(self._call_ctx_writes):
            inputs.append(
                access(gcall_d, call_npops + k, 1, 0, val, tag=ctxtag,
                       id_expr=self._call_new_id, field=field)
            )
        # no-descend CALL (codeless callee): warm write + empty-CodeHash
        # account read + (CALL) balance transfer pair + success-1 push
        gcall_nd = gcall_b * call_fnd
        call_f1 = cr[20]
        nd_addr = self._call_addr_raw
        inputs.append(access(
            gcall_nd, call_npops, 1, nd_addr, 1,
            tag=int(RwTag.TxAccessListAccount), id_expr=txid,
        ))
        from ..witness.rw import AccountField as _AF

        inputs.append(access(
            gcall_nd, call_npops + 1, 0, nd_addr, 0,
            tag=int(RwTag.Account), id_expr=0, field=int(_AF.CodeHash),
        ))
        # value-carrying variants emit the balance pair: CALL credits the
        # callee, CALLCODE credits SELF (self-transfer no-op)
        call_f2 = cr[21]
        gnd_hv = gcall_nd * (call_f1 + call_f2)
        credit_addr = call_f1 * nd_addr + call_f2 * Advice(self.c_callee)
        inputs.append(access(
            gnd_hv, call_npops + 2, 1, Advice(self.c_callee),
            Advice(self.c_acc_m), tag=int(RwTag.Account), id_expr=0,
            field=int(_AF.Balance),
        ))
        inputs.append(access(
            gnd_hv, call_npops + 3, 1, credit_addr, Advice(self.c_rpl),
            tag=int(RwTag.Account), id_expr=0, field=int(_AF.Balance),
        ))
        inputs.append(access(
            gcall_nd, call_npops + 2 + 2 * (call_f1 + call_f2), 1,
            sp + call_npops - 1, 1,
        ))
        # aborted CALL (depth/balance): warm write + (value variants) the
        # caller Balance read + failure-0 push
        gcall_ab = gcall_b * cr[26]
        inputs.append(access(
            gcall_ab, call_npops, 1, nd_addr, 1,
            tag=int(RwTag.TxAccessListAccount), id_expr=txid,
        ))
        inputs.append(access(
            gcall_ab * call_hv, call_npops + 1, 0, Advice(self.c_callee),
            Advice(self.c_acc_m), tag=int(RwTag.Account), id_expr=0,
            field=int(_AF.Balance),
        ))
        inputs.append(access(
            gcall_ab, call_npops + 1 + call_hv, 1,
            sp + call_npops - 1, 0,
        ))
        # ---- CREATE accesses: pops + account machine + ctx writes --------
        gcr_b = q * ind["CREATE"]
        cr_np = self._create_npops
        cr_fc2 = self._create_fc2
        cr_addr = self._create_addr
        from ..witness.rw import AccountField as _AF
        _acctag = int(RwTag.Account)
        _altag = int(RwTag.TxAccessListAccount)
        inputs.append(access(gcr_b, 0, 0, sp, va))            # value
        inputs.append(access(gcr_b, 1, 0, sp + 1, vb))        # offset
        inputs.append(access(gcr_b, 2, 0, sp + 2, vc))        # size
        salt_rlc = None
        rp_s = None
        for i in range(32):
            bdi = Advice(self.c_bytes_d[i])
            t_s = bdi if i == 0 else bdi * rp_s
            salt_rlc = t_s if salt_rlc is None else salt_rlc + t_s
            rp_s = self.r_word if rp_s is None else rp_s * self.r_word
        inputs.append(access(gcr_b * cr_fc2, 3, 0, sp + 3, salt_rlc))
        # creator nonce bump: write value = recomposed nonce + 1
        inputs.append(access(gcr_b, cr_np, 1, callee,
                             self._create_nv + 1, tag=_acctag,
                             id_expr=0, field=int(_AF.Nonce)))
        # created address warmed (EIP-2929)
        inputs.append(access(gcr_b, cr_np + 1, 1, cr_addr, 1, tag=_altag,
                             id_expr=txid))
        # endowment transfer (post-balances witness-carried in
        # c_acc_m / c_inv; arithmetic binding staged behind value_prev)
        inputs.append(access(gcr_b, cr_np + 2, 1, callee,
                             Advice(self.c_acc_m), tag=_acctag,
                             id_expr=0, field=int(_AF.Balance)))
        inputs.append(access(gcr_b, cr_np + 3, 1, cr_addr,
                             Advice(self.c_inv), tag=_acctag,
                             id_expr=0, field=int(_AF.Balance)))
        # created account nonce init (EIP-161)
        inputs.append(access(gcr_b, cr_np + 4, 1, cr_addr, 1, tag=_acctag,
                             id_expr=0, field=int(_AF.Nonce)))
        for k, (field, val) in enumerate(self._create_ctx_writes):
            inputs.append(
                access(gcr_b, cr_np + 5 + k, 1, 0, val, tag=ctxtag,
                       id_expr=self._create_new_id, field=field)
            )
        # ---- RET accesses: pops + restoration reads + success write ------
        gret_b = q * ind["RET"]
        rtn_b, stp_b, rvt_b = self._ret_flags
        gret_d = gret_b * (rtn_b + rvt_b)
        ret_npp = self._ret_npp
        ret_la4 = self._ret_la4
        inputs.append(access(gret_d, 0, 0, sp, va))
        inputs.append(access(gret_d, 1, 0, sp + 1, vb))
        ret_base = ret_npp + 2 * ret_la4
        ret_reads = [
            (int(CallContextField.CallerId), cid_n),
            (int(CallContextField.ReturnPc), pc_n),
            (int(CallContextField.ReturnSp), sp_n),
            (int(CallContextField.ParentCalleeAddress), callee_n),
            (int(CallContextField.ParentCodeHash), chash_n),
            (int(CallContextField.RetOffset), self._ret_retoff4),
            (int(CallContextField.RetLength), self._ret_retlen4),
            # binds fcr to the IsCreate flag the frame was created with
            # (without this read a malicious prover could
            # flip fcr to skip the code deposit or forge the pushed word)
            (int(CallContextField.IsCreate), self._ret_fcr),
        ]
        for k, (field, val) in enumerate(ret_reads):
            inputs.append(
                access(gret_b, ret_base + k, 0, 0, val, tag=ctxtag,
                       field=field)
            )
        # last-callee bookkeeping written to the CALLER's context.
        # Successful creates (fcr * (rtn+stp)) expose NO return data.
        fcr_b = self._ret_fcr
        # error-unwind rows push 0 and expose no data: the ferr modifier
        # cancels the STOP variant's success contribution
        ret_ok = rtn_b + stp_b - self._ret_ferr
        hide = fcr_b * ret_ok
        ret_writes = [
            (int(CallContextField.LastCalleeId), Advice(self.c_call_id)),
            (int(CallContextField.LastCalleeReturnDataOffset),
             self._ret_off4 * (1 - hide)),
            (int(CallContextField.LastCalleeReturnDataLength),
             self._ret_len4 * (1 - hide)),
        ]
        for k, (field, valw) in enumerate(ret_writes):
            inputs.append(
                access(gret_b, ret_base + 8 + k, 1, 0, valw, tag=ctxtag,
                       id_expr=cid_n, field=field)
            )
        # pushed word: success bit, or the created address / 0 for
        # init-frame returns
        push_val = (1 - fcr_b) * ret_ok \
            + fcr_b * ret_ok * self._ret_caddr_rlc
        inputs.append(
            access(gret_b, ret_base + 11, 1, sp_n, push_val,
                   id_expr=cid_n)
        )
        # code deposit: RETURN from an init frame writes the account's
        # code hash (value witness-carried in c_acc_m; its binding to
        # keccak(returned bytes) lands with the memory->bytecode copy
        # kind — reference CopyDataType::Bytecode)
        gdep = gret_b * fcr_b * rtn_b
        inputs.append(
            access(gdep, ret_base + 12, 1, callee, Advice(self.c_acc_m),
                   tag=int(RwTag.Account), id_expr=0,
                   field=int(AccountField.CodeHash))
        )
        # ---- LOG accesses: pops + TxLog address/topic writes (the TxLog
        # side gated by the persistence flag — doomed frames pop only) ----
        glog_b = q * ind["LOG"]
        fp_b = Advice(self.c_carry[29])
        logtag = int(RwTag.TxLog)
        L32, L48 = 1 << 32, 1 << 48
        log_n = self._log_n
        log_lid1 = self._log_lid1
        inputs.append(access(glog_b, 0, 0, sp, va))
        inputs.append(access(glog_b, 1, 0, sp + 1, vb))
        inputs.append(
            access(glog_b * fp_b, 2 + log_n, 1, 1 * L32 + log_lid1 * L48,
                   rlc_expr(ba), tag=logtag, id_expr=txid)
        )
        for j in range(4):
            gate_j = None
            for k in range(j + 1, 5):
                t_ = self._log_flags[k]
                gate_j = t_ if gate_j is None else gate_j + t_
            gtj = glog_b * gate_j
            cell = self._log_topic_cells[j]
            inputs.append(access(gtj, 2 + j, 0, sp + 2 + j, cell))
            inputs.append(
                access(gtj * fp_b, 3 + log_n + j, 1,
                       j + 2 * L32 + log_lid1 * L48, cell,
                       tag=logtag, id_expr=txid)
            )

        # ---- memory word gadgets ------------------------------------------
        mem = [Advice(c) for c in self.c_mem]  # big-endian: mem[j] @ addr+j
        ab = [Advice(c) for c in self.c_addr]  # le bytes of the address
        addr_expr = ab[0] + 256 * ab[1] + 65536 * ab[2] + 16777216 * ab[3]
        gml = q * ind["MLOAD"]
        gms = q * ind["MSTORE"]
        gmem = q * (ind["MLOAD"] + ind["MSTORE"])
        # address word RLC binding (addr < 2^32: higher RLC bytes vanish)
        addr_rlc = ab[0] + self.r_word * ab[1] \
            + self.r_word * self.r_word * ab[2] \
            + self.r_word * self.r_word * self.r_word * ab[3]
        cs.create_gate("MEM addr rlc", gmem * (addr_rlc - va))
        # word RLC binding: le byte i of the word is mem[31-i]
        def word_rlc_from_mem():
            expr = None
            rpow = None
            for i in range(32):
                b = mem[31 - i]
                term = b if i == 0 else b * rpow
                expr = term if expr is None else expr + term
                rpow = self.r_word if rpow is None else rpow * self.r_word
            return expr

        cs.create_gate("MEM word rlc", gmem * (word_rlc_from_mem() - vb))
        # stack accesses
        inputs.append(access(gml, 0, 0, sp, va))           # MLOAD addr pop
        inputs.append(access(gml, 33, 1, sp, vb))          # MLOAD result
        inputs.append(access(gms, 0, 0, sp, va))           # MSTORE addr pop
        inputs.append(access(gms, 1, 0, sp + 1, vb))       # MSTORE value pop
        # per-byte memory bus accesses
        memtag = int(RwTag.Memory)
        for j in range(32):
            inputs.append(
                access(gml, 1 + j, 0, addr_expr + j, mem[j], tag=memtag)
            )
            inputs.append(
                access(gms, 2 + j, 1, addr_expr + j, mem[j], tag=memtag)
            )
        # MSTORE8 (reference execution/memory.rs MSTORE8 path): value word
        # in bank a; the single written byte is its lowest byte a[0]
        gm8 = q * ind["MSTORE8"]
        cs.create_gate("M8 addr rlc", gm8 * (addr_rlc - va))
        cs.create_gate("M8 value rlc", gm8 * (rlc_expr(ba) - vb))
        inputs.append(access(gm8, 0, 0, sp, va))
        inputs.append(access(gm8, 1, 0, sp + 1, vb))
        inputs.append(access(gm8, 2, 1, addr_expr, ba[0], tag=memtag))
        # MULMOD/ADDMOD accesses: 3 pops + result push at sp+2
        gmod_b = q * (ind["MULMOD"] + ind["ADDMOD"])
        inputs.append(access(gmod_b, 0, 0, sp, rlc_expr(ba)))
        inputs.append(access(gmod_b, 1, 0, sp + 1, rlc_expr(bb)))
        inputs.append(access(gmod_b, 2, 0, sp + 2, rlc_expr(bc)))
        inputs.append(access(gmod_b, 3, 1, sp + 2, rlc_expr(bd)))
        # CALLDATALOAD accesses: offset pop, IsRoot + CallDataLength ctx
        # reads, then (nested only) CallDataOffset + CallerId ctx reads
        # and one CALLER-memory read per in-range byte, then the push
        gcdl_b = q * ind["CALLDATALOAD"]
        cdl_irf_b, cdl_off_b, cdl_selsum_b = self._cdl_exprs
        cdlen_b = (bd[0] + bd[1] * 256 + bd[2] * 65536 + bd[3] * 16777216)
        cdl_cdoff = (bd[4] + bd[5] * 256 + bd[6] * 65536
                     + bd[7] * 16777216)
        cdl_caller = (bd[8] + bd[9] * 256 + bd[10] * 65536
                      + bd[11] * 16777216)
        gcdl_nr = gcdl_b * (1 - cdl_irf_b)
        inputs.append(access(gcdl_b, 0, 0, sp, va))
        inputs.append(access(gcdl_b, 1, 0, 0, cdl_irf_b, tag=ctxtag,
                             field=int(CCF.IsRoot)))
        inputs.append(access(gcdl_b, 2, 0, 0, cdlen_b, tag=ctxtag,
                             field=int(CCF.CallDataLength)))
        inputs.append(access(gcdl_nr, 3, 0, 0, cdl_cdoff, tag=ctxtag,
                             field=int(CCF.CallDataOffset)))
        inputs.append(access(gcdl_nr, 4, 0, 0, cdl_caller, tag=ctxtag,
                             field=int(CCF.CallerId)))
        pref = None
        for j in range(32):
            d_rwc = 5 if pref is None else 5 + pref
            inputs.append(access(
                gcdl_nr * cr[j], d_rwc, 0,
                cdl_cdoff + cdl_off_b + j, bb[j], tag=int(RwTag.Memory),
                id_expr=cdl_caller,
            ))
            pref = cr[j] if pref is None else pref + cr[j]
        inputs.append(access(
            gcdl_b, cdl_irf_b * 3 + (1 - cdl_irf_b) * (5 + cdl_selsum_b),
            1, sp, vb,
        ))

        # CALLDATACOPY ctx accesses: IsRoot (both kinds) + the nested
        # frame's CallDataLength / CallDataOffset / CallerId reads
        gcdc_c = q * ind["CALLDATACOPY"]
        cdc_irf_c, cdc_cdlen_c, cdc_cdoff_c, cdc_caller_c = self._cdc_exprs
        gcdc_nr = gcdc_c * (1 - cdc_irf_c)
        inputs.append(access(gcdc_c, 3, 0, 0, cdc_irf_c, tag=ctxtag,
                             field=int(CCF.IsRoot)))
        inputs.append(access(gcdc_nr, 4, 0, 0, cdc_cdlen_c, tag=ctxtag,
                             field=int(CCF.CallDataLength)))
        inputs.append(access(gcdc_nr, 5, 0, 0, cdc_cdoff_c, tag=ctxtag,
                             field=int(CCF.CallDataOffset)))
        inputs.append(access(gcdc_nr, 6, 0, 0, cdc_caller_c, tag=ctxtag,
                             field=int(CCF.CallerId)))

        # ---- RETURNDATASIZE / RETURNDATACOPY accesses --------------------
        grds_b = q * ind["RETURNDATASIZE"]
        inputs.append(access(grds_b, 0, 0, 0, fold4_int(ab4), tag=ctxtag,
                             field=int(CCF.LastCalleeReturnDataLength)))
        inputs.append(access(grds_b, 1, 1, sp - 1, va))
        gcc_b = q * ind["CODECOPY"]
        inputs.append(access(gcc_b, 0, 0, sp, va))
        inputs.append(access(gcc_b, 1, 0, sp + 1, vb))
        inputs.append(access(gcc_b, 2, 0, sp + 2, vc))
        grdc_b = q * ind["RETURNDATACOPY"]
        inputs.append(access(grdc_b, 0, 0, sp, va))
        inputs.append(access(grdc_b, 1, 0, sp + 1, vb))
        inputs.append(access(grdc_b, 2, 0, sp + 2, vc))
        inputs.append(access(grdc_b, 3, 0, 0, self._rdc_lcid, tag=ctxtag,
                             field=int(CCF.LastCalleeId)))
        inputs.append(access(grdc_b, 4, 0, 0, self._rdc_off4, tag=ctxtag,
                             field=int(CCF.LastCalleeReturnDataOffset)))
        inputs.append(access(grdc_b, 5, 0, 0, self._rdc_rdl4, tag=ctxtag,
                             field=int(CCF.LastCalleeReturnDataLength)))

        # ---- precompile call accesses ------------------------------------
        for gname, extra_in, extra_out in (
            ("ECRECOVER", 128, 32), ("ECADD", 128, 64), ("ECMUL", 96, 64),
            ("MODEXP", 192, 32),
            ("IDENTITY", None, None), ("SHA256", None, None),
        ):
            gp_ = q * ind[gname]
            hv_p = Advice(self.c_carry[20])
            npp_p = 6 + hv_p
            if gname == "IDENTITY":
                in_out = 2 * self._id_la4
                alen_val = self._id_len_r
                rlen_val = self._id_rlen_r
                rdlen_val = self._id_la4
            elif gname == "MODEXP":
                in_out = self._mx_al + self._mx_ml
                alen_val = self._mx_al
                rlen_val = self._mx_ml
                rdlen_val = self._mx_ml
            elif gname == "SHA256":
                in_out = self._s2_len_i + 32
                alen_val = self._s2_len_r
                rlen_val = 32
                rdlen_val = 32
            else:
                in_out = extra_in + extra_out
                alen_val = extra_in
                rlen_val = extra_out
                rdlen_val = extra_out
            addr_c = {"ECRECOVER": 1, "SHA256": 2, "IDENTITY": 4,
                      "MODEXP": 5, "ECADD": 6, "ECMUL": 7}[gname]
            inputs.append(access(gp_, 0, 0, sp, va))
            inputs.append(access(gp_, 1, 0, sp + 1, addr_c))
            inputs.append(access(gp_ * hv_p, 2, 0, sp + 2, vc))
            inputs.append(
                access(gp_, 2 + hv_p, 0, sp + 2 + hv_p, self._p_aoff_rlc)
            )
            inputs.append(
                access(gp_, 3 + hv_p, 0, sp + 3 + hv_p, alen_val)
            )
            inputs.append(
                access(gp_, 4 + hv_p, 0, sp + 4 + hv_p, self._p_roff_rlc)
            )
            inputs.append(
                access(gp_, 5 + hv_p, 0, sp + 5 + hv_p, rlen_val)
            )
            base_p = npp_p + in_out
            inputs.append(access(gp_, base_p, 1, 0, 0, tag=ctxtag,
                                 field=int(CCF.LastCalleeId)))
            inputs.append(
                access(gp_, base_p + 1, 1, 0, 0, tag=ctxtag,
                       field=int(CCF.LastCalleeReturnDataOffset))
            )
            inputs.append(
                access(gp_, base_p + 2, 1, 0, rdlen_val, tag=ctxtag,
                       field=int(CCF.LastCalleeReturnDataLength))
            )
            inputs.append(access(gp_, base_p + 3, 1, sp + npp_p - 1, 1))

        # ---- BEGIN_TX: the 6 call-context reads (builder _begin_tx order:
        # TxId, CalleeAddress, CallerAddress, Value, IsRoot,
        # CallDataLength); va = raw caller, vb = value RLC, vc = raw
        # calldata length (reference execution/begin_tx.rs) --------------
        inputs.append(access(gbt, 0, 0, 0, txid, tag=ctxtag,
                             field=int(CCF.TxId)))
        inputs.append(access(gbt, 1, 0, 0, callee, tag=ctxtag,
                             field=int(CCF.CalleeAddress)))
        inputs.append(access(gbt, 2, 0, 0, va, tag=ctxtag,
                             field=int(CCF.CallerAddress)))
        inputs.append(access(gbt, 3, 0, 0, vb, tag=ctxtag,
                             field=int(CCF.Value)))
        inputs.append(access(gbt, 4, 0, 0, 1, tag=ctxtag,
                             field=int(CCF.IsRoot)))
        inputs.append(access(gbt, 5, 0, 0, vc, tag=ctxtag,
                             field=int(CCF.CallDataLength)))
        # account-machine rows (reference execution/begin_tx.rs):
        # EIP-2929 warms, caller nonce bump, fee purchase, value transfer,
        # callee code-hash read.  New values live in per-step cells
        # (nonce_new: c_ez raw; the three balance word-RLCs: acc_m/rpl/prl;
        # code hash: the step's own c_code_hash).  Arithmetic binding of
        # fee/value (MulWordByU64 + AddWords over the banks) is staged
        # behind the value_prev bus extension.
        from ..witness.rw import AccountField as AF
        altag = int(RwTag.TxAccessListAccount)
        acctag = int(RwTag.Account)
        nonce_new = Advice(self.c_ez)
        bal_fee = Advice(self.c_acc_m)
        bal_cval = Advice(self.c_rpl)
        bal_eval = Advice(self.c_prl)
        inputs.append(access(gbt, 6, 1, va, 1, tag=altag, id_expr=txid))
        inputs.append(access(gbt, 7, 1, callee, 1, tag=altag, id_expr=txid))
        inputs.append(access(gbt, 8, 1, va, nonce_new, tag=acctag,
                             id_expr=0, field=int(AF.Nonce)))
        inputs.append(access(gbt, 9, 1, va, bal_fee, tag=acctag,
                             id_expr=0, field=int(AF.Balance)))
        inputs.append(access(gbt, 10, 1, va, bal_cval, tag=acctag,
                             id_expr=0, field=int(AF.Balance)))
        inputs.append(access(gbt, 11, 1, callee, bal_eval, tag=acctag,
                             id_expr=0, field=int(AF.Balance)))
        inputs.append(access(gbt, 12, 0, callee, chash, tag=acctag,
                             id_expr=0, field=int(AF.CodeHash)))
        # END_TX rows (execution/end_tx.rs): refund counter (c_ez raw),
        # caller gas refund + coinbase reward balances (acc_m / rpl RLCs);
        # va = raw caller, vc = raw coinbase on END_TX rows
        get = q * et
        inputs.append(access(get, 0, 0, 0, Advice(self.c_prl),
                             tag=ctxtag, field=int(CCF.IsSuccess)))
        inputs.append(access(get, 1, 1, 0, Advice(self.c_ez),
                             tag=int(RwTag.TxRefund), id_expr=txid))
        inputs.append(access(get, 2, 1, va, Advice(self.c_acc_m),
                             tag=acctag, id_expr=0, field=int(AF.Balance)))
        inputs.append(access(get, 3, 1, vc, Advice(self.c_rpl),
                             tag=acctag, id_expr=0, field=int(AF.Balance)))
        # TxReceipt rows: status, cumulative gas (incl. this tx), log
        # count (reference operation.rs:113; raw value encoding)
        from ..witness.rw import TxReceiptField as TRF

        rcpt = int(RwTag.TxReceipt)
        et_used = (Advice(self.c_gas_limit) - Advice(self.c_gas_left)
                   - Advice(self.c_ez))
        inputs.append(access(get, 4, 1, 0, Advice(self.c_prl), tag=rcpt,
                             id_expr=txid,
                             field=int(TRF.PostStateOrStatus)))
        inputs.append(access(get, 5, 1, 0,
                             Advice(self.c_cum_gas) + et_used, tag=rcpt,
                             id_expr=txid,
                             field=int(TRF.CumulativeGasUsed)))
        inputs.append(access(get, 6, 1, 0, Advice(self.c_log_id),
                             tag=rcpt, id_expr=txid,
                             field=int(TRF.LogLength)))
        if self.tx_table is not None:
            # anchor the context to the TxTable (tx_id, tag, index, value)
            from .tx import TxFieldTag as TT

            cs.lookup_logup(
                "begin tx table",
                [
                    [gbt * txid, gbt * int(TT.CalleeAddress), gbt * 0,
                     gbt * callee],
                    [gbt * txid, gbt * int(TT.CallerAddress), gbt * 0,
                     gbt * va],
                    [gbt * txid, gbt * int(TT.Value), gbt * 0, gbt * vb],
                    [gbt * txid, gbt * int(TT.CallDataLength), gbt * 0,
                     gbt * vc],
                    # gas anchor: BEGIN_TX.gas is the tx gas limit; its
                    # gas_cost is 21000 + calldata gas + access-list gas
                    # (the TxTable commits CallDataGasCost and the
                    # EIP-2930 AccessListGasCost / AccessListRows,
                    # reference execution/begin_tx.rs)
                    [gbt * txid, gbt * int(TT.Gas), gbt * 0,
                     gbt * Advice(self.c_gas_left)],
                    [gbt * txid, gbt * int(TT.CallDataGasCost), gbt * 0,
                     gbt * (Advice(self.c_gas_cost) - 21000
                            - Advice(self.c_eo))],
                    [gbt * txid, gbt * int(TT.AccessListGasCost), gbt * 0,
                     gbt * Advice(self.c_eo)],
                    [gbt * txid, gbt * int(TT.AccessListRows), gbt * 0,
                     gbt * Advice(self.c_gas_aux)],
                ],
                self.tx_table,
            )

        # ---- context opcodes: ctx read + stack push ----------------------
        # CALLER / ADDRESS: ctx value is the RAW address; the pushed stack
        # word is its RLC — bytes_a cells carry the 20-byte decomposition
        gcaller = q * ind["CALLER"]
        gaddr = q * ind["ADDRESS"]
        gctx_addr = gcaller + gaddr
        addr_raw = None
        for i in range(20):
            term = ba[i] * (1 << (8 * i))
            addr_raw = term if addr_raw is None else addr_raw + term
        for i in range(20, 32):
            cs.create_gate(f"ctx addr byte {i} zero", gctx_addr * ba[i])
        cs.create_gate("ctx addr rlc", gctx_addr * (rlc_expr(ba) - va))
        cs.create_gate("ADDRESS is callee", gaddr * (addr_raw - callee))
        inputs.append(access(gcaller, 0, 0, 0, addr_raw, tag=ctxtag,
                             field=int(CCF.CallerAddress)))
        inputs.append(access(gcaller, 1, 1, sp - 1, va))
        inputs.append(access(gaddr, 0, 0, 0, addr_raw, tag=ctxtag,
                             field=int(CCF.CalleeAddress)))
        inputs.append(access(gaddr, 1, 1, sp - 1, va))
        # CALLVALUE: ctx Value is stored as word RLC — both sides are va
        gcv = q * ind["CALLVALUE"]
        inputs.append(access(gcv, 0, 0, 0, va, tag=ctxtag,
                             field=int(CCF.Value)))
        inputs.append(access(gcv, 1, 1, sp - 1, va))
        # CALLDATASIZE: raw length (< 2^32) in c_addr bytes
        gcds = q * ind["CALLDATASIZE"]
        cs.create_gate("CDS rlc", gcds * (fold4_rlc(ab4) - va))
        inputs.append(access(gcds, 0, 0, 0, fold4_int(ab4), tag=ctxtag,
                             field=int(CCF.CallDataLength)))
        inputs.append(access(gcds, 1, 1, sp - 1, va))

        # ---- storage: SLOAD / SSTORE (reference execution/sload.rs,
        # sstore.rs).  The stack key word-RLC IS the rw-table storage-key
        # convention, so va feeds the lookup directly. -------------------
        storetag = int(RwTag.Storage)
        gsl = q * ind["SLOAD"]
        inputs.append(access(gsl, 0, 0, sp, va))
        inputs.append(access(gsl, 1, 0, callee, vb, tag=storetag,
                             id_expr=txid, key=va))
        inputs.append(access(gsl, 2, 1, sp, vb))
        gss = q * ind["SSTORE"]
        inputs.append(access(gss, 0, 0, sp, va))
        inputs.append(access(gss, 1, 0, sp + 1, vb))
        inputs.append(access(gss, 2, 1, callee, vb, tag=storetag,
                             id_expr=txid, key=va))

        # ---- account opcodes (reference execution/balance.rs,
        # extcodesize.rs, extcodehash.rs, selfbalance.rs): pop the address
        # word (bytes_a; low 20 bytes form the account key), warm it
        # (TxAccessListAccount write), read the Account field, push.
        af_bal = int(AccountField.Balance)
        gsb = q * ind["SELFBALANCE"]
        inputs.append(access(gsb, 0, 0, callee, vb, tag=acctag,
                             id_expr=0, field=af_bal))
        inputs.append(access(gsb, 1, 1, sp - 1, vb))
        g_acct = q * (ind["BALANCE"] + ind["EXTCODESIZE"]
                      + ind["EXTCODEHASH"])
        cs.create_gate("acct addr rlc", g_acct * (rlc_expr(ba) - va))
        inputs.append(access(g_acct, 0, 0, sp, va))
        inputs.append(access(g_acct, 1, 1, addr_raw, 1, tag=altag,
                             id_expr=txid))
        inputs.append(access(g_acct, 3, 1, sp, vb))
        gb2 = q * ind["BALANCE"]
        inputs.append(access(gb2, 2, 0, addr_raw, vb, tag=acctag,
                             id_expr=0, field=af_bal))
        # EXTCODESIZE: raw size (c_addr 4 bytes) on the account row, its
        # word-RLC on the stack
        ges = q * ind["EXTCODESIZE"]
        cs.create_gate("EXTCODESIZE size rlc", ges * (fold4_rlc(ab4) - vb))
        inputs.append(access(ges, 2, 0, addr_raw, fold4_int(ab4),
                             tag=acctag, id_expr=0,
                             field=int(AccountField.CodeSize)))
        # EXTCODEHASH: bytes_b holds the digest BIG-ENDIAN; the account
        # row uses the keccak fold (BE byte 0 at r^0), the stack word its
        # LE fold — both from the same cells
        geh = q * ind["EXTCODEHASH"]
        cs.create_gate(
            "EXTCODEHASH word rlc",
            geh * (rlc_expr(list(reversed(bb))) - vb),
        )
        inputs.append(access(geh, 2, 0, addr_raw, rlc_expr(bb),
                             tag=acctag, id_expr=0,
                             field=int(AccountField.CodeHash)))
        # EXTCODECOPY: 4 pops + warm write + ext CodeHash read
        inputs.append(access(gxc, 0, 0, sp, va))
        inputs.append(access(gxc, 1, 0, sp + 1, vb))
        inputs.append(access(gxc, 2, 0, sp + 2, vc))
        inputs.append(access(gxc, 3, 0, sp + 3, fold4_rlc(bb)))
        inputs.append(access(gxc, 4, 1, addr_raw, 1, tag=altag,
                             id_expr=txid))
        inputs.append(access(gxc, 5, 0, addr_raw, Advice(self.c_acc_m),
                             tag=acctag, id_expr=0,
                             field=int(AccountField.CodeHash)))

        cs.lookup_logup("rw bus", inputs, table)

    # ------------------------------------------------------------------
    def _target(self, n: int) -> int:
        t = self.params.target_steps or usable_rows(n)
        assert len(self.steps) <= t <= usable_rows(n)
        return t

    def _rw_target(self, n: int) -> int:
        t = self.params.rw_target or usable_rows(n)
        return t

    def fixed_columns(self, n: int):
        t = self._target(n)
        assert n >= 256, "domain must fit the byte range table"
        mont = F.mont_from_ints
        nib = lambda i, op: op(i >> 4, i & 15) if i < 256 else 0
        out = {
            self.q_step: mont([1 if i < t else 0 for i in range(n)]),
            self.q_first: mont([1 if i == 0 else 0 for i in range(n)]),
            self.tbl_byte: mont([i if i < 256 else 0 for i in range(n)]),
            self.tbl_and: mont(
                [nib(i, lambda x, y: x & y) for i in range(n)]
            ),
            self.tbl_or: mont([nib(i, lambda x, y: x | y) for i in range(n)]),
            self.tbl_xor: mont(
                [nib(i, lambda x, y: x ^ y) for i in range(n)]
            ),
            self.tbl_sel256: mont([1 if i < 256 else 0 for i in range(n)]),
            self.tbl_op_pops: mont([
                op.pops if (i < 256 and (op := opcode_from_byte(i))
                            is not None) else 0
                for i in range(n)
            ]),
            self.tbl_op_pushes: mont([
                op.pushes if (i < 256 and (op := opcode_from_byte(i))
                              is not None) else 0
                for i in range(n)
            ]),
            self.tbl_op_gas: mont([
                op.constant_gas if (i < 256 and (op := opcode_from_byte(i))
                                    is not None) else 0
                for i in range(n)
            ]),
            self.tbl_op_invalid: mont([
                1 if (i < 256 and (opcode_from_byte(i) is None
                                   or i == 0xFE)) else 0
                for i in range(n)
            ]),
            self.tbl_pow2_lo: mont(
                [(1 << i) if i < 128 else 0 for i in range(n)]
            ),
            self.tbl_pow2_hi: mont(
                [(1 << (i - 128)) if 128 <= i < 256 else 0 for i in range(n)]
            ),
            self.q_padt: mont([1 if i < 136 else 0 for i in range(n)]),
            self.q_padt0: mont([1 if i == 0 else 0 for i in range(n)]),
        }
        if self.standalone:
            rt = self._rw_target(n)
            out[self.q_rw] = mont([1 if i < rt else 0 for i in range(n)])
        return out

    def _classify(self, s: ExecStep) -> str:
        if s.exec_state.startswith("ERR_"):
            return s.exec_state
        if s.exec_state == "BeginTx":
            return "BEGIN_TX"
        if s.exec_state == "EndTx":
            return "END_TX"
        if s.op is not None and s.op.is_log:
            return "LOG"
        if s.op is not None and s.op.is_push:
            return "PUSH"
        if s.op is not None and s.op.is_dup:
            return "DUP"
        if s.op is not None and s.op.is_swap:
            return "SWAP"
        assert s.exec_state in GADGETS, f"unsupported opcode {s.exec_state}"
        return s.exec_state

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        t = self._target(n)
        steps = self.steps
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        if phase == 0:
            cols = {}
            kinds = [self._classify(s) for s in steps]
            pad_n = t - len(steps)
            for g in GADGETS:
                base = [int(k == g) for k in kinds]
                # padding rows are STOP steps (terminal, no transitions)
                pad = [1 if g == "STOP" else 0] * pad_n
                cols[self.c_ind[g]] = mont(base + pad)
            # padding rows must satisfy the END_TX transition out of the
            # last real row and the tx/callee/call continuity gates, so
            # they inherit the last step's context
            last = steps[-1] if steps else None
            pad_rwc = (
                last.rw_counter_start + len(last.rw_indices) if last else 0
            )
            pads = {
                "pc": 0, "sp": STACK_BASE if last else 0, "rwc": pad_rwc,
                "cid": last.call_id if last else 0,
                "txid": last.tx_id if last else 0,
                "callee": last.callee if last else 0,
                "lid": last.log_id if last else 0,
            }
            padded = lambda vals, key: mont(vals + [pads[key]] * pad_n)
            cols[self.c_pc] = padded([s.pc for s in steps], "pc")
            cols[self.c_gas_cost] = mont([s.gas_cost for s in steps])
            # gas_left chain; padding STOP rows hold the final gas
            pads["gas"] = (last.gas - last.gas_cost) if last else 0
            cols[self.c_gas_left] = padded([s.gas for s in steps], "gas")
            # tx gas limit (BEGIN_TX row's gas, carried) and the block-
            # cumulative gas used (updated after each END_TX)
            lims, cums = [], []
            cur_lim, cur_cum = 0, 0
            for s in steps:
                if s.exec_state == "BeginTx":
                    cur_lim = s.gas
                lims.append(cur_lim)
                cums.append(cur_cum)
                if s.exec_state == "EndTx":
                    refund_v = (self.rw_by_counter[s.rw_indices[1]].value
                                if len(s.rw_indices) > 1 else 0)
                    cur_cum += cur_lim - s.gas - refund_v
            pads["lim"] = cur_lim
            pads["cum"] = cur_cum
            cols[self.c_gas_limit] = padded(lims, "lim")
            cols[self.c_cum_gas] = padded(cums, "cum")
            pads["mw"] = last.mem_words if last else 0
            cols[self.c_mw] = padded([s.mem_words for s in steps], "mw")
            # PUSH0 IsZero inverse: 1/plen for PUSHn (n>=1); ERR_STACK rows
            # overwrite theirs with the underflow distance in the loop
            gas_aux = [
                pow(s.op.push_len, -1, R)
                if (s.op is not None and s.op.is_push and s.op.push_len
                    and not s.exec_state.startswith("ERR_"))
                else 0
                for s in steps
            ]
            cols[self.c_rwc] = padded(
                [s.rw_counter_start for s in steps], "rwc"
            )
            cols[self.c_sp] = padded([s.stack_pointer for s in steps], "sp")
            cols[self.c_call_id] = padded(
                [s.call_id for s in steps], "cid"
            )
            cols[self.c_tx_id] = padded([s.tx_id for s in steps], "txid")
            cols[self.c_callee] = padded(
                [s.callee for s in steps], "callee"
            )
            cols[self.c_log_id] = padded([s.log_id for s in steps], "lid")
            plens = [
                s.op.push_len if (s.op is not None and s.op.is_push) else 0
                for s in steps
            ]  # SHA3 rows overwrite theirs with the pad length below;
            # c_push_len is assigned after the per-step loop
            depth = [
                (s.err_aux if s.exec_state == "ERR_INVALID_OP"
                 else int(s.op)) if s.exec_state.startswith("ERR_")
                else (s.op - 0x7F) if (s.op is not None and s.op.is_dup)
                else (s.op - 0x8F) if (s.op is not None and s.op.is_swap)
                else 0
                for s in steps
            ]
            cols[self.c_depth_n] = mont(depth)
            # AddWords byte cells + carries (ADD: a+b=c; SUB: c+b=a; PC
            # borrows bytes_a for the pc decomposition)
            n_steps = len(steps)
            byts = {k: [[0] * n_steps for _ in range(32)] for k in "abcdefg"}
            carries = [[0] * n_steps for _ in range(32)]
            membytes = [[0] * n_steps for _ in range(32)]
            addrbytes = [[0] * n_steps for _ in range(4)]
            ez_col = [0] * n_steps
            eo_col = [0] * n_steps
            M128, M256 = (1 << 128) - 1, 1 << 256

            def set_word(key, si, w):
                le = w.to_bytes(32, "little")
                for i in range(32):
                    byts[key][i][si] = le[i]

            def mul_carries(x, y, z, w):
                """carry bytes for x*y + z = w (mod 2^256)."""
                lx = [(x >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]
                ly = [(y >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]
                t = [
                    sum(lx[i] * ly[k - i] for i in range(4) if 0 <= k - i < 4)
                    for k in range(4)
                ]
                cl = (t[0] + (t[1] << 64) + (z & M128) - (w & M128)) >> 128
                ch = (t[2] + (t[3] << 64) + (z >> 128) + cl
                      - ((w >> 128) & M128)) >> 128
                assert 0 <= cl < (1 << 72) and 0 <= ch < (1 << 72)
                return cl, ch

            def set_carry_bytes(si, cl, ch, bor=None):
                clb = cl.to_bytes(9, "little")
                chb = ch.to_bytes(9, "little")
                for i in range(9):
                    carries[i][si] = clb[i]
                    carries[9 + i][si] = chb[i]
                if bor is not None:
                    carries[18][si] = bor

            gx_cols = [[0] * n_steps for _ in range(18)]
            for si, s in enumerate(steps):
                kind = self._classify(s)
                ops = [self.rw_by_counter[i] for i in s.rw_indices]
                if kind in ("CALLDATACOPY", "CODECOPY", "RETURNDATACOPY",
                            "SHA3", "LOG", "RETURN", "REVERT",
                            "EXTCODECOPY"):
                    # dynamic-gas cells (gates above).  start/size stack
                    # positions per kind; RETURN/REVERT also need their
                    # off/len byte banks filled here (no gadget fill).
                    if kind in ("SHA3", "LOG", "RETURN", "REVERT"):
                        start_v, size_v = ops[0].value, ops[1].value
                    elif kind == "EXTCODECOPY":
                        start_v, size_v = ops[1].value, ops[3].value
                    else:
                        start_v, size_v = ops[0].value, ops[2].value
                    if kind in ("RETURN", "REVERT"):
                        for i in range(4):
                            addrbytes[i][si] = (start_v >> (8 * i)) & 0xFF
                            byts["b"][i][si] = (size_v >> (8 * i)) & 0xFF
                    nz_v = int(size_v != 0)
                    wc_v = (size_v + 31) // 32
                    mw_v = s.mem_words
                    gx_cols[13][si] = nz_v
                    gx_cols[14][si] = pow(size_v, -1, R) if size_v else 0
                    gx_cols[16][si] = wc_v
                    gx_cols[17][si] = 32 * wc_v - size_v
                    if nz_v:
                        m_v = (start_v + size_v + 31) // 32
                        mwp_v = max(mw_v, m_v)
                        e_v = int(m_v >= mw_v)
                        d_v = (m_v - mw_v) if e_v else (mw_v - m_v)
                        qn_, sn_ = divmod(mwp_v * mwp_v, 512)
                        qo_, so_ = divmod(mw_v * mw_v, 512)
                        vals = [
                            m_v, 32 * m_v - start_v - size_v, e_v,
                            d_v & 0xFF, (d_v >> 8) & 0xFF,
                            (d_v >> 16) & 0xFF, (d_v >> 24) & 0xFF,
                            qn_, sn_ & 0xFF, sn_ >> 8,
                            qo_, so_ & 0xFF, so_ >> 8,
                        ]
                        for ci2, v2 in enumerate(vals):
                            gx_cols[ci2][si] = v2
                        gx_cols[15][si] = mwp_v
                    else:
                        gx_cols[15][si] = mw_v
                if kind in ("MLOAD", "MSTORE", "MSTORE8"):
                    # memory-expansion gas cells (gates above)
                    width = 1 if kind == "MSTORE8" else 32
                    addr_v = ops[0].value
                    m_v = (addr_v + width + 31) // 32
                    mw_v = s.mem_words
                    mwn_v = max(mw_v, m_v)
                    e_v = int(m_v >= mw_v)
                    d_v = (m_v - mw_v) if e_v else (mw_v - m_v - 1)
                    qn_, sn_ = divmod(mwn_v * mwn_v, 512)
                    qo_, so_ = divmod(mw_v * mw_v, 512)
                    vals = [
                        m_v, 32 * m_v - addr_v - width, e_v,
                        d_v & 0xFF, (d_v >> 8) & 0xFF, (d_v >> 16) & 0xFF,
                        (d_v >> 24) & 0xFF, qn_, sn_ & 0xFF, sn_ >> 8,
                        qo_, so_ & 0xFF, so_ >> 8,
                    ]
                    for ci2, v2 in enumerate(vals):
                        gx_cols[ci2][si] = v2
                if kind in ("BEGIN_TX", "END_TX"):
                    if kind == "BEGIN_TX":
                        ez_col[si] = ops[8].value  # caller nonce_new (raw)
                        gas_aux[si] = s.al_count  # EIP-2930 prewarm rows
                        eo_col[si] = s.al_gas  # access-list intrinsic gas
                    else:
                        ez_col[si] = ops[1].value  # TxRefund counter (raw)
                        gas_aux[si] = s.rev_count
                elif kind in ("BALANCE", "EXTCODESIZE", "EXTCODEHASH"):
                    set_word("a", si, ops[0].value)  # popped address word
                    if kind == "EXTCODESIZE":
                        size = ops[2].value
                        for i in range(4):
                            addrbytes[i][si] = (size >> (8 * i)) & 0xFF
                    elif kind == "EXTCODEHASH":
                        hb = ops[2].value.to_bytes(32, "big")
                        for i in range(32):
                            byts["b"][i][si] = hb[i]
                elif kind in ("ERR_JUMP", "ERR_RDOOB"):
                    op = s.op
                    ez_col[si] = op.pops
                    eo_col[si] = op.pushes
                    plens[si] = op.constant_gas
                    if kind == "ERR_JUMP":
                        carries[0][si] = int(op == OpcodeId.JUMPI)
                        dest = ops[0].value
                        db_ = dest.to_bytes(32, "little")
                        for i in range(32):
                            byts["a"][i][si] = db_[i]
                        s28v = sum(db_[4:])
                        carries[1][si] = int(s28v == 0)
                        gx_cols[1][si] = (
                            pow(s28v, -1, R) if s28v else 0
                        )
                        ln_, b_at, ic_at, oor_ = s.err_aux
                        carries[2][si] = oor_
                        gx_cols[7][si] = ln_
                        gx_cols[8][si] = b_at
                        gx_cols[9][si] = ic_at
                        gx_cols[10][si] = int(b_at != 0x5B)
                        gx_cols[11][si] = (
                            pow(b_at - 0x5B, -1, R) if b_at != 0x5B else 0
                        )
                        if oor_ and s28v == 0:
                            ev_ = (dest & 0xFFFFFFFF) - ln_
                            for i in range(4):
                                gx_cols[3 + i][si] = (ev_ >> (8 * i)) & 0xFF
                    else:  # ERR_RDOOB
                        src_v, len_v = ops[1].value, ops[2].value
                        rdl_v = ops[3].value
                        for i in range(4):
                            byts["a"][i][si] = (src_v >> (8 * i)) & 0xFF
                            byts["b"][i][si] = (len_v >> (8 * i)) & 0xFF
                            addrbytes[i][si] = (rdl_v >> (8 * i)) & 0xFF
                        ev_ = src_v + len_v - rdl_v - 1
                        for i in range(4):
                            gx_cols[3 + i][si] = (ev_ >> (8 * i)) & 0xFF
                elif kind == "ERR_OOG_DYN":
                    op = s.op
                    ez_col[si] = op.pops
                    eo_col[si] = op.pushes
                    plens[si] = op.constant_gas
                    fam, addr_v, size_v, required = s.err_aux
                    fam_idx = {"mem32": 2, "mem1": 3, "sha": 4,
                               "copy": 5, "log": 6, "span": 7}[fam]
                    carries[fam_idx][si] = 1
                    if required == "ovf":
                        # u64-overflow sub-shape: full offending word in
                        # bank c + high-sum inverse + 5-byte gas bound
                        carries[8][si] = 1
                        fhi_ = int(addr_v < (1 << 32))
                        carries[9][si] = fhi_
                        w_v = size_v if fhi_ else addr_v
                        wb_ = w_v.to_bytes(32, "little")
                        for i in range(32):
                            byts["c"][i][si] = wb_[i]
                        gx_cols[15][si] = pow(sum(wb_[4:]), -1, R)
                        for i in range(5):
                            byts["d"][i][si] = (s.gas >> (8 * i)) & 0xFF
                        ez_col[si] = s.op.pops
                        eo_col[si] = s.op.pushes
                        plens[si] = s.op.constant_gas
                        continue
                    for i in range(4):
                        addrbytes[i][si] = (addr_v >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (size_v >> (8 * i)) & 0xFF
                    mem_f = fam in ("mem32", "mem1")
                    width = (32 if fam == "mem32"
                             else 1 if fam == "mem1" else size_v)
                    nz_ = int(size_v != 0)
                    gx_cols[13][si] = nz_
                    gx_cols[14][si] = (
                        pow(size_v % R, -1, R) if size_v else 0
                    )
                    if mem_f or nz_:
                        extent = addr_v + width
                        m_ = (extent + 31) // 32
                        gx_cols[0][si] = m_
                        gx_cols[1][si] = 32 * m_ - extent
                        mw_v = s.mem_words
                        e_ = int(m_ > mw_v)
                        gx_cols[2][si] = e_
                        d_ = (m_ - mw_v) if e_ else (mw_v - m_)
                        for i in range(4):
                            gx_cols[3 + i][si] = (d_ >> (8 * i)) & 0xFF
                        if e_:
                            gx_cols[7][si] = (m_ * m_) // 512
                            sm_ = (m_ * m_) % 512
                            gx_cols[8][si] = sm_ & 0xFF
                            gx_cols[9][si] = sm_ >> 8
                            gx_cols[10][si] = (mw_v * mw_v) // 512
                            sw_ = (mw_v * mw_v) % 512
                            gx_cols[11][si] = sw_ & 0xFF
                            gx_cols[12][si] = sw_ >> 8
                    if fam in ("sha", "copy"):
                        w_ = (size_v + 31) // 32
                        gx_cols[16][si] = w_
                        gx_cols[17][si] = 32 * w_ - size_v
                    slack_v = required - s.gas - 1
                    assert 0 <= slack_v < (1 << 64)
                    for i in range(8):
                        byts["f"][i][si] = (slack_v >> (8 * i)) & 0xFF
                elif kind == "ERR_WRITE_PROT":
                    op = s.op
                    ez_col[si] = op.pops
                    eo_col[si] = op.pushes
                    plens[si] = op.constant_gas
                    # family flags: carry cells 0..9 (gates above)
                    if op == OpcodeId.SSTORE:
                        carries[0][si] = 1
                    elif op.is_log:
                        carries[1 + (op - 0xA0)][si] = 1
                    elif op in (OpcodeId.CREATE, OpcodeId.CREATE2):
                        carries[6][si] = 1
                        if op == OpcodeId.CREATE2:
                            carries[7][si] = 1
                    elif op == OpcodeId.SELFDESTRUCT:
                        carries[8][si] = 1
                    else:  # CALL with value
                        carries[9][si] = 1
                elif kind in ("ERR_STACK", "ERR_OOG"):
                    op = s.op
                    ez_col[si] = op.pops
                    eo_col[si] = op.pushes
                    plens[si] = op.constant_gas
                    if kind == "ERR_STACK":
                        under = s.stack_pointer + op.pops > 1024
                        carries[0][si] = int(under)
                        carries[1][si] = int(not under)
                        if under:
                            gas_aux[si] = s.stack_pointer + op.pops - 1025
                    else:  # ERR_OOG: gas_left < constant_gas
                        # clamped, not asserted: an inconsistent claim
                        # (gas >= cost) must fail at the GATE, not in
                        # witness generation
                        d2 = min(max(op.constant_gas - s.gas - 1, 0),
                                 (1 << 16) - 1)
                        byts["a"][0][si] = d2 & 0xFF
                        byts["a"][1][si] = d2 >> 8
                elif kind == "PUSH":
                    set_word("a", si, ops[0].value)
                    for i in range(s.op.push_len):
                        carries[i][si] = 1
                elif kind in ("JUMP", "JUMPI"):
                    dest = ops[0].value
                    assert dest < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (dest >> (8 * i)) & 0xFF
                    if kind == "JUMPI":
                        eo_col[si] = int(ops[1].value != 0)
                elif kind == "SHR":
                    s_, v_ = ops[0].value, ops[1].value
                    res = ops[2].value
                    set_word("a", si, s_)
                    set_word("b", si, v_)
                    set_word("c", si, res)
                    if s_ < 256:
                        p2 = 1 << s_
                        rem = v_ - (res << s_)
                        set_word("d", si, p2)
                        db = rem.to_bytes(32, "little")
                        for j in range(32):
                            membytes[j][si] = db[j]
                        set_carry_bytes(
                            si, *mul_carries(res, p2, rem, v_),
                            bor=int((rem & M128) < (p2 & M128)),
                        )
                        diff = rem - p2 + M256
                        eb = diff.to_bytes(32, "little")
                        for j in range(32):
                            byts["e"][j][si] = eb[j]
                elif kind == "PC":
                    byts["a"][0][si] = s.pc & 0xFF
                    byts["a"][1][si] = (s.pc >> 8) & 0xFF
                elif kind in ("MLOAD", "MSTORE"):
                    addr = ops[0].value
                    for i in range(4):
                        addrbytes[i][si] = (addr >> (8 * i)) & 0xFF
                    mem_ops = (
                        ops[1:33] if kind == "MLOAD" else ops[2:34]
                    )
                    for j, op_ in enumerate(mem_ops):
                        membytes[j][si] = op_.value
                elif kind in ("ADD", "SUB"):
                    if kind == "ADD":
                        words = dict(
                            a=ops[0].value, b=ops[1].value, c=ops[2].value
                        )
                    else:  # SUB: x=result, y=subtrahend, z=minuend
                        words = dict(
                            a=ops[2].value, b=ops[1].value, c=ops[0].value
                        )
                    for key, w in words.items():
                        set_word(key, si, w)
                    carry = 0
                    for i in range(32):
                        tot = byts["a"][i][si] + byts["b"][i][si] + carry
                        carry = tot >> 8
                        carries[i][si] = carry
                elif kind == "MUL":
                    x, y, w = ops[0].value, ops[1].value, ops[2].value
                    set_word("a", si, x)
                    set_word("b", si, y)
                    set_word("c", si, w)
                    set_carry_bytes(si, *mul_carries(x, y, 0, w))
                elif kind == "SAR":
                    s_, x_, res = (o.value for o in ops[:3])
                    set_word("a", si, s_)
                    set_word("b", si, x_)
                    set_word("c", si, res)
                    sx_v = int(x_ >= (1 << 255))
                    carries[19][si] = sx_v
                    addrbytes[0][si] = (x_ >> 248) - sx_v * 128
                    ez_col[si] = int(s_ >= 256)
                    eo_col[si] = int(s_ == 0)
                    if s_ < 256:
                        p2 = 1 << s_
                        qv = x_ >> s_
                        rem = x_ - (qv << s_)
                        set_word("d", si, p2)
                        set_word("f", si, rem)
                        qb = qv.to_bytes(32, "little")
                        for j in range(32):
                            membytes[j][si] = qb[j]
                        set_carry_bytes(
                            si, *mul_carries(qv, p2, rem, x_),
                            bor=int((rem & M128) < (p2 & M128)),
                        )
                        set_word("g", si, (rem - p2 + M256) % M256)
                        if s_ > 0:
                            pinv = 1 << (256 - s_)
                            set_word("e", si, pinv)
                        fill = res - qv
                        carries[22][si] = int(sx_v and s_ > 0)
                        carries[20][si] = int(
                            (res & M128) < (qv & M128)
                        )
                        if carries[22][si]:
                            pv = 1 << (256 - s_)
                            fl = ((res & M128) - (qv & M128)
                                  + carries[20][si] * (1 << 128))
                            carries[21][si] = (
                                fl + (pv & M128)
                            ) >> 128
                elif kind in ("SDIV", "SMOD"):
                    M255 = 1 << 255
                    a_, b_v, res = (o.value for o in ops[:3])
                    sa_v, sb_v = int(a_ >= M255), int(b_v >= M255)
                    abs_a = (M256 - a_) % M256 if sa_v else a_
                    abs_b = (M256 - b_v) % M256 if sb_v else b_v
                    qv = abs_a // abs_b if abs_b else 0
                    rv = abs_a - qv * abs_b if abs_b else 0
                    set_word("a", si, a_)
                    set_word("b", si, b_v)
                    set_word("c", si, res)
                    set_word("d", si, abs_a)
                    set_word("e", si, abs_b)
                    set_word("f", si, rv)
                    qb = qv.to_bytes(32, "little")
                    for j in range(32):
                        membytes[j][si] = qb[j]
                    if abs_b:
                        set_carry_bytes(
                            si, *mul_carries(qv, abs_b, rv, abs_a),
                            bor=int((rv & M128) < (abs_b & M128)),
                        )
                        set_word("g", si, (rv - abs_b + M256) % M256)
                    carries[19][si] = sa_v
                    carries[20][si] = sb_v
                    if sa_v:
                        carries[21][si] = (
                            (a_ & M128) + (abs_a & M128)
                        ) >> 128
                    if sb_v:
                        carries[22][si] = (
                            (b_v & M128) + (abs_b & M128)
                        ) >> 128
                    val = qv if kind == "SDIV" else rv
                    rsgn = sa_v ^ sb_v if kind == "SDIV" else sa_v
                    if abs_b and rsgn and val:
                        carries[23][si] = (
                            (val & M128) + (res & M128)
                        ) >> 128
                    addrbytes[0][si] = (a_ >> 248) - sa_v * 128
                    addrbytes[1][si] = (b_v >> 248) - sb_v * 128
                    ez_col[si] = int(val == 0)
                elif kind == "SIGNEXTEND":
                    i_w, x_w, res = (o.value for o in ops[:3])
                    set_word("a", si, i_w)
                    set_word("b", si, x_w)
                    set_word("c", si, res)
                    keep_all = i_w >= 31
                    kept = 31 if keep_all else i_w
                    for j in range(kept + 1):
                        carries[j][si] = 1
                    if not keep_all:
                        sel = (x_w >> (8 * i_w)) & 0xFF
                        eo_col[si] = sel >> 7
                        addrbytes[2][si] = sel & 0x7F
                    ez_col[si] = int(31 <= i_w < 256)
                elif kind in ("DIV", "MOD"):
                    a_, b_ = ops[0].value, ops[1].value
                    qv = a_ // b_ if b_ else 0
                    r_ = a_ - qv * b_ if b_ else a_
                    set_word("a", si, a_)
                    set_word("b", si, b_)
                    set_word("c", si, qv)
                    set_word("d", si, r_)
                    bor = int((r_ & M128) < (b_ & M128))
                    set_carry_bytes(si, *mul_carries(qv, b_, r_, a_), bor=bor)
                    diff = (r_ - b_ + M256) % M256 if b_ else 0
                    db = diff.to_bytes(32, "little")
                    for j in range(32):
                        membytes[j][si] = db[j]
                elif kind in ("LT", "GT"):
                    x = ops[0].value if kind == "LT" else ops[1].value
                    y = ops[1].value if kind == "LT" else ops[0].value
                    res = ops[2].value
                    set_word("a", si, x)
                    set_word("b", si, y)
                    set_word("c", si, x - y + res * M256)
                    carries[0][si] = int((x & M128) < (y & M128))
                elif kind in ("SLT", "SGT"):
                    x = ops[0].value if kind == "SLT" else ops[1].value
                    y = ops[1].value if kind == "SLT" else ops[0].value
                    ltv = int(x < y)
                    set_word("a", si, x)
                    set_word("b", si, y)
                    set_word("c", si, x - y + ltv * M256)
                    carries[0][si] = int((x & M128) < (y & M128))
                    gx_cols[0][si] = x >> 255
                    gx_cols[1][si] = y >> 255
                    ez_col[si] = ltv
                elif kind == "EXTCODECOPY":
                    aw = ops[0].value.to_bytes(32, "little")
                    for i in range(32):
                        byts["a"][i][si] = aw[i]
                    dst_v, src_v, len_v = (ops[j].value for j in (1, 2, 3))
                    assert max(dst_v, src_v, len_v) < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (dst_v >> (8 * i)) & 0xFF
                        byts["d"][i][si] = (src_v >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (len_v >> (8 * i)) & 0xFF
                    # EIP-2929 base from the warm write's previous value
                    eo_col[si] = 100 if ops[4].value_prev else 2600
                elif kind == "GAS":
                    gv = ops[0].value
                    for i in range(8):
                        byts["a"][i][si] = (gv >> (8 * i)) & 0xFF
                elif kind == "BLOCKHASH":
                    numv = ops[0].value
                    nb = numv.to_bytes(32, "little")
                    for i in range(32):
                        byts["a"][i][si] = nb[i]
                    cur = self.block_number
                    s24v = sum(nb[8:])
                    hi_zero = int(s24v == 0)
                    gx_cols[0][si] = hi_zero
                    gx_cols[1][si] = pow(s24v, -1, R) if s24v else 0
                    gx_cols[12][si] = cur
                    lo = numv & ((1 << 64) - 1)
                    valid = hi_zero and 0 <= cur - 1 - lo <= 255
                    ez_col[si] = int(valid)
                    if valid:
                        gx_cols[2][si] = cur - 1 - lo
                    elif hi_zero:
                        if lo >= cur:
                            gx_cols[3][si] = 1
                            ev_ = lo - cur
                        else:
                            ev_ = cur - 257 - lo
                            assert ev_ >= 0, "window gap is unreachable"
                        for i in range(8):
                            gx_cols[4 + i][si] = (ev_ >> (8 * i)) & 0xFF
                elif kind in ("MSIZE", "CODESIZE"):
                    v4 = ops[0].value
                    for i in range(4):
                        byts["a"][i][si] = (v4 >> (8 * i)) & 0xFF
                elif kind == "NOT":
                    set_word("a", si, ops[0].value)
                    set_word("c", si, ops[1].value)
                elif kind in ("AND", "OR", "XOR"):
                    x, y, w = (o.value for o in ops[:3])
                    set_word("a", si, x)
                    set_word("b", si, y)
                    set_word("c", si, w)
                    xb = x.to_bytes(32, "little")
                    yb = y.to_bytes(32, "little")
                    wb = w.to_bytes(32, "little")
                    for i in range(32):
                        carries[i][si] = xb[i] & 15
                        membytes[i][si] = yb[i] & 15
                        byts["d"][i][si] = wb[i] & 15
                elif kind == "BYTE":
                    iw, xw, res = (o.value for o in ops[:3])
                    set_word("a", si, iw)
                    set_word("b", si, xw)
                    set_word("c", si, res)
                    if iw < 32:
                        carries[iw][si] = 1  # one-hot selector
                    else:
                        ez_col[si] = int((iw & 0xFF) >= 32)
                elif kind == "SHL":
                    s_, v_, res = (o.value for o in ops[:3])
                    set_word("a", si, s_)
                    set_word("b", si, v_)
                    set_word("c", si, res)
                    if s_ < 256:
                        p2 = 1 << s_
                        set_word("d", si, p2)
                        set_carry_bytes(si, *mul_carries(v_, p2, 0, res))
                elif kind == "EXP":
                    assert self.exp_table is not None or ops[1].value < 2, (
                        "EXP step needs the Exp circuit's table (composed mode)"
                    )
                    set_word("a", si, ops[0].value)
                    set_word("b", si, ops[1].value)
                    set_word("c", si, ops[2].value)
                    ez_col[si] = int(ops[1].value == 0)
                    eo_col[si] = int(ops[1].value == 1)
                elif kind == "CALLDATACOPY":
                    assert self.copy_table is not None or ops[2].value == 0, (
                        "CALLDATACOPY needs the Copy circuit's table"
                    )
                    dst, src, ln = (o.value for o in ops[:3])
                    assert max(dst, src, ln) < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (dst >> (8 * i)) & 0xFF
                        byts["a"][i][si] = (src >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (ln >> (8 * i)) & 0xFF
                    ez_col[si] = int(ln == 0)
                    irf = ops[3].value  # IsRoot ctx read
                    carries[24][si] = irf
                    cdlen_c = ops[4].value  # CallDataLength ctx read
                    for i in range(4):
                        byts["d"][i][si] = (cdlen_c >> (8 * i)) & 0xFF
                    if ln:
                        fov_v = int(src >= cdlen_c)
                        fpart_v = int(not fov_v and src + ln > cdlen_c)
                        carries[26][si] = fov_v
                        carries[27][si] = fpart_v
                        if fov_v:
                            slack_a, slack_b = src - cdlen_c, 0
                        elif fpart_v:
                            slack_a = cdlen_c - src - 1
                            slack_b = src + ln - cdlen_c - 1
                        else:
                            slack_a, slack_b = cdlen_c - src - ln, 0
                        for i in range(4):
                            byts["d"][12 + i][si] = (slack_a >> (8 * i)) & 0xFF
                            byts["d"][16 + i][si] = (slack_b >> (8 * i)) & 0xFF
                    if not irf:
                        cdoff_c = ops[5].value
                        caller_c = ops[6].value
                        for i in range(4):
                            byts["d"][4 + i][si] = (cdoff_c >> (8 * i)) & 0xFF
                            byts["d"][8 + i][si] = \
                                (caller_c >> (8 * i)) & 0xFF
                elif kind in ("MULMOD", "ADDMOD"):
                    assert self.mulmod_table is not None, (
                        f"{kind} step needs the MulMod circuit's table"
                    )
                    set_word("a", si, ops[0].value)
                    set_word("b", si, ops[1].value)
                    set_word("c", si, ops[2].value)
                    set_word("d", si, ops[3].value)
                elif kind == "MSTORE8":
                    addr, val = ops[0].value, ops[1].value
                    for i in range(4):
                        addrbytes[i][si] = (addr >> (8 * i)) & 0xFF
                    set_word("a", si, val)
                elif kind == "CALLDATALOAD":
                    off = ops[0].value
                    irf = ops[1].value  # IsRoot ctx read
                    cdlen = ops[2].value
                    word = ops[-1].value
                    ez_col[si] = irf
                    if not irf:
                        cdoff_c = ops[3].value
                        caller_c = ops[4].value
                        for i in range(4):
                            byts["d"][4 + i][si] = (cdoff_c >> (8 * i)) & 0xFF
                            byts["d"][8 + i][si] = \
                                (caller_c >> (8 * i)) & 0xFF
                    set_word("a", si, off)
                    wb_ = word.to_bytes(32, "big")
                    for j in range(32):
                        byts["b"][j][si] = wb_[j]
                    for i in range(4):
                        byts["d"][i][si] = (cdlen >> (8 * i)) & 0xFF
                    if off < (1 << 32):
                        m = min(32, max(0, cdlen - off))
                        for j in range(m):
                            carries[j][si] = 1
                        if m > 0:
                            dA = cdlen - off - m
                            for i in range(4):
                                byts["e"][i][si] = (dA >> (8 * i)) & 0xFF
                        if m < 32:
                            dB = off + m - cdlen
                            for i in range(4):
                                byts["e"][8 + i][si] = (dB >> (8 * i)) & 0xFF
                elif kind in ("CALLER", "ADDRESS"):
                    addr = ops[0].value  # raw 160-bit address
                    le = addr.to_bytes(20, "little")
                    for i in range(20):
                        byts["a"][i][si] = le[i]
                elif kind in ("CALLDATASIZE", "RETURNDATASIZE"):
                    ln = ops[0].value
                    assert ln < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (ln >> (8 * i)) & 0xFF
                elif kind == "SHA256":
                    hv = int(s.op == OpcodeId.CALL)
                    npp_ = 6 + hv
                    flag_idx = {
                        OpcodeId.CALL: 20, OpcodeId.DELEGATECALL: 22,
                        OpcodeId.STATICCALL: 23,
                    }[s.op]
                    carries[flag_idx][si] = 1
                    aoff = ops[npp_ - 4].value
                    alen = ops[npp_ - 3].value
                    roff = ops[npp_ - 2].value
                    for i in range(4):
                        addrbytes[i][si] = (aoff >> (8 * i)) & 0xFF
                        membytes[i][si] = (alen >> (8 * i)) & 0xFF
                        membytes[4 + i][si] = (roff >> (8 * i)) & 0xFF
                    # pad length incl. 0x80 and the 8-byte bit length
                    pl = (-alen) % 64
                    pl = pl if pl >= 9 else pl + 64
                    plens[si] = pl
                    q64v = (alen + pl) // 64
                    assert (alen + pl) % 64 == 0
                    for i in range(4):
                        membytes[8 + i][si] = (q64v >> (8 * i)) & 0xFF
                    bits = (8 * alen).to_bytes(8, "big")
                    for i in range(8):
                        byts["b"][i][si] = bits[i]
                    digest = [
                        o.value for o in ops[npp_ + alen : npp_ + alen + 32]
                    ]
                    for i in range(32):
                        byts["a"][i][si] = digest[i]
                    ez_col[si] = int(alen == 0)
                elif kind == "MODEXP":
                    hv = int(s.op == OpcodeId.CALL)
                    npp_ = 6 + hv
                    flag_idx = {
                        OpcodeId.CALL: 20, OpcodeId.DELEGATECALL: 22,
                        OpcodeId.STATICCALL: 23,
                    }[s.op]
                    carries[flag_idx][si] = 1
                    aoff = ops[npp_ - 4].value
                    roff = ops[npp_ - 2].value
                    for i in range(4):
                        addrbytes[i][si] = (aoff >> (8 * i)) & 0xFF
                        membytes[4 + i][si] = (roff >> (8 * i)) & 0xFF
                    alen_v = ops[npp_ - 3].value
                    ins = bytes(ops[npp_ + i].value for i in range(alen_v))
                    outs = [o.value for o in ops[npp_ + alen_v : -4]]
                    bl_v = int.from_bytes(ins[0:32], "big")
                    el_v = int.from_bytes(ins[32:64], "big")
                    ml_v = int.from_bytes(ins[64:96], "big")
                    # right-aligned operand values; leading-zero masks in
                    # banks d/f/g (zB/zE/zM)
                    off_ = 96
                    for bank, zbank, ln in (("a", "d", bl_v),
                                            ("b", "f", el_v),
                                            ("c", "g", ml_v)):
                        vb_ = int.from_bytes(ins[off_ : off_ + ln], "big") \
                            .to_bytes(32, "big")
                        off_ += ln
                        for i in range(32):
                            byts[bank][i][si] = vb_[i]
                            if i < 32 - ln:
                                byts[zbank][i][si] = 1
                    for i, o_v in enumerate(outs):
                        byts["e"][i + 32 - ml_v][si] = o_v
                elif kind in ("ECRECOVER", "ECADD", "ECMUL", "IDENTITY"):
                    hv = int(s.op == OpcodeId.CALL)
                    npp_ = 6 + hv
                    flag_idx = {
                        OpcodeId.CALL: 20, OpcodeId.DELEGATECALL: 22,
                        OpcodeId.STATICCALL: 23,
                    }[s.op]
                    carries[flag_idx][si] = 1
                    aoff = ops[npp_ - 4].value
                    alen = ops[npp_ - 3].value
                    roff = ops[npp_ - 2].value
                    rlen = ops[npp_ - 1].value
                    for i in range(4):
                        addrbytes[i][si] = (aoff >> (8 * i)) & 0xFF
                        membytes[4 + i][si] = (roff >> (8 * i)) & 0xFF
                    if kind == "IDENTITY":
                        la_v = min(alen, rlen)
                        for i in range(4):
                            membytes[i][si] = (alen >> (8 * i)) & 0xFF
                            membytes[8 + i][si] = (rlen >> (8 * i)) & 0xFF
                            byts["d"][i][si] = (la_v >> (8 * i)) & 0xFF
                        carries[24][si] = int(alen < rlen)
                        dv = rlen - alen if alen < rlen else alen - rlen
                        for i in range(4):
                            byts["g"][i][si] = (dv >> (8 * i)) & 0xFF
                        ez_col[si] = int(la_v == 0)
                    else:
                        in_len = {"ECRECOVER": 128, "ECADD": 128,
                                  "ECMUL": 96}[kind]
                        ins = [ops[npp_ + i].value for i in range(in_len)]
                        outs = [
                            o.value for o in ops[npp_ + in_len : -4]
                        ]
                        if kind == "ECRECOVER":
                            for i in range(32):
                                byts["a"][i][si] = ins[i]
                                byts["b"][i][si] = ins[64 + i]
                                byts["c"][i][si] = ins[96 + i]
                            byts["d"][0][si] = ins[63]
                            for j in range(20):
                                byts["e"][j][si] = outs[12 + j]
                        else:
                            for i in range(32):
                                byts["a"][i][si] = ins[i]
                                byts["b"][i][si] = ins[32 + i]
                                byts["c"][i][si] = ins[64 + i]
                                if kind == "ECADD":
                                    byts["d"][i][si] = ins[96 + i]
                                byts["e"][i][si] = outs[i]
                                byts["f"][i][si] = outs[32 + i]
                elif kind == "CODECOPY":
                    assert self.copy_table is not None or \
                        ops[2].value == 0, (
                            "CODECOPY needs the Copy circuit"
                        )
                    dst, src_, ln = (o.value for o in ops[:3])
                    assert max(dst, src_, ln) < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (dst >> (8 * i)) & 0xFF
                        byts["a"][i][si] = (src_ >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (ln >> (8 * i)) & 0xFF
                    ez_col[si] = int(ln == 0)
                elif kind == "RETURNDATACOPY":
                    assert self.copy_table is not None or \
                        ops[2].value == 0, (
                            "RETURNDATACOPY needs the Copy circuit"
                        )
                    dst, src_, ln = (o.value for o in ops[:3])
                    lcid, rdoff, rdlen = (o.value for o in ops[3:6])
                    assert max(dst, src_, ln, rdoff, rdlen) < (1 << 32)
                    for i in range(4):
                        addrbytes[i][si] = (dst >> (8 * i)) & 0xFF
                        byts["a"][i][si] = (src_ >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (ln >> (8 * i)) & 0xFF
                        byts["d"][i][si] = (rdoff >> (8 * i)) & 0xFF
                        byts["e"][i][si] = (rdlen >> (8 * i)) & 0xFF
                        byts["f"][i][si] = (
                            (rdlen - src_ - ln) >> (8 * i)
                        ) & 0xFF
                    plens[si] = lcid
                    ez_col[si] = int(ln == 0)
                elif kind in ("TIMESTAMP", "NUMBER", "GASLIMIT", "CHAINID",
                              "BASEFEE", "COINBASE", "ORIGIN"):
                    if kind not in ("ORIGIN",):
                        assert self.block_table is not None, (
                            f"{kind} needs the Block circuit's table"
                        )
                    v = ops[0].value
                    nb = 20 if kind in ("COINBASE", "ORIGIN") else 8
                    assert v < (1 << (8 * nb))
                    le = v.to_bytes(nb, "little")
                    for i in range(nb):
                        byts["a"][i][si] = le[i]
                elif kind in ("DIFFICULTY", "GASPRICE"):
                    if kind == "DIFFICULTY":
                        assert self.block_table is not None, (
                            "DIFFICULTY needs the Block circuit's table"
                        )
                elif kind == "LOG":
                    ntop = s.op - 0xA0
                    carries[24 + ntop][si] = 1
                    carries[29][si] = int(s.persistent)
                    off_v = ops[0].value
                    size_v = ops[1].value
                    assert max(off_v, size_v) < (1 << 32)
                    assert (self.copy_table is not None or size_v == 0
                            or not s.persistent), (
                        "LOG with size > 0 needs the Copy circuit's table"
                    )
                    for i in range(4):
                        addrbytes[i][si] = (off_v >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (size_v >> (8 * i)) & 0xFF
                    cle = s.callee.to_bytes(20, "little")
                    for i in range(20):
                        byts["a"][i][si] = cle[i]
                    ez_col[si] = int(size_v == 0)
                elif kind == "CALL":
                    op_ = s.op
                    hv = int(op_ in (OpcodeId.CALL, OpcodeId.CALLCODE))
                    npp_ = 6 + hv
                    flag_idx = {
                        OpcodeId.CALL: 20, OpcodeId.CALLCODE: 21,
                        OpcodeId.DELEGATECALL: 22, OpcodeId.STATICCALL: 23,
                    }[op_]
                    carries[flag_idx][si] = 1
                    set_word("a", si, ops[1].value)  # `to` stack word
                    tail = [ops[npp_ - 4 + j].value for j in range(4)]
                    for i in range(4):
                        addrbytes[i][si] = (tail[0] >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (tail[1] >> (8 * i)) & 0xFF
                        byts["d"][i][si] = (tail[2] >> (8 * i)) & 0xFF
                        byts["e"][i][si] = (tail[3] >> (8 * i)) & 0xFF
                    if len(ops) < npp_ + 17:
                        # no-descend (codeless: CodeHash read after the
                        # warm write) vs abort (depth/balance)
                        from ..witness.rw import (
                            AccountField as _AFw, RwTag as _RTw,
                        )

                        nd_like = (
                            ops[npp_ + 1].tag == _RTw.Account
                            and ops[npp_ + 1].field_tag == _AFw.CodeHash
                        )
                        carries[25 if nd_like else 26][si] = 1
                    else:
                        caller_v = ops[npp_ + 9].value  # CallerAddress
                        cle = caller_v.to_bytes(20, "little")
                        for i in range(20):
                            membytes[i][si] = cle[i]
                        ez_col[si] = ops[npp_ + 14].value  # IsStatic
                elif kind == "CREATE":
                    from ..crypto.keccak import keccak256 as _kec
                    from ..types import rlp as _rlp

                    is2 = int(s.op == OpcodeId.CREATE2)
                    carries[20][si] = is2
                    npe_ = 3 + is2
                    cle = s.callee.to_bytes(20, "little")
                    for i in range(20):
                        membytes[i][si] = cle[i]
                    nonce_v = ops[npe_].value - 1  # bump write = nonce+1
                    # nonce cells are variant-independent (the bump
                    # access claims the nonce+1 for CREATE2 too).  nl=0: single byte in bytes_f[0]; else the
                    # o_{nl} one-hot (mem bank 20..27) + big-endian
                    # bytes in bytes_f[1..nl] (canonical RLP)
                    nl_ = (0 if nonce_v <= 0x7F
                           else (nonce_v.bit_length() + 7) // 8)
                    if nl_ == 0:
                        byts["f"][0][si] = nonce_v
                        carries[21][si] = int(nonce_v == 0)
                        ez_col[si] = (
                            pow(nonce_v, -1, R) if nonce_v else 0
                        )
                    else:
                        membytes[19 + nl_][si] = 1
                        for i2, byte2 in enumerate(
                                nonce_v.to_bytes(nl_, "big")):
                            byts["f"][1 + i2][si] = byte2
                        # nz/fz/inverse take the satisfying (1, 0, 1)
                        # assignment (nonce != 0 in this branch)
                        byts["f"][0][si] = 1
                        carries[21][si] = 0
                        ez_col[si] = 1
                    if is2:
                        salt_le = ops[3].value.to_bytes(32, "little")
                        for i in range(32):
                            byts["d"][i][si] = salt_le[i]
                        ihb = ops[npe_ + 5 + 13].value.to_bytes(32, "big")
                        for i in range(32):
                            byts["e"][i][si] = ihb[i]
                        preimage = (b"\xff" + s.callee.to_bytes(20, "big")
                                    + ops[3].value.to_bytes(32, "big") + ihb)
                        plens[si] = 51
                    else:
                        preimage = _rlp.encode(
                            [s.callee.to_bytes(20, "big"), nonce_v]
                        )
                        plens[si] = 136 - len(preimage)
                    dgst = _kec(preimage)
                    for i in range(32):
                        byts["c"][i][si] = dgst[i]
                elif kind == "RET":
                    gas_aux[si] = s.rev_count
                    op_ = s.op
                    flag_idx = {
                        OpcodeId.RETURN: 20, OpcodeId.STOP: 21,
                        OpcodeId.REVERT: 22,
                    }[op_]
                    carries[flag_idx][si] = 1
                    if s.is_err_ret:
                        carries[25][si] = 1
                    dep_ = int(s.is_create_ret and op_ == OpcodeId.RETURN)
                    if s.is_create_ret:
                        carries[24][si] = 1
                        cle = s.callee.to_bytes(20, "little")
                        for i in range(20):
                            byts["c"][i][si] = cle[i]
                    has_d = op_ != OpcodeId.STOP
                    npp_ = 2 if has_d else 0
                    off_v = ops[0].value if has_d else 0
                    len_v = ops[1].value if has_d else 0
                    nrw = len(ops) - s.rev_count  # reversion rows trail
                    # tail: 8 ctx reads (incl. IsCreate) + 3 bookkeeping
                    # writes + success push (+ the code-deposit write on
                    # create RETURNs)
                    base = nrw - 12 - dep_
                    retoff_v = ops[base + 5].value
                    retlen_v = ops[base + 6].value
                    la_v = min(len_v, retlen_v)
                    assert (nrw - npp_ - 12 - dep_) == 2 * la_v
                    if has_d:
                        carries[23][si] = int(len_v < retlen_v)
                        diff_v = (retlen_v - len_v if len_v < retlen_v
                                  else len_v - retlen_v)
                    else:
                        diff_v = 0
                    for i in range(4):
                        addrbytes[i][si] = (off_v >> (8 * i)) & 0xFF
                        byts["b"][i][si] = (len_v >> (8 * i)) & 0xFF
                        byts["a"][i][si] = (retoff_v >> (8 * i)) & 0xFF
                        byts["e"][i][si] = (retlen_v >> (8 * i)) & 0xFF
                        byts["d"][i][si] = (la_v >> (8 * i)) & 0xFF
                        membytes[i][si] = (diff_v >> (8 * i)) & 0xFF
                    ez_col[si] = int(la_v == 0)
                elif kind == "SHA3":
                    assert self.keccak_table is not None, (
                        "SHA3 needs the Keccak circuit's table (composed)"
                    )
                    off, size = ops[0].value, ops[1].value
                    assert self.copy_table is not None or size == 0, (
                        "SHA3 with size > 0 needs the Copy circuit's table"
                    )
                    assert max(off, size) < (1 << 32)
                    digest = ops[2 + size].value  # stack write (big-endian)
                    for i in range(4):
                        addrbytes[i][si] = (off >> (8 * i)) & 0xFF
                        byts["a"][i][si] = (size >> (8 * i)) & 0xFF
                    pl = 136 - (size % 136)
                    plens[si] = pl
                    q136v = (size + pl) // 136
                    for i in range(4):
                        byts["b"][i][si] = (q136v >> (8 * i)) & 0xFF
                    db = digest.to_bytes(32, "big")  # digest output order
                    for i in range(32):
                        byts["c"][i][si] = db[i]
                    ez_col[si] = int(size == 0)
            cols[self.c_push_len] = mont(plens)
            cols[self.c_gas_aux] = mont(gas_aux)
            for ci2, colvals in enumerate(gx_cols):
                cols[self.c_gx[ci2]] = mont(colvals)
            for key, colset in (
                ("a", self.c_bytes_a), ("b", self.c_bytes_b),
                ("c", self.c_bytes_c), ("d", self.c_bytes_d),
                ("e", self.c_bytes_e), ("f", self.c_bytes_f),
                ("g", self.c_bytes_g),
            ):
                for i, ci in enumerate(colset):
                    cols[ci] = mont(byts[key][i])
            for i, ci in enumerate(self.c_carry):
                cols[ci] = mont(carries[i])
            for i, ci in enumerate(self.c_mem):
                cols[ci] = mont(membytes[i])
            for i, ci in enumerate(self.c_addr):
                cols[ci] = mont(addrbytes[i])
            cols[self.c_ez] = mont(ez_col)
            cols[self.c_eo] = mont(eo_col)
            if self.standalone:
                # rw table (phase-0 part)
                rws = sorted(
                    self.rw_by_counter.values(), key=lambda r: r.rw_counter
                )
                rws = [
                    r for r in rws
                    if r.tag in (RwTag.Stack, RwTag.Memory, RwTag.Storage,
                                 RwTag.CallContext, RwTag.TxLog,
                                 RwTag.Account, RwTag.TxAccessListAccount,
                                 RwTag.TxAccessListAccountStorage,
                                 RwTag.TxRefund, RwTag.TxReceipt)
                ]
                assert len(rws) <= self._rw_target(n), (
                    f"rw table overflow: {len(rws)} rows > rw_target "
                    f"{self._rw_target(n)} — raise EvmParams.rw_target"
                )
                cols[self.t_rwc] = mont([r.rw_counter for r in rws])
                cols[self.t_is_write] = mont([int(r.is_write) for r in rws])
                cols[self.t_tag] = mont([int(r.tag) for r in rws])
                cols[self.t_id] = mont([r.id for r in rws])
                cols[self.t_addr] = mont([r.address for r in rws])
                cols[self.t_field] = mont([int(r.field_tag) for r in rws])
                self._rw_rows = rws
            return cols
        # phase 1: word RLCs
        r_chal = challenges[self.r_word.index]
        r_int = F.to_int(F.from_mont(r_chal))
        va, vb, vc, invs, inv2s = [], [], [], [], []
        accms, rpls, prls = [], [], []
        M128_, M256 = (1 << 128) - 1, 1 << 256
        binary = ("ADD", "SUB", "MUL", "DIV", "MOD", "SDIV", "SMOD",
                  "SIGNEXTEND", "SAR", "LT", "GT", "SLT", "SGT", "EQ",
                  "EXP", "CALLDATACOPY", "AND", "OR", "XOR", "BYTE", "SHL",
                  "SHR")
        for s in steps:
            ops = [self.rw_by_counter[i] for i in s.rw_indices]
            kind = self._classify(s)
            def rlc(rw):
                return word_rlc(rw.value, r_int)
            inv_of = 0
            inv2_of = 0
            inv_direct = None  # raw override of the c_inv cell
            inv2_direct = None  # raw override of the c_inv2 cell
            acc_m = rpl_v = prl_v = 0
            if kind == "SHA256":
                hv = int(s.op == OpcodeId.CALL)
                npp_ = 6 + hv
                va.append(rlc(ops[0]))
                vb.append(0)
                vc.append(rlc(ops[2]) if hv else 0)
                alen = ops[npp_ - 3].value
                inv_of = alen % R
                for i in range(alen):
                    acc_m = (acc_m * r_int + ops[npp_ + i].value) % R
                for o in ops[npp_ + alen : npp_ + alen + 32]:
                    rpl_v = (rpl_v * r_int + o.value) % R
                pl = (-alen) % 64
                pl = pl if pl >= 9 else pl + 64
                prl_v = pow(r_int, pl - 1, R)
            elif kind in ("ECRECOVER", "ECADD", "ECMUL", "IDENTITY",
                          "MODEXP"):
                hv = int(s.op == OpcodeId.CALL)
                npp_ = 6 + hv
                va.append(rlc(ops[0]))
                vb.append(0)
                vc.append(rlc(ops[2]) if hv else 0)
                if kind == "IDENTITY":
                    alen = ops[npp_ - 3].value
                    rlen = ops[npp_ - 1].value
                    inv_of = min(alen, rlen) % R
                elif kind == "MODEXP":
                    alen_v = ops[npp_ - 3].value
                    ins_v = [ops[npp_ + i].value for i in range(alen_v)]
                    for b_v in ins_v:
                        acc_m = (acc_m * r_int + b_v) % R
                    outs_v = [o.value for o in ops[npp_ + alen_v : -4]]
                    rpl0 = 0
                    for o_v in outs_v:
                        rpl0 = (rpl0 * r_int + o_v) % R
                    bl_v = int.from_bytes(bytes(ins_v[0:32]), "big")
                    el_v = int.from_bytes(bytes(ins_v[32:64]), "big")
                    ml_v = int.from_bytes(bytes(ins_v[64:96]), "big")
                    # out acc cell is rpl in the skeleton convention;
                    # the r^BL/r^EL/r^ML power cells ride prl/inv/inv2
                    # ... but prl carries r^BL here, so p_out_acc uses
                    # rpl as usual
                    rpl_v = rpl0
                    prl_v = pow(r_int, bl_v, R)
                    inv_direct = pow(r_int, el_v, R)
                    inv2_direct = pow(r_int, ml_v, R)
                else:
                    in_len = {"ECRECOVER": 128, "ECADD": 128,
                              "ECMUL": 96}[kind]
                    for i in range(in_len):
                        acc_m = (acc_m * r_int + ops[npp_ + i].value) % R
                    for o in ops[npp_ + in_len : -4]:
                        rpl_v = (rpl_v * r_int + o.value) % R
            elif kind == "LOG":
                ntop = s.op - 0xA0
                va.append(rlc(ops[0]))
                vb.append(rlc(ops[1]))
                topics = [rlc(ops[2 + j]) for j in range(ntop)] + [0] * 4
                vc.append(topics[0])
                acc_m, rpl_v, prl_v = topics[1], topics[2], topics[3]
                inv_of = ops[1].value % R
            elif kind == "CREATE":
                is2 = int(s.op == OpcodeId.CREATE2)
                npe_ = 3 + is2
                va.append(rlc(ops[0]))          # value word
                vb.append(rlc(ops[1]))          # offset word
                vc.append(rlc(ops[2]))          # size word
                nonce_v1 = ops[npe_].value - 1
                nl1 = (0 if nonce_v1 <= 0x7F
                       else (nonce_v1.bit_length() + 7) // 8)
                pl_ = 51 if is2 else 113 - nl1
                rpl_v = pow(r_int, pl_, R)
                prl_v = (pow(r_int, pl_ - 1, R) + 128) % R
                acc_m = rlc(ops[npe_ + 2])      # creator post-endowment
                inv_direct = rlc(ops[npe_ + 3])  # created account balance
            elif kind == "CALL":
                hv = int(s.op in (OpcodeId.CALL, OpcodeId.CALLCODE))
                npp_ = 6 + hv
                va.append(rlc(ops[0]))          # gas word
                vb.append(rlc(ops[1]))          # to word
                vc.append(rlc(ops[2]) if hv else 0)
                if s.op == OpcodeId.DELEGATECALL \
                        and len(ops) >= npp_ + 17:
                    acc_m = word_rlc(ops[npp_ + 10].value, r_int)  # Value
                if len(ops) < npp_ + 17:  # no-descend / abort
                    from ..witness.rw import (
                        AccountField as _AFw, RwTag as _RTw,
                    )

                    nd_like = (
                        ops[npp_ + 1].tag == _RTw.Account
                        and ops[npp_ + 1].field_tag == _AFw.CodeHash
                    )
                    if s.op in (OpcodeId.CALL, OpcodeId.CALLCODE):
                        if nd_like:
                            acc_m = rlc(ops[npp_ + 2])  # caller bal new
                            rpl_v = rlc(ops[npp_ + 3])  # credit bal new
                        else:
                            acc_m = rlc(ops[npp_ + 1])  # caller balance
            elif kind == "RET":
                has_d = s.op != OpcodeId.STOP
                va.append(rlc(ops[0]) if has_d else 0)
                vb.append(rlc(ops[1]) if has_d else 0)
                vc.append(0)
                dep_ = int(s.is_create_ret and s.op == OpcodeId.RETURN)
                nrw_ = len(ops) - s.rev_count  # reversion rows trail
                # tail: 8 ctx reads (incl. IsCreate) + 3 bookkeeping
                # writes + success push (+ code deposit) — RetLength is
                # the 6th-from-last ctx read
                la_v = min(ops[1].value, ops[nrw_ - 6 - dep_].value) \
                    if has_d else 0
                inv_of = la_v % R
                if dep_:
                    # deposited code hash, account-row encoding (BE byte
                    # i folds with r^i)
                    hb_ = ops[nrw_ - 1].value.to_bytes(32, "big")
                    for byte_ in reversed(hb_):
                        acc_m = (acc_m * r_int + byte_) % R
            elif kind in ("RETURN", "REVERT"):
                va.append(rlc(ops[0]))
                vb.append(rlc(ops[1]))
                vc.append(0)
            elif kind == "SHA3":
                size = ops[1].value
                va.append(rlc(ops[0]))
                vb.append(rlc(ops[1]))
                vc.append(rlc(ops[2 + size]))
                inv_of = size % R
                pl = 136 - (size % 136)
                for j in range(size):
                    acc_m = (acc_m * r_int + ops[2 + j].value) % R
                rpl_v = pow(r_int, pl, R)
                prl_v = (pow(r_int, pl - 1, R) + 128) % R
            elif kind in ("PUSH", "POP", "PC"):
                va.append(rlc(ops[0])); vb.append(0); vc.append(0)
            elif kind == "MLOAD":
                # va = addr, vb = loaded word (the final stack write)
                va.append(rlc(ops[0])); vb.append(rlc(ops[33])); vc.append(0)
            elif kind == "MSTORE":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
            elif kind in binary:
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(rlc(ops[2]))
                if kind in ("DIV", "MOD"):
                    inv_of = vb[-1]
                elif kind in ("SDIV", "SMOD"):
                    M255 = 1 << 255
                    b_v = ops[1].value
                    abs_b = (M256 - b_v) % M256 if b_v >= M255 else b_v
                    inv_of = ((abs_b & M128_) + (abs_b >> 128)) % R
                    a_ = ops[0].value
                    abs_a = (M256 - a_) % M256 if a_ >= M255 else a_
                    val = (abs_a // abs_b if kind == "SDIV"
                           else abs_a % abs_b) if abs_b else 0
                    inv2_of = ((val & M128_) + (val >> 128)) % R
                elif kind == "SIGNEXTEND":
                    inv_of = sum(
                        ops[0].value.to_bytes(32, "little")[1:]
                    ) % R
                elif kind == "SAR":
                    sbytes = ops[0].value.to_bytes(32, "little")
                    inv_of = sum(sbytes[1:]) % R
                    inv2_of = sum(sbytes) % R
                elif kind == "EQ":
                    inv_of = (va[-1] - vb[-1]) % R
                elif kind == "EXP":
                    inv2_of = vb[-1] * (vb[-1] - 1) % R
                elif kind == "CALLDATACOPY":
                    inv2_of = vc[-1]
                elif kind in ("BYTE", "SHL", "SHR"):
                    # inverse of the index/shift word's high-byte sum
                    inv_of = sum(
                        ops[0].value.to_bytes(32, "little")[1:]
                    ) % R
            elif kind in ("ISZERO", "NOT"):
                va.append(rlc(ops[0])); vb.append(0); vc.append(rlc(ops[1]))
                if kind == "ISZERO":
                    inv_of = va[-1]
            elif kind == "MSTORE8":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
            elif kind == "CALLDATALOAD":
                va.append(rlc(ops[0])); vb.append(rlc(ops[-1])); vc.append(0)
                inv_of = sum(ops[0].value.to_bytes(32, "little")[4:]) % R
            elif kind == "JUMP":
                va.append(rlc(ops[0])); vb.append(0); vc.append(0)
            elif kind == "JUMPI":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
                inv2_of = vb[-1]
            elif kind == "BEGIN_TX":
                # builder order: TxId, Callee, Caller, Value, IsRoot,
                # CDLen, AL caller, AL callee, nonce, fee, caller-value,
                # callee-value, code-hash read
                va.append(ops[2].value % R)       # raw caller address
                vb.append(rlc(ops[3]))            # value word RLC
                vc.append(ops[5].value % R)       # raw calldata length
                acc_m = rlc(ops[9])               # caller balance post-fee
                rpl_v = rlc(ops[10])              # caller balance post-value
                prl_v = rlc(ops[11])              # callee balance post-value
            elif kind == "END_TX":
                # IsSuccess, TxRefund, caller refund, coinbase reward
                va.append(ops[2].address % R)     # raw caller address
                vb.append(0)
                vc.append(ops[3].address % R)     # raw coinbase address
                acc_m = rlc(ops[2])               # caller balance
                rpl_v = rlc(ops[3])               # coinbase balance
                prl_v = ops[0].value % R          # IsSuccess flag
            elif kind in ("CALLER", "ADDRESS", "CALLVALUE", "CALLDATASIZE",
                          "RETURNDATASIZE"):
                va.append(rlc(ops[1])); vb.append(0); vc.append(0)
            elif kind in ("RETURNDATACOPY", "CODECOPY"):
                va.append(rlc(ops[0])); vb.append(rlc(ops[1]))
                vc.append(rlc(ops[2]))
                inv_of = ops[2].value % R
            elif kind in ("TIMESTAMP", "NUMBER", "COINBASE", "GASLIMIT",
                          "CHAINID", "BASEFEE", "DIFFICULTY", "GASPRICE",
                          "ORIGIN", "GAS", "MSIZE", "CODESIZE"):
                va.append(rlc(ops[0])); vb.append(0); vc.append(0)
            elif kind == "BLOCKHASH":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
            elif kind == "SLOAD":
                va.append(rlc(ops[0])); vb.append(rlc(ops[2])); vc.append(0)
            elif kind == "SSTORE":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
            elif kind == "SELFBALANCE":
                va.append(0); vb.append(rlc(ops[1])); vc.append(0)
            elif kind in ("BALANCE", "EXTCODESIZE", "EXTCODEHASH"):
                va.append(rlc(ops[0])); vb.append(rlc(ops[3])); vc.append(0)
            elif kind == "EXTCODECOPY":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1]))
                vc.append(rlc(ops[2]))
                # ext code hash, account-row/bytecode-table BE encoding
                hb_ = ops[5].value.to_bytes(32, "big")
                for byte_ in reversed(hb_):
                    acc_m = (acc_m * r_int + byte_) % R
            elif kind == "DUP":
                va.append(rlc(ops[0])); vb.append(0); vc.append(0)
            elif kind == "SWAP":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1])); vc.append(0)
            elif kind == "ERR_JUMP":
                va.append(rlc(ops[0]))
                if s.op == OpcodeId.JUMPI:
                    vb.append(rlc(ops[1]))
                    inv2_of = vb[-1]
                else:
                    vb.append(0)
                vc.append(0)
            elif kind == "ERR_RDOOB":
                va.append(rlc(ops[0])); vb.append(rlc(ops[1]))
                vc.append(rlc(ops[2]))
            elif kind == "ERR_OOG_DYN":
                fam = s.err_aux[0]
                va.append(rlc(ops[0]))
                if fam in ("mem32", "mem1"):
                    vb.append(0); vc.append(0)
                elif fam == "copy":
                    vc.append(rlc(ops[1])); vb.append(rlc(ops[2]))
                else:  # sha / log / span
                    vb.append(rlc(ops[1])); vc.append(0)
            elif kind == "ERR_WRITE_PROT":
                # ops[0] = IsStatic read; CALL family adds the value
                # stack read whose RLC must be proven nonzero (inverse
                # witness in c_acc_m)
                if len(ops) > 1:
                    va.append(rlc(ops[1]))
                    # clamped, not asserted (corruption tests must fail
                    # at the gate, not in witness generation)
                    acc_m = pow(va[-1], -1, R) if va[-1] else 0
                else:
                    va.append(0)
                vb.append(0); vc.append(0)
            else:
                va.append(0); vb.append(0); vc.append(0)
            if inv_direct is not None:
                invs.append(inv_direct)
            else:
                invs.append(pow(inv_of, -1, R) if inv_of else 0)
            if inv2_direct is not None:
                inv2s.append(inv2_direct)
            else:
                inv2s.append(pow(inv2_of, -1, R) if inv2_of else 0)
            accms.append(acc_m)
            rpls.append(rpl_v)
            prls.append(prl_v)
        # code-hash RLC: fold of the keccak DIGEST bytes under r with
        # digest[0] (most-significant) taking r^0 — the BytecodeCircuit's
        # c_hash encoding (circuits/bytecode.py synthesize).  Padding STOP
        # rows inherit the last step's hash (continuity gate).
        rpows = [1] * 32
        for i in range(1, 32):
            rpows[i] = rpows[i - 1] * r_int % R
        def hash_rlc(h: int) -> int:
            if not h:
                return 0
            return sum(
                b * rpows[i] for i, b in enumerate(h.to_bytes(32, "big"))
            ) % R
        chash_vals = [hash_rlc(s.code_hash) for s in steps]
        chash_pad = [chash_vals[-1] if chash_vals else 0] * (t - len(steps))
        # pad-power table rows: row p-1 carries (r^p, r^(p-1) + 128)
        rp_vals = [pow(r_int, p, R) for p in range(1, 137)]
        prlc_vals = [(pow(r_int, p - 1, R) + 128) % R for p in range(1, 137)]
        out = {
            self.c_val_a: mont(va),
            self.c_val_b: mont(vb),
            self.c_val_c: mont(vc),
            self.c_inv: mont(invs),
            self.c_inv2: mont(inv2s),
            self.c_code_hash: mont(chash_vals + chash_pad),
            self.c_acc_m: mont(accms),
            self.c_rpl: mont(rpls),
            self.c_prl: mont(prls),
            self.c_rp: mont(rp_vals),
            self.c_prlc: mont(prlc_vals),
        }
        if self.standalone:
            out[self.t_val] = mont(
                [rw_value_encoding(r, r_int) for r in self._rw_rows]
            )
            out[self.t_key] = mont(
                [word_rlc(r.storage_key, r_int) for r in self._rw_rows]
            )
        return out
