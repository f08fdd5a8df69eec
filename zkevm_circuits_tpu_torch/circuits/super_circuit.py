"""SuperCircuit (port of zkevm_circuits_tpu/circuits/super_circuit.py):
every sub-circuit composed over shared tables.

Equivalent of the reference's `zkevm-circuits/src/super_circuit.rs`
(SURVEY.md §2.2 "SuperCircuit"): one constraint system containing every
sub-circuit, communicating through shared lookup tables instead of
duplicated witness.

Composition mechanics:
  * Every sub-circuit allocates columns from ONE ConstraintSystem, so
    indices are globally disjoint; fixed/advice witness is merged by
    column index (dict-based `fixed_columns`/`synthesize`).  Column
    indices, and so the proof's bytes, follow the configure order below,
    which is the JAX package's.
  * The EVM circuit's bus lookups target the State circuit's RW table via
    recomposition EXPRESSIONS over the State limb columns — no duplicated
    rw columns at all (the reference shares the RwTable struct,
    zkevm-circuits/src/table.rs:577).
  * One shared phase-0 challenge serves every RLC (the reference splits
    evm_word / keccak_input challenges across phases,
    zkevm-circuits/src/util.rs:93-106).  Every RLC data coefficient is a
    phase-0 column and every phase-1 column is a gate- or
    lookup-determined accumulator (docs/SOUNDNESS_single_challenge.md).

Cross-circuit bindings wired here:
  * EVM bus lookups -> State RW table (shared columns).
  * Bytecode code-hash -> Keccak table (when keccak witness present).
  * PI statement hash -> Keccak table + instance exposure.
  * Copy byte bus -> State RW table + Tx table calldata rows.
  * Exp / Poseidon ride along with shared byte table / own geometry.
"""

from __future__ import annotations

import dataclasses

from ..plonk.circuit import Circuit, ConstraintSystem
from ..types.bytecode import Bytecode
from ..types.transaction import Transaction
from ..witness.builder import CircuitInputBuilder
from .bytecode import BytecodeCircuit, BytecodeParams
from .copy import CopyCircuit, CopyParams
from .evm import EvmCircuit, EvmParams
from .exp import ExpCircuit, ExpParams
from .keccak import KeccakCircuit
from .pi import PiCircuit, PublicData
from .poseidon import PoseidonCircuit, PoseidonEvent
from .rlp import RlpCircuit
from .state import StateCircuit, StateParams
from .tx import TxCircuit, TxParams


@dataclasses.dataclass
class SuperParams:
    state: StateParams = dataclasses.field(
        default_factory=lambda: StateParams(
            limb_bits=4, id_bits=8, addr_bits=160, key_bits=16, rwc_bits=16,
            target_rows=0,  # fill usable rows
        )
    )
    evm: EvmParams = dataclasses.field(
        default_factory=lambda: EvmParams(target_steps=64)
    )
    bytecode: BytecodeParams = dataclasses.field(default_factory=BytecodeParams)
    tx: TxParams = dataclasses.field(default_factory=TxParams)
    copy: CopyParams = dataclasses.field(
        default_factory=lambda: CopyParams(target_rows=0)
    )
    exp: ExpParams = dataclasses.field(
        default_factory=lambda: ExpParams(target_rows=64)
    )


class SuperCircuit(Circuit):
    """Composes every implemented sub-circuit.

    Always-on: State, EVM, Bytecode, Tx.  Witness-gated: Copy and Exp (on
    when the builder produced events), Keccak (on when `with_keccak` or
    `public_data` — enables the bytecode code-hash binding), PI (on when
    `public_data` given; adds the two-element digest instance), Poseidon
    (on when events given).
    """

    def __init__(self, builder: CircuitInputBuilder,
                 bytecodes: list[Bytecode], txs: list[Transaction],
                 params: SuperParams | None = None,
                 public_data: PublicData | None = None,
                 poseidon_events: list[PoseidonEvent] | None = None,
                 with_keccak: bool = False, with_sig: bool = False,
                 block=None, accounts_before: dict | None = None):
        """accounts_before: {addr: AccountFields} pre-state — enables the
        TWO-LEVEL MPT composition (reference super_circuit.rs:310-314):
        per-account storage subtries + the account trie, coupled to the
        State circuit's Storage/Account groups, with the account-trie
        roots copy-bound into the PI circuit's state-root byte folds
        (super_circuit.rs:698-707).  `self.state_roots` then carries the
        (old, new) account-trie roots the PublicData must match."""
        p = params or SuperParams()
        self.params = p
        self.state = StateCircuit(builder.rws, p.state)
        self.evm = EvmCircuit(
            builder.steps, builder.rws.rws, p.evm,
            block_number=(block.number if block is not None else 1),
        )
        self.bytecode = BytecodeCircuit(bytecodes, p.bytecode)
        self.tx = TxCircuit(txs, p.tx)
        self.subs: list[Circuit] = [self.state, self.evm, self.bytecode, self.tx]
        self.rlp = None
        if txs:
            self.rlp = RlpCircuit(txs)
            self.subs.append(self.rlp)

        self.copy = None
        if builder.copy_events:
            tx_rows = [
                (i + 1, j, b)
                for i, tx in enumerate(txs) for j, b in enumerate(tx.data)
            ]
            self.copy = CopyCircuit(builder.copy_events, p.copy, tx_rows=tx_rows)
            self.subs.append(self.copy)
        self.exp = None
        if builder.exp_events:
            self.exp = ExpCircuit(builder.exp_events, p.exp)
            self.subs.append(self.exp)
        # Sig circuit (opt-in for txs: ~258 sig rows + ~5400 MulMod rows
        # per signature, needs K >= 13; auto-on when the block executed
        # ECRECOVER) — verifies signatures in-circuit
        self.sig = None
        sig_mm_events: list = []
        sig_events = list(builder.sig_events)
        if with_sig:
            from ..crypto import secp256k1 as secp
            from .sig import SigEvent

            for tx in txs:
                digest = tx.sign_hash()
                rec = (tx.v - 35 - 2 * tx.chain_id) & 1 if tx.v >= 35 \
                    else tx.v & 1
                pub = secp.recover(digest, tx.r, tx.s, rec)
                sig_events.append(SigEvent(
                    msg_hash=int.from_bytes(digest, "big"),
                    r=tx.r, s=tx.s, pubkey=pub,
                ))
        if sig_events:
            from .sig import SigCircuit

            self.sig = SigCircuit(sig_events)
            self.subs.append(self.sig)
            for ev in sig_events:
                sig_mm_events.extend(ev.mulmod_events())
        self.with_sig_txs = with_sig

        # SHA256 circuit (sha256 precompile inputs)
        self.sha256 = None
        if builder.sha256_inputs:
            from .sha256 import Sha256Circuit

            self.sha256 = Sha256Circuit(builder.sha256_inputs)
            self.subs.append(self.sha256)

        # ECC circuit (EcAdd/EcMul precompile events)
        self.ecc = None
        ecc_mm_events: list = []
        if builder.ecadd_events or builder.ecmul_events:
            from .ecc import EccCircuit

            self.ecc = EccCircuit(
                add_events=builder.ecadd_events,
                mul_events=builder.ecmul_events,
            )
            self.subs.append(self.ecc)
            for ev in builder.ecadd_events + builder.ecmul_events:
                ecc_mm_events.extend(ev.mulmod_events())

        # ModExp circuit (modexp precompile events)
        self.modexp = None
        modexp_mm_events: list = []
        if builder.modexp_events:
            from .modexp import ModExpCircuit

            self.modexp = ModExpCircuit(builder.modexp_events)
            self.subs.append(self.modexp)
            for ev in builder.modexp_events:
                modexp_mm_events.extend(ev.mulmod_events())

        self.mulmod = None
        if (builder.mulmod_events or sig_mm_events or ecc_mm_events
                or modexp_mm_events):
            from .mulmod import MulModCircuit, MulModParams

            evs = (list(builder.mulmod_events) + sig_mm_events
                   + ecc_mm_events + modexp_mm_events)
            self.mulmod = MulModCircuit(
                evs, MulModParams(target_rows=len(evs) + 1)
            )
            self.subs.append(self.mulmod)
        # bytecode-table opcode binding: on when the builder carried real
        # code hashes (dev witnesses leave code_hash = 0, reference-style)
        self.bind_bytecode = bool(builder.steps) and all(
            s.code_hash for s in builder.steps
        )

        self.pd = public_data
        self.keccak = None
        if (with_keccak or public_data is not None or builder.sha3_inputs
                or self.sig is not None):
            messages = [bc.to_bytes() for bc in bytecodes]
            messages += [tx.sign_payload() for tx in txs]
            messages += [tx.rlp_signed() for tx in txs]  # tx-hash preimages
            messages += list(builder.sha3_inputs)
            if self.sig is not None:
                messages += [ev.pubkey_bytes() for ev in self.sig.events]
            if public_data is not None:
                messages.append(public_data.pi_bytes())
                if public_data.block is not None:
                    messages.append(public_data.data_bytes())
            self.keccak = KeccakCircuit(messages)
            self.subs.append(self.keccak)
        self.pi = None
        if public_data is not None:
            self.pi = PiCircuit(public_data)
            self.subs.append(self.pi)
        self.poseidon = None
        if poseidon_events:
            self.poseidon = PoseidonCircuit(poseidon_events)
            self.subs.append(self.poseidon)
        self.block = None
        if block is not None:
            from .block import BlockCircuit

            self.block = BlockCircuit(block)
            self.subs.append(self.block)

        # two-level MPT: storage subtries + account trie
        self.mpt_stor = self.mpt_acct = None
        self.state_roots = None
        self._mpt_groups = None
        if accounts_before is not None:
            from ..witness.mpt import two_level_updates_from_rws
            from .mpt import MptCircuit

            storage, groups, accounts, (atrie, _subtries) = \
                two_level_updates_from_rws(builder.rws.rws, accounts_before)
            self._mpt_groups = groups
            self._mpt_accounts = accounts
            if storage:
                self.mpt_stor = MptCircuit(
                    storage=storage, two_level=True,
                    chain_groups=[g[1] for g in groups],
                )
                self.subs.append(self.mpt_stor)
            self.mpt_acct = MptCircuit(accounts=accounts)
            self.subs.append(self.mpt_acct)
            if accounts:
                first = self.mpt_acct.updates[0]
                last = self.mpt_acct.updates[-1]
                self.state_roots = (first.old_root, last.new_root)

    def configure(self, cs: ConstraintSystem):
        r_word = cs.challenge(phase=0)
        mpt_storage_table = mpt_account_table = None
        if self.mpt_acct is not None:
            if self.mpt_stor is not None:
                self.mpt_stor.configure(cs, challenge=r_word)
                mpt_storage_table = self.mpt_stor.storage_table
            self.mpt_acct.configure(cs, challenge=r_word)
            mpt_account_table = self.mpt_acct.account_table
        self.state.configure(
            cs, challenge=r_word,
            mpt_storage_table=mpt_storage_table,
            mpt_account_table=mpt_account_table,
        )
        rw_table = self.state.rw_table_exprs()
        keccak_table = None
        if self.keccak is not None:
            self.keccak.configure(cs, challenge=r_word)
            keccak_table = self.keccak.keccak_table_exprs()
        self.bytecode.configure(cs, challenge=r_word, keccak_table=keccak_table)
        if self.mulmod is not None:
            self.mulmod.configure(cs)
        sig_table = None
        if self.sig is not None:
            from ..plonk.expression import Fixed as _Fixed

            self.sig.configure(
                cs, mulmod_table=self.mulmod.mulmod_table,
                keccak_table=keccak_table, challenge=r_word,
                byte_table=[_Fixed(self.bytecode.tbl_byte)],
            )
            sig_table = self.sig.sig_table
        rlp_table = data_len_table = sign_hash_table = None
        if self.rlp is not None:
            self.rlp.configure(cs, challenge=r_word, keccak_table=keccak_table)
            rlp_table = self.rlp.rlp_table
            data_len_table = self.rlp.data_len_table
            sign_hash_table = self.rlp.sign_hash_table
        sha256_table = None
        if self.sha256 is not None:
            self.sha256.configure(cs, challenge=r_word)
            sha256_table = self.sha256.sha256_table
        ecc_table = None
        if self.ecc is not None:
            self.ecc.configure(cs, mulmod_table=self.mulmod.mulmod_table)
            ecc_table = self.ecc.ecc_table
        modexp_table = None
        if self.modexp is not None:
            from ..plonk.expression import Fixed as _FixedB

            self.modexp.configure(
                cs, mulmod_table=self.mulmod.mulmod_table,
                byte_table=[_FixedB(self.bytecode.tbl_byte)],
            )
            modexp_table = self.modexp.modexp_table
        tx_sig_table = sig_table if self.with_sig_txs else None
        self.tx.configure(
            cs, challenge=r_word, rlp_table=rlp_table,
            data_len_table=data_len_table, sig_table=tx_sig_table,
            tx_type_table=(
                self.rlp.tx_type_table if self.rlp is not None else None
            ),
            sign_hash_table=sign_hash_table if tx_sig_table is not None
            else None,
        )
        if self.copy is not None:
            self.copy.configure(
                cs, rw_table=rw_table, tx_table=self.tx.tx_table_exprs(),
                challenge=r_word,
                bytecode_table=(
                    self.bytecode.bytecode_table_exprs()
                    if self.bind_bytecode else None
                ),
            )
        if self.exp is not None:
            self.exp.configure(cs)
        if self.block is not None:
            self.block.configure(cs, challenge=r_word)
        self.evm.configure(
            cs, rw_table=rw_table, challenge=r_word,
            exp_table=self.exp.exp_table if self.exp is not None else None,
            copy_table=self.copy.copy_table if self.copy is not None else None,
            copy_bound_table=(
                self.copy.copy_bound_table if self.copy is not None else None
            ),
            tx_table=self.tx.tx_table_exprs(),
            bytecode_table=(
                self.bytecode.bytecode_table_exprs()
                if self.bind_bytecode else None
            ),
            bytecode_len_table=(
                self.bytecode.bytecode_len_exprs()
                if self.bind_bytecode else None
            ),
            mulmod_table=(
                self.mulmod.mulmod_table if self.mulmod is not None else None
            ),
            keccak_table=keccak_table,
            block_table=(
                self.block.block_table if self.block is not None else None
            ),
            sig_table=sig_table,
            ecc_table=ecc_table,
            sha256_table=sha256_table,
            modexp_table=modexp_table,
        )
        if self.pi is not None:
            self.pi.configure(
                cs, keccak_table=keccak_table, challenge=r_word,
                block_table=(
                    self.block.block_table if self.block is not None
                    else None
                ),
                tx_hash_table=(
                    self.rlp.tx_hash_table if self.rlp is not None else None
                ),
            )
        if self.poseidon is not None:
            self.poseidon.configure(cs)

    def fixed_columns(self, n: int):
        out = {}
        for sub in self.subs:
            out.update(sub.fixed_columns(n))
        return out

    def copy_constraints(self, n: int):
        out = []
        for sub in self.subs:
            out.extend(sub.copy_constraints(n))
        # two-level glue: subtrie roots <-> account leaf sroot cells,
        # addresses carried (the TwoLevel pattern, tests/test_account_trie)
        if self.mpt_acct is not None and self._mpt_groups is not None:
            group_span = {}
            j = 0
            for addr, cnt, _, _ in self._mpt_groups:
                group_span[addr] = (j, j + cnt - 1)
                j += cnt
            for i, au in enumerate(self._mpt_accounts):
                cells = self.mpt_acct.account_cells(i)
                if self.mpt_stor is not None and au.addr in group_span:
                    j0, j1 = group_span[au.addr]
                    out.append((cells["sroot_old"],
                                self.mpt_stor.update_root_cells(j0)[0]))
                    out.append((cells["sroot_new"],
                                self.mpt_stor.update_root_cells(j1)[1]))
                    for jj in range(j0, j1 + 1):
                        out.append((self.mpt_stor.storage_addr_cell(jj),
                                    cells["addr"]))
                else:
                    out.append((cells["sroot_old"], cells["sroot_new"]))
            # PI state-root imports: the byte folds of prev/post roots in
            # the chunk header equal the account trie's chain endpoints
            if self.pi is not None and self.mpt_acct.updates:
                prev_c, post_c = self.pi.state_root_cells()
                out.append((
                    prev_c, self.mpt_acct.update_root_cells(0)[0]
                ))
                out.append((
                    post_c,
                    self.mpt_acct.update_root_cells(
                        len(self.mpt_acct.updates) - 1
                    )[1],
                ))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        out = {}
        for sub in self.subs:
            out.update(sub.synthesize(phase, n, challenges, instances))
        return out
