"""RW operations & container — the bus-mapping operation layer.

Equivalent of the reference's `bus-mapping/src/operation.rs` (Op kinds +
`OperationContainer`) and `zkevm-circuits/src/witness/rw.rs` (`RwMap`/`Rw`)
— SURVEY.md §2.1 item 5.  One flat record type with a tag discriminator
(the reference's enum-of-structs becomes a struct-of-arrays at export
time: `RwMap.columns()` hands the State circuit ready (n, field) numpy
planes, the columnar layout SURVEY.md §7.1 calls for).
"""

from __future__ import annotations

import dataclasses
import enum


class RwTag(enum.IntEnum):
    Start = 1
    Stack = 2
    Memory = 3
    Storage = 4
    CallContext = 5
    Account = 6
    TxRefund = 7
    TxAccessListAccount = 8
    TxAccessListAccountStorage = 9
    TxLog = 10
    TxReceipt = 11
    Padding = 12  # fills the RW table tail; sorts after every real tag


class CallContextField(enum.IntEnum):
    TxId = 1
    CallerId = 2
    CalleeAddress = 3
    CallerAddress = 4
    CallDataLength = 5
    Value = 6
    IsStatic = 7
    IsRoot = 8
    IsSuccess = 9
    LastCalleeReturnDataLength = 10
    ProgramCounter = 11
    StackPointer = 12
    GasLeft = 13
    Depth = 14
    # call-frame restoration fields (written at the CALL step keyed by the
    # NEW call id, read back at the frame-ending step; the reference keeps
    # equivalents in its CallContext tag, table.rs:577)
    ReturnPc = 15  # caller pc after the call opcode
    ReturnSp = 16  # caller stack slot receiving the success flag
    RetOffset = 17  # caller memory offset for return data
    RetLength = 18  # caller-declared max return data length
    ParentCalleeAddress = 19  # caller's own executing address (raw)
    ParentCodeHash = 20  # caller's code-hash RLC (word-RLC encoded)
    CodeHash = 21  # callee's code-hash RLC (word-RLC encoded)
    LastCalleeId = 22  # written to the CALLER at frame end
    LastCalleeReturnDataOffset = 23  # offset of the data in callee memory
    IsCreate = 24  # 1 iff the frame executes init code (CREATE/CREATE2)
    CallDataOffset = 25  # nested frames: args offset in CALLER memory


class AccountField(enum.IntEnum):
    Nonce = 1
    Balance = 2
    CodeHash = 3
    CodeSize = 4


class TxReceiptField(enum.IntEnum):
    """Reference TxReceiptFieldTag (table.rs:503)."""

    PostStateOrStatus = 1
    CumulativeGasUsed = 2
    LogLength = 3


class TxLogField(enum.IntEnum):
    Address = 1
    Topic = 2
    Data = 3


@dataclasses.dataclass
class Rw:
    rw_counter: int
    is_write: bool
    tag: RwTag
    id: int = 0  # tx_id or call_id depending on tag
    address: int = 0  # memory address / stack pointer / account address
    field_tag: int = 0
    storage_key: int = 0
    value: int = 0
    value_prev: int = 0


class RwMap:
    """Append-only during replay; sorted/columnar on export."""

    def __init__(self):
        self.rws: list[Rw] = []
        self.counter = 0  # rw_counter starts at 1 (0 reserved for Start)
        self.rws.append(Rw(rw_counter=0, is_write=False, tag=RwTag.Start))

    def next_counter(self) -> int:
        self.counter += 1
        return self.counter

    def push(self, **kw) -> Rw:
        rw = Rw(rw_counter=self.next_counter(), **kw)
        self.rws.append(rw)
        return rw

    # -- typed emitters (mirror CircuitInputStateRef push helpers,
    #    reference bus-mapping/src/circuit_input_builder/input_state_ref.rs)
    def stack_read(self, call_id, sp, value):
        return self.push(is_write=False, tag=RwTag.Stack, id=call_id,
                         address=sp, value=value)

    def stack_write(self, call_id, sp, value):
        return self.push(is_write=True, tag=RwTag.Stack, id=call_id,
                         address=sp, value=value)

    def memory_read(self, call_id, addr, byte):
        return self.push(is_write=False, tag=RwTag.Memory, id=call_id,
                         address=addr, value=byte)

    def memory_write(self, call_id, addr, byte):
        return self.push(is_write=True, tag=RwTag.Memory, id=call_id,
                         address=addr, value=byte)

    def storage_read(self, tx_id, addr, key, value, committed):
        return self.push(is_write=False, tag=RwTag.Storage, id=tx_id,
                         address=addr, storage_key=key, value=value,
                         value_prev=value)

    def storage_write(self, tx_id, addr, key, value, value_prev):
        return self.push(is_write=True, tag=RwTag.Storage, id=tx_id,
                         address=addr, storage_key=key, value=value,
                         value_prev=value_prev)

    def tx_log_write(self, tx_id, log_id, field, index, value):
        """TxLog row; the (log_id, field, index) triple packs into the
        address key (reference build_tx_log_address,
        eth-types/src/evm_types.rs): index + field << 32 + log_id << 48."""
        packed = index + (int(field) << 32) + (log_id << 48)
        return self.push(is_write=True, tag=RwTag.TxLog, id=tx_id,
                         address=packed, value=value)

    def account_read(self, addr, field, value):
        """Account row (reference operation.rs AccountOp): id unused,
        address = account, field_tag = AccountField, committed read."""
        return self.push(is_write=False, tag=RwTag.Account, address=addr,
                         field_tag=field, value=value, value_prev=value)

    def account_write(self, addr, field, value, value_prev):
        return self.push(is_write=True, tag=RwTag.Account, address=addr,
                         field_tag=field, value=value,
                         value_prev=value_prev)

    def access_list_account_write(self, tx_id, addr, value, value_prev):
        """EIP-2929 warm-address set (reference TxAccessListAccountOp):
        value 1 = warm; value_prev carries the previous warmth so reverts
        can restore it."""
        return self.push(is_write=True, tag=RwTag.TxAccessListAccount,
                         id=tx_id, address=addr, value=value,
                         value_prev=value_prev)

    def access_list_storage_write(self, tx_id, addr, key, value, value_prev):
        return self.push(is_write=True,
                         tag=RwTag.TxAccessListAccountStorage, id=tx_id,
                         address=addr, storage_key=key, value=value,
                         value_prev=value_prev)

    def tx_refund_write(self, tx_id, value, value_prev):
        return self.push(is_write=True, tag=RwTag.TxRefund, id=tx_id,
                         value=value, value_prev=value_prev)

    def tx_receipt_write(self, tx_id, field, value):
        """TxReceipt row (reference operation.rs:113 TxReceiptOp): one
        write per (tx, field) at EndTx."""
        return self.push(is_write=True, tag=RwTag.TxReceipt, id=tx_id,
                         field_tag=field, value=value)

    def call_context_read(self, call_id, field, value):
        return self.push(is_write=False, tag=RwTag.CallContext, id=call_id,
                         field_tag=field, value=value)

    def call_context_write(self, call_id, field, value):
        return self.push(is_write=True, tag=RwTag.CallContext, id=call_id,
                         field_tag=field, value=value)

    # -- export -----------------------------------------------------------------
    def sort_key(self, rw: Rw):
        """State-circuit lexicographic order: (tag, id, address, field_tag,
        storage_key, rw_counter) — reference state_circuit
        lexicographic_ordering.rs:96."""
        return (rw.tag, rw.id, rw.address, rw.field_tag, rw.storage_key,
                rw.rw_counter)

    def sorted_rws(self) -> list[Rw]:
        return sorted(self.rws, key=self.sort_key)

    def columns(self):
        """Struct-of-arrays export (sorted): dict of python-int lists the
        circuit layer turns into Montgomery digit planes."""
        s = self.sorted_rws()
        return {
            "rw_counter": [r.rw_counter for r in s],
            "is_write": [int(r.is_write) for r in s],
            "tag": [int(r.tag) for r in s],
            "id": [r.id for r in s],
            "address": [r.address for r in s],
            "field_tag": [int(r.field_tag) for r in s],
            "storage_key": [r.storage_key for r in s],
            "value": [r.value for r in s],
            "value_prev": [r.value_prev for r in s],
        }

    def check_consistency(self) -> list[str]:
        """Host-side oracle for the state circuit's statement: every read
        returns the last written value within its (tag,id,addr,field,key)
        group; first access per group reads 0/fresh."""
        errs = []
        s = self.sorted_rws()
        prev = None
        last_val = 0
        for r in s:
            group = (r.tag, r.id, r.address, r.field_tag, r.storage_key)
            if group != prev:
                last_val = 0
                prev = group
            if r.tag in (RwTag.Stack, RwTag.Memory, RwTag.Storage):
                if not r.is_write and r.value != last_val and r.tag != RwTag.Storage:
                    errs.append(f"read mismatch at rw {r.rw_counter}: {r}")
                last_val = r.value
        return errs
