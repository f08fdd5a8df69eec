"""Block witness bundle + conversion.

Equivalent of the reference's `zkevm-circuits/src/witness/block.rs`
(`Block` struct + `block_convert`, SURVEY.md §2.2 "Witness structs"):
everything the sub-circuits need for one proven chunk, in one bundle.

Port of zkevm_circuits_tpu/witness/block.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256_batch
from ..types.bytecode import Bytecode
from ..types.transaction import Transaction
from .builder import CircuitInputBuilder, CopyEvent, ExecStep
from .rw import RwMap
from .test_ctx import GethData


@dataclasses.dataclass
class Block:
    """Witness for one block/chunk (reference witness::Block fields that
    exist at this round's circuit coverage)."""

    rws: RwMap
    steps: list[ExecStep]
    copy_events: list[CopyEvent]
    bytecodes: list[Bytecode]
    txs: list[Transaction]
    keccak_inputs: list[bytes]
    code_hashes: list[bytes]

    @property
    def num_rws(self) -> int:
        return len(self.rws.rws)


def block_convert(builder: CircuitInputBuilder, data: GethData,
                  signed_txs: list[Transaction] | None = None) -> Block:
    """builder output + mock-chain data -> circuit witness bundle.

    Collects the block-wide keccak preimages the way the reference's
    `keccak_inputs` does (bus-mapping circuit_input_builder.rs:724):
    every deployed bytecode (code hash), every signed tx payload.
    """
    bytecodes = [
        Bytecode(acct.code) for acct in data.pre_state.values() if acct.code
    ]
    txs = signed_txs or []
    inputs: list[bytes] = [bc.to_bytes() for bc in bytecodes]
    inputs += [tx.sign_payload() for tx in txs]
    inputs += [tx.rlp_signed() for tx in txs]
    hashes = keccak256_batch([bc.to_bytes() for bc in bytecodes])
    return Block(
        rws=builder.rws,
        steps=builder.steps,
        copy_events=builder.copy_events,
        bytecodes=bytecodes,
        txs=txs,
        keccak_inputs=inputs,
        code_hashes=hashes,
    )
