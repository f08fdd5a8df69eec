"""Geth-style execution trace schema.

Mirrors the reference's trace types byte-for-byte at the JSON level so
real geth traces can be ingested unchanged:
  * `GethExecStep`  <-> eth-types/src/lib.rs:396 (StructLog fields
    pc/op/gas/gasCost/refund/depth/stack/memory/storage)
  * `GethExecTrace` <-> eth-types/src/lib.rs:683 (gas/failed/returnValue/
    structLogs)
The in-repo tracer (tracer/evm.py) PRODUCES this schema — the equivalent
of the reference's embedded Go geth (`geth-utils/l2geth/trace.go`,
SURVEY.md §2.3 item 2) — and bus-mapping replays it.

Port of zkevm_circuits_tpu/witness/trace.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..types.evm import OpcodeId


@dataclasses.dataclass
class GethExecStep:
    pc: int
    op: OpcodeId
    gas: int
    gas_cost: int
    depth: int
    refund: int = 0
    stack: list[int] = dataclasses.field(default_factory=list)  # top LAST
    memory: bytes = b""
    storage: dict[int, int] = dataclasses.field(default_factory=dict)
    error: str | None = None

    def stack_top(self, nth: int = 0) -> int:
        return self.stack[-1 - nth]

    def to_json(self) -> dict[str, Any]:
        return {
            "pc": self.pc,
            "op": self.op.name,
            "gas": self.gas,
            "gasCost": self.gas_cost,
            "depth": self.depth,
            "refund": self.refund,
            "stack": [hex(v) for v in self.stack],
            "memory": [
                self.memory[i : i + 32].hex()
                for i in range(0, len(self.memory), 32)
            ],
            "storage": {hex(k): hex(v) for k, v in self.storage.items()},
            **({"error": self.error} if self.error else {}),
        }

    @classmethod
    def from_json(cls, d: dict) -> "GethExecStep":
        mem = b"".join(bytes.fromhex(w) for w in d.get("memory") or [])
        return cls(
            pc=d["pc"],
            op=OpcodeId[d["op"]],
            gas=d["gas"],
            gas_cost=d.get("gasCost", 0),
            depth=d["depth"],
            refund=d.get("refund", 0),
            stack=[int(v, 16) for v in d.get("stack") or []],
            memory=mem,
            storage={
                int(k, 16): int(v, 16)
                for k, v in (d.get("storage") or {}).items()
            },
            error=d.get("error"),
        )


@dataclasses.dataclass
class GethExecTrace:
    gas: int
    failed: bool
    return_value: str
    struct_logs: list[GethExecStep]

    def to_json(self) -> dict:
        return {
            "gas": self.gas,
            "failed": self.failed,
            "returnValue": self.return_value,
            "structLogs": [s.to_json() for s in self.struct_logs],
        }

    @classmethod
    def from_json(cls, d: dict) -> "GethExecTrace":
        return cls(
            gas=d["gas"],
            failed=d["failed"],
            return_value=d.get("returnValue", ""),
            struct_logs=[GethExecStep.from_json(s) for s in d["structLogs"]],
        )
