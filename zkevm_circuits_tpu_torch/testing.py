"""CircuitTestBuilder — the end-to-end test harness.

Equivalent of the reference's `CircuitTestBuilder` (zkevm-circuits/src/
test_util.rs:81-307, SURVEY.md §3.1): TestContext -> tracer -> bus-mapping
replay -> per-circuit MockProver runs.  Grows a circuit per milestone —
currently State + Bytecode; each new sub-circuit plugs into `run()`.

Port of zkevm_circuits_tpu/testing.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

from .circuits.bytecode import BytecodeCircuit, BytecodeParams
from .circuits.state import StateCircuit, StateParams
from .plonk.mock import MockProver
from .types.bytecode import Bytecode
from .witness.builder import CircuitInputBuilder
from .witness.test_ctx import GethData, TestContext


class CircuitTestBuilder:
    def __init__(self, ctx: TestContext, k: int = 9,
                 state_params: StateParams | None = None):
        self.ctx = ctx
        self.k = k
        self.state_params = state_params or StateParams(
            limb_bits=4, id_bits=8, addr_bits=32, key_bits=16, rwc_bits=12,
            target_rows=300,
        )
        self.modifiers = []  # witness-corruption hooks (negative tests)

    def block_modifier(self, fn) -> "CircuitTestBuilder":
        self.modifiers.append(fn)
        return self

    def build_witness(self):
        data: GethData = self.ctx.build()
        builder = CircuitInputBuilder()
        for tx, trace in zip(data.txs, data.geth_traces):
            pre_storage = {
                (addr, k): v
                for addr, acct in data.pre_state.items()
                for k, v in acct.storage.items()
            }
            builder.handle_tx(
                dict(from_addr=tx.from_addr, to_addr=tx.to or 0,
                     value=tx.value, calldata=tx.data),
                trace,
                committed_storage=pre_storage,
            )
        for fn in self.modifiers:
            fn(builder)
        return data, builder

    def run(self) -> None:
        data, builder = self.build_witness()
        errs = builder.rws.check_consistency()
        assert not errs, errs
        MockProver(
            self.k, StateCircuit(builder.rws, self.state_params)
        ).assert_satisfied()
        codes = [
            Bytecode(acct.code)
            for acct in data.pre_state.values()
            if acct.code
        ]
        if codes:
            MockProver(self.k, BytecodeCircuit(codes)).assert_satisfied()
