"""TestContext — deterministic test-chain builder.

Equivalent of the reference's `mock` crate (`mock::TestContext`,
mock/src/test_ctx.rs:85, SURVEY.md §2.1 item 4): closures configure
accounts and transactions, the in-repo tracer (tracer/evm.py — the
geth-utils stand-in) executes them, and the result bundles traces +
pre-state the way `GethData` does.  Constants mirror the reference's
MOCK_* fixtures (mock/src/lib.rs:20-31).

Port of zkevm_circuits_tpu/witness/test_ctx.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import dataclasses

from ..tracer import Account, BlockEnv, Interpreter, StateDB, Tx
from ..types.bytecode import Bytecode
from ..witness.trace import GethExecTrace

# mirror of the reference's MOCK_ACCOUNTS / MOCK_COINBASE spirit
MOCK_COINBASE = 0x00000000000000000000000000000000C014BA5E
MOCK_ACCOUNTS = [
    0x000000000000000000000000000000000CAFE111 + i for i in range(5)
]
MOCK_CHAIN_ID = 1337
MOCK_BASEFEE = 7
MOCK_GASLIMIT = 30_000_000
DEFAULT_BALANCE = 10**21


@dataclasses.dataclass
class GethData:
    """Pre-state + executed traces for one mock block (reference
    `mock::GethData`)."""

    block: BlockEnv
    state: StateDB  # post-state after all txs
    pre_state: dict[int, Account]
    txs: list[Tx]
    geth_traces: list[GethExecTrace]


class TestContext:
    """Builder: TestContext().account(addr, code=..., balance=...)
    .tx(from_addr, to, ...).build() -> GethData."""

    def __init__(self):
        self._accounts: dict[int, Account] = {}
        self._txs: list[Tx] = []
        self.block = BlockEnv(
            coinbase=MOCK_COINBASE,
            chain_id=MOCK_CHAIN_ID,
            base_fee=MOCK_BASEFEE,
            gas_limit=MOCK_GASLIMIT,
        )

    def account(self, addr: int, code: Bytecode | bytes = b"",
                balance: int = DEFAULT_BALANCE, nonce: int = 0,
                storage: dict[int, int] | None = None) -> "TestContext":
        raw = code.to_bytes() if isinstance(code, Bytecode) else bytes(code)
        self._accounts[addr] = Account(
            nonce=nonce, balance=balance, code=raw, storage=dict(storage or {})
        )
        return self

    def tx(self, from_addr: int | None = None, to: int | None = None,
           gas: int = 1_000_000, gas_price: int = 10, value: int = 0,
           data: bytes = b"") -> "TestContext":
        self._txs.append(
            Tx(from_addr=from_addr if from_addr is not None else MOCK_ACCOUNTS[0],
               to=to, gas=gas, gas_price=gas_price, value=value, data=data)
        )
        return self

    def build(self) -> GethData:
        # default sender accounts exist with funded balances
        for tx in self._txs:
            if tx.from_addr not in self._accounts:
                self._accounts[tx.from_addr] = Account(balance=DEFAULT_BALANCE)
        import copy

        pre = copy.deepcopy(self._accounts)
        state = StateDB(copy.deepcopy(self._accounts))
        it = Interpreter(state, self.block)
        traces = [it.run_tx(tx) for tx in self._txs]
        return GethData(
            block=self.block, state=state, pre_state=pre,
            txs=list(self._txs), geth_traces=traces,
        )
