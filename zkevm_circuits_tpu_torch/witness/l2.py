"""L2 block-trace ingestion (port of zkevm_circuits_tpu/witness/l2.py): the
production witness path.

Equivalent of the reference's `new_from_l2_trace`
(bus-mapping/src/circuit_input_builder/l2.rs:345): a proving service
receives a self-contained BlockTrace JSON — header fields, the pre-state
touched by the block (the reference carries zktrie proofs; this schema
carries the parsed account/storage pre-state directly, which is what the
proofs decode to), transaction envelopes, per-tx geth execution traces
(the standard structLogs schema, witness/trace.py), and the code store —
and builds the full block witness WITHOUT a live tracer or node
(reference `BuilderClient::gen_inputs`, circuit_input_builder.rs:1274,
is the live-node counterpart).

Schema (all numbers hex-or-int tolerant):

    {
      "chain_id": 1337, "coinbase": "0x..", "number": 7,
      "timestamp": 1000, "gas_limit": 30000000, "base_fee": 7,
      "prev_hashes": {"6": "0x.."},
      "accounts_before": {"0x..": {"nonce": 0, "balance": "0x..",
                                   "code_hash": "0x.."}},
      "storage_before": {"0x..": {"0x05": "0x2a"}},
      "codes": {"0x<code_hash>": "0x<bytes>"},
      "transactions": [{"from": "0x..", "to": "0x..", "value": 0,
                        "gas": 1000000, "gas_price": 10,
                        "calldata": "0x.."}],
      "execution_results": [<geth trace JSON, structLogs schema>]
    }
"""

from __future__ import annotations

import json

from .builder import CircuitInputBuilder
from .mpt import AccountFields
from .trace import GethExecTrace


def _int(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


def _bytes(v) -> bytes:
    if not v:
        return b""
    s = v[2:] if v.startswith("0x") else v
    return bytes.fromhex(s)


class BlockTrace:
    """Parsed L2 block trace (reference eth-types/src/l2_types.rs
    BlockTrace shape)."""

    def __init__(self, d: dict):
        self.chain_id = _int(d.get("chain_id", 1))
        self.coinbase = _int(d.get("coinbase", 0))
        self.number = _int(d.get("number", 1))
        self.timestamp = _int(d.get("timestamp", 0))
        self.gas_limit = _int(d.get("gas_limit", 30_000_000))
        self.base_fee = _int(d.get("base_fee", 7))
        self.prev_hashes = {
            _int(k): _int(v) for k, v in d.get("prev_hashes", {}).items()
        }
        self.accounts_before = {
            _int(a): {
                "nonce": _int(f.get("nonce", 0)),
                "balance": _int(f.get("balance", 0)),
                "code_hash": _int(f.get("code_hash", 0)),
            }
            for a, f in d.get("accounts_before", {}).items()
        }
        self.storage_before = {
            _int(a): {_int(k): _int(v) for k, v in slots.items()}
            for a, slots in d.get("storage_before", {}).items()
        }
        self.codes = {
            _int(h): _bytes(c) for h, c in d.get("codes", {}).items()
        }
        self.transactions = [
            {
                "from": _int(t["from"]), "to": _int(t["to"]),
                "value": _int(t.get("value", 0)),
                "gas": _int(t.get("gas", 1_000_000)),
                "gas_price": _int(t.get("gas_price", 10)),
                "calldata": _bytes(t.get("calldata", "0x")),
            }
            for t in d["transactions"]
        ]
        self.execution_results = [
            GethExecTrace.from_json(r) for r in d["execution_results"]
        ]
        assert len(self.transactions) == len(self.execution_results)

    @classmethod
    def from_json(cls, s: str) -> "BlockTrace":
        return cls(json.loads(s))


def builder_from_l2_trace(bt: BlockTrace) -> CircuitInputBuilder:
    """Replay every tx of the block trace into a CircuitInputBuilder —
    the `new_from_l2_trace` equivalent (l2.rs:345)."""
    accounts = {
        a: (f["nonce"], f["balance"], f["code_hash"])
        for a, f in bt.accounts_before.items()
    }
    b = CircuitInputBuilder(
        accounts=accounts, coinbase=bt.coinbase, base_fee=bt.base_fee
    )
    code_by_addr = {
        a: bt.codes.get(f["code_hash"], b"")
        for a, f in bt.accounts_before.items()
        if f["code_hash"]
    }
    hashes = {a: f["code_hash"] for a, f in bt.accounts_before.items()}
    committed = {
        (a, k): v
        for a, slots in bt.storage_before.items()
        for k, v in slots.items()
    }
    for tx, trace in zip(bt.transactions, bt.execution_results):
        b.handle_tx(
            dict(from_addr=tx["from"], to_addr=tx["to"],
                 value=tx["value"], calldata=tx["calldata"],
                 code_hash=hashes.get(tx["to"], 0)),
            trace,
            committed_storage=dict(committed),
            code_hashes=dict(hashes),
            code_db=dict(code_by_addr),
        )
        # later txs see the block's running storage state
        for (a, k), v in list(committed.items()):
            committed[(a, k)] = b._storage.get((a, k), v)
        for (a, k), v in b._storage.items():
            committed[(a, k)] = v
    return b


def accounts_before_fields(bt: BlockTrace) -> dict:
    """{addr: AccountFields} pre-state for the two-level trie witness
    (witness/mpt.py two_level_updates_from_rws)."""
    out = {}
    for a, f in bt.accounts_before.items():
        code = bt.codes.get(f["code_hash"], b"")
        out[a] = AccountFields(
            nonce=f["nonce"], code_size=len(code),
            balance=f["balance"], code_hash=f["code_hash"],
        )
    return out


def block_env(bt: BlockTrace):
    """A tracer BlockEnv mirroring the trace header (for the Block
    circuit / BLOCKHASH window)."""
    from ..tracer.evm import BlockEnv

    return BlockEnv(
        coinbase=bt.coinbase, number=bt.number, timestamp=bt.timestamp,
        gas_limit=bt.gas_limit, base_fee=bt.base_fee,
        chain_id=bt.chain_id, prev_hashes=dict(bt.prev_hashes),
    )
