"""GeneralStateTests filler (JSON) parser (port of
zkevm_circuits_tpu/testool/json_parser.py).

Subset of the reference's `testool/src/statetest/json.rs`: env / pre /
transaction / expect sections.  Each (data, gas, value) index
combination referenced by an expect block becomes one StateTest.
Code fields accept hex (with/without 0x) and `:raw 0x...`; LLL/asm
compilation (reference `src/compiler.rs` shelling out to solc) is out
of scope — such tests surface as skips.
"""

from __future__ import annotations

import json

from ..tracer import BlockEnv
from .statetest import AccountState, StateTest


def _int(v, default=0) -> int:
    if v is None:
        return default
    if isinstance(v, int):
        return v
    v = v.strip()
    if v == "":
        return default
    if v.startswith("0x") or v.startswith("0X"):
        return int(v, 16)
    return int(v, 0) if v.startswith("0") and len(v) > 1 and not v.isdigit() \
        else int(v)


def _code(v: str) -> bytes:
    if not v:
        return b""
    v = v.strip()
    if v.startswith(":raw"):
        v = v[4:].strip()
    if v.startswith("0x"):
        v = v[2:]
    if v == "":
        return b""
    if all(c in "0123456789abcdefABCDEF" for c in v):
        return bytes.fromhex(v)
    raise NotImplementedError(f"non-hex code (LLL/asm): {v[:40]}...")


def _account(d: dict) -> AccountState:
    return AccountState(
        balance=_int(d.get("balance")),
        nonce=_int(d.get("nonce")),
        code=_code(d.get("code", "")),
        storage={
            _int(k): _int(v) for k, v in (d.get("storage") or {}).items()
        },
    )


def _match_index(sel, idx: int) -> bool:
    """expect.indexes entries: -1 = all, int, or list of ints."""
    if sel is None or sel == -1:
        return True
    if isinstance(sel, list):
        return idx in [int(s) for s in sel]
    return int(sel) == idx


def load_json_fillers(text: str) -> list[StateTest]:
    """Parse a filler JSON document -> list of StateTests (one per
    expect-covered (data, gas, value) index combination)."""
    return _parse_doc(json.loads(text))


def load_yaml_fillers(text: str) -> list[StateTest]:
    """Official-corpus YAML fillers (reference testool/src/statetest/
    yaml.rs): the same env/pre/transaction/expect schema with
    int-or-string scalars.  Code fields must be hex or `:raw` — LLL /
    asm / :yul sources need the external compiler (staged, like the
    JSON path)."""
    import yaml

    return _parse_doc(yaml.safe_load(text))


def _parse_doc(doc: dict) -> list[StateTest]:
    out: list[StateTest] = []
    for name, t in doc.items():
        envd = t.get("env", {})
        env = BlockEnv(
            coinbase=_int(envd.get("currentCoinbase"), BlockEnv.coinbase),
            number=_int(envd.get("currentNumber"), 1),
            timestamp=_int(envd.get("currentTimestamp"), 1000),
            gas_limit=_int(envd.get("currentGasLimit"), 30_000_000),
            base_fee=_int(envd.get("currentBaseFee"), 7),
            difficulty=_int(envd.get("currentDifficulty"), 0),
        )
        pre = {
            _int(addr): _account(a) for addr, a in t.get("pre", {}).items()
        }
        txd = t["transaction"]
        datas = [
            d["data"] if isinstance(d, dict) else d
            for d in txd.get("data", [""])
        ]
        gases = txd.get("gasLimit", ["10000000"])
        values = txd.get("value", ["0"])
        sk = _int(txd.get("secretKey"), 0) or None
        sender = _int(txd.get("sender"), 0)
        if not sender and sk:
            # official fillers usually omit `sender` — derive it from the
            # secret key like the reference (testool statetest/json.rs)
            from ..types.transaction import Transaction as _Tx

            sender = _Tx(nonce=0).sign(sk).recover_sender()
        to_raw = txd.get("to", "")
        to = _int(to_raw) if to_raw else None
        expects = t.get("expect", [])
        for di, data in enumerate(datas):
            for gi, gas in enumerate(gases):
                for vi, value in enumerate(values):
                    result: dict[int, AccountState] = {}
                    covered = False
                    for e in expects:
                        idx = e.get("indexes", {})
                        if not (
                            _match_index(idx.get("data"), di)
                            and _match_index(idx.get("gas"), gi)
                            and _match_index(idx.get("value"), vi)
                        ):
                            continue
                        covered = True
                        for addr, acc in e.get("result", {}).items():
                            result[_int(addr)] = AccountState(
                                balance=(
                                    _int(acc["balance"])
                                    if "balance" in acc else None
                                ),
                                nonce=(
                                    _int(acc["nonce"])
                                    if "nonce" in acc else None
                                ),
                                code=(
                                    _code(acc["code"])
                                    if "code" in acc else None
                                ),
                                storage={
                                    _int(k): _int(v)
                                    for k, v in (
                                        acc.get("storage") or {}
                                    ).items()
                                },
                            )
                    if not covered and expects:
                        continue
                    suffix = (
                        f"_d{di}g{gi}v{vi}"
                        if len(datas) * len(gases) * len(values) > 1 else ""
                    )
                    out.append(StateTest(
                        name=name + suffix,
                        pre=pre,
                        tx_from=sender,
                        tx_to=to,
                        tx_gas=_int(gas),
                        tx_gas_price=_int(txd.get("gasPrice"), 10),
                        tx_value=_int(value),
                        tx_data=_code(data),
                        tx_nonce=_int(txd.get("nonce"), 0),
                        env=env,
                        expect=result,
                        secret_key=sk,
                    ))
    return out
