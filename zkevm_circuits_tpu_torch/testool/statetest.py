"""StateTest model + executor (port of zkevm_circuits_tpu/testool/statetest.py).

Mirrors the reference's `testool/src/statetest/{spec,executor}.rs`
(SURVEY.md §4.6): a state test is (env, pre-state, one tx, expected
post-state); execution levels mirror `CircuitsConfig`
(`testool/src/statetest/executor.rs:81`):

    trace    — run the tx through the EVM tracer, check post-state
    witness  — additionally replay the trace through CircuitInputBuilder
               (rw consistency oracle)
    mock     — additionally MockProver-verify the SuperCircuit composition
    prove    — additionally REALLY prove the SuperCircuit (keygen ->
               prove -> verify at config.k on `config.device`; the
               reference's inner-prove CI level,
               testool/src/statetest/executor.rs:81)

The trace, witness and mock levels are host work; only the prove level
uses the device (None: the card).  Unsupported constructs (precompile
calls, CREATE, reverted storage frames) surface as
`StateTestResult.skipped` with the reason — the reference testool
likewise maintains suite-level skip lists (`testool/src/config.rs:17-33`).
"""

from __future__ import annotations

import dataclasses

from ..crypto.keccak import keccak256
from ..tracer import Account, BlockEnv, Interpreter, StateDB, Tx

PROVE_SEED = 0x7E57  # the prove level's blinding rng


@dataclasses.dataclass
class AccountState:
    """Pre/expected account: None fields are unchecked."""

    balance: int | None = None
    nonce: int | None = None
    code: bytes | None = None
    storage: dict | None = None


@dataclasses.dataclass
class StateTest:
    name: str
    pre: dict  # addr -> AccountState (all fields concrete)
    tx_from: int
    tx_to: int | None
    tx_gas: int = 10_000_000
    tx_gas_price: int = 10
    tx_value: int = 0
    tx_data: bytes = b""
    tx_nonce: int | None = None
    env: BlockEnv | None = None
    expect: dict | None = None  # addr -> AccountState (None = unchecked)
    expect_failure: bool = False
    secret_key: int | None = None  # enables the mock level's Tx circuit


@dataclasses.dataclass
class CircuitsConfig:
    level: str = "trace"  # trace | witness | mock | prove
    k: int = 9
    super_circuit: bool = True
    srs_tau: int = 0xBEEF  # prove level: deterministic test SRS
    device: object = None  # prove level: None means the card


@dataclasses.dataclass
class StateTestResult:
    name: str
    ok: bool
    skipped: bool = False
    reason: str = ""

    @property
    def status(self) -> str:
        return "skip" if self.skipped else ("pass" if self.ok else "FAIL")


def _build_state(pre: dict) -> StateDB:
    accounts = {}
    for addr, a in pre.items():
        accounts[addr] = Account(
            balance=a.balance or 0,
            nonce=a.nonce or 0,
            code=a.code or b"",
            storage=dict(a.storage or {}),
        )
    return StateDB(accounts)


def _check_post(state: StateDB, expect: dict) -> list[str]:
    errs = []
    for addr, exp in expect.items():
        acct = state.account(addr)
        if exp.balance is not None and acct.balance != exp.balance:
            errs.append(
                f"0x{addr:x}: balance {acct.balance} != {exp.balance}"
            )
        if exp.nonce is not None and acct.nonce != exp.nonce:
            errs.append(f"0x{addr:x}: nonce {acct.nonce} != {exp.nonce}")
        if exp.code is not None and bytes(acct.code) != exp.code:
            errs.append(f"0x{addr:x}: code mismatch")
        for k, v in (exp.storage or {}).items():
            got = acct.storage.get(k, 0)
            if got != v:
                errs.append(
                    f"0x{addr:x}: storage[{hex(k)}] {hex(got)} != {hex(v)}"
                )
    return errs


def _host_levels(st: StateTest, config: CircuitsConfig):
    """The trace, witness and mock levels: (result, None) where the run
    ends before the prove level, else (None, circuit) with the
    SuperCircuit that passed the MockProver at config.k."""
    state = _build_state(st.pre)
    committed = {
        (addr, k): v
        for addr, a in st.pre.items()
        for k, v in (a.storage or {}).items()
    }
    interp = Interpreter(state, st.env)
    tx = Tx(
        from_addr=st.tx_from, to=st.tx_to, gas=st.tx_gas,
        gas_price=st.tx_gas_price, value=st.tx_value, data=st.tx_data,
        nonce=st.tx_nonce,
    )
    try:
        trace = interp.run_tx(tx)
    except Exception as e:  # intrinsic-gas / nonce / balance failures
        if st.expect_failure:
            return StateTestResult(st.name, ok=True), None
        return StateTestResult(st.name, ok=False, reason=f"tracer: {e}"), None

    if st.expect_failure and not trace.failed:
        return StateTestResult(
            st.name, ok=False, reason="expected failure, tx succeeded"
        ), None
    errs = _check_post(state, st.expect or {})
    if errs:
        return StateTestResult(st.name, ok=False, reason="; ".join(errs)), None
    if config.level == "trace":
        return StateTestResult(st.name, ok=True), None

    # ---- witness level: builder replay + rw consistency oracle ----------
    from ..witness.builder import CircuitInputBuilder

    code_hashes = {
        addr: int.from_bytes(keccak256(a.code or b""), "big")
        for addr, a in st.pre.items()
    }
    b = CircuitInputBuilder()
    try:
        b.handle_tx(
            dict(
                from_addr=st.tx_from, to_addr=st.tx_to, value=st.tx_value,
                calldata=st.tx_data,
                code_hash=code_hashes.get(st.tx_to, 0),
            ),
            trace,
            committed_storage=committed,
            code_hashes=code_hashes,
        )
    except NotImplementedError as e:
        return StateTestResult(st.name, ok=True, skipped=True,
                               reason=f"witness: {e}"), None
    errs = b.rws.check_consistency()
    if errs:
        return StateTestResult(
            st.name, ok=False, reason="rw oracle: " + "; ".join(errs[:3])
        ), None
    if config.level == "witness":
        return StateTestResult(st.name, ok=True), None

    # ---- mock level: SuperCircuit composition under the MockProver ------
    from ..circuits.super_circuit import SuperCircuit
    from ..plonk.mock import MockProver
    from ..types import Bytecode
    from ..types.transaction import Transaction

    if st.secret_key is None:
        return StateTestResult(
            st.name, ok=True, skipped=True,
            reason="mock: no secret key for the Tx circuit",
        ), None
    if st.tx_to is None:
        return StateTestResult(
            st.name, ok=True, skipped=True, reason="mock: create tx"
        ), None
    env = st.env or BlockEnv()
    txobj = Transaction(
        nonce=st.tx_nonce or 0, gas_price=st.tx_gas_price, gas=st.tx_gas,
        to=st.tx_to, value=st.tx_value, data=st.tx_data,
        chain_id=env.chain_id,
    ).sign(st.secret_key)
    if txobj.recover_sender() != st.tx_from:
        return StateTestResult(
            st.name, ok=False,
            reason="mock: secret key does not match tx sender",
        ), None
    codes = [Bytecode(a.code) for a in st.pre.values() if a.code]
    try:
        circ = SuperCircuit(b, codes, [txobj])
        failures = MockProver(config.k, circ).verify()
    except NotImplementedError as e:
        return StateTestResult(st.name, ok=True, skipped=True,
                               reason=f"mock: {e}"), None
    if failures:
        return StateTestResult(
            st.name, ok=False, reason="mock: " + "; ".join(failures[:3])
        ), None
    if config.level == "mock":
        return StateTestResult(st.name, ok=True), None
    return None, circ


def _keygen_level(circ, config: CircuitsConfig):
    """The prove level's keys on config.device: (srs, pk, vk) with the test
    SRS at config.k and tau config.srs_tau."""
    from ..plonk.keygen import keygen
    from ..poly.kzg import Srs

    srs = Srs.unsafe_setup(config.k, tau=config.srs_tau, device=config.device)
    pk, vk = keygen(circ, config.k, srs, device=config.device)
    return srs, pk, vk


def _prove_level(circ, config: CircuitsConfig, keys=None) -> tuple[bytes, bool]:
    """The prove level's tail on config.device: prove with no instances
    and the PROVE_SEED rng, verify, under `keys` = (srs, pk, vk) (default:
    _keygen_level's).  Returns (proof bytes, verdict)."""
    import numpy as np

    from ..plonk.prover import prove
    from ..plonk.verifier import verify

    srs, pk, vk = keys or _keygen_level(circ, config)
    proof = prove(pk, circ, [], srs, rng=np.random.default_rng(PROVE_SEED),
                  device=config.device)
    return proof, verify(vk, [], proof)


def run_state_test(
    st: StateTest, config: CircuitsConfig | None = None
) -> StateTestResult:
    config = config or CircuitsConfig()
    result, circ = _host_levels(st, config)
    if result is not None:
        return result

    # ---- prove level: real keygen -> prove -> verify (inner-prove) ------
    _, ok = _prove_level(circ, config)
    if not ok:
        return StateTestResult(
            st.name, ok=False, reason="prove: proof failed verification"
        )
    return StateTestResult(st.name, ok=True)
