"""The k=5 demonstration circuit of the reference's tests
(tests/test_plonk_prove.py::DemoCircuit), written against the port's IR.

It exercises every argument of the proof system at once: two gates
(degree 2 and 3), a rotation-using chain gate, a lookup into a fixed table,
and copy constraints across advice columns and into the instance column.
"""

from __future__ import annotations

import numpy as np

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from .circuit import Cell, Circuit, ConstraintSystem
from .expression import Advice, Fixed

F = fr()
K = 5
A_IN = 3
N_ADD = 10  # rows 0..9: c = a + b, chained a[i+1] = c[i] on rows 0..8
MUL_ROWS = range(10, 15)

# sha256 of the reference's proof of DemoCircuit at k = 5 with
# Srs.unsafe_setup(5, tau=987654321), instance [[3]] and
# rng=np.random.default_rng(7); the port's proof must equal it.
GOLDEN_TAU = 987654321
GOLDEN_SEED = 7
GOLDEN_SHA256 = "962e1792f8246ca5d9df549779d984e975344954eeb27b88606cb7f1706c9e36"
GOLDEN_LEN = 1792

# sha256 of the reference's proof of circuits/keccak.py::KeccakCircuit
# (Z_PER_ROW = 8) over KECCAK_GOLDEN_MESSAGES at k = 9 with
# Srs.unsafe_setup(9, tau=0xBE2C4), no instances and
# rng=np.random.default_rng(7); the port's proof must equal it.
KECCAK_GOLDEN_K = 9
KECCAK_GOLDEN_TAU = 0xBE2C4
KECCAK_GOLDEN_SEED = 7
KECCAK_GOLDEN_MESSAGES = (b"abc",)
KECCAK_GOLDEN_SHA256 = "61910750f7403e117d53a961c58cd2b9a42689ddf05b23d8089cf89e39c4aa5a"
KECCAK_GOLDEN_LEN = 139360

# The EVM circuit's k=9 proof: circuits/evm.py::EvmCircuit with
# EvmParams(target_steps=40, rw_target=256) over one transaction from
# EVM_GOLDEN_SENDER to EVM_GOLDEN_CONTRACT (no value, no calldata) running
# PUSH2 0xBEEF, PUSH1 7, MSTORE, PUSH1 7, MLOAD, PUSH1 5, ADD, POP, STOP,
# traced by tracer.Interpreter and replayed by CircuitInputBuilder, with
# Srs.unsafe_setup(9, tau=0xBE2C4), no instances and
# rng=np.random.default_rng(7): sha256 and length of the reference's proof
# (the JAX package on the CPU, native library built); the port's proof
# must equal it.
EVM_GOLDEN_K = 9
EVM_GOLDEN_TAU = 0xBE2C4
EVM_GOLDEN_SEED = 7
EVM_GOLDEN_SENDER = 0xCAFE
EVM_GOLDEN_CONTRACT = 0xC0DE
EVM_GOLDEN_CODE = bytes.fromhex("61beef6007526007516005015000")
EVM_GOLDEN_TARGET_STEPS = 40
EVM_GOLDEN_RW_TARGET = 256
EVM_GOLDEN_SHA256 = "487c95f60e07c8b469ba6ed3497d4176e47b759452a0f1f6bc94b226dfba6e0b"
EVM_GOLDEN_LEN = 134816


def _mont(vals):
    return F.from_ints([v % R * F.R % R for v in vals])


class DemoCircuit(Circuit):
    def __init__(self, corrupt_row: int | None = None):
        self.corrupt_row = corrupt_row

    def configure(self, cs: ConstraintSystem):
        self.qadd = cs.fixed_column()
        self.qmul = cs.fixed_column()
        self.qchain = cs.fixed_column()
        self.tbl = cs.fixed_column()
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.c = cs.advice_column()
        self.d = cs.advice_column()
        self.inst = cs.instance_column()
        cs.create_gate(
            "add", Fixed(self.qadd) * (Advice(self.a) + Advice(self.b) - Advice(self.c))
        )
        cs.create_gate(
            "mul", Fixed(self.qmul) * (Advice(self.a) * Advice(self.b) - Advice(self.c))
        )
        cs.create_gate(
            "chain", Fixed(self.qchain) * (Advice(self.a, 1) - Advice(self.c))
        )
        cs.lookup("range16", [(Advice(self.d), Fixed(self.tbl))])
        cs.enable_equality("advice", self.a)
        cs.enable_equality("advice", self.b)
        cs.enable_equality("advice", self.c)
        cs.enable_equality("instance", self.inst)

    def _witness(self, n):
        a = [0] * n
        b = [0] * n
        c = [0] * n
        a[0] = A_IN
        for i in range(N_ADD):
            b[i] = 2 * i + 1
            c[i] = (a[i] + b[i]) % R
            if i + 1 < n:
                a[i + 1] = c[i]
        for i in MUL_ROWS:
            a[i] = i + 2
            b[i] = 3 * i + 1
            c[i] = a[i] * b[i] % R
        # copy constraint target: b[20] must equal c[12]
        b[20] = c[12]
        if self.corrupt_row is not None:
            c[self.corrupt_row] = (c[self.corrupt_row] + 1) % R
        d = [i % 16 for i in range(n)]
        return a, b, c, d

    def fixed_columns(self, n):
        qadd = [1 if i < N_ADD else 0 for i in range(n)]
        qmul = [1 if i in MUL_ROWS else 0 for i in range(n)]
        qchain = [1 if i < N_ADD - 1 else 0 for i in range(n)]
        tbl = [i if i < 16 else 0 for i in range(n)]
        return np.stack([_mont(col) for col in (qadd, qmul, qchain, tbl)])

    def copy_constraints(self, n):
        return [
            (Cell("instance", self.inst, 0), Cell("advice", self.a, 0)),
            (Cell("advice", self.b, 20), Cell("advice", self.c, 12)),
        ]

    def synthesize(self, phase, n, challenges, instances):
        assert phase == 0
        a, b, c, d = self._witness(n)
        return {
            self.a: _mont(a),
            self.b: _mont(b),
            self.c: _mont(c),
            self.d: _mont(d),
        }


# ---------------------------------------------------------------------------
# The EVM's table partners at small k: the witnesses of the reference's own
# tests (tests/test_{exp,bytecode,tx,copy,rlp}_circuit.py; MulMod, which has
# no test of its own, takes the MULMOD/ADDMOD program of
# tests/test_super_circuit.py::test_super_circuit_mulmod_composed with an
# ADDMOD mod 0 and a full-width MULMOD added), each with
# Srs.unsafe_setup(k, tau=PARTNER_GOLDEN_TAU), no instances and
# rng=np.random.default_rng(PARTNER_GOLDEN_SEED).  PARTNER_GOLDENS holds
# each proof's sha256 and length, made by the reference (the JAX package on
# the CPU, native library built); the port's proof must equal it.

PARTNER_GOLDEN_TAU = 0xBE2C4
PARTNER_GOLDEN_SEED = 7
PARTNER_SENDER, PARTNER_CONTRACT = 0xCAFE, 0xC0DE
_M256 = 1 << 256

# (n, b, a) per MULMOD/ADDMOD step, pushed in that order: r = (a op b) mod n
MULMOD_GOLDEN_OPS = (
    ("MULMOD", 100, 23, 17),
    ("ADDMOD", 250, 0x1234, 99),
    ("ADDMOD", 0, 5, 7),
    ("MULMOD", _M256 - 189, _M256 - 3, _M256 - 5),
)
# (base, exponent) per EXP step (tests/test_exp_circuit.py)
EXP_GOLDEN_PAIRS = ((3, 5), (2**120 + 7, 2**130 + 3))
# tests/test_bytecode_circuit.py::_codes: PUSH1 5 PUSH2 0x1234 ADD STOP;
# PUSH1 7 DUP1 MUL POP STOP; a PUSH2 cut short by the end of the code
BYTECODE_GOLDEN_CODES = (
    bytes.fromhex("600561123401" "00"),
    bytes.fromhex("6007800250" "00"),
    bytes([0x61, 0xAB]),
)
# tests/test_tx_circuit.py::_txs: Transaction keyword arguments and the key
# that signs each
TX_GOLDEN_TXS = (
    (dict(nonce=0, to=0xBEEF, value=100, data=b"\x01\x02\x03", chain_id=1337),
     0x1111111111111111111111111111111111111111111111111111111111111111),
    (dict(nonce=5, to=None, value=0, data=b"\x60\x00", chain_id=1337),
     0x2222222222222222222222222222222222222222222222222222222222222222),
)
# tests/test_copy_circuit.py: CALLDATACOPY of 4 calldata bytes to memory 0
COPY_GOLDEN_CALLDATA = bytes([0xAA, 0xBB, 0xCC, 0xDD])
# tests/test_rlp_circuit.py: TX_SHORT, TX_LONG, TX_CREATE (unsigned)
RLP_GOLDEN_TXS = (
    dict(nonce=0, gas_price=10, gas=1_000_000, to=0xC0DE, value=0x1234,
         data=bytes([0xAA, 0xBB]), chain_id=1337),
    dict(nonce=7, gas_price=2**40 + 3, gas=21000, to=0xBEEF,
         value=2**128 + 5, data=bytes(range(40)), chain_id=1337),
    dict(nonce=1, gas_price=1, gas=53000, to=None, value=0, data=b"\x60\x01",
         chain_id=1),
)

# name: (k, sha256, proof length)
PARTNER_GOLDENS = {
    "mulmod": (9, "0cacc1d4cd1d0ab6802c2d1682fe7aefe5a082952ed24759b23557c5dbbf2959", 82816),
    "exp": (9, "be09b4c10329d3a66e51f65b53815d98f21319f997bc22d9f80e94eec4ea2fcf", 37856),
    "bytecode": (9, "57503aa58dd59ca412daa1d3949a4024ce2c7c40fb45fdcc25fa493cdfd42470", 2080),
    "tx": (9, "6235282f033a585c109b7342f95eb1ca29d758957616d43dd51e40024b156288", 2624),
    "copy": (7, "df37160d00641c8c2d23eec42e74edc53dfd2d936d0f5b15e016ef4d80c46c9c", 4928),
    "rlp": (11, "2ecb8fd41b91898b19948a649212d6fb83c74817dde1277e59e7d75f2ec43980", 8064),
}


def port_modules() -> dict:
    """This package's modules that partner_golden builds from."""
    from ..circuits import bytecode, copy, exp, mulmod, rlp, tx
    from .. import tracer, types
    from ..types import transaction
    from ..witness import builder

    return dict(types=types, transaction=transaction, tracer=tracer,
                builder=builder, mulmod=mulmod,
                exp=exp, bytecode=bytecode, tx=tx, copy=copy, rlp=rlp)


def partner_builder(m: dict, code: bytes, calldata: bytes = b""):
    """The builder after one transaction from PARTNER_SENDER to
    PARTNER_CONTRACT running `code` with `calldata`."""
    tr_ = m["tracer"]
    state = tr_.StateDB({PARTNER_SENDER: tr_.Account(balance=10**18),
                         PARTNER_CONTRACT: tr_.Account(code=code)})
    trace = tr_.Interpreter(state).run_tx(
        tr_.Tx(from_addr=PARTNER_SENDER, to=PARTNER_CONTRACT, data=calldata))
    assert not trace.failed
    b = m["builder"].CircuitInputBuilder()
    b.handle_tx(dict(from_addr=PARTNER_SENDER, to_addr=PARTNER_CONTRACT,
                     value=0, calldata=calldata), trace)
    return b


def partner_golden(name: str, m: dict | None = None):
    """The circuit of golden `name` (a key of PARTNER_GOLDENS), built from
    the modules `m` (default: port_modules(); another package's modules of
    the same names build the same witness there)."""
    m = m or port_modules()
    B = m["types"].Bytecode
    Transaction = m["transaction"].Transaction
    if name == "mulmod":
        code = B()
        for op, nn, b, a in MULMOD_GOLDEN_OPS:
            code.push(32, nn).push(32, b).push(32, a).op(op).op("POP")
        b = partner_builder(m, code.op("STOP").to_bytes())
        return m["mulmod"].MulModCircuit(b.mulmod_events)
    if name == "exp":
        code = B()
        for base, e in EXP_GOLDEN_PAIRS:
            code.push(32, e).push(32, base).op("EXP").op("POP")
        b = partner_builder(m, code.op("STOP").to_bytes())
        return m["exp"].ExpCircuit(b.exp_events)
    if name == "bytecode":
        return m["bytecode"].BytecodeCircuit([B(c) for c in BYTECODE_GOLDEN_CODES])
    if name == "tx":
        return m["tx"].TxCircuit([Transaction(**kw).sign(sk)
                                  for kw, sk in TX_GOLDEN_TXS])
    if name == "copy":
        data = COPY_GOLDEN_CALLDATA
        code = (B().push(1, len(data)).push(1, 0).push(1, 0)
                .op("CALLDATACOPY").op("STOP"))
        b = partner_builder(m, code.to_bytes(), data)
        return m["copy"].CopyCircuit(
            b.copy_events, rw_rows=b.rws.rws,
            tx_rows=[(1, i, byte) for i, byte in enumerate(data)])
    if name == "rlp":
        return m["rlp"].RlpCircuit([Transaction(**kw) for kw in RLP_GOLDEN_TXS])
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the precompile circuits' goldens: k=9 proofs (Srs.unsafe_setup(9,
# tau=PARTNER_GOLDEN_TAU), no instances, rng=np.random.default_rng(
# PARTNER_GOLDEN_SEED)) over the witnesses of the reference's tests, each
# proof's sha256 and length made by the reference (the JAX package on the
# CPU, native library built); the port's proof must equal it.  Sig has no
# golden: one signature needs k=13 (see service/bench_circuits.py).

# tests/test_sha256_circuit.py::MSGS: 1, 1 and 2 blocks
SHA256_GOLDEN_MESSAGES = (b"abc", b"", bytes(range(100)))
# (base, exponent, modulus) of tests/test_modexp_circuit.py::
# test_modexp_circuit_satisfied
MODEXP_GOLDEN_EVENTS = (
    (3, 5, 1009),
    (2**200 + 7, 2**130 + 3, (1 << 255) - 19),
    (2**255 + 17, 65537, 10**60 + 7),
)
# tests/test_ecc_circuit.py::test_ecadd_cases_satisfied: P = 5G, Q = 11G
ECC_GOLDEN_SCALARS = (5, 11)

# name: (k, sha256, proof length)
PRECOMPILE_GOLDENS = {
    "sha256": (9, "45c72fb2a0737ad50b2c767647ec55fba309987630d4aa8c4916c10878bfba7d", 25472),
    "modexp": (9, "13ee280e62d8f6941a05d3311c9da53ad1dc9489f580a94cc85da1246882763d", 98720),
    "ecc": (9, "8587ffa1b7065d47a9fcc0bb792d676b38744e097a44380bedbfca088421da4a", 110080),
}


def precompile_modules() -> dict:
    """This package's modules that precompile_golden builds from."""
    from ..circuits import ecc, modexp, sha256
    from ..crypto import curve, params

    return dict(sha256=sha256, modexp=modexp, ecc=ecc, curve=curve,
                params=params)


def precompile_golden(name: str, m: dict | None = None):
    """The circuit of golden `name` (a key of PRECOMPILE_GOLDENS), built
    from the modules `m` (default: precompile_modules(); another package's
    modules of the same names build the same witness there)."""
    m = m or precompile_modules()
    if name == "sha256":
        return m["sha256"].Sha256Circuit(list(SHA256_GOLDEN_MESSAGES))
    if name == "modexp":
        ev = m["modexp"].ModExpEvent
        return m["modexp"].ModExpCircuit([
            ev(base=b, exponent=e, modulus=n, result=pow(b, e, n) if n else 0)
            for b, e, n in MODEXP_GOLDEN_EVENTS])
    if name == "ecc":
        add, mul = m["curve"].host_g1_add, m["curve"].host_g1_mul
        gen, q = m["params"].G1_GEN, m["params"].FQ_MODULUS
        ev, O = m["ecc"].EcAddEvent, (0, 0)
        aff = lambda p: O if p is None else p  # noqa: E731
        P, Q = (mul(gen, s) for s in ECC_GOLDEN_SCALARS)
        return m["ecc"].EccCircuit(add_events=[
            ev(p=P, q=Q, r=aff(add(P, Q))),       # generic
            ev(p=P, q=P, r=aff(add(P, P))),       # double
            ev(p=P, q=(P[0], -P[1] % q), r=O),    # P + (-P)
            ev(p=O, q=Q, r=Q),                    # O + Q
            ev(p=P, q=O, r=P),                    # P + O
            ev(p=O, q=O, r=O),                    # O + O
        ])
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the Poseidon chain's goldens.  The k=5 DemoCircuit proved under the
# Poseidon transcript (tests/test_poseidon_transcript.py: Srs.unsafe_setup(
# 5, tau=GOLDEN_TAU), instance [[A_IN]], rng=np.random.default_rng(1),
# transcript=PoseidonTranscript()); and the Poseidon, MPT and PI circuits
# over the witnesses of the reference's tests, each with
# Srs.unsafe_setup(k, tau=PARTNER_GOLDEN_TAU), rng=np.random.default_rng(
# PARTNER_GOLDEN_SEED) and the Blake2b transcript (PI with its two
# instance values, the others with none).  Each sha256 and length is the
# reference's proof (the JAX package on the CPU, native library built);
# the port's proof must equal it.

POSEIDON_TRANSCRIPT_GOLDEN_SEED = 1
POSEIDON_TRANSCRIPT_GOLDEN_SHA256 = "d9306ead02536de048ce02998a479e8ae5295ed4e39ce4c5e17867a21aadb6c6"
POSEIDON_TRANSCRIPT_GOLDEN_LEN = 1792

# tests/test_poseidon.py::test_poseidon_circuit_satisfied: (domain, in0,
# in1) per permutation; the other five blocks of k=9 hash the zero state
POSEIDON_GOLDEN_EVENTS = ((0, 123, 456), (2 << 64, 7, 8))
# tests/test_mpt_circuit.py::_updates: trie pre-state (key, value), then
# the witnessed writes (a value update at depth 2, an insert into the
# empty slot at depth 1, an update of that key)
MPT_GOLDEN_PRESTATE = ((0b00, 5), (0b10, 6))
MPT_GOLDEN_WRITES = ((0b00, 55), (1, 77), (1, 88))
# tests/test_pi_circuit.py::_pd: chain id, prev_state_root, and the
# messages whose keccak digests are the other three roots
PI_GOLDEN_CHAIN_ID = 534352
PI_GOLDEN_PREV_ROOT = bytes(range(32))
PI_GOLDEN_DIGESTS_OF = (b"post", b"withdraw", b"data")

# name: (k, sha256, proof length)
CHAIN_GOLDENS = {
    "poseidon": (9, "3d4f122a8bd061d839e7323258e8f5c3bf531fa0286b3f78b41f7a44687bb68a", 1600),
    "mpt": (7, "450f9290807f26dd336dc8488637525ecf32997b508643477e3251944d135d09", 4160),
    "pi": (9, "54adb68a37de00ac85117a17ff30fc5dbef4e21126dac7ffd3a06db79110cba7", 8992),
}


def chain_modules() -> dict:
    """This package's modules that chain_golden builds from."""
    from ..circuits import mpt, pi, poseidon
    from ..crypto import keccak
    from ..witness import mpt as mpt_witness

    return dict(poseidon=poseidon, mpt=mpt, pi=pi, keccak=keccak,
                mpt_witness=mpt_witness)


def chain_golden(name: str, m: dict | None = None):
    """(circuit, instances) of golden `name` (a key of CHAIN_GOLDENS),
    built from the modules `m` (default: chain_modules(); another
    package's modules of the same names build the same witness there)."""
    m = m or chain_modules()
    if name == "poseidon":
        ev = m["poseidon"].PoseidonEvent
        return m["poseidon"].PoseidonCircuit(
            [ev(domain=d, in0=a, in1=b) for d, a, b in POSEIDON_GOLDEN_EVENTS]), []
    if name == "mpt":
        ups = m["mpt_witness"].MptUpdates()
        for key, value in MPT_GOLDEN_PRESTATE:
            ups.trie.update(key, value)
        for key, value in MPT_GOLDEN_WRITES:
            ups.write(key, value)
        return m["mpt"].MptCircuit(ups.updates), []
    if name == "pi":
        post, withdraw, data = (m["keccak"].keccak256(s) for s in PI_GOLDEN_DIGESTS_OF)
        pd = m["pi"].PublicData(
            chain_id=PI_GOLDEN_CHAIN_ID, prev_state_root=PI_GOLDEN_PREV_ROOT,
            post_state_root=post, withdraw_root=withdraw, data_hash=data)
        return m["pi"].PiCircuit(pd), [pd.instance()]
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the SuperCircuit's golden: tests/test_super_circuit.py::_witness(), one
# transaction signed with SUPER_GOLDEN_SK on chain SUPER_GOLDEN_CHAIN_ID to
# SUPER_GOLDEN_CONTRACT running PUSH1 5, PUSH2 0x1234, ADD, POP, STOP
# (code hash carried, so the bytecode binding is live), composed by
# SuperCircuit(b, [code], txs) with the default SuperParams and proved at
# k=9 with Srs.unsafe_setup(9, tau=PARTNER_GOLDEN_TAU), no instances,
# rng=np.random.default_rng(PARTNER_GOLDEN_SEED) and the Blake2b
# transcript.  SUPER_GOLDEN_SHA256 and SUPER_GOLDEN_LEN are the sha256 and
# length of the reference's proof (the JAX package on the CPU, native
# library built); the port's proof must equal it.

SUPER_GOLDEN_K = 9
SUPER_GOLDEN_CONTRACT = 0xC0DE
SUPER_GOLDEN_SK = int("33" * 32, 16)
SUPER_GOLDEN_CHAIN_ID = 1337
SUPER_GOLDEN_CODE = bytes.fromhex("600561123401" "5000")
SUPER_GOLDEN_SHA256 = "f5fb97b4143e361f44afbbc5d8b4a1c0cb86759d0f21b3e8c9d208d27a1e1dbc"
SUPER_GOLDEN_LEN = 175136


def super_modules() -> dict:
    """This package's modules that super_witness builds from."""
    from .. import tracer, types
    from ..circuits import super_circuit
    from ..crypto import keccak
    from ..types import transaction
    from ..witness import builder

    return dict(types=types, transaction=transaction, tracer=tracer,
                builder=builder, keccak=keccak, super_circuit=super_circuit)


def super_witness(m: dict | None = None):
    """(builder, [code], txs) of tests/test_super_circuit.py::_witness():
    one signed transaction to SUPER_GOLDEN_CONTRACT running
    SUPER_GOLDEN_CODE with the code hash carried, built from the modules
    `m` (default: super_modules(); another package's modules of the same
    names build the same witness there)."""
    m = m or super_modules()
    tr_ = m["tracer"]
    code = m["types"].Bytecode(SUPER_GOLDEN_CODE)
    tx = m["transaction"].Transaction(
        nonce=0, to=SUPER_GOLDEN_CONTRACT,
        chain_id=SUPER_GOLDEN_CHAIN_ID).sign(SUPER_GOLDEN_SK)
    sender = tx.recover_sender()
    state = tr_.StateDB({sender: tr_.Account(balance=10**18),
                         SUPER_GOLDEN_CONTRACT: tr_.Account(code=code.to_bytes())})
    trace = tr_.Interpreter(state).run_tx(
        tr_.Tx(from_addr=sender, to=SUPER_GOLDEN_CONTRACT))
    assert not trace.failed
    b = m["builder"].CircuitInputBuilder()
    b.handle_tx(dict(from_addr=sender, to_addr=SUPER_GOLDEN_CONTRACT, value=0,
                     calldata=b"",
                     code_hash=int.from_bytes(
                         m["keccak"].keccak256(code.to_bytes()), "big")), trace)
    return b, [code], [tx]


def super_golden(m: dict | None = None):
    """The golden's SuperCircuit, built from the modules `m` (default:
    super_modules())."""
    m = m or super_modules()
    b, codes, txs = super_witness(m)
    return m["super_circuit"].SuperCircuit(b, codes, txs)


# ---------------------------------------------------------------------------
# the recursion layer's goldens.  "compression" is the witness of
# tests/test_compression.py::test_compression_real_prove: DemoCircuit at
# k=5 proved with Srs.unsafe_setup(5, tau=GOLDEN_TAU), instance [[A_IN]],
# the Poseidon transcript and rng=np.random.default_rng(
# COMPRESSION_INNER_SEED); CompressionCircuit(vk, proof, [[A_IN]]) at its
# min_k() proved with Srs.unsafe_setup(k, tau=COMPRESSION_TAU),
# rng=np.random.default_rng(COMPRESSION_SEED) and the Blake2b transcript.
# "batch_hash" is BatchHashCircuit over tests/test_batch_hash.py::
# _mk_batch(3) at k=10, with [circuit.instance()], PARTNER_GOLDEN_TAU and
# PARTNER_GOLDEN_SEED.  Each sha256 and length is the reference's proof
# (the JAX package on the CPU, native library built); the port's proof
# must equal it.

COMPRESSION_INNER_SEED = 3
COMPRESSION_TAU = 777
COMPRESSION_SEED = 4
BATCH_HASH_CHAIN_ID = 534352

# name: (k, sha256, proof length)
RECURSION_GOLDENS = {
    "compression": (10, "c283df2b3c121d3e6e63da92aea2699721da145eafcafd1e31ea3b54922aa347", 2400),
    "batch_hash": (10, "2fca72a2f48f3c941658f93ac743f4d3310c31e2e252b4c36c6130eeb16a0497", 15648),
}


def recursion_modules() -> dict:
    """This package's modules that recursion_golden builds from."""
    from ..crypto import keccak
    from ..recursion import aggregation, batch_hash, compression

    return dict(aggregation=aggregation, batch_hash=batch_hash,
                compression=compression, keccak=keccak)


def mk_batch(m: dict, n_chunks: int = 3, chain_id: int = BATCH_HASH_CHAIN_ID):
    """tests/test_batch_hash.py::_mk_batch: a BatchHash of `n_chunks`
    chained chunks with keccak-derived roots, built from the modules `m`."""
    kk = m["keccak"].keccak256
    agg = m["aggregation"]
    roots = [int.from_bytes(kk(bytes([i])), "big") for i in range(n_chunks + 1)]
    return agg.BatchHash([
        agg.ChunkHash(
            chain_id=chain_id, prev_state_root=roots[i],
            post_state_root=roots[i + 1],
            withdraw_root=int.from_bytes(kk(b"w%d" % i), "big"),
            data_hash=int.from_bytes(kk(b"d%d" % i), "big"))
        for i in range(n_chunks)
    ])


def recursion_golden(name: str, m: dict | None = None, inner=None):
    """(circuit, instances) of golden `name` (a key of RECURSION_GOLDENS),
    built from the modules `m` (default: recursion_modules()).  The
    compression golden needs `inner` = (vk, proof) of its inner proof."""
    m = m or recursion_modules()
    if name == "compression":
        vk, proof = inner
        c = m["compression"].CompressionCircuit(vk, proof, [[A_IN]])
        return c, c.instances()
    if name == "batch_hash":
        c = m["batch_hash"].BatchHashCircuit(mk_batch(m))
        return c, [c.instance()]
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the testool's golden: the `sstoreGas` filler of tests/test_testool.py
# (1 + 1 stored to slot 0 of 0x095e...2d87, one signed transaction with
# value 100000) loaded by testool.load_json_fillers and run by
# testool.run_state_test at the prove level: the SuperCircuit that passed
# the MockProver at k=9, proved with Srs.unsafe_setup(9,
# tau=TESTOOL_GOLDEN_TAU), no instances, rng=np.random.default_rng(
# TESTOOL_GOLDEN_SEED) and the Blake2b transcript (CircuitsConfig's
# defaults).  TESTOOL_GOLDEN_SHA256 and TESTOOL_GOLDEN_LEN are the sha256
# and length of the reference's proof (the JAX package on the CPU through
# `chain_goldens.py jax testool`); the port's proof must equal it.

TESTOOL_GOLDEN_K = 9
TESTOOL_GOLDEN_TAU = 0xBEEF
TESTOOL_GOLDEN_SEED = 0x7E57
TESTOOL_GOLDEN_SHA256 = "15217dac8928b9b65203f4ae2dc1bfcae0e8b4cba90b829a85aebe8655b6e1d9"
TESTOOL_GOLDEN_LEN = 175136
TESTOOL_GOLDEN_FILLER = {
    "sstoreGas": {
        "env": {
            "currentCoinbase": "0x2adc25665018aa1fe0e6bc666dac8fc2697ff9ba",
            "currentGasLimit": "0x05f5e100",
            "currentNumber": "1",
            "currentTimestamp": "1000",
        },
        "pre": {
            "0x095e7baea6a6c7c4c2dfeb977efac326af552d87": {
                "balance": "1000000000000000000",
                "code": ":raw 0x600160010160005500",
                "nonce": "0",
                "storage": {},
            },
            "0xa94f5374fce5edbc8e2a8697c15331677e6ebf0b": {
                "balance": "1000000000000000000",
                "code": "0x",
                "nonce": "0",
                "storage": {},
            },
        },
        "transaction": {
            "data": ["0x"],
            "gasLimit": ["400000"],
            "gasPrice": "10",
            "nonce": "0",
            "secretKey": "0x45a915e4d060149eb4365960e6a7a45f334393093061116b197e3240065ff2d8",
            "sender": "0xa94f5374fce5edbc8e2a8697c15331677e6ebf0b",
            "to": "0x095e7baea6a6c7c4c2dfeb977efac326af552d87",
            "value": ["100000"],
        },
        "expect": [
            {
                "indexes": {"data": -1, "gas": -1, "value": -1},
                "result": {
                    "0x095e7baea6a6c7c4c2dfeb977efac326af552d87": {
                        "storage": {"0x00": "0x02"}
                    }
                },
            }
        ],
    }
}
