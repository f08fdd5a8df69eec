"""EVM interpreter producing geth-schema execution traces.

Replaces the reference's embedded geth tracer (`geth-utils/l2geth/
trace.go:1-266` builds an in-memory chain from a TraceConfig and runs the
tracer; SURVEY.md §2.3 item 2).  Shanghai-fork semantics: EIP-2929
warm/cold access costs, EIP-3529 refunds, EIP-3860 initcode metering,
PUSH0.  One step record per opcode, state snapshots BEFORE execution —
the exact shape bus-mapping replays.

Scope notes: precompiles 0x02 (sha256) and 0x04 (identity)
execute; others are recognized, gas-charged a flat cost, and return empty
success — extended together with the precompile circuits.

Port of zkevm_circuits_tpu/tracer/evm.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib

from ..crypto.keccak import keccak256
from ..types import rlp
from ..types.evm import (
    GasCost,
    OpcodeId,
    memory_expansion_gas,
    memory_word_size,
    opcode_from_byte,
)
from ..witness.trace import GethExecStep, GethExecTrace

U256 = (1 << 256) - 1
U255 = 1 << 255


def _signed(v: int) -> int:
    return v - (1 << 256) if v >= U255 else v


@dataclasses.dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    code: bytes = b""
    storage: dict[int, int] = dataclasses.field(default_factory=dict)

    def is_empty(self) -> bool:
        return self.nonce == 0 and self.balance == 0 and not self.code


class StateDB:
    def __init__(self, accounts: dict[int, Account] | None = None):
        self.accounts: dict[int, Account] = accounts or {}

    def account(self, addr: int) -> Account:
        if addr not in self.accounts:
            self.accounts[addr] = Account()
        return self.accounts[addr]

    def get_storage(self, addr: int, key: int) -> int:
        return self.account(addr).storage.get(key, 0)

    def set_storage(self, addr: int, key: int, val: int):
        st = self.account(addr).storage
        if val == 0:
            st.pop(key, None)
        else:
            st[key] = val

    def snapshot(self):
        return copy.deepcopy(self.accounts)

    def restore(self, snap):
        self.accounts = snap


@dataclasses.dataclass
class BlockEnv:
    coinbase: int = 0x2000000000000000000000000000000000000000
    number: int = 1
    timestamp: int = 1000
    gas_limit: int = 30_000_000
    base_fee: int = 7
    difficulty: int = 0
    chain_id: int = 1
    prev_hashes: dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Tx:
    from_addr: int
    to: int | None  # None => create
    gas: int = 1_000_000
    gas_price: int = 10
    value: int = 0
    data: bytes = b""
    nonce: int | None = None
    # EIP-2930: [(address, [storage_key, ...]), ...] — prewarmed at tx
    # start and charged intrinsic gas (2400/addr + 1900/key)
    access_list: list = dataclasses.field(default_factory=list)
    # EIP-1559 fee market: when max_fee_per_gas is set the effective
    # gas price is min(max_fee, base_fee + max_priority_fee)
    max_fee_per_gas: int | None = None
    max_priority_fee_per_gas: int = 0

    def effective_gas_price(self, base_fee: int) -> int:
        """geth core/state_transition.go effectiveGasPrice — pure; the
        interpreter never mutates the caller's Tx (it used to write
        tx.gas_price, which carried stale prices across blocks)."""
        if self.max_fee_per_gas is None:
            return self.gas_price
        return min(self.max_fee_per_gas,
                   base_fee + self.max_priority_fee_per_gas)


# ---- blake2f (EIP-152) compression -------------------------------------
_B2_IV = [0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
          0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
          0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179]
_B2_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _blake2f_compress(rounds, h, m, t, final):
    """The BLAKE2b F function (RFC 7693 §3.2), as the 0x09 precompile
    runs it (EIP-152: unkeyed, caller-chosen round count)."""
    M64 = (1 << 64) - 1
    v = h[:8] + _B2_IV[:8]
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= M64

    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & M64

    def G(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & M64
        v[d] = rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & M64
        v[b] = rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & M64
        v[d] = rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & M64
        v[b] = rotr(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _B2_SIGMA[r % 10]
        G(0, 4, 8, 12, m[s[0]], m[s[1]])
        G(1, 5, 9, 13, m[s[2]], m[s[3]])
        G(2, 6, 10, 14, m[s[4]], m[s[5]])
        G(3, 7, 11, 15, m[s[6]], m[s[7]])
        G(0, 5, 10, 15, m[s[8]], m[s[9]])
        G(1, 6, 11, 12, m[s[10]], m[s[11]])
        G(2, 7, 8, 13, m[s[12]], m[s[13]])
        G(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _g2_valid(pt) -> bool:
    """ecPairing G2 operand check: on the twist curve y^2 = x^3 + 3/(9+u)
    over Fq2 AND in the r-torsion subgroup (EIP-197 requires both)."""
    from ..crypto.params import FQ_MODULUS as q, FR_MODULUS as r_

    (xr, xi), (yr, yi) = pt
    # b2 = 3 / (9 + u) in Fq2
    d = (81 + 1) % q  # |9+u|^2 = 81 + 1
    dinv = pow(d, -1, q)
    b_r = (3 * 9 * dinv) % q
    b_i = (-3 * dinv) % q

    def f2mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % q,
                (a[0] * b[1] + a[1] * b[0]) % q)

    x2 = f2mul((xr, xi), (xr, xi))
    x3 = f2mul(x2, (xr, xi))
    y2 = f2mul((yr, yi), (yr, yi))
    on = (y2[0] - x3[0] - b_r) % q == 0 and (y2[1] - x3[1] - b_i) % q == 0
    if not on:
        return False
    from ..crypto import pairing as _pr

    return _pr.g2_scalar_mul(pt, r_) is None


class VmError(Exception):
    def __init__(self, name: str):
        self.name = name
        super().__init__(name)


@dataclasses.dataclass
class Frame:
    caller: int
    address: int  # storage/context address
    code_address: int  # whose code runs
    value: int
    calldata: bytes
    code: bytes
    gas: int
    depth: int
    is_static: bool
    is_create: bool = False
    stack: list[int] = dataclasses.field(default_factory=list)
    memory: bytearray = dataclasses.field(default_factory=bytearray)
    pc: int = 0
    return_data: bytes = b""

    def mem_words(self) -> int:
        return len(self.memory) // 32

    def expand_memory(self, end: int):
        if end > len(self.memory):
            new_words = memory_word_size(end)
            self.memory += bytearray(new_words * 32 - len(self.memory))


PRECOMPILE_RANGE = range(1, 10)


def _bn254_point(d: bytes):
    """64 input bytes -> affine point or None (infinity); raises
    ValueError off-curve (the precompile reverts)."""
    from ..crypto.params import FQ_MODULUS

    x = int.from_bytes(d[:32], "big")
    y = int.from_bytes(d[32:64], "big")
    if x == 0 and y == 0:
        return None
    if x >= FQ_MODULUS or y >= FQ_MODULUS:
        raise ValueError("coordinate out of range")
    if (y * y - x * x * x - 3) % FQ_MODULUS != 0:
        raise ValueError("point not on curve")
    return (x, y)
CREATE_CODE_DEPOSIT = 200
MAX_CODE_SIZE = 24576
MAX_INITCODE_SIZE = 2 * MAX_CODE_SIZE


class Interpreter:
    def __init__(self, state: StateDB, block: BlockEnv | None = None):
        self.state = state
        self.block = block or BlockEnv()

    # ---------------------------------------------------------------- tx level
    def run_tx(self, tx: Tx, capture_memory: bool = True) -> GethExecTrace:
        st = self.state
        self.logs: list = []
        self.steps: list[GethExecStep] = []
        self.refund = 0
        self.capture_memory = capture_memory
        self._tx_original = {}
        self._origin = tx.from_addr
        # EIP-1559 preCheck + effective gas price (geth
        # core/state_transition.go): reject ErrTipAboveFeeCap and
        # ErrFeeCapTooLow, then price = min(gasFeeCap, baseFee + tip);
        # legacy txs pass gas_price.  The Tx object is NOT mutated.
        if tx.max_fee_per_gas is not None:
            if tx.max_priority_fee_per_gas > tx.max_fee_per_gas:
                raise ValueError(
                    "max priority fee per gas higher than max fee per gas"
                )
            if tx.max_fee_per_gas < self.block.base_fee:
                raise ValueError("max fee per gas less than block base fee")
        gas_price = tx.effective_gas_price(self.block.base_fee)
        self._gas_price = gas_price
        self._revert_data = b""
        self._revert_gas = 0
        self.warm_addrs = {tx.from_addr, self.block.coinbase}
        self.warm_slots: set = set()
        for p in PRECOMPILE_RANGE:
            self.warm_addrs.add(p)
        sender = st.account(tx.from_addr)
        if tx.nonce is not None and sender.nonce != tx.nonce:
            raise ValueError("nonce mismatch")

        # EIP-2930 access-list prewarm (geth core/state_transition.go
        # Prepare): listed addresses + storage keys start warm
        for al_addr, al_keys in tx.access_list:
            self.warm_addrs.add(al_addr)
            for k in al_keys:
                self.warm_slots.add((al_addr, k))

        is_create = tx.to is None
        intrinsic = GasCost.TX + sum(
            GasCost.TX_DATA_ZERO if b == 0 else GasCost.TX_DATA_NONZERO
            for b in tx.data
        )
        intrinsic += sum(
            2400 + 1900 * len(keys) for _, keys in tx.access_list
        )
        if is_create:
            intrinsic += GasCost.CREATE
            intrinsic += GasCost.INIT_CODE_WORD * memory_word_size(len(tx.data))
        if tx.gas < intrinsic:
            raise ValueError("intrinsic gas too low")

        # geth buyGas: the balance check is against the FEE CAP (worst
        # case) + value, the deduction against the effective price
        cap = tx.max_fee_per_gas if tx.max_fee_per_gas is not None \
            else gas_price
        if sender.balance < tx.gas * cap + tx.value:
            raise ValueError("insufficient funds for gas * price + value")
        sender.balance -= tx.gas * gas_price
        sender.nonce += 1
        gas = tx.gas - intrinsic

        if is_create:
            to_addr = _create_address(tx.from_addr, sender.nonce - 1)
            self.warm_addrs.add(to_addr)
            ok, ret, gas_left = self._create_frame(
                tx.from_addr, to_addr, tx.value, tx.data, gas, 1
            )
        else:
            self.warm_addrs.add(tx.to)
            ok, ret, gas_left = self._call_frame(
                caller=tx.from_addr, address=tx.to, code_address=tx.to,
                value=tx.value, calldata=tx.data, gas=gas, depth=1,
                is_static=False, transfers_value=True,
            )

        gas_used = tx.gas - gas_left
        refund = min(self.refund, gas_used // 5)
        gas_used -= refund
        sender.balance += (tx.gas - gas_used) * gas_price
        st.account(self.block.coinbase).balance += gas_used * max(
            0, gas_price - self.block.base_fee
        )
        return GethExecTrace(
            gas=gas_used,
            failed=not ok,
            return_value=ret.hex(),
            struct_logs=self.steps,
        )

    # ---------------------------------------------------------------- frames
    def _transfer(self, frm: int, to: int, value: int):
        a = self.state.account(frm)
        if a.balance < value:
            raise VmError("insufficient balance")
        a.balance -= value
        self.state.account(to).balance += value

    def _call_frame(self, caller, address, code_address, value, calldata,
                    gas, depth, is_static, transfers_value) -> tuple:
        st = self.state
        snap = st.snapshot()
        warm_a, warm_s = set(self.warm_addrs), set(self.warm_slots)
        refund0 = self.refund
        try:
            if transfers_value and value:
                self._transfer(caller, address, value)
            if code_address in PRECOMPILE_RANGE:
                ok, ret, gas_left = self._precompile(code_address, calldata, gas)
                if not ok:
                    st.restore(snap)
                    self.warm_addrs, self.warm_slots = warm_a, warm_s
                    self.refund = refund0
                return ok, ret, gas_left
            code = st.account(code_address).code
            fr = Frame(
                caller=caller, address=address, code_address=code_address,
                value=value, calldata=calldata, code=code, gas=gas,
                depth=depth, is_static=is_static,
            )
            ret = self._execute(fr)
            return True, ret, fr.gas
        except VmError as e:
            if e.name == "revert":
                st.restore(snap)
                self.warm_addrs, self.warm_slots = warm_a, warm_s
                self.refund = refund0
                return False, self._revert_data, self._revert_gas
            st.restore(snap)
            self.warm_addrs, self.warm_slots = warm_a, warm_s
            self.refund = refund0
            return False, b"", 0

    def _create_frame(self, caller, new_addr, value, initcode, gas, depth):
        st = self.state
        snap = st.snapshot()
        warm_a, warm_s = set(self.warm_addrs), set(self.warm_slots)
        refund0 = self.refund
        try:
            existing = st.account(new_addr)
            if existing.nonce > 0 or existing.code:
                raise VmError("contract address collision")
            self._transfer(caller, new_addr, value)
            acct = st.account(new_addr)
            acct.nonce = 1
            fr = Frame(
                caller=caller, address=new_addr, code_address=new_addr,
                value=value, calldata=b"", code=initcode, gas=gas,
                depth=depth, is_static=False, is_create=True,
            )
            deployed = self._execute(fr)
            deposit = CREATE_CODE_DEPOSIT * len(deployed)
            if len(deployed) > MAX_CODE_SIZE:
                raise VmError("max code size exceeded")
            if deployed[:1] == b"\xef":
                raise VmError("invalid code: starts with 0xEF")
            if fr.gas < deposit:
                raise VmError("out of gas")
            fr.gas -= deposit
            acct.code = deployed
            return True, deployed, fr.gas
        except VmError as e:
            st.restore(snap)
            self.warm_addrs, self.warm_slots = warm_a, warm_s
            self.refund = refund0
            if e.name == "revert":
                return False, self._revert_data, self._revert_gas
            return False, b"", 0

    def _precompile(self, addr: int, data: bytes, gas: int) -> tuple:
        if addr == 4:  # identity
            cost = 15 + 3 * memory_word_size(len(data))
            if gas < cost:
                return False, b"", 0
            return True, data, gas - cost
        if addr == 2:  # sha256
            cost = 60 + 12 * memory_word_size(len(data))
            if gas < cost:
                return False, b"", 0
            return True, hashlib.sha256(data).digest(), gas - cost
        if addr == 1:  # ecrecover
            cost = 3000
            if gas < cost:
                return False, b"", 0
            d = data.ljust(128, b"\x00")[:128]
            h, v = d[:32], int.from_bytes(d[32:64], "big")
            r = int.from_bytes(d[64:96], "big")
            s = int.from_bytes(d[96:128], "big")
            from ..crypto import secp256k1 as secp

            if v not in (27, 28) or not (0 < r < secp.N and 0 < s < secp.N):
                return True, b"", gas - cost
            try:
                pub = secp.recover(h, r, s, v - 27)
            except Exception:
                return True, b"", gas - cost
            if pub is None:
                return True, b"", gas - cost
            from ..crypto.keccak import keccak256

            pb = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
            out = b"\x00" * 12 + keccak256(pb)[12:]
            return True, out, gas - cost
        if addr == 6:  # BN254 add
            cost = 150
            if gas < cost:
                return False, b"", 0
            d = data.ljust(128, b"\x00")[:128]
            try:
                p, q = _bn254_point(d[:64]), _bn254_point(d[64:128])
            except ValueError:
                return False, b"", 0
            from ..crypto.curve import host_g1_add

            r_ = host_g1_add(p, q) if p and q else (p or q)
            out = (b"\x00" * 64 if r_ is None else
                   r_[0].to_bytes(32, "big") + r_[1].to_bytes(32, "big"))
            return True, out, gas - cost
        if addr == 7:  # BN254 scalar mul
            cost = 6000
            if gas < cost:
                return False, b"", 0
            d = data.ljust(96, b"\x00")[:96]
            try:
                p = _bn254_point(d[:64])
            except ValueError:
                return False, b"", 0
            k = int.from_bytes(d[64:96], "big")
            from ..crypto.curve import host_g1_mul

            r_ = host_g1_mul(p, k) if p and k else None
            out = (b"\x00" * 64 if r_ is None else
                   r_[0].to_bytes(32, "big") + r_[1].to_bytes(32, "big"))
            return True, out, gas - cost
        if addr == 5:  # modexp, EIP-2565 gas, any operand lengths
            d = data.ljust(96, b"\x00")
            bsize = int.from_bytes(d[:32], "big")
            esize = int.from_bytes(d[32:64], "big")
            msize = int.from_bytes(d[64:96], "big")
            if max(bsize, esize, msize) > (1 << 20):
                return False, b"", 0  # absurd sizes: OOG like geth
            body = data[96:].ljust(bsize + esize + msize, b"\x00")
            e_head = int.from_bytes(
                body[bsize : bsize + min(esize, 32)], "big"
            )
            # EIP-2565 (core/vm/contracts.go modexp gas)
            words = (max(bsize, msize) + 7) // 8
            mult_c = words * words
            if esize <= 32:
                iters = max(e_head.bit_length() - 1, 0)
            else:
                iters = 8 * (esize - 32) + max(e_head.bit_length() - 1, 0)
            cost = max(200, mult_c * max(iters, 1) // 3)
            if gas < cost:
                return False, b"", 0
            b_ = int.from_bytes(body[:bsize], "big")
            e_ = int.from_bytes(body[bsize : bsize + esize], "big")
            m_ = int.from_bytes(body[bsize + esize :], "big")
            out_v = pow(b_, e_, m_) if m_ else 0
            return True, out_v.to_bytes(msize, "big"), gas - cost
        if addr == 3:  # ripemd160 (EIP-152-era geth gas schedule)
            cost = 600 + 120 * memory_word_size(len(data))
            if gas < cost:
                return False, b"", 0
            digest = hashlib.new("ripemd160", data).digest()
            return True, b"\x00" * 12 + digest, gas - cost
        if addr == 9:  # blake2f (EIP-152)
            if len(data) != 213 or data[212] not in (0, 1):
                return False, b"", 0  # malformed input: error like geth
            rounds = int.from_bytes(data[:4], "big")
            if gas < rounds:
                return False, b"", 0
            h = [int.from_bytes(data[4 + 8 * i : 12 + 8 * i], "little")
                 for i in range(8)]
            m = [int.from_bytes(data[68 + 8 * i : 76 + 8 * i], "little")
                 for i in range(16)]
            t = [int.from_bytes(data[196:204], "little"),
                 int.from_bytes(data[204:212], "little")]
            out = _blake2f_compress(rounds, h, m, t, data[212] == 1)
            return True, b"".join(
                v.to_bytes(8, "little") for v in out
            ), gas - rounds
        if addr == 8:  # ecPairing (EIP-197)
            k, rem = divmod(len(data), 192)
            if rem:
                return False, b"", 0
            cost = 45000 + 34000 * k
            if gas < cost:
                return False, b"", 0
            from ..crypto import pairing as _pr
            from ..crypto.params import FQ_MODULUS as _Q

            pairs = []
            for i in range(k):
                seg = data[192 * i : 192 * (i + 1)]
                x1 = int.from_bytes(seg[:32], "big")
                y1 = int.from_bytes(seg[32:64], "big")
                # G2 coords on the wire: (x_imag, x_real, y_imag, y_real)
                xi = int.from_bytes(seg[64:96], "big")
                xr = int.from_bytes(seg[96:128], "big")
                yi = int.from_bytes(seg[128:160], "big")
                yr = int.from_bytes(seg[160:192], "big")
                if max(x1, y1, xi, xr, yi, yr) >= _Q:
                    return False, b"", 0
                g1 = None if (x1 | y1) == 0 else (x1, y1)
                if g1 is not None and \
                        (y1 * y1 - x1 * x1 * x1 - 3) % _Q != 0:
                    return False, b"", 0
                g2 = None if (xi | xr | yi | yr) == 0 \
                    else ((xr, xi), (yr, yi))
                if g2 is not None and not _g2_valid(g2):
                    return False, b"", 0
                if g1 is not None and g2 is not None:
                    pairs.append((g1, g2))
            ok = _pr.pairing_product_is_one(pairs)
            return True, int(ok).to_bytes(32, "big"), gas - cost
        # remaining precompiles (0x0a+ point evaluation): flat stub
        cost = 100
        if gas < cost:
            return False, b"", 0
        return True, b"", gas - cost

    # ---------------------------------------------------------------- step loop
    def _execute(self, fr: Frame) -> bytes:
        while True:
            if fr.pc >= len(fr.code):
                # implicit STOP: geth fetches byte 0 past the code end and
                # logs a STOP step (core/vm Contract.GetOp out-of-bounds
                # semantics).  Empty-code frames emit no steps at all —
                # geth never enters the interpreter for them.
                if fr.code:
                    self.steps.append(GethExecStep(
                        pc=fr.pc, op=OpcodeId.STOP, gas=fr.gas, gas_cost=0,
                        depth=fr.depth, refund=self.refund,
                        stack=list(fr.stack),
                        memory=(bytes(fr.memory) if self.capture_memory
                                else b""),
                    ))
                return b""
            byte = fr.code[fr.pc]
            op = opcode_from_byte(byte)
            step = GethExecStep(
                pc=fr.pc,
                op=op if op is not None else OpcodeId.INVALID,
                gas=fr.gas,
                gas_cost=0,
                depth=fr.depth,
                refund=self.refund,
                stack=list(fr.stack),
                memory=bytes(fr.memory) if self.capture_memory else b"",
            )
            self.steps.append(step)
            try:
                if op is None:
                    raise VmError("invalid opcode")
                if len(fr.stack) < op.pops:
                    raise VmError("stack underflow")
                if len(fr.stack) + op.pushes - op.pops > 1024:
                    raise VmError("stack overflow")
                gas_before = fr.gas
                done = self._step(fr, op)
                step.gas_cost = gas_before - fr.gas
                if done is not None:
                    return done
            except VmError as e:
                step.error = e.name
                if e.name == "revert":
                    step.gas_cost = 0
                raise

    def _use_gas(self, fr: Frame, amount: int):
        if fr.gas < amount:
            raise VmError("out of gas")
        fr.gas -= amount

    def _mem_gas(self, fr: Frame, offset: int, length: int):
        """Charge memory expansion and expand."""
        if length == 0:
            return
        end = offset + length
        if end > 0x1FFFFFFFE0:
            raise VmError("gas uint64 overflow")
        cur_w = fr.mem_words()
        new_w = memory_word_size(end)
        self._use_gas(fr, memory_expansion_gas(cur_w, new_w))
        fr.expand_memory(end)

    def _touch_addr(self, fr: Frame, addr: int) -> int:
        """EIP-2929 account access; returns gas cost."""
        if addr in self.warm_addrs:
            return GasCost.WARM_ACCESS
        self.warm_addrs.add(addr)
        return GasCost.COLD_ACCOUNT_ACCESS

    def _step(self, fr: Frame, op: OpcodeId):
        st = self.state
        stack = fr.stack
        push = stack.append
        pop = stack.pop

        if op.is_push:  # incl. PUSH0 (Shanghai): push_len 0 -> pushes 0
            self._use_gas(fr, op.constant_gas)
            n = op.push_len
            val = int.from_bytes(fr.code[fr.pc + 1 : fr.pc + 1 + n], "big")
            push(val)
            fr.pc += 1 + n
            return None
        if op.is_dup:
            self._use_gas(fr, 3)
            push(stack[-(op - 0x7F)])
            fr.pc += 1
            return None
        if op.is_swap:
            self._use_gas(fr, 3)
            i = op - 0x8F
            stack[-1], stack[-1 - i] = stack[-1 - i], stack[-1]
            fr.pc += 1
            return None

        fr.pc += 1
        name = op.name

        # -- halting ---------------------------------------------------------
        if op == OpcodeId.STOP:
            return b""
        if op == OpcodeId.RETURN:
            off, ln = pop(), pop()
            self._mem_gas(fr, off, ln)
            return bytes(fr.memory[off : off + ln])
        if op == OpcodeId.REVERT:
            off, ln = pop(), pop()
            self._mem_gas(fr, off, ln)
            self._revert_data = bytes(fr.memory[off : off + ln])
            self._revert_gas = fr.gas
            raise VmError("revert")

        # -- arithmetic / bitwise ------------------------------------------------
        simple = {
            "ADD": lambda a, b: (a + b) & U256,
            "MUL": lambda a, b: (a * b) & U256,
            "SUB": lambda a, b: (a - b) & U256,
            "DIV": lambda a, b: a // b if b else 0,
            "MOD": lambda a, b: a % b if b else 0,
            "SDIV": lambda a, b: (
                0 if b == 0 else (abs(_signed(a)) // abs(_signed(b)))
                * (1 if (_signed(a) < 0) == (_signed(b) < 0) else -1) & U256
            ),
            "SMOD": lambda a, b: (
                0 if b == 0 else
                ((abs(_signed(a)) % abs(_signed(b))) * (1 if _signed(a) >= 0 else -1))
                & U256
            ),
            "LT": lambda a, b: int(a < b),
            "GT": lambda a, b: int(a > b),
            "SLT": lambda a, b: int(_signed(a) < _signed(b)),
            "SGT": lambda a, b: int(_signed(a) > _signed(b)),
            "EQ": lambda a, b: int(a == b),
            "AND": lambda a, b: a & b,
            "OR": lambda a, b: a | b,
            "XOR": lambda a, b: a ^ b,
            "BYTE": lambda i, x: (x >> (8 * (31 - i))) & 0xFF if i < 32 else 0,
            "SHL": lambda s, v: (v << s) & U256 if s < 256 else 0,
            "SHR": lambda s, v: v >> s if s < 256 else 0,
            "SAR": lambda s, v: (
                (_signed(v) >> min(s, 255)) & U256
            ),
            "SIGNEXTEND": lambda b, x: (
                x if b >= 31 else (
                    (x | (U256 ^ ((1 << (8 * (b + 1))) - 1)))
                    if x & (1 << (8 * (b + 1) - 1))
                    else x & ((1 << (8 * (b + 1))) - 1)
                )
            ),
        }
        if name in simple:
            self._use_gas(fr, op.constant_gas)
            a = pop()
            b = pop()
            push(simple[name](a, b) & U256)
            return None
        if op == OpcodeId.ADDMOD:
            self._use_gas(fr, 8)
            a, b, m = pop(), pop(), pop()
            push((a + b) % m if m else 0)
            return None
        if op == OpcodeId.MULMOD:
            self._use_gas(fr, 8)
            a, b, m = pop(), pop(), pop()
            push((a * b) % m if m else 0)
            return None
        if op == OpcodeId.EXP:
            base, exp = pop(), pop()
            nbytes = (exp.bit_length() + 7) // 8
            self._use_gas(fr, GasCost.EXP + GasCost.EXP_BYTE * nbytes)
            push(pow(base, exp, 1 << 256))
            return None
        if op in (OpcodeId.ISZERO, OpcodeId.NOT):
            self._use_gas(fr, 3)
            a = pop()
            push(int(a == 0) if op == OpcodeId.ISZERO else a ^ U256)
            return None
        if op == OpcodeId.POP:
            self._use_gas(fr, 2)
            pop()
            return None

        # -- sha3 --------------------------------------------------------------
        if op == OpcodeId.SHA3:
            off, ln = pop(), pop()
            self._use_gas(
                fr, GasCost.KECCAK256 + GasCost.KECCAK256_WORD * memory_word_size(ln)
            )
            self._mem_gas(fr, off, ln)
            push(int.from_bytes(keccak256(bytes(fr.memory[off : off + ln])), "big"))
            return None

        # -- context -------------------------------------------------------------
        ctx = {
            "ADDRESS": lambda: fr.address,
            "ORIGIN": lambda: self._origin,
            "CALLER": lambda: fr.caller,
            "CALLVALUE": lambda: fr.value,
            "CALLDATASIZE": lambda: len(fr.calldata),
            "CODESIZE": lambda: len(fr.code),
            "GASPRICE": lambda: self._gas_price,
            "RETURNDATASIZE": lambda: len(fr.return_data),
            "COINBASE": lambda: self.block.coinbase,
            "TIMESTAMP": lambda: self.block.timestamp,
            "NUMBER": lambda: self.block.number,
            "DIFFICULTY": lambda: self.block.difficulty,
            "GASLIMIT": lambda: self.block.gas_limit,
            "CHAINID": lambda: self.block.chain_id,
            "BASEFEE": lambda: self.block.base_fee,
            "PC": lambda: fr.pc - 1,
            "MSIZE": lambda: len(fr.memory),
            "GAS": lambda: fr.gas,  # constant gas already charged
        }
        if name in ctx:
            self._use_gas(fr, op.constant_gas)
            push(ctx[name]() & U256)
            return None
        if op == OpcodeId.SELFBALANCE:
            self._use_gas(fr, 5)
            push(st.account(fr.address).balance)
            return None
        if op == OpcodeId.BALANCE:
            addr = pop() & ((1 << 160) - 1)
            self._use_gas(fr, self._touch_addr(fr, addr))
            push(st.account(addr).balance)
            return None
        if op == OpcodeId.EXTCODESIZE:
            addr = pop() & ((1 << 160) - 1)
            self._use_gas(fr, self._touch_addr(fr, addr))
            push(len(st.account(addr).code))
            return None
        if op == OpcodeId.EXTCODEHASH:
            addr = pop() & ((1 << 160) - 1)
            self._use_gas(fr, self._touch_addr(fr, addr))
            acct = st.account(addr)
            push(0 if acct.is_empty() else int.from_bytes(keccak256(acct.code), "big"))
            return None
        if op == OpcodeId.BLOCKHASH:
            self._use_gas(fr, 20)
            num = pop()
            push(self.block.prev_hashes.get(num, 0))
            return None

        if op == OpcodeId.CALLDATALOAD:
            self._use_gas(fr, 3)
            off = pop()
            data = fr.calldata[off : off + 32] if off < len(fr.calldata) else b""
            push(int.from_bytes(data.ljust(32, b"\x00"), "big"))
            return None

        # -- copies -------------------------------------------------------------
        if op in (OpcodeId.CALLDATACOPY, OpcodeId.CODECOPY, OpcodeId.RETURNDATACOPY):
            dst, src, ln = pop(), pop(), pop()
            self._use_gas(fr, 3 + GasCost.COPY * memory_word_size(ln))
            self._mem_gas(fr, dst, ln)
            source = {
                OpcodeId.CALLDATACOPY: fr.calldata,
                OpcodeId.CODECOPY: fr.code,
                OpcodeId.RETURNDATACOPY: fr.return_data,
            }[op]
            if op == OpcodeId.RETURNDATACOPY and src + ln > len(source):
                raise VmError("return data out of bounds")
            chunk = bytes(source[src : src + ln]).ljust(ln, b"\x00")
            fr.memory[dst : dst + ln] = chunk
            return None
        if op == OpcodeId.EXTCODECOPY:
            addr = pop() & ((1 << 160) - 1)
            dst, src, ln = pop(), pop(), pop()
            self._use_gas(fr, self._touch_addr(fr, addr))
            self._use_gas(fr, GasCost.COPY * memory_word_size(ln))
            self._mem_gas(fr, dst, ln)
            code = st.account(addr).code
            fr.memory[dst : dst + ln] = bytes(code[src : src + ln]).ljust(ln, b"\x00")
            return None

        # -- memory ---------------------------------------------------------------
        if op == OpcodeId.MLOAD:
            self._use_gas(fr, 3)
            off = pop()
            self._mem_gas(fr, off, 32)
            push(int.from_bytes(fr.memory[off : off + 32], "big"))
            return None
        if op == OpcodeId.MSTORE:
            self._use_gas(fr, 3)
            off, val = pop(), pop()
            self._mem_gas(fr, off, 32)
            fr.memory[off : off + 32] = val.to_bytes(32, "big")
            return None
        if op == OpcodeId.MSTORE8:
            self._use_gas(fr, 3)
            off, val = pop(), pop()
            self._mem_gas(fr, off, 1)
            fr.memory[off] = val & 0xFF
            return None

        # -- storage ----------------------------------------------------------------
        if op == OpcodeId.SLOAD:
            key = pop()
            slot = (fr.address, key)
            if slot in self.warm_slots:
                self._use_gas(fr, GasCost.WARM_ACCESS)
            else:
                self.warm_slots.add(slot)
                self._use_gas(fr, GasCost.COLD_SLOAD)
            push(st.get_storage(fr.address, key))
            return None
        if op == OpcodeId.SSTORE:
            if fr.is_static:
                raise VmError("write protection")
            if fr.gas <= GasCost.CALL_STIPEND:
                raise VmError("out of gas")
            key, val = pop(), pop()
            slot = (fr.address, key)
            cost = 0
            if slot not in self.warm_slots:
                self.warm_slots.add(slot)
                cost += GasCost.COLD_SLOAD
            cur = st.get_storage(fr.address, key)
            orig = getattr(self, "_tx_original", {}).get(slot, None)
            if orig is None:
                orig = cur
                self._tx_original.setdefault(slot, cur)
            if cur == val:
                cost += GasCost.WARM_ACCESS
            elif cur == orig:
                cost += (
                    GasCost.SSTORE_SET if orig == 0 else GasCost.SSTORE_RESET
                )
                if val == 0 and orig != 0:
                    self.refund += GasCost.SSTORE_CLEARS_SCHEDULE
            else:
                cost += GasCost.WARM_ACCESS
                # refund bookkeeping for dirty slots (EIP-3529 rules)
                if orig != 0:
                    if cur == 0:
                        self.refund -= GasCost.SSTORE_CLEARS_SCHEDULE
                    if val == 0:
                        self.refund += GasCost.SSTORE_CLEARS_SCHEDULE
                if val == orig:
                    if orig == 0:
                        self.refund += GasCost.SSTORE_SET - GasCost.WARM_ACCESS
                    else:
                        self.refund += GasCost.SSTORE_RESET - GasCost.WARM_ACCESS
            self._use_gas(fr, cost)
            st.set_storage(fr.address, key, val)
            return None

        # -- control ----------------------------------------------------------------
        if op == OpcodeId.JUMP:
            self._use_gas(fr, 8)
            dst = pop()
            self._jump(fr, dst)
            return None
        if op == OpcodeId.JUMPI:
            self._use_gas(fr, 10)
            dst, cond = pop(), pop()
            if cond:
                self._jump(fr, dst)
            return None
        if op == OpcodeId.JUMPDEST:
            self._use_gas(fr, 1)
            return None

        # -- logs ------------------------------------------------------------------
        if op.is_log:
            if fr.is_static:
                raise VmError("write protection")
            ntopics = op - 0xA0
            off, ln = pop(), pop()
            topics = [pop() for _ in range(ntopics)]
            self._use_gas(
                fr,
                GasCost.LOG + GasCost.LOG_TOPIC * ntopics + GasCost.LOG_DATA * ln,
            )
            self._mem_gas(fr, off, ln)
            self.logs.append(
                dict(address=fr.address, topics=topics,
                     data=bytes(fr.memory[off : off + ln]))
            )
            return None

        # -- calls / creates -----------------------------------------------------------
        if op.is_call:
            return self._op_call(fr, op)
        if op.is_create:
            return self._op_create(fr, op)

        if op == OpcodeId.SELFDESTRUCT:
            if fr.is_static:
                raise VmError("write protection")
            ben = pop() & ((1 << 160) - 1)
            cost = GasCost.SELFDESTRUCT
            if ben not in self.warm_addrs:
                self.warm_addrs.add(ben)
                cost += GasCost.COLD_ACCOUNT_ACCESS
            acct = st.account(fr.address)
            if acct.balance and st.account(ben).is_empty():
                cost += GasCost.NEW_ACCOUNT
            self._use_gas(fr, cost)
            st.account(ben).balance += acct.balance
            acct.balance = 0
            return b""

        if op == OpcodeId.INVALID:
            raise VmError("invalid opcode")
        raise VmError(f"unimplemented opcode {op.name}")

    def _jump(self, fr: Frame, dst: int):
        if dst >= len(fr.code) or fr.code[dst] != int(OpcodeId.JUMPDEST):
            raise VmError("invalid jump destination")
        # must not be push data
        i = 0
        while i < dst:
            opc = opcode_from_byte(fr.code[i])
            i += 1 + (opc.push_len if opc is not None and opc.is_push_with_data else 0)
        if i != dst:
            raise VmError("invalid jump destination")
        fr.pc = dst

    def _op_call(self, fr: Frame, op: OpcodeId):
        gas_req = fr.stack.pop()
        addr = fr.stack.pop() & ((1 << 160) - 1)
        value = fr.stack.pop() if op in (OpcodeId.CALL, OpcodeId.CALLCODE) else 0
        in_off, in_len = fr.stack.pop(), fr.stack.pop()
        out_off, out_len = fr.stack.pop(), fr.stack.pop()
        if fr.is_static and value and op == OpcodeId.CALL:
            raise VmError("write protection")

        self._use_gas(fr, self._touch_addr(fr, addr))
        self._mem_gas(fr, in_off, in_len)
        self._mem_gas(fr, out_off, out_len)
        extra = 0
        if value:
            extra += GasCost.CALL_VALUE
            if op == OpcodeId.CALL and self.state.account(addr).is_empty():
                extra += GasCost.NEW_ACCOUNT
        self._use_gas(fr, extra)

        avail = fr.gas - fr.gas // 64
        gas_fwd = min(gas_req, avail)
        self._use_gas(fr, gas_fwd)
        if value:
            gas_fwd += GasCost.CALL_STIPEND

        calldata = bytes(fr.memory[in_off : in_off + in_len])
        if fr.depth >= 1024 or (
            value and self.state.account(fr.address).balance < value
        ):
            # geth returns the forwarded gas untouched in these cases
            ok, ret, gas_left = False, b"", gas_fwd
        else:
            kwargs = dict(
                calldata=calldata, gas=gas_fwd, depth=fr.depth + 1,
            )
            if op == OpcodeId.CALL:
                ok, ret, gas_left = self._call_frame(
                    caller=fr.address, address=addr, code_address=addr,
                    value=value, is_static=fr.is_static,
                    transfers_value=True, **kwargs)
            elif op == OpcodeId.CALLCODE:
                ok, ret, gas_left = self._call_frame(
                    caller=fr.address, address=fr.address, code_address=addr,
                    value=value, is_static=fr.is_static,
                    transfers_value=False, **kwargs)
            elif op == OpcodeId.DELEGATECALL:
                ok, ret, gas_left = self._call_frame(
                    caller=fr.caller, address=fr.address, code_address=addr,
                    value=fr.value, is_static=fr.is_static,
                    transfers_value=False, **kwargs)
            else:  # STATICCALL
                ok, ret, gas_left = self._call_frame(
                    caller=fr.address, address=addr, code_address=addr,
                    value=0, is_static=True, transfers_value=False, **kwargs)
        fr.gas += gas_left
        fr.return_data = ret
        n = min(out_len, len(ret))
        fr.memory[out_off : out_off + n] = ret[:n]
        fr.stack.append(int(ok))
        return None

    def _op_create(self, fr: Frame, op: OpcodeId):
        if fr.is_static:
            raise VmError("write protection")
        value = fr.stack.pop()
        off, ln = fr.stack.pop(), fr.stack.pop()
        salt = fr.stack.pop() if op == OpcodeId.CREATE2 else None
        if ln > MAX_INITCODE_SIZE:
            raise VmError("max initcode size exceeded")
        self._use_gas(fr, GasCost.INIT_CODE_WORD * memory_word_size(ln))
        if op == OpcodeId.CREATE2:
            self._use_gas(fr, GasCost.KECCAK256_WORD * memory_word_size(ln))
        self._mem_gas(fr, off, ln)
        initcode = bytes(fr.memory[off : off + ln])

        acct = self.state.account(fr.address)
        avail = fr.gas - fr.gas // 64
        self._use_gas(fr, avail)
        if fr.depth >= 1024 or acct.balance < value:
            # depth/balance checks precede the nonce bump (geth order)
            fr.gas += avail
            fr.return_data = b""
            fr.stack.append(0)
            return None
        if op == OpcodeId.CREATE:
            new_addr = _create_address(fr.address, acct.nonce)
        else:
            new_addr = _create2_address(fr.address, salt, initcode)
        acct.nonce += 1
        self.warm_addrs.add(new_addr)
        ok, ret, gas_left = self._create_frame(
            fr.address, new_addr, value, initcode, avail, fr.depth + 1
        )
        fr.gas += gas_left
        fr.return_data = b"" if ok else ret
        fr.stack.append(new_addr if ok else 0)
        return None

def _create_address(sender: int, nonce: int) -> int:
    payload = rlp.encode([sender.to_bytes(20, "big"), nonce])
    return int.from_bytes(keccak256(payload)[12:], "big")


def _create2_address(sender: int, salt: int, initcode: bytes) -> int:
    buf = b"\xff" + sender.to_bytes(20, "big") + salt.to_bytes(32, "big")
    buf += keccak256(initcode)
    return int.from_bytes(keccak256(buf)[12:], "big")
