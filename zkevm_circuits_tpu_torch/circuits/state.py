"""State circuit (port of zkevm_circuits_tpu/circuits/state.py): proves
the RW table is sorted and consistent.

Equivalent of the reference's `zkevm-circuits/src/state_circuit.rs`
(SURVEY.md §2.2 "State"): lexicographic ordering over (tag, id, address,
field_tag, storage_key, rw_counter), limb range checks, and
read-after-write consistency.

Design decisions (vs the reference's chips):
  * Ordering: the key is decomposed into `limb_bits`-bit limbs (most
    significant first).  Per adjacent row pair the witness carries a
    one-hot indicator of the FIRST differing limb plus the limb
    difference; three vectorized gate families replace the reference's
    BinaryNumber chip + per-limb chain.
  * All range checks ride ONE logUp argument (every limb column + the
    diff column into a single 2^limb_bits fixed table) — the reference
    needs a permuted-column halo2 lookup per limb family.
  * 256-bit values are exposed as byte-RLC under the phase-1 challenge
    (reference convention); ordering uses plain key limbs.
  * Padding rows carry RwTag.Padding (sorts last, rw_counter keeps
    incrementing) so fixed selectors are static for any witness size —
    the variadic-size property the reference tests in
    integration_test_circuits.rs:291-309.

Field widths are parameters (`StateParams`) — tests shrink address/key
widths so the column count stays CPU-testable; production uses full
widths.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Circuit, ConstraintSystem
from ..plonk.expression import Advice, Expression, Fixed
from ..witness.rw import CallContextField, Rw, RwMap, RwTag

F = fr()


@dataclasses.dataclass
class StateParams:
    limb_bits: int = 16
    id_bits: int = 32
    addr_bits: int = 160
    key_bits: int = 256
    rwc_bits: int = 32
    field_bits: int = 8  # field_tag width (CallContextField reaches 21)
    target_rows: int = 0  # 0 => fill usable rows

    def limb_counts(self):
        lb = self.limb_bits
        ceil = lambda b: -(-b // lb)
        # (field name, limb count), most significant field first
        return [
            ("tag", 1),
            ("id", ceil(self.id_bits)),
            ("address", ceil(self.addr_bits)),
            ("field_tag", ceil(self.field_bits)),
            ("storage_key", ceil(self.key_bits)),
            ("rw_counter", ceil(self.rwc_bits)),
        ]

    @property
    def total_limbs(self):
        return sum(c for _, c in self.limb_counts())

    @property
    def group_limbs(self):
        """Limbs that define the access group (everything but rw_counter)."""
        return self.total_limbs - self.limb_counts()[-1][1]


def _decompose(value: int, count: int, bits: int) -> list[int]:
    """Most-significant-limb-first decomposition."""
    mask = (1 << bits) - 1
    return [(value >> (bits * (count - 1 - i))) & mask for i in range(count)]


def word_rlc(value: int, r_chal: int) -> int:
    """Byte-RLC of a 256-bit word: sum_i le_bytes[i] * r^i (the reference's
    evm_word RLC convention — least-significant byte gets r^0)."""
    if value < 256:  # single-byte fast path (memory rows, flags, padding)
        return value
    acc = 0
    nbytes = max(1, (value.bit_length() + 7) // 8)
    for b in value.to_bytes(nbytes, "big"):  # be fold == sum le[i] r^i
        acc = (acc * r_chal + b) % R
    return acc


def rw_value_encoding(r: Rw, r_chal: int) -> int:
    """Per-(tag, field) value convention (reference RwTable, table.rs:577):
    word RLC for 256-bit-word fields (stack/memory/storage values and
    CallContext.Value), RAW field element for small fields (addresses,
    lengths, ids, flags) — so TxTable/BytecodeTable lookups compare raw
    integers while word lookups compare RLCs."""
    from ..witness.rw import AccountField

    if r.tag in (RwTag.TxAccessListAccount, RwTag.TxAccessListAccountStorage,
                 RwTag.TxRefund, RwTag.TxReceipt):
        return r.value % R  # raw small values (flags / counters / gas)
    if r.tag == RwTag.Account and r.field_tag in (
        AccountField.Nonce, AccountField.CodeSize
    ):
        return r.value % R
    if (r.tag == RwTag.Account and r.field_tag == AccountField.CodeHash) or (
        r.tag == RwTag.CallContext and r.field_tag in (
            CallContextField.CodeHash, CallContextField.ParentCodeHash
        )
    ):
        # keccak digests use the BytecodeCircuit's fold (digest byte 0
        # takes r^0) so the EVM circuit's code-hash column feeds lookups
        # directly (circuits/evm.py phase-1 `hash_rlc`)
        acc = 0
        for i, b in enumerate(r.value.to_bytes(32, "big")):
            acc = (acc + b * pow(r_chal, i, R)) % R
        return acc
    if r.tag == RwTag.CallContext and r.field_tag != CallContextField.Value:
        return r.value % R
    return word_rlc(r.value, r_chal)


class StateCircuit(Circuit):
    def __init__(self, rws: RwMap | list[Rw], params: StateParams | None = None):
        self.params = params or StateParams()
        rows = rws.sorted_rws() if isinstance(rws, RwMap) else list(rws)
        self.rows = rows

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, challenge=None,
                  mpt_storage_table=None, mpt_account_table=None):
        """`mpt_storage_table`: the MptCircuit's (enable, addr, key_rlc,
        old_rlc, new_rlc) exprs — when given, every Storage group's
        (committed -> final) transition is looked up against a proven
        trie update (reference state_circuit.rs:66-72).
        `mpt_account_table`: the account-mode MptCircuit's (enable,
        field_tag, addr, old_enc, new_enc) exprs — when given, every
        Account group's transition is looked up against a proven
        account-trie update (same reference coupling, account rows)."""
        p = self.params
        self.q_row = cs.fixed_column()  # 1 on all table rows
        self.q_ord = cs.fixed_column()  # 1 on rows 1..target-1 (has a prev)
        self.tbl = cs.fixed_column()  # range table 0..2^limb_bits-1
        self._shared_challenge = challenge

        self.col_is_write = cs.advice_column()
        self.col_value = cs.advice_column(phase=1)
        self.col_value_prev = cs.advice_column(phase=1)
        self.col_key_rlc = cs.advice_column(phase=1)  # storage key word-RLC
        self.limb_cols = [cs.advice_column() for _ in range(p.total_limbs)]
        self.e_cols = [cs.advice_column() for _ in range(p.total_limbs)]
        self.col_diff = cs.advice_column()
        # tag indicators (IsZero-style pairs) for stack/memory rules
        self.col_is_stack = cs.advice_column()
        self.col_inv_stack = cs.advice_column()
        self.col_is_mem = cs.advice_column()
        self.col_inv_mem = cs.advice_column()
        self.col_is_stor = cs.advice_column()
        self.col_inv_stor = cs.advice_column()
        self.col_is_acct = cs.advice_column()
        self.col_inv_acct = cs.advice_column()
        # flag: tag carries value_prev semantics (Storage / Account /
        # TxAccessList* / TxRefund — reference state_circuit
        # constraint_builder.rs per-tag value_prev rules)
        self.col_is_prevtag = cs.advice_column()
        self.col_inv_prevtag = cs.advice_column()
        # committed (pre-block) value of the group, carried to every row
        self.col_init_val = cs.advice_column(phase=1)

        self.r_word = (
            challenge if challenge is not None else cs.challenge(phase=0)
        )  # word-RLC challenge, squeezed after phase-0 advice

        q_row = Fixed(self.q_row)
        q_ord = Fixed(self.q_ord)
        iw = Advice(self.col_is_write)
        diff = Advice(self.col_diff)
        limbs = [Advice(c) for c in self.limb_cols]
        limbs_prev = [Advice(c, -1) for c in self.limb_cols]
        es = [Advice(c) for c in self.e_cols]

        # booleans
        cs.create_gate("is_write bool", q_row * iw * (iw - 1))
        for e in es:
            cs.create_gate("indicator bool", q_row * e * (e - 1))
        esum: Expression = es[0]
        for e in es[1:]:
            esum = esum + e
        cs.create_gate("one-hot", q_ord * (esum - 1))

        # prefix equality: limbs before the first-diff index match prev row
        run: Expression | None = None
        for i in range(p.total_limbs):
            run = es[i] if run is None else run + es[i]
            # for all i: (cur_i - prev_i) is forced 0 unless some e_k with
            # k <= i fired
            cs.create_gate(
                f"prefix-eq {i}", q_ord * (limbs[i] - limbs_prev[i]) * (1 - run)
            )

        # picked difference equals diff and diff >= 1 (range: diff-1 in table)
        picked: Expression | None = None
        for i in range(p.total_limbs):
            term = es[i] * (limbs[i] - limbs_prev[i])
            picked = term if picked is None else picked + term
        cs.create_gate("diff pick", q_ord * (picked - diff))

        # tag indicator correctness: is_stack = (tag == Stack) etc.
        tag = limbs[0]
        for flag_col, inv_col, tag_val in (
            (self.col_is_stack, self.col_inv_stack, int(RwTag.Stack)),
            (self.col_is_mem, self.col_inv_mem, int(RwTag.Memory)),
            (self.col_is_stor, self.col_inv_stor, int(RwTag.Storage)),
            (self.col_is_acct, self.col_inv_acct, int(RwTag.Account)),
        ):
            fl, inv = Advice(flag_col), Advice(inv_col)
            d = tag - tag_val
            cs.create_gate("tag flag def", q_row * (1 - fl - d * inv))
            cs.create_gate("tag flag zero", q_row * fl * d)

        # read consistency: same group + read => value unchanged
        first_access: Expression = es[0]
        for e in es[1 : p.group_limbs]:
            first_access = first_access + e
        not_first = 1 - first_access
        val = Advice(self.col_value)
        val_prev_row = Advice(self.col_value, -1)
        cs.create_gate(
            "read consistency",
            q_ord * not_first * (1 - iw) * (val - val_prev_row),
        )
        # stack: first access must be a write
        cs.create_gate(
            "stack first is write",
            q_ord * first_access * Advice(self.col_is_stack) * (1 - iw),
        )
        # memory: first read returns 0
        cs.create_gate(
            "memory first read zero",
            q_ord * first_access * Advice(self.col_is_mem) * (1 - iw) * val,
        )
        # value_prev chain (Storage/Account/TxAccessList*/TxRefund): the
        # prev-tag flag f = (prod_{t in set}(tag - t) == 0) via IsZero
        PREV_TAGS = (RwTag.Storage, RwTag.Account, RwTag.TxAccessListAccount,
                     RwTag.TxAccessListAccountStorage, RwTag.TxRefund)
        dprod: Expression | None = None
        for tv in PREV_TAGS:
            term = tag - int(tv)
            dprod = term if dprod is None else dprod * term
        fpt, ipt = Advice(self.col_is_prevtag), Advice(self.col_inv_prevtag)
        cs.create_gate("prevtag flag def", q_row * (1 - fpt - dprod * ipt))
        cs.create_gate("prevtag flag zero", q_row * fpt * dprod)
        vprev = Advice(self.col_value_prev)
        # within a group: this row's value_prev is the previous row's value
        cs.create_gate(
            "value_prev chain",
            q_ord * not_first * fpt * (vprev - val_prev_row),
        )
        # reads leave value = value_prev (writes update it)
        cs.create_gate(
            "read keeps prev", q_row * fpt * (1 - iw) * (val - vprev)
        )
        # per-tx tags start fresh: first access of TxAccessList*/TxRefund
        # groups has value_prev = 0 (Account/Storage first access reads the
        # committed value — bound through MptTable when the coupling lands)
        FRESH_TAGS = (RwTag.TxAccessListAccount,
                      RwTag.TxAccessListAccountStorage, RwTag.TxRefund)
        fprod: Expression | None = None
        for tv in FRESH_TAGS:
            term = tag - int(tv)
            fprod = term if fprod is None else fprod * term
        # gate by the zero-ness of fprod via the same flag pattern is
        # overkill: fpt=1 together with (tag - Storage)(tag - Account) != 0
        # identifies the fresh set, but a direct product gate is cheaper:
        # fresh first access => value_prev * prod_{t in {Storage,Account}}
        # (tag - t) = 0 is wrong (nonzero product for fresh tags).  Use an
        # explicit IsZero-free form: for first access with fpt = 1, require
        # value_prev * z = 0 where z kills Storage/Account rows:
        # z = (tag - Storage)(tag - Account) is nonzero exactly on the
        # fresh tags (within the fpt = 1 set), so the product forces
        # value_prev = 0 there and nothing elsewhere.
        zsa = (tag - int(RwTag.Storage)) * (tag - int(RwTag.Account))
        cs.create_gate(
            "fresh first prev zero",
            q_ord * first_access * fpt * zsa * vprev,
        )

        # storage-key word-RLC binding: key_rlc = sum le_bytes(key) * r^i,
        # a LINEAR form over the key limbs when limb_bits divides 8 (limb j
        # covers a within-byte bit range) — the convention that lets the
        # EVM circuit pass its stack-word key RLC straight into the rw
        # lookup with no extra byte cells.  limb_bits > 8 (standalone test
        # geometries) leaves the column unbound; composed/production
        # configs use limb_bits <= 8.
        if 8 % p.limb_bits == 0:
            counts = p.limb_counts()
            key_cnt = dict(counts)["storage_key"]
            key_off = sum(
                c for nme, c in counts[: [n for n, _ in counts].index("storage_key")]
            )
            expr = None
            rpow: Expression | int = 1
            cur_byte = -1
            for j in range(key_cnt - 1, -1, -1):  # least-significant first
                bitpos = (key_cnt - 1 - j) * p.limb_bits
                byte_i, shift = bitpos // 8, bitpos % 8
                if byte_i != cur_byte:
                    if cur_byte >= 0:
                        rpow = (
                            self.r_word if rpow == 1 else rpow * self.r_word
                        )
                    cur_byte = byte_i
                term = limbs[key_off + j] * (1 << shift)
                term = term if rpow == 1 else term * rpow
                expr = term if expr is None else expr + term
            cs.create_gate(
                "key rlc binding", q_row * (Advice(self.col_key_rlc) - expr)
            )

        # init_val: committed value of the access group — equals
        # value_prev at the first access (prev-tag rows), constant within
        # the group (reference state_circuit initial_value column)
        init_v = Advice(self.col_init_val)
        cs.create_gate(
            "init val first",
            q_ord * first_access * fpt * (init_v - vprev),
        )
        cs.create_gate(
            "init val carry",
            q_ord * not_first * (init_v - Advice(self.col_init_val, -1)),
        )
        if mpt_storage_table is not None:
            # last-of-group Storage rows: the (addr, key, committed ->
            # final) transition must be a proven trie update.  A row is
            # last-of-group when the NEXT row starts a new group (its
            # first-diff one-hot fires in a group limb); the final padding
            # row's successor is all-zero => gated off.
            first_next: Expression | None = None
            for c in self.e_cols[: p.group_limbs]:
                e_n = Advice(c, 1)
                first_next = e_n if first_next is None else first_next + e_n
            counts = p.limb_counts()
            addr_cnt = dict(counts)["address"]
            addr_off = sum(
                c for nme, c in
                counts[: [n_ for n_, _ in counts].index("address")]
            )
            addr_expr: Expression | None = None
            for i in range(addr_cnt):
                term = limbs[addr_off + i] * (
                    1 << (p.limb_bits * (addr_cnt - 1 - i))
                )
                addr_expr = term if addr_expr is None else addr_expr + term
            g_mpt = q_row * Advice(self.col_is_stor) * first_next
            cs.lookup_logup(
                "storage mpt",
                [[g_mpt, g_mpt * addr_expr, g_mpt * Advice(self.col_key_rlc),
                  g_mpt * init_v, g_mpt * Advice(self.col_value)]],
                mpt_storage_table,
            )
            self._mpt_helpers = (first_next, addr_expr)

        if mpt_account_table is not None:
            # last-of-group Account rows: the (addr, field_tag,
            # committed -> final) transition must be a proven account-
            # trie leaf transition (reference state_circuit.rs:66-72)
            if mpt_storage_table is not None:
                first_next, addr_expr = self._mpt_helpers
            else:
                first_next = None
                for c in self.e_cols[: p.group_limbs]:
                    e_n = Advice(c, 1)
                    first_next = (e_n if first_next is None
                                  else first_next + e_n)
                counts = p.limb_counts()
                addr_cnt = dict(counts)["address"]
                addr_off = sum(
                    c for nme, c in
                    counts[: [n_ for n_, _ in counts].index("address")]
                )
                addr_expr = None
                for i in range(addr_cnt):
                    term = limbs[addr_off + i] * (
                        1 << (p.limb_bits * (addr_cnt - 1 - i))
                    )
                    addr_expr = (term if addr_expr is None
                                 else addr_expr + term)
            counts = p.limb_counts()
            ft_cnt = dict(counts)["field_tag"]
            ft_off = sum(
                c for nme, c in
                counts[: [n_ for n_, _ in counts].index("field_tag")]
            )
            ftag_expr = None
            for i in range(ft_cnt):
                term = limbs[ft_off + i] * (
                    1 << (p.limb_bits * (ft_cnt - 1 - i))
                )
                ftag_expr = term if ftag_expr is None else ftag_expr + term
            g_am = q_row * Advice(self.col_is_acct) * first_next
            cs.lookup_logup(
                "account mpt",
                [[g_am, g_am * ftag_expr, g_am * addr_expr,
                  g_am * init_v, g_am * Advice(self.col_value)]],
                mpt_account_table,
            )

        # single logUp argument: every limb + diff-1 into the range table
        inputs = [[q_row * l] for l in limbs]
        inputs.append([q_ord * (diff - 1)])
        cs.lookup_logup("limb ranges", inputs, [Fixed(self.tbl)])

    def rw_table_exprs(self) -> list:
        """The RW table as (rw_counter, is_write, tag, id, address,
        field_tag, storage_key_rlc, value) expressions recomposed from the
        limb columns — the SuperCircuit points the EVM circuit's bus
        lookups at these (reference RwTable, zkevm-circuits/src/
        table.rs:577), zero-gated outside table rows."""
        p = self.params
        q = Fixed(self.q_row)
        limbs = [Advice(c) for c in self.limb_cols]
        counts = p.limb_counts()
        out_by_name = {}
        off = 0
        for name, cnt in counts:
            expr = None
            for i in range(cnt):
                term = limbs[off + i] * (1 << (p.limb_bits * (cnt - 1 - i)))
                expr = term if expr is None else expr + term
            out_by_name[name] = expr
            off += cnt
        return [
            q * out_by_name["rw_counter"],
            q * Advice(self.col_is_write),
            q * out_by_name["tag"],
            q * out_by_name["id"],
            q * out_by_name["address"],
            q * out_by_name["field_tag"],
            q * Advice(self.col_key_rlc),
            q * Advice(self.col_value),
        ]

    # ------------------------------------------------------------------
    def _target(self, n: int) -> int:
        from ..plonk.circuit import usable_rows

        # default leaves a few q_row = 0 rows: gated-off logUp inputs
        # against the exposed rw table need an all-zero table row
        t = self.params.target_rows or (usable_rows(n) - 8)
        assert len(self.rows) <= t <= usable_rows(n)
        return t

    def _padded_rows(self, n: int) -> list[Rw]:
        t = self._target(n)
        rows = list(self.rows)
        next_ctr = (max(r.rw_counter for r in rows) + 1) if rows else 1
        while len(rows) < t:
            rows.append(
                Rw(rw_counter=next_ctr, is_write=False, tag=RwTag.Padding)
            )
            next_ctr += 1
        return rows

    def fixed_columns(self, n: int):
        p = self.params
        t = self._target(n)
        q_row = [1 if i < t else 0 for i in range(n)]
        q_ord = [1 if 1 <= i < t else 0 for i in range(n)]
        tbl = [i if i < (1 << p.limb_bits) else 0 for i in range(n)]
        assert n >= (1 << p.limb_bits), "domain must fit the range table"
        mont = F.mont_from_ints
        return {
            self.q_row: mont(q_row),
            self.q_ord: mont(q_ord),
            self.tbl: mont(tbl),
        }

    def _limbify(self, r: Rw) -> list[int]:
        p = self.params
        out = []
        for name, cnt in p.limb_counts():
            v = {
                "tag": int(r.tag),
                "id": r.id,
                "address": r.address,
                "field_tag": int(r.field_tag),
                "storage_key": r.storage_key,
                "rw_counter": r.rw_counter,
            }[name]
            out.extend(_decompose(v, cnt, p.limb_bits))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        p = self.params
        rows = self._padded_rows(n)
        t = len(rows)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        if phase == 0:
            limb_mat = [self._limbify(r) for r in rows]
            cols = {}
            cols[self.col_is_write] = mont([int(r.is_write) for r in rows])
            for li in range(p.total_limbs):
                cols[self.limb_cols[li]] = mont([lm[li] for lm in limb_mat])
            e_mat = []
            diffs = []
            for i in range(t):
                if i == 0:
                    e_mat.append([0] * p.total_limbs)
                    diffs.append(1)
                    continue
                cur, prev = limb_mat[i], limb_mat[i - 1]
                j = next(
                    (k for k in range(p.total_limbs) if cur[k] != prev[k]),
                    None,
                )
                # soft handling of corrupt witnesses: constraints (one-hot,
                # range lookup) catch duplicates / unsorted rows in the
                # mock/real prover rather than crashing witness gen
                onehot = [0] * p.total_limbs
                if j is not None:
                    onehot[j] = 1
                e_mat.append(onehot)
                d = (cur[j] - prev[j]) % R if j is not None else 1
                diffs.append(d)
            for li in range(p.total_limbs):
                cols[self.e_cols[li]] = mont([em[li] for em in e_mat])
            # diff column: rows without q_ord still pass the gated range
            # lookup (input expression is 0 there); witness stores d
            cols[self.col_diff] = mont(diffs)
            cols[self.col_is_stack] = mont(
                [int(r.tag == RwTag.Stack) for r in rows]
            )
            cols[self.col_is_mem] = mont(
                [int(r.tag == RwTag.Memory) for r in rows]
            )
            cols[self.col_is_stor] = mont(
                [int(r.tag == RwTag.Storage) for r in rows]
            )

            def invs(tag_val):
                # inverses depend only on the (12-valued) tag: compute one
                # inverse per distinct tag, not per row (k=18 fill perf)
                cache: dict[int, int] = {}
                out = []
                for r in rows:
                    tv = int(r.tag)
                    e = cache.get(tv)
                    if e is None:
                        d = (tv - tag_val) % R
                        e = cache[tv] = pow(d, -1, R) if d else 0
                    out.append(e)
                return out

            cols[self.col_inv_stack] = mont(invs(int(RwTag.Stack)))
            cols[self.col_inv_mem] = mont(invs(int(RwTag.Memory)))
            cols[self.col_inv_stor] = mont(invs(int(RwTag.Storage)))
            cols[self.col_is_acct] = mont(
                [int(r.tag == RwTag.Account) for r in rows]
            )
            cols[self.col_inv_acct] = mont(invs(int(RwTag.Account)))
            PREV_TAGS = (RwTag.Storage, RwTag.Account,
                         RwTag.TxAccessListAccount,
                         RwTag.TxAccessListAccountStorage, RwTag.TxRefund)
            pcache: dict[int, tuple[int, int]] = {}
            flags, pinvs = [], []
            for r in rows:
                tv = int(r.tag)
                e = pcache.get(tv)
                if e is None:
                    d = 1
                    for pt in PREV_TAGS:
                        d = d * (tv - int(pt)) % R
                    e = pcache[tv] = (
                        int(d == 0), pow(d, -1, R) if d else 0
                    )
                flags.append(e[0])
                pinvs.append(e[1])
            cols[self.col_is_prevtag] = mont(flags)
            cols[self.col_inv_prevtag] = mont(pinvs)
            return cols
        # phase 1: value/key RLC columns under the phase-0 challenge
        r_chal = challenges[self.r_word.index]
        r_int = F.to_int(F.from_mont(r_chal))
        vals = [rw_value_encoding(r, r_int) for r in rows]
        prevs = [
            rw_value_encoding(
                dataclasses.replace(r, value=r.value_prev), r_int
            )
            for r in rows
        ]
        keys = [word_rlc(r.storage_key, r_int) for r in rows]
        inits = []
        prev_group = None
        cur_init = 0
        for r, pv in zip(rows, prevs):
            group = (r.tag, r.id, r.address, r.field_tag, r.storage_key)
            if group != prev_group:
                cur_init = pv  # committed value = first access's prev
                prev_group = group
            inits.append(cur_init)
        return {
            self.col_value: mont(vals),
            self.col_value_prev: mont(prevs),
            self.col_key_rlc: mont(keys),
            self.col_init_val: mont(inits),
        }
