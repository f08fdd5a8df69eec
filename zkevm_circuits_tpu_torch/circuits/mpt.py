"""MPT circuit (port of zkevm_circuits_tpu/circuits/mpt.py): proves zktrie
value updates against old/new roots.

Equivalent of the reference's MPT circuit wrapper + external
`halo2-mpt-circuits` (reference zkevm-circuits/src/mpt_circuit.rs:38-80,
SURVEY.md §2.2 "MPT"): each storage/account write is proven as a pair of
Merkle paths (old value, new value) sharing the same siblings, with every
node hash delegated to the Poseidon circuit via PoseidonTable lookups —
the layering: this circuit is pure plumbing (selects + chaining
+ lookups), all permutation work rides the fixed-geometry Poseidon blocks.

Layout: one row per path node, bottom-up per update (leaf row first, root
row last).  Leaf row binds (key, old_value)/(key, new_value) through
DOM_LEAF hashes (old side skipped for fresh inserts into empty slots);
branch rows select (child, sibling) order by the path bit and chain
accumulators upward; the root row pins both accumulators to the carried
old_root/new_root and exposes the MptTable tuple
(enable, key, old_value, new_value, old_root, new_root).

Round-1 scope note (witness/mpt.py): leaf-split insertions are not yet
witnessable; path-bit <-> key binding relies on hash collision resistance
via the root (the canonical-placement argument), as documented there.
"""

from __future__ import annotations

import dataclasses

from ..crypto.field import fr
from ..crypto.params import FR_MODULUS as R
from ..plonk.circuit import Cell, Circuit, ConstraintSystem, usable_rows
from ..plonk.expression import Advice, Fixed
from ..trie.zktrie import DOM_BRANCH, DOM_LEAF, hash2_domain
from ..witness.mpt import MptUpdate

F = fr()


@dataclasses.dataclass
class MptParams:
    target_rows: int = 0


class MptCircuit(Circuit):
    def __init__(self, updates: list[MptUpdate] | None = None,
                 params: MptParams | None = None, storage=None,
                 accounts=None, two_level: bool = False,
                 chain_groups: list[int] | None = None):
        """`storage`: list[witness.mpt.StorageUpdate] — enables the
        storage-schema bridges: each update's trie key is re-derived
        in-circuit from (addr, slot) and its leaf values from the raw
        256-bit words (poseidon + byte-RLC bindings), and the circuit
        exposes `storage_table` = (enable, addr, key_rlc, old_rlc,
        new_rlc) for the State circuit's storage-group lookups
        (reference state_circuit.rs:66-72 MptTable coupling).

        `two_level`: storage mode over per-account SUBTRIES (reference
        zktrie two-level layout, zktrie/src/state/builder.rs:80,167):
        the trie key is H(DOM_SKEY, slot_lo, slot_hi) with NO address
        wrap — the address is a carried cell authenticated by copying
        the subtrie's roots into the account leaf (compose with an
        account-mode instance).  `chain_groups` then lists the number of
        consecutive updates per account; the root chain breaks between
        groups.

        `accounts`: list[witness.mpt.AccountUpdate] — account mode: leaf
        rows re-derive the account leaf hash from (nonce, code_size,
        balance, code_hash, storage_root) through PoseidonTable lookups,
        the trie key from the address, and a trailing exposure section
        publishes `account_table` = (enable, field_tag, addr, old_enc,
        new_enc) for the State circuit's Account-group lookups."""
        self.storage = storage
        self.accounts = accounts
        self.two_level = two_level
        self.chain_groups = chain_groups
        if storage is not None:
            updates = [su.mpt for su in storage]
        if accounts is not None:
            assert storage is None, "one mode per instance"
            updates = [au.mpt for au in accounts]
        self.updates = updates or []
        self.params = params or MptParams()

    # ------------------------------------------------------------------
    def configure(self, cs: ConstraintSystem, poseidon_table=None,
                  challenge=None):
        """`poseidon_table`: (enable, domain, in0, in1, out) exprs from the
        Poseidon circuit; standalone mode carries witness columns.
        `challenge`: the shared word-RLC challenge (storage mode)."""
        self.standalone = poseidon_table is None
        self.q_mpt = cs.fixed_column()
        self.q_row0 = cs.fixed_column()
        self.q_chain = cs.fixed_column()  # 1 on REAL (non-pad) rows
        if self.storage is not None:
            self._shared_challenge = (
                challenge if challenge is not None else cs.challenge(phase=0)
            )

        self.c_first = cs.advice_column()
        self.c_last = cs.advice_column()
        self.c_emp = cs.advice_column()  # leaf row: old slot was empty
        self.c_nemp = cs.advice_column()  # leaf row: new side also empty
        self.c_occ = cs.advice_column()  # absence under a foreign leaf
        self.c_kinv = cs.advice_column()  # 1/(occ_key - key)
        self.c_bit = cs.advice_column()
        self.c_sib = cs.advice_column()
        self.c_old_acc = cs.advice_column()
        self.c_new_acc = cs.advice_column()
        # leaf-split extension zone: branch rows below the displaced
        # leaf's OLD depth (old chain frozen, new-side siblings empty)
        self.c_ext = cs.advice_column()
        self.c_k1 = cs.advice_column()  # displaced leaf key (split row)
        self.c_v1 = cs.advice_column()  # displaced leaf value
        # carried per-update values (constant within a block)
        self.c_key = cs.advice_column()
        self.c_old_v = cs.advice_column()
        self.c_new_v = cs.advice_column()
        self.c_old_root = cs.advice_column()
        self.c_new_root = cs.advice_column()

        if self.standalone:
            self.t_en = cs.fixed_column()
            self.t_dom = cs.advice_column()
            self.t_in0 = cs.advice_column()
            self.t_in1 = cs.advice_column()
            self.t_out = cs.advice_column()
            poseidon_table = [
                Fixed(self.t_en), Advice(self.t_dom), Advice(self.t_in0),
                Advice(self.t_in1), Advice(self.t_out),
            ]

        q = Fixed(self.q_mpt)
        q_n = Fixed(self.q_mpt, 1)
        qz = Fixed(self.q_row0)
        first, first_n = Advice(self.c_first), Advice(self.c_first, 1)
        last = Advice(self.c_last)
        emp = Advice(self.c_emp)
        bit = Advice(self.c_bit)
        sib = Advice(self.c_sib)
        oa, oa_p = Advice(self.c_old_acc), Advice(self.c_old_acc, -1)
        na, na_p = Advice(self.c_new_acc), Advice(self.c_new_acc, -1)

        for name, e in (("first", first), ("last", last), ("emp", emp),
                        ("bit", bit)):
            cs.create_gate(f"mpt {name} bool", q * e * (e - 1))
        cs.create_gate("mpt first row", q * qz * (first - 1))
        cs.create_gate("mpt trailing last", q * (1 - q_n) * (1 - last))
        cs.create_gate("mpt boundary", q * q_n * (first_n - last))
        intra = q * q_n * (1 - last)
        for name, col in (("key", self.c_key), ("old_v", self.c_old_v),
                          ("new_v", self.c_new_v),
                          ("old_root", self.c_old_root),
                          ("new_root", self.c_new_root)):
            cs.create_gate(
                f"mpt {name} carry", intra * (Advice(col, 1) - Advice(col))
            )

        key = Advice(self.c_key)
        old_v, new_v = Advice(self.c_old_v), Advice(self.c_new_v)
        old_root, new_root = Advice(self.c_old_root), Advice(self.c_new_root)

        # leaf row: empty old slot starts the old chain at 0 — unless a
        # FOREIGN leaf occupies the walk's endpoint (absence-under-leaf):
        # then both chains seed at its hash and occ_key != key is proven
        gf = q * first
        occ = Advice(self.c_occ)
        kinv = Advice(self.c_kinv)
        k1c, v1c = Advice(self.c_k1), Advice(self.c_v1)
        cs.create_gate("mpt occ bool", q * occ * (occ - 1))
        cs.create_gate("mpt empty old acc", gf * emp * (1 - occ) * oa)
        # no-op absence proof: new side mirrors the old side exactly
        nemp = Advice(self.c_nemp)
        cs.create_gate("mpt nemp bool", q * nemp * (nemp - 1))
        cs.create_gate("mpt nemp needs emp", gf * nemp * (1 - emp))
        cs.create_gate("mpt occ needs nemp", gf * occ * (1 - nemp))
        cs.create_gate("mpt empty new acc", gf * nemp * (na - oa))
        cs.create_gate("mpt nemp zero value", gf * nemp * new_v)
        cs.create_gate(
            "mpt occ key differs", gf * occ * ((k1c - key) * kinv - 1)
        )
        # root row: accumulators match the claimed roots
        gl = q * last
        cs.create_gate("mpt old root", gl * (oa - old_root))
        cs.create_gate("mpt new root", gl * (na - new_root))

        # ---- leaf-split extension zone (reference halo2-mpt-circuits'
        # extension-node machinery): ext marks branch rows BELOW the
        # displaced leaf's old depth.  The split row (first branch row of
        # the zone) pins the old accumulator to the sibling, which must
        # itself be the displaced leaf's hash; inner ext rows carry the
        # old accumulator unchanged over EMPTY siblings; the old-side
        # branch hash is gated off throughout the zone. ------------------
        ext = Advice(self.c_ext)
        first_p = Advice(self.c_first, -1)
        k1, v1 = Advice(self.c_k1), Advice(self.c_v1)
        cs.create_gate("mpt ext bool", q * ext * (ext - 1))
        cs.create_gate("mpt ext not leaf", q * ext * first)
        # ext rows form a prefix of the branch rows (no re-entry)
        cs.create_gate(
            "mpt ext prefix",
            q * (1 - first) * (1 - first_p) * ext * (1 - Advice(self.c_ext, -1)),
        )
        # split row = first branch row with ext set
        g_split = q * ext * first_p
        cs.create_gate("mpt split seeds old", g_split * (oa - sib))
        g_inner = q * ext * (1 - first_p)
        cs.create_gate("mpt ext sib empty", g_inner * sib)
        cs.create_gate("mpt ext old frozen", g_inner * (oa - oa_p))
        # splits are fresh inserts: the exposed old slot is empty
        cs.create_gate(
            "mpt split implies empty",
            g_split * (1 - Advice(self.c_emp, -1)),
        )

        # poseidon lookups: leaf hashes + branch hashes (old & new sides)
        g_old_leaf = gf * (1 - emp)
        g_branch = q * (1 - first)
        g_branch_old = g_branch * (1 - ext)
        l_old = bit * sib + (1 - bit) * oa_p
        r_old = bit * oa_p + (1 - bit) * sib
        l_new = bit * sib + (1 - bit) * na_p
        r_new = bit * na_p + (1 - bit) * sib
        g_new_leaf = gf * (1 - nemp)
        g_occl = gf * occ
        cs.lookup_logup(
            "mpt poseidon",
            [
                # occupied-absence: the seed is the foreign leaf's hash
                [g_occl, g_occl * DOM_LEAF, g_occl * k1c, g_occl * v1c,
                 g_occl * oa],
                [g_old_leaf, g_old_leaf * DOM_LEAF, g_old_leaf * key,
                 g_old_leaf * old_v, g_old_leaf * oa],
                [g_new_leaf, g_new_leaf * DOM_LEAF, g_new_leaf * key,
                 g_new_leaf * new_v, g_new_leaf * na],
                [g_branch_old, g_branch_old * DOM_BRANCH,
                 g_branch_old * l_old, g_branch_old * r_old,
                 g_branch_old * oa],
                [g_branch, g_branch * DOM_BRANCH, g_branch * l_new,
                 g_branch * r_new, g_branch * na],
                # the split row's sibling IS the displaced leaf's hash
                [g_split, g_split * DOM_LEAF, g_split * k1, g_split * v1,
                 g_split * sib],
            ],
            poseidon_table,
        )

        # chained blocks: a LINKED update starts from its predecessor's
        # new root (pad blocks and group starts are unlinked; q_link sits
        # on the leaf row of every linked update)
        self.q_link = cs.fixed_column()
        cs.create_gate(
            "mpt root chain",
            q * last * Fixed(self.q_link, 1)
            * (Advice(self.c_old_root, 1) - new_root),
        )

        # ---- storage-schema bridges (storage mode): on each update's
        # LEAF row, re-derive the trie key from (addr, slot) and the leaf
        # values from the raw words (witness/mpt.py conventions) ---------
        if self.storage is not None:
            from ..witness.mpt import DOM_SKEY, DOM_SVAL

            self.tbl_byte = cs.fixed_column()
            self.s_addr = cs.advice_column()
            self.s_inner = cs.advice_column()  # H(DOM_SKEY, k_lo, k_hi)
            self.s_nz = cs.advice_column()  # new word nonzero flag
            self.kb = [cs.advice_column() for _ in range(32)]
            self.ob = [cs.advice_column() for _ in range(32)]
            self.nb = [cs.advice_column() for _ in range(32)]
            self.s_key_rlc = cs.advice_column(phase=1)
            self.s_old_rlc = cs.advice_column(phase=1)
            self.s_new_rlc = cs.advice_column(phase=1)
            r_word = self._shared_challenge
            gf2 = q * first * Fixed(self.q_chain)  # real leaf rows only
            kb = [Advice(c) for c in self.kb]
            ob = [Advice(c) for c in self.ob]
            nb = [Advice(c) for c in self.nb]

            def lohi(bs):
                lo = None
                hi = None
                for i in range(16):
                    tl = bs[i] * (1 << (8 * i))
                    th = bs[16 + i] * (1 << (8 * i))
                    lo = tl if lo is None else lo + tl
                    hi = th if hi is None else hi + th
                return lo, hi

            def rlc_of(bs):
                expr = None
                rpow = None
                for i, b in enumerate(bs):
                    term = b if i == 0 else b * rpow
                    expr = term if expr is None else expr + term
                    rpow = r_word if rpow is None else rpow * r_word
                return expr

            k_lo, k_hi = lohi(kb)
            ov_lo, ov_hi = lohi(ob)
            nv_lo, nv_hi = lohi(nb)
            cs.create_gate(
                "stor key rlc", gf2 * (Advice(self.s_key_rlc) - rlc_of(kb))
            )
            cs.create_gate(
                "stor old rlc", gf2 * (Advice(self.s_old_rlc) - rlc_of(ob))
            )
            cs.create_gate(
                "stor new rlc", gf2 * (Advice(self.s_new_rlc) - rlc_of(nb))
            )
            g_oldv = gf2 * (1 - emp)  # empty old slot has no leaf value
            # zero new word stores leaf value 0 (delete-on-zero pending):
            # nz gates the packing bridge and pins everything to 0 off it
            nz = Advice(self.s_nz)
            g_newv = gf2 * nz
            cs.create_gate("stor nz bool", gf2 * nz * (nz - 1))
            cs.create_gate("stor zero new leaf", gf2 * (1 - nz) * new_v)
            for i, b in enumerate(nb):
                cs.create_gate(f"stor zero new byte {i}",
                               gf2 * (1 - nz) * b)
            key_rows = [
                [gf2, gf2 * DOM_SKEY, gf2 * k_lo, gf2 * k_hi,
                 gf2 * Advice(self.s_inner)],
            ]
            if self.two_level:
                # subtrie key = inner hash; the address is a carried
                # cell, authenticated via the account-leaf coupling
                cs.create_gate(
                    "stor subtrie key",
                    gf2 * (key - Advice(self.s_inner)),
                )
            else:
                key_rows.append(
                    [gf2, gf2 * DOM_SKEY, gf2 * Advice(self.s_addr),
                     gf2 * Advice(self.s_inner), gf2 * key]
                )
            cs.lookup_logup(
                "stor poseidon bridges",
                key_rows + [
                    [g_oldv, g_oldv * DOM_SVAL, g_oldv * ov_lo,
                     g_oldv * ov_hi, g_oldv * old_v],
                    [g_newv, g_newv * DOM_SVAL, g_newv * nv_lo,
                     g_newv * nv_hi, g_newv * new_v],
                ],
                poseidon_table,
            )
            for col in (self.s_addr, self.c_old_root, self.c_new_root):
                cs.enable_equality("advice", col)
            byte_inputs = [[gf2 * b] for b in kb + ob + nb]
            cs.lookup_logup(
                "stor byte ranges", byte_inputs, [Fixed(self.tbl_byte)]
            )
            # zero old word <=> empty old slot (the bridge is gated off
            # for empty slots, so pin the bytes to zero there)
            for i, b in enumerate(ob):
                cs.create_gate(f"stor empty old byte {i}", gf2 * emp * b)
            self.storage_table = [
                gf2, gf2 * Advice(self.s_addr), gf2 * Advice(self.s_key_rlc),
                gf2 * Advice(self.s_old_rlc), gf2 * Advice(self.s_new_rlc),
            ]

        # ---- account-schema bridges (account mode): on each update's
        # leaf row, re-derive the trie key from the address and both leaf
        # values from the packed account fields; a trailing exposure
        # section publishes per-field (old, new) pairs for the State
        # circuit's Account groups (reference state_circuit.rs:66-72 +
        # zktrie/src/state/builder.rs:80 account packing). -----------------
        if self.accounts is not None:
            from ..witness.mpt import (
                DOM_A1, DOM_A2, DOM_ABAL, DOM_ACH, DOM_AKEY,
            )

            self.tbl_byte = cs.fixed_column()
            self._shared_challenge = (
                challenge if challenge is not None else cs.challenge(phase=0)
            )
            adv = cs.advice_column
            self.a_addr = adv()
            self.a_nz = adv()
            self.a_non = (adv(), adv())      # (old, new) raw nonce
            self.a_cs = (adv(), adv())       # (old, new) raw code size
            self.a_sroot = (adv(), adv())
            self.bb_o = [adv() for _ in range(32)]  # balance bytes (LE)
            self.bb_n = [adv() for _ in range(32)]
            self.cb_o = [adv() for _ in range(32)]  # code-hash bytes (LE)
            self.cb_n = [adv() for _ in range(32)]
            self.a_balp = (adv(), adv())
            self.a_chp = (adv(), adv())
            self.a_h1 = (adv(), adv())
            self.a_h2 = (adv(), adv())
            self.a_bal_rlc = (cs.advice_column(phase=1),
                              cs.advice_column(phase=1))
            self.a_ch_rlc = (cs.advice_column(phase=1),
                             cs.advice_column(phase=1))
            # exposure section
            self.x_en = cs.fixed_column()
            self.x_tag = cs.fixed_column()
            self.x_addr = adv()
            self.x_old = cs.advice_column(phase=1)
            self.x_new = cs.advice_column(phase=1)
            eq_cols = ([self.a_addr, self.a_sroot[0], self.a_sroot[1],
                        self.a_non[0], self.a_non[1], self.a_cs[0],
                        self.a_cs[1], self.x_addr,
                        self.c_old_root, self.c_new_root])
            for col in eq_cols:
                cs.enable_equality("advice", col)
            for col in (self.a_bal_rlc + self.a_ch_rlc
                        + (self.x_old, self.x_new)):
                cs.enable_equality("advice", col)

            r_word = self._shared_challenge
            g_al = q * first * Fixed(self.q_chain)
            nz_a = Advice(self.a_nz)
            cs.create_gate("acct nz bool", g_al * nz_a * (nz_a - 1))

            def lohi_a(bs):
                lo = None
                hi = None
                for i in range(16):
                    tl = Advice(bs[i]) * (1 << (8 * i))
                    th = Advice(bs[16 + i]) * (1 << (8 * i))
                    lo = tl if lo is None else lo + tl
                    hi = th if hi is None else hi + th
                return lo, hi

            def rlc_le(bs):
                expr = None
                rpow = None
                for i, b in enumerate(bs):
                    term = Advice(b) if i == 0 else Advice(b) * rpow
                    expr = term if expr is None else expr + term
                    rpow = r_word if rpow is None else rpow * r_word
                return expr

            sides = []
            for sd in (0, 1):
                bank_b = self.bb_o if sd == 0 else self.bb_n
                bank_c = self.cb_o if sd == 0 else self.cb_n
                b_lo, b_hi = lohi_a(bank_b)
                c_lo, c_hi = lohi_a(bank_c)
                npack = Advice(self.a_non[sd]) \
                    + (1 << 64) * Advice(self.a_cs[sd])
                leafv = old_v if sd == 0 else new_v
                gate = g_al * (1 - emp) if sd == 0 else g_al * nz_a
                sides.append((gate, b_lo, b_hi, c_lo, c_hi, npack, leafv,
                              bank_b, bank_c))
                # word-RLC (LE fold) of balance; BE fold of the keccak
                # code hash (the State circuit's value conventions,
                # circuits/state.py rw_value_encoding)
                cs.create_gate(
                    f"acct bal rlc {sd}",
                    g_al * (Advice(self.a_bal_rlc[sd]) - rlc_le(bank_b)),
                )
                cs.create_gate(
                    f"acct ch rlc {sd}",
                    g_al * (Advice(self.a_ch_rlc[sd])
                            - rlc_le(list(reversed(bank_c)))),
                )
            pos_rows = [[g_al, g_al * DOM_AKEY, g_al * Advice(self.a_addr),
                         g_al * 0, g_al * key]]
            for sd, (gate, b_lo, b_hi, c_lo, c_hi, npack, leafv,
                     bank_b, bank_c) in enumerate(sides):
                balp = Advice(self.a_balp[sd])
                chp = Advice(self.a_chp[sd])
                h1_ = Advice(self.a_h1[sd])
                h2_ = Advice(self.a_h2[sd])
                sroot = Advice(self.a_sroot[sd])
                pos_rows += [
                    [gate, gate * DOM_ABAL, gate * b_lo, gate * b_hi,
                     gate * balp],
                    [gate, gate * DOM_ACH, gate * c_lo, gate * c_hi,
                     gate * chp],
                    [gate, gate * DOM_A1, gate * npack, gate * balp,
                     gate * h1_],
                    [gate, gate * DOM_A1, gate * chp, gate * sroot,
                     gate * h2_],
                    [gate, gate * DOM_A2, gate * h1_, gate * h2_,
                     gate * leafv],
                ]
            cs.lookup_logup("acct poseidon bridges", pos_rows,
                            poseidon_table)
            # gated-off sides pin their raw fields (range-checked bytes
            # sum to zero iff all zero) and the leaf value on the new side
            g_emp = g_al * emp
            g_z = g_al * (1 - nz_a)
            for gate_z, non, cs_, sroot, bank_b, bank_c, leafv in (
                (g_emp, self.a_non[0], self.a_cs[0], self.a_sroot[0],
                 self.bb_o, self.cb_o, None),
                (g_z, self.a_non[1], self.a_cs[1], self.a_sroot[1],
                 self.bb_n, self.cb_n, new_v),
            ):
                cs.create_gate("acct zero non", gate_z * Advice(non))
                cs.create_gate("acct zero cs", gate_z * Advice(cs_))
                cs.create_gate("acct zero sroot", gate_z * Advice(sroot))
                sb = None
                for b in bank_b + bank_c:
                    sb = Advice(b) if sb is None else sb + Advice(b)
                cs.create_gate("acct zero bytes", gate_z * sb)
                if leafv is not None:
                    cs.create_gate("acct zero leaf", gate_z * leafv)
            byte_inputs = [
                [g_al * Advice(b)]
                for b in self.bb_o + self.bb_n + self.cb_o + self.cb_n
            ]
            cs.lookup_logup("acct byte ranges", byte_inputs,
                            [Fixed(self.tbl_byte)])
            # exposure table: (enable, field_tag, addr, old_enc, new_enc)
            xg = Fixed(self.x_en)
            self.account_table = [
                xg, xg * Fixed(self.x_tag), xg * Advice(self.x_addr),
                xg * Advice(self.x_old), xg * Advice(self.x_new),
            ]

        # exposed MptTable (reference table.rs:748) on root rows
        self.mpt_table = [
            gl, gl * key, gl * old_v, gl * new_v, gl * old_root,
            gl * new_root,
        ]

    # ------------------------------------------------------------------
    def _rows(self):
        """(first, last, emp, bit, sib, old_acc, new_acc, key, old_v,
        new_v, old_root, new_root) per row, bottom-up per update."""
        rows = []
        for u in self.updates:
            if u.occupied:
                oacc = hash2_domain(DOM_LEAF, u.occ_key, u.occ_value)
            elif u.was_empty:
                oacc = 0
            else:
                oacc = hash2_domain(DOM_LEAF, u.key, u.old_value)
            nacc = oacc if u.new_empty else \
                hash2_domain(DOM_LEAF, u.key, u.new_value)
            n_rows = u.depth + 1
            for j in range(n_rows):
                ext = k1 = v1 = 0
                if j == 0:
                    b, s = 0, 0
                    if u.occupied:
                        k1, v1 = u.occ_key, u.occ_value
                else:
                    d = u.depth - j  # branch for depth d
                    b, s = u.bits[d], u.siblings[d]
                    ext = int(u.is_split and d >= u.split_old_depth)
                    ln, rn = (s, nacc) if b else (nacc, s)
                    nacc = hash2_domain(DOM_BRANCH, ln, rn)
                    if ext and j == 1:  # split row: seed the frozen chain
                        oacc = s
                        k1, v1 = u.split_key, u.split_value
                    elif not ext:
                        lo, ro = (s, oacc) if b else (oacc, s)
                        oacc = hash2_domain(DOM_BRANCH, lo, ro)
                rows.append((
                    int(j == 0), int(j == n_rows - 1), int(u.was_empty and j == 0),
                    b, s, oacc, nacc, u.key, u.old_value, u.new_value,
                    u.old_root, u.new_root, ext, k1, v1,
                    int(u.new_empty and j == 0),
                    int(u.occupied and j == 0),
                ))
            assert oacc == u.old_root and nacc == u.new_root
        return rows

    def _target(self, n: int) -> int:
        t = self.params.target_rows or len(self._rows())
        assert len(self._rows()) <= t <= usable_rows(n)
        return t

    def _expo_base(self) -> int:
        return sum(u.depth + 1 for u in self.updates)

    def _group_sizes(self) -> list[int]:
        if self.chain_groups is not None:
            assert sum(self.chain_groups) == len(self.updates)
            return list(self.chain_groups)
        return [len(self.updates)] if self.updates else []

    def fixed_columns(self, n: int):
        t = self._target(n)
        mont = F.mont_from_ints
        n_real = sum(u.depth + 1 for u in self.updates)
        # q_link: 1 on the leaf row of every non-group-start real update
        link = [0] * n
        pos = 0
        j = 0
        for gsize in self._group_sizes():
            for gi in range(gsize):
                if gi:
                    link[pos] = 1
                pos += self.updates[j].depth + 1
                j += 1
        out = {
            self.q_mpt: mont([1 if i < t else 0 for i in range(n)]),
            self.q_row0: mont([1 if i == 0 else 0 for i in range(n)]),
            self.q_chain: mont([1 if i < n_real else 0 for i in range(n)]),
            self.q_link: mont(link),
        }
        if self.storage is not None or self.accounts is not None:
            out[self.tbl_byte] = mont(
                [i if i < 256 else 0 for i in range(n)]
            )
            assert n >= 256, "schema bridges need the byte range table"
        if self.accounts is not None:
            base = self._expo_base()
            x_en = [0] * n
            x_tag = [0] * n
            for i in range(len(self.accounts)):
                for tg in range(4):  # Nonce=1, Balance=2, CodeHash=3,
                    x_en[base + 4 * i + tg] = 1  # CodeSize=4
                    x_tag[base + 4 * i + tg] = tg + 1
            assert base + 4 * len(self.accounts) <= usable_rows(n)
            out[self.x_en] = mont(x_en)
            out[self.x_tag] = mont(x_tag)
        if self.standalone:
            n_evs = len(self._poseidon_rows()) \
                + len(self._storage_bridge_rows()) \
                + len(self._account_bridge_rows())
            if t > sum(u.depth + 1 for u in self.updates):
                n_evs += 1  # pad-block leaf hash row (see synthesize)
            out[self.t_en] = mont(
                [1 if i < n_evs else 0 for i in range(n)]
            )
        return out

    def _poseidon_rows(self):
        from ..witness.mpt import mpt_poseidon_events

        return [
            (ev.domain, ev.in0, ev.in1,
             hash2_domain(ev.domain, ev.in0, ev.in1))
            for ev in mpt_poseidon_events(self.updates)
        ]

    def _storage_bridge_rows(self):
        """Extra poseidon permutations backing the storage-schema bridges
        (key derivation + value packing), for the standalone witness table
        and composed-mode PoseidonEvents."""
        if self.storage is None:
            return []
        from ..witness.mpt import DOM_SKEY, DOM_SVAL
        from ..trie.zktrie import hash2_domain as h2

        HALF = (1 << 128) - 1
        out = []
        for su in self.storage:
            k_lo, k_hi = su.key & HALF, su.key >> 128
            inner = h2(DOM_SKEY, k_lo, k_hi)
            out.append((DOM_SKEY, k_lo, k_hi, inner))
            out.append((DOM_SKEY, su.addr, inner,
                        h2(DOM_SKEY, su.addr, inner)))
            if su.old_word:
                out.append((DOM_SVAL, su.old_word & HALF,
                            su.old_word >> 128,
                            h2(DOM_SVAL, su.old_word & HALF,
                               su.old_word >> 128)))
            if su.new_word:
                out.append((DOM_SVAL, su.new_word & HALF,
                            su.new_word >> 128,
                            h2(DOM_SVAL, su.new_word & HALF,
                               su.new_word >> 128)))
        if self.two_level:
            # subtrie keys skip the address wrap — rebuild without it
            out = []
            for su in self.storage:
                k_lo, k_hi = su.key & HALF, su.key >> 128
                out.append((DOM_SKEY, k_lo, k_hi,
                            h2(DOM_SKEY, k_lo, k_hi)))
                for w in (su.old_word, su.new_word):
                    if w:
                        out.append((DOM_SVAL, w & HALF, w >> 128,
                                    h2(DOM_SVAL, w & HALF, w >> 128)))
        return out

    def _account_bridge_rows(self):
        """Poseidon permutations backing the account-schema bridges."""
        if self.accounts is None:
            return []
        from ..witness.mpt import (
            DOM_A1, DOM_A2, DOM_ABAL, DOM_ACH, DOM_AKEY,
        )
        from ..trie.zktrie import hash2_domain as h2

        HALF = (1 << 128) - 1
        out = []
        for au in self.accounts:
            out.append((DOM_AKEY, au.addr, 0, h2(DOM_AKEY, au.addr, 0)))
            for fl, upd in ((au.old.is_empty(), au.old),
                            (au.new.is_empty(), au.new)):
                if fl:
                    continue
                b_lo, b_hi = upd.balance & HALF, upd.balance >> 128
                c_lo, c_hi = upd.code_hash & HALF, upd.code_hash >> 128
                balp = h2(DOM_ABAL, b_lo, b_hi)
                chp = h2(DOM_ACH, c_lo, c_hi)
                npack = upd.nonce + (upd.code_size << 64)
                h1_ = h2(DOM_A1, npack, balp)
                h2__ = h2(DOM_A1, chp, upd.storage_root)
                out += [
                    (DOM_ABAL, b_lo, b_hi, balp),
                    (DOM_ACH, c_lo, c_hi, chp),
                    (DOM_A1, npack, balp, h1_),
                    (DOM_A1, chp, upd.storage_root, h2__),
                    (DOM_A2, h1_, h2__, h2(DOM_A2, h1_, h2__)),
                ]
        return out

    def poseidon_events(self):
        """Composed mode: every permutation this circuit looks up
        (paths + storage bridges) as PoseidonEvents."""
        from ..circuits.poseidon import PoseidonEvent
        from ..witness.mpt import mpt_poseidon_events

        evs = list(mpt_poseidon_events(self.updates))
        for (dom, a, b, _) in (self._storage_bridge_rows()
                               + self._account_bridge_rows()):
            evs.append(PoseidonEvent(domain=dom, in0=a, in1=b))
        return evs

    # -- composition cell accessors --------------------------------------
    def update_root_cells(self, j: int):
        """(old_root@leaf_row, new_root@last_row) cells of update j."""
        pos = self._leaf_row_positions()[j]
        last = pos + self.updates[j].depth
        return (Cell("advice", self.c_old_root, pos),
                Cell("advice", self.c_new_root, last))

    def storage_addr_cell(self, j: int):
        return Cell("advice", self.s_addr, self._leaf_row_positions()[j])

    def account_cells(self, i: int):
        """{name: Cell} of account i's leaf-row bridge cells."""
        pos = self._leaf_row_positions()[i]
        c = lambda col: Cell("advice", col, pos)
        return {
            "addr": c(self.a_addr),
            "sroot_old": c(self.a_sroot[0]),
            "sroot_new": c(self.a_sroot[1]),
        }

    def _leaf_row_positions(self):
        pos, out = 0, []
        for u in self.updates:
            out.append(pos)
            pos += u.depth + 1
        return out

    def copy_constraints(self, n):
        """Account mode: bind the exposure section to the leaf-row bridge
        cells (field_tag order Nonce, Balance, CodeHash, CodeSize)."""
        if self.accounts is None:
            return []
        out = []
        base = self._expo_base()
        for i, au in enumerate(self.accounts):
            pos = self._leaf_row_positions()[i]
            c = lambda col, row: Cell("advice", col, row)
            for tg in range(4):
                out.append((c(self.x_addr, base + 4 * i + tg),
                            c(self.a_addr, pos)))
            pairs = [
                (self.a_non[0], self.a_non[1]),          # Nonce (raw)
                (self.a_bal_rlc[0], self.a_bal_rlc[1]),  # Balance (RLC)
                (self.a_ch_rlc[0], self.a_ch_rlc[1]),    # CodeHash (RLC)
                (self.a_cs[0], self.a_cs[1]),            # CodeSize (raw)
            ]
            for tg, (oc, nc) in enumerate(pairs):
                out.append((c(self.x_old, base + 4 * i + tg), c(oc, pos)))
                out.append((c(self.x_new, base + 4 * i + tg), c(nc, pos)))
        return out

    def synthesize(self, phase: int, n: int, challenges: dict, instances):
        if phase == 1 and self.storage is not None:
            r_chal = challenges[self._shared_challenge.index]
            r_int = F.to_int(F.from_mont(r_chal))
            from ..circuits.state import word_rlc

            key_rlc = [0] * n
            old_rlc = [0] * n
            new_rlc = [0] * n
            for su, pos in zip(self.storage, self._leaf_row_positions()):
                key_rlc[pos] = word_rlc(su.key, r_int)
                old_rlc[pos] = word_rlc(su.old_word, r_int)
                new_rlc[pos] = word_rlc(su.new_word, r_int)
            mont = F.mont_from_ints
            return {
                self.s_key_rlc: mont(key_rlc),
                self.s_old_rlc: mont(old_rlc),
                self.s_new_rlc: mont(new_rlc),
            }
        if phase == 1 and self.accounts is not None:
            r_chal = challenges[self._shared_challenge.index]
            r_int = F.to_int(F.from_mont(r_chal))
            from ..circuits.state import word_rlc

            def ch_rlc(v: int) -> int:
                acc = 0
                for i, b in enumerate(v.to_bytes(32, "big")):
                    acc = (acc + b * pow(r_int, i, R)) % R
                return acc

            bal = [[0] * n, [0] * n]
            ch = [[0] * n, [0] * n]
            x_old = [0] * n
            x_new = [0] * n
            base = self._expo_base()
            for i, (au, pos) in enumerate(
                zip(self.accounts, self._leaf_row_positions())
            ):
                for sd, f in ((0, au.old), (1, au.new)):
                    bal[sd][pos] = word_rlc(f.balance, r_int)
                    ch[sd][pos] = ch_rlc(f.code_hash)
                encs = [
                    (au.old.nonce, au.new.nonce),
                    (word_rlc(au.old.balance, r_int),
                     word_rlc(au.new.balance, r_int)),
                    (ch_rlc(au.old.code_hash), ch_rlc(au.new.code_hash)),
                    (au.old.code_size, au.new.code_size),
                ]
                for tg, (ov, nv) in enumerate(encs):
                    x_old[base + 4 * i + tg] = ov
                    x_new[base + 4 * i + tg] = nv
            mont = F.mont_from_ints
            return {
                self.a_bal_rlc[0]: mont(bal[0]),
                self.a_bal_rlc[1]: mont(bal[1]),
                self.a_ch_rlc[0]: mont(ch[0]),
                self.a_ch_rlc[1]: mont(ch[1]),
                self.x_old: mont(x_old),
                self.x_new: mont(x_new),
            }
        if phase != 0:
            return {}
        rows = self._rows()
        t = self._target(n)
        # padding rows are degenerate depth-0 updates "insert value 0 at
        # key 0 into an empty slot": old side empty (emp=1, old_acc=0,
        # old_root=0), new side a real (key=0, value=0) leaf — the ONE
        # extra poseidon row H(DOM_LEAF, 0, 0) is appended to the table
        # witness (composed mode must add the matching PoseidonEvent).
        pad_hash = hash2_domain(DOM_LEAF, 0, 0)
        pad = (1, 1, 1, 0, 0, 0, pad_hash, 0, 0, 0, 0, pad_hash, 0, 0, 0,
               0, 0)
        n_real = len(rows)
        rows = rows + [pad] * (t - n_real)
        mont = lambda vals: F.mont_from_ints_padded(vals, n)
        cols = {}
        for ci, idx in (
            (self.c_first, 0), (self.c_last, 1), (self.c_emp, 2),
            (self.c_bit, 3), (self.c_sib, 4), (self.c_old_acc, 5),
            (self.c_new_acc, 6), (self.c_key, 7), (self.c_old_v, 8),
            (self.c_new_v, 9), (self.c_old_root, 10), (self.c_new_root, 11),
            (self.c_ext, 12), (self.c_k1, 13), (self.c_v1, 14),
            (self.c_nemp, 15), (self.c_occ, 16),
        ):
            cols[ci] = mont([r[idx] for r in rows])
        kinv_c = [0] * n
        pos0 = 0
        for u in self.updates:
            if u.occupied:
                kinv_c[pos0] = pow((u.occ_key - u.key) % R, -1, R)
            pos0 += u.depth + 1
        cols[self.c_kinv] = mont(kinv_c)
        if self.storage is not None:
            from ..witness.mpt import DOM_SKEY
            from ..trie.zktrie import hash2_domain as h2

            HALF = (1 << 128) - 1
            addr_c = [0] * n
            inner_c = [0] * n
            kb = [[0] * n for _ in range(32)]
            ob = [[0] * n for _ in range(32)]
            nb = [[0] * n for _ in range(32)]
            for su, pos in zip(self.storage, self._leaf_row_positions()):
                addr_c[pos] = su.addr
                inner_c[pos] = h2(DOM_SKEY, su.key & HALF, su.key >> 128)
                for i, b in enumerate(su.key.to_bytes(32, "little")):
                    kb[i][pos] = b
                for i, b in enumerate(su.old_word.to_bytes(32, "little")):
                    ob[i][pos] = b
                for i, b in enumerate(su.new_word.to_bytes(32, "little")):
                    nb[i][pos] = b
            cols[self.s_addr] = mont(addr_c)
            cols[self.s_inner] = mont(inner_c)
            nz_c = [0] * n
            for su, pos in zip(self.storage, self._leaf_row_positions()):
                nz_c[pos] = int(su.new_word != 0)
            cols[self.s_nz] = mont(nz_c)
            for i in range(32):
                cols[self.kb[i]] = mont(kb[i])
                cols[self.ob[i]] = mont(ob[i])
                cols[self.nb[i]] = mont(nb[i])
        if self.accounts is not None:
            from ..witness.mpt import DOM_A1, DOM_ABAL, DOM_ACH
            from ..trie.zktrie import hash2_domain as h2

            HALF = (1 << 128) - 1
            addr_c = [0] * n
            nz_c = [0] * n
            non = [[0] * n, [0] * n]
            csz = [[0] * n, [0] * n]
            srt = [[0] * n, [0] * n]
            balp = [[0] * n, [0] * n]
            chp = [[0] * n, [0] * n]
            h1c = [[0] * n, [0] * n]
            h2c = [[0] * n, [0] * n]
            bbank = [[[0] * n for _ in range(32)] for _ in range(2)]
            cbank = [[[0] * n for _ in range(32)] for _ in range(2)]
            x_addr = [0] * n
            base = self._expo_base()
            for i, (au, pos) in enumerate(
                zip(self.accounts, self._leaf_row_positions())
            ):
                addr_c[pos] = au.addr
                nz_c[pos] = int(not au.new.is_empty())
                for tg in range(4):
                    x_addr[base + 4 * i + tg] = au.addr
                for sd, f in ((0, au.old), (1, au.new)):
                    if (sd == 0 and f.is_empty()) or \
                            (sd == 1 and f.is_empty()):
                        continue
                    non[sd][pos] = f.nonce
                    csz[sd][pos] = f.code_size
                    srt[sd][pos] = f.storage_root
                    for j, b in enumerate(
                        f.balance.to_bytes(32, "little")
                    ):
                        bbank[sd][j][pos] = b
                    for j, b in enumerate(
                        f.code_hash.to_bytes(32, "little")
                    ):
                        cbank[sd][j][pos] = b
                    bp = h2(DOM_ABAL, f.balance & HALF, f.balance >> 128)
                    cp = h2(DOM_ACH, f.code_hash & HALF,
                            f.code_hash >> 128)
                    balp[sd][pos] = bp
                    chp[sd][pos] = cp
                    h1c[sd][pos] = h2(
                        DOM_A1, f.nonce + (f.code_size << 64), bp
                    )
                    h2c[sd][pos] = h2(DOM_A1, cp, f.storage_root)
            cols[self.a_addr] = mont(addr_c)
            cols[self.a_nz] = mont(nz_c)
            cols[self.x_addr] = mont(x_addr)
            for sd in range(2):
                cols[self.a_non[sd]] = mont(non[sd])
                cols[self.a_cs[sd]] = mont(csz[sd])
                cols[self.a_sroot[sd]] = mont(srt[sd])
                cols[self.a_balp[sd]] = mont(balp[sd])
                cols[self.a_chp[sd]] = mont(chp[sd])
                cols[self.a_h1[sd]] = mont(h1c[sd])
                cols[self.a_h2[sd]] = mont(h2c[sd])
                for j in range(32):
                    cols[(self.bb_o if sd == 0 else self.bb_n)[j]] = \
                        mont(bbank[sd][j])
                    cols[(self.cb_o if sd == 0 else self.cb_n)[j]] = \
                        mont(cbank[sd][j])
        if self.standalone:
            evs = (self._poseidon_rows() + self._storage_bridge_rows()
                   + self._account_bridge_rows())
            if t > n_real:
                evs = evs + [(DOM_LEAF, 0, 0, pad_hash)]
            cols[self.t_dom] = mont([e[0] for e in evs])
            cols[self.t_in0] = mont([e[1] for e in evs])
            cols[self.t_in1] = mont([e[2] for e in evs])
            cols[self.t_out] = mont([e[3] for e in evs])
        return cols
