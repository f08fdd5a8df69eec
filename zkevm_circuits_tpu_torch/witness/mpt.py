"""MPT update witness (port of zkevm_circuits_tpu/witness/mpt.py): zktrie
state transitions with Merkle proofs.

Equivalent of the reference's `ZktrieState` -> `MptUpdates` pipeline
(reference zktrie/src/state.rs:84-156, zkevm-circuits/src/witness/mpt.rs:93,
SURVEY.md §2.1 item 9): applies key/value writes to the sparse
Poseidon-Merkle trie and records, per write, everything the MPT circuit
needs (old/new roots, the shared sibling path, leaf values).

Round-1 scope: value updates of EXISTING keys re-use the same tree shape
(old and new paths share all siblings); fresh-key insertions that split a
leaf are applied to the trie but witness rows are only emitted when the
insertion does not restructure the path (i.e. lands in an empty slot —
the leaf-split gadget is a documented gap, reference halo2-mpt-circuits
covers it via its extension-node machinery).
"""

from __future__ import annotations

import dataclasses

from ..crypto.params import FR_MODULUS as P
from ..trie.zktrie import DOM_LEAF, ZkTrie, hash2_domain


@dataclasses.dataclass
class MptUpdate:
    key: int
    old_value: int  # 0 => the slot was empty (fresh insert into empty slot)
    new_value: int
    old_root: int
    new_root: int
    depth: int
    siblings: list[int]  # top-down
    bits: list[int]  # top-down path bits (little-endian key bits)
    was_empty: bool
    # leaf-split insertion: the displaced leaf (old_depth < depth); the
    # old path ends at leaf(split_key, split_value) at split_old_depth
    split_old_depth: int = -1  # -1 => not a split
    split_key: int = 0
    split_value: int = 0
    # no-op absence proof: writing "empty" (value 0) into an empty slot
    # leaves the trie untouched — both sides walk the same empty path
    # (the account-level read of a non-existing account).  When a FOREIGN
    # leaf occupies the walk's endpoint, both chains seed at its hash and
    # the circuit additionally proves occ_key != key.
    new_empty: bool = False
    occupied: bool = False
    occ_key: int = 0
    occ_value: int = 0

    @property
    def is_split(self) -> bool:
        return self.split_old_depth >= 0


class MptUpdates:
    """Apply writes in order, recording one MptUpdate per write."""

    def __init__(self, trie: ZkTrie | None = None):
        self.trie = trie or ZkTrie()
        self.updates: list[MptUpdate] = []

    def write(self, key: int, new_value: int) -> MptUpdate:
        key %= P
        old_root = self.trie.root()
        before = self.trie.prove(key)
        was_existing = before.found and before.leaf_key == key
        if new_value == 0 and not was_existing:
            # absence no-op: nothing to insert, both sides walk the same
            # path — from an empty slot (chains seed at 0) or from a
            # FOREIGN occupying leaf (chains seed at its hash; the
            # circuit proves occ_key != key)
            upd = MptUpdate(
                key=key, old_value=0, new_value=0, old_root=old_root,
                new_root=old_root, depth=before.depth,
                siblings=before.siblings,
                bits=[(key >> d) & 1 for d in range(before.depth)],
                was_empty=True, new_empty=True,
                occupied=bool(before.found),
                occ_key=before.leaf_key if before.found else 0,
                occ_value=before.leaf_value if before.found else 0,
            )
            self.updates.append(upd)
            return upd
        self.trie.update(key, new_value)
        after = self.trie.prove(key)
        new_root = self.trie.root()
        split_old_depth, split_key, split_value = -1, 0, 0
        if was_existing:
            assert after.depth == before.depth
            assert after.siblings == before.siblings, "structure changed"
            old_value = before.leaf_value
            was_empty = False
        elif before.found:
            # leaf split: the occupying leaf moved down; the new path's
            # shared prefix keeps the old siblings, the extension zone is
            # empty, and the displaced leaf is the bottom sibling
            d0, d1 = before.depth, after.depth
            assert d1 > d0
            assert after.siblings[:d0] == before.siblings
            assert all(s == 0 for s in after.siblings[d0 : d1 - 1])
            leaf_h = hash2_domain(
                DOM_LEAF, before.leaf_key, before.leaf_value
            )
            assert after.siblings[d1 - 1] == leaf_h
            split_old_depth = d0
            split_key = before.leaf_key
            split_value = before.leaf_value
            old_value = 0
            was_empty = True
        else:
            if after.depth != before.depth:
                raise NotImplementedError(
                    "unexpected restructure without a displaced leaf"
                )
            old_value = 0
            was_empty = True
        upd = MptUpdate(
            key=key, old_value=old_value, new_value=new_value,
            old_root=old_root, new_root=new_root, depth=after.depth,
            siblings=after.siblings,
            bits=[(key >> d) & 1 for d in range(after.depth)],
            was_empty=was_empty, split_old_depth=split_old_depth,
            split_key=split_key, split_value=split_value,
        )
        self.updates.append(upd)
        return upd

    def poseidon_events(self):
        return mpt_poseidon_events(self.updates)


def mpt_poseidon_events(updates: list[MptUpdate]):
    """Every Poseidon permutation the MPT circuit will look up, as
    PoseidonEvent triples (the Poseidon circuit's witness share)."""
    from ..circuits.poseidon import PoseidonEvent
    from ..trie.zktrie import DOM_BRANCH

    events = []

    def emit(update: MptUpdate, value: int, skip_leaf: bool,
             depth: int | None = None, seed: int = 0):
        if not skip_leaf:
            acc = hash2_domain(DOM_LEAF, update.key, value)
            events.append(
                PoseidonEvent(domain=DOM_LEAF, in0=update.key, in1=value)
            )
        else:
            acc = seed
        for d in reversed(range(update.depth if depth is None else depth)):
            sib = update.siblings[d]
            l, r = (sib, acc) if update.bits[d] else (acc, sib)
            events.append(PoseidonEvent(domain=DOM_BRANCH, in0=l, in1=r))
            acc = hash2_domain(DOM_BRANCH, l, r)

    for u in updates:
        if u.is_split:
            # old side: the displaced leaf hashed up from its OLD depth
            leaf_h = hash2_domain(DOM_LEAF, u.split_key, u.split_value)
            events.append(PoseidonEvent(
                domain=DOM_LEAF, in0=u.split_key, in1=u.split_value
            ))
            emit(u, 0, skip_leaf=True, depth=u.split_old_depth, seed=leaf_h)
        elif u.occupied:
            leaf_h = hash2_domain(DOM_LEAF, u.occ_key, u.occ_value)
            events.append(PoseidonEvent(
                domain=DOM_LEAF, in0=u.occ_key, in1=u.occ_value
            ))
            emit(u, 0, skip_leaf=True, seed=leaf_h)
            emit(u, 0, skip_leaf=True, seed=leaf_h)
            continue
        else:
            emit(u, u.old_value, skip_leaf=u.was_empty)
        emit(u, u.new_value, skip_leaf=u.new_empty)
    return events


# ---------------------------------------------------------------------------
# storage <-> trie schema (reference zktrie/src/state/builder.rs:80,167 uses
# the two-level account/storage layout; v1 here derives flat trie keys —
# the two-level split lands with account-trie work).  Conventions:
#   trie_key(addr, key) = H(DOM_SKEY, addr, H(DOM_SKEY, key_lo, key_hi))
#   leaf value         = H(DOM_SVAL, value_lo, value_hi)
# with 128-bit lo/hi halves — everything a circuit can rebind through
# PoseidonTable lookups (circuits/mpt.py key/value bridges).
# ---------------------------------------------------------------------------
DOM_SKEY = 3
DOM_SVAL = 4
_HALF = (1 << 128) - 1


def storage_trie_key(addr: int, key: int) -> int:
    inner = hash2_domain(DOM_SKEY, key & _HALF, key >> 128)
    return hash2_domain(DOM_SKEY, addr % P, inner)


def storage_leaf_value(value: int) -> int:
    if value == 0:
        return 0  # empty slot convention (delete-on-zero pending)
    return hash2_domain(DOM_SVAL, value & _HALF, value >> 128)


@dataclasses.dataclass
class StorageUpdate:
    """One per-(addr, key) storage transition of a block: committed ->
    final value, with the raw words the circuits' RLC bridges bind."""

    addr: int
    key: int  # 256-bit storage slot
    old_word: int
    new_word: int
    mpt: MptUpdate


def storage_updates_from_rws(rws, trie: ZkTrie | None = None):
    """Group the RW table's Storage rows by (addr, key); one trie write
    per touched slot: committed value (first value_prev) -> final value
    (last value) — the reference's MptUpdates::from_rws shape
    (zkevm-circuits/src/witness/mpt.rs:93)."""
    from .rw import RwTag

    groups: dict[tuple[int, int], list] = {}
    order: list[tuple[int, int]] = []
    for r in rws:
        if r.tag != RwTag.Storage:
            continue
        g = (r.address, r.storage_key)
        if g not in groups:
            groups[g] = []
            order.append(g)
        groups[g].append(r)
    ups = MptUpdates(trie)
    out: list[StorageUpdate] = []
    for g in order:
        rows = sorted(groups[g], key=lambda r: r.rw_counter)
        committed = rows[0].value_prev
        final = rows[-1].value
        addr, key = g
        # seed the committed value, then apply the block's transition
        if committed:
            ups.trie.update(storage_trie_key(addr, key),
                            storage_leaf_value(committed))
    for g in order:
        rows = sorted(groups[g], key=lambda r: r.rw_counter)
        committed = rows[0].value_prev
        final = rows[-1].value
        addr, key = g
        upd = ups.write(storage_trie_key(addr, key),
                        storage_leaf_value(final))
        out.append(StorageUpdate(addr=addr, key=key, old_word=committed,
                                 new_word=final, mpt=upd))
    return out, ups


# ---------------------------------------------------------------------------
# Two-level state layout (reference zktrie/src/state/builder.rs:80,167:
# the account trie's leaves pack nonce/code_size/balance/code_hash and the
# root of that account's OWN storage subtrie).  Conventions:
#   account_trie_key(addr)  = H(DOM_AKEY, addr, 0)
#   subtrie_key(slot)       = H(DOM_SKEY, slot_lo, slot_hi)   (no addr —
#                             the addr binding is the account leaf itself)
#   leaf value = H(DOM_A2, H(DOM_A1, nonce + 2^64*code_size, bal_packed),
#                          H(DOM_A1, ch_packed, storage_root))
#   bal_packed = H(DOM_ABAL, bal_lo, bal_hi)
#   ch_packed  = H(DOM_ACH, ch_lo, ch_hi)
# and the all-zero account packs to leaf value 0 (empty-slot convention).
# ---------------------------------------------------------------------------
DOM_AKEY = 5
DOM_ABAL = 6
DOM_ACH = 7
DOM_A1 = 8
DOM_A2 = 9


def account_trie_key(addr: int) -> int:
    return hash2_domain(DOM_AKEY, addr % P, 0)


def subtrie_key(slot: int) -> int:
    return hash2_domain(DOM_SKEY, slot & _HALF, slot >> 128)


def account_leaf_value(nonce: int, code_size: int, balance: int,
                       code_hash: int, storage_root: int) -> int:
    if not (nonce or code_size or balance or code_hash or storage_root):
        return 0
    balp = hash2_domain(DOM_ABAL, balance & _HALF, balance >> 128)
    chp = hash2_domain(DOM_ACH, code_hash & _HALF, code_hash >> 128)
    h1 = hash2_domain(DOM_A1, (nonce + (code_size << 64)) % P, balp)
    h2 = hash2_domain(DOM_A1, chp, storage_root % P)
    return hash2_domain(DOM_A2, h1, h2)


@dataclasses.dataclass
class AccountFields:
    nonce: int = 0
    code_size: int = 0
    balance: int = 0
    code_hash: int = 0
    storage_root: int = 0

    def leaf(self) -> int:
        return account_leaf_value(self.nonce, self.code_size, self.balance,
                                  self.code_hash, self.storage_root)

    def is_empty(self) -> bool:
        return not (self.nonce or self.code_size or self.balance
                    or self.code_hash or self.storage_root)


@dataclasses.dataclass
class AccountUpdate:
    """One per-account transition of a block: committed -> final fields,
    with the account-trie path (reference witness/mpt.rs:93 account
    rows)."""

    addr: int
    old: AccountFields
    new: AccountFields
    mpt: MptUpdate


def two_level_updates_from_rws(rws, accounts_before: dict | None = None):
    """Group the block's Storage and Account rows into the two-level
    layout: per-account storage subtries (committed -> final slot values)
    whose roots feed per-account account-trie updates.

    `accounts_before`: {addr: AccountFields-like or (nonce, code_size,
    balance, code_hash)} pre-state for fields the rws never touch.

    Returns (storage_updates, storage_groups, account_updates, tries):
      storage_updates — list[StorageUpdate], ordered per account,
      storage_groups  — list[(addr, n_updates, sroot_old, sroot_new)],
      account_updates — list[AccountUpdate] in the account trie,
      tries           — (account_trie, {addr: subtrie}).
    """
    from .rw import AccountField, RwTag

    # --- per-account storage subtries -----------------------------------
    stor_groups: dict[int, dict[int, list]] = {}
    addr_order: list[int] = []
    acct_rows: dict[int, dict[int, list]] = {}
    for r in rws:
        if r.tag == RwTag.Storage:
            stor_groups.setdefault(r.address, {})
            if r.address not in addr_order:
                addr_order.append(r.address)
            stor_groups[r.address].setdefault(r.storage_key, []).append(r)
        elif r.tag == RwTag.Account:
            acct_rows.setdefault(r.address, {})
            if r.address not in addr_order:
                addr_order.append(r.address)
            acct_rows[r.address].setdefault(int(r.field_tag), []).append(r)

    storage_updates: list[StorageUpdate] = []
    groups: list[tuple] = []
    sroots: dict[int, tuple[int, int]] = {}
    subtries: dict[int, ZkTrie] = {}
    for addr in addr_order:
        slots = stor_groups.get(addr)
        if not slots:
            continue
        trie = ZkTrie()
        transitions = []
        for slot, rows_ in slots.items():
            rows_ = sorted(rows_, key=lambda r: r.rw_counter)
            committed, final = rows_[0].value_prev, rows_[-1].value
            if committed:
                trie.update(subtrie_key(slot), storage_leaf_value(committed))
            transitions.append((slot, committed, final))
        sroot_old = trie.root()
        ups = MptUpdates(trie)
        n_here = 0
        for slot, committed, final in transitions:
            upd = ups.write(subtrie_key(slot), storage_leaf_value(final))
            storage_updates.append(StorageUpdate(
                addr=addr, key=slot, old_word=committed, new_word=final,
                mpt=upd,
            ))
            n_here += 1
        sroots[addr] = (sroot_old, trie.root())
        groups.append((addr, n_here, sroot_old, trie.root()))
        subtries[addr] = trie

    # --- account trie ----------------------------------------------------
    def before(addr) -> AccountFields:
        src = (accounts_before or {}).get(addr)
        if src is None:
            f = AccountFields()
        elif isinstance(src, AccountFields):
            f = dataclasses.replace(src)
        else:
            f = AccountFields(*src)
        f.storage_root = sroots.get(addr, (0, 0))[0]
        return f

    FIELD_ATTR = {
        int(AccountField.Nonce): "nonce",
        int(AccountField.Balance): "balance",
        int(AccountField.CodeHash): "code_hash",
        int(AccountField.CodeSize): "code_size",
    }
    acct_trie = ZkTrie()
    plans = []
    for addr in addr_order:
        old_f = before(addr)
        new_f = dataclasses.replace(old_f)
        for ftag, rows_ in acct_rows.get(addr, {}).items():
            rows_ = sorted(rows_, key=lambda r: r.rw_counter)
            committed, final = rows_[0].value_prev, rows_[-1].value
            attr = FIELD_ATTR[ftag]
            assert getattr(old_f, attr) == committed, (
                f"pre-state mismatch for {attr} of {addr:#x}: "
                f"{getattr(old_f, attr)} vs committed {committed}"
            )
            setattr(new_f, attr, final)
        new_f.storage_root = sroots.get(addr, (0, 0))[1]
        plans.append((addr, old_f, new_f))
        if not old_f.is_empty():
            acct_trie.update(account_trie_key(addr), old_f.leaf())
    a_ups = MptUpdates(acct_trie)
    account_updates = []
    for addr, old_f, new_f in plans:
        upd = a_ups.write(account_trie_key(addr), new_f.leaf())
        account_updates.append(AccountUpdate(
            addr=addr, old=old_f, new=new_f, mpt=upd,
        ))
    return storage_updates, groups, account_updates, (acct_trie, subtries)
