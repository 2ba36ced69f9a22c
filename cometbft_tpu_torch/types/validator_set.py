"""Validator and ValidatorSet (reference: ``types/validator.go``,
``types/validator_set.go``).

Counterpart of ``cometbft_tpu/types/validator_set.py``: the
address-sorted validator list, lookups by index and by address, the
total voting power, the dense columnar view of an all-Ed25519 set, the
BLS cohort, the set's merkle hash, and proposer rotation with set
updates.  Validators hold Ed25519 or BLS12-381 keys.

Proposer selection is the reference's weighted round-robin over
proposer priorities: each increment adds every validator's voting power
to its priority, picks the largest (ties go to the lower address) and
charges the winner the total voting power.  Priorities are centred on
their average and rescaled so that their spread stays within
``2 * total_power``, all with Go's truncating integer division
(:func:`_go_div`), which differs from Python's floor division on
negative numbers and is consensus-critical.  A new set is incremented
once, as in the JAX package, so its stored bytes (``types/codec.py``)
match.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from ..crypto import merkle
from . import wire

__all__ = ["MAX_TOTAL_VOTING_POWER", "PRIORITY_WINDOW_SIZE_FACTOR",
           "Validator", "ValidatorSet"]

MAX_TOTAL_VOTING_POWER = (2**63 - 1) // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2

# caches derived from membership and powers, dropped on an update
_DERIVED = ("_dense", "_addr_idx", "_bls_cohort", "_bls_agg_tbl",
            "_bls_dev_tbl")


def _go_div(a: int, b: int) -> int:
    """Integer division truncating toward zero (Go semantics)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _pubkey_proto(pk) -> bytes:
    """cometbft.crypto.v1.PublicKey oneof: 1=ed25519, 3=bls12_381 (2 is
    secp256k1, which the port does not carry)."""
    fld = {"ed25519": 1, "bls12_381": 3}[pk.type()]
    return wire.field_bytes(fld, pk.bytes(), force=True)


@dataclass
class Validator:
    pub_key: object                  # Ed25519PubKey or Bls12381PubKey
    voting_power: int
    proposer_priority: int = 0
    _address: bytes = field(default=b"", repr=False)

    @property
    def address(self) -> bytes:
        if not self._address:
            self._address = self.pub_key.address()
        return self._address

    def copy(self) -> "Validator":
        return replace(self)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break to the smaller address."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        return self if self.address < other.address else other

    def simple_encode(self) -> bytes:
        """SimpleValidator proto for set hashing (types/validator.go)."""
        return (wire.field_message(1, _pubkey_proto(self.pub_key), force=True)
                + wire.field_varint(2, self.voting_power))


class ValidatorSet:
    """Validators sorted by address (the reference's order) and the
    rotating proposer."""

    def __init__(self, validators: list[Validator]):
        vals = sorted((v.copy() for v in validators),
                      key=lambda v: v.address)
        if len({v.address for v in vals}) != len(vals):
            raise ValueError("duplicate validator address")
        if any(v.voting_power < 0 for v in vals):
            raise ValueError("negative voting power")
        self.validators: list[Validator] = vals
        self._total: int | None = None
        self.proposer: Validator | None = None
        if vals:
            self.increment_proposer_priority(1)

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total is None:
            t = sum(v.voting_power for v in self.validators)
            if t > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power exceeds cap")
            self._total = t
        return self._total

    def get_by_address(self, addr: bytes) -> tuple[int, Validator | None]:
        i = self.address_index().get(addr)
        return (-1, None) if i is None else (i, self.validators[i])

    def get_by_index(self, idx: int) -> Validator | None:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def dense(self):
        """Cached ``(pubkeys uint8 (N, 32), powers int64 (N,))``: the
        matrices the dense verify path and the per-valset table cache
        key on; None when the set is empty or any key is not Ed25519 (such
        sets verify through the lane loop of ``types/validation.py``)."""
        d = self.__dict__.get("_dense", False)
        if d is False:
            n = len(self.validators)
            d = None
            if n and all(v.pub_key.type() == "ed25519"
                         for v in self.validators):
                pubs = np.frombuffer(
                    b"".join(v.pub_key.bytes() for v in self.validators),
                    np.uint8).reshape(n, 32)
                powers = np.fromiter(
                    (v.voting_power for v in self.validators), np.int64, n)
                d = (pubs, powers)
            self.__dict__["_dense"] = d
        return d

    def bls_cohort(self) -> tuple:
        """Cached ``(indices tuple, pubkeys tuple)`` of the validators with
        bls12_381 keys, in index order; empty tuples on an all-Ed25519
        set."""
        c = self.__dict__.get("_bls_cohort")
        if c is None:
            idx, pks = [], []
            for i, v in enumerate(self.validators):
                if v.pub_key.type() == "bls12_381":
                    idx.append(i)
                    pks.append(v.pub_key.bytes())
            c = (tuple(idx), tuple(pks))
            self.__dict__["_bls_cohort"] = c
        return c

    def has_bls(self) -> bool:
        return bool(self.bls_cohort()[0])

    def hash(self, device=None) -> bytes:
        """Merkle root of the validators' simple encodings; at
        ``merkle.MERKLE_KERNEL_MIN_LEAVES`` validators or more it is
        hashed by the kernels on ``device`` (None: CUDA)."""
        return merkle.hash_from_byte_slices_fast(
            [v.simple_encode() for v in self.validators], device=device)

    def address_index(self) -> dict:
        """Cached address -> row map."""
        m = self.__dict__.get("_addr_idx")
        if m is None:
            m = {v.address: i for i, v in enumerate(self.validators)}
            self.__dict__["_addr_idx"] = m
        return m

    def has_address(self, addr: bytes) -> bool:
        return addr in self.address_index()

    # ------------------------------------------------- proposer rotation

    def increment_proposer_priority(self, times: int) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_once()
        self.proposer = proposer

    def _increment_once(self) -> Validator:
        for v in self.validators:
            v.proposer_priority += v.voting_power
        mostest = self._find_proposer()
        mostest.proposer_priority -= self.total_voting_power()
        return mostest

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                v.proposer_priority = _go_div(v.proposer_priority, ratio)

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = _go_div(sum(v.proposer_priority for v in self.validators),
                      len(self.validators))
        for v in self.validators:
            v.proposer_priority -= avg

    def get_proposer(self) -> Validator:
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        return mostest

    def copy(self) -> "ValidatorSet":
        """Validators copied with their priorities; the proposer is the
        copy's validator of the same address.  Derived caches (dense
        view, address index, device tables) are built anew."""
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new._total = self._total
        new.proposer = None
        if self.proposer is not None:
            idx, _ = self.get_by_address(self.proposer.address)
            if idx >= 0:
                new.proposer = new.validators[idx]
        return new

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    # --------------------------------------------------------- updates

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply validator updates and removals (voting power 0 removes);
        reference: types/validator_set.go UpdateWithChangeSet."""
        if not changes:
            return
        by_addr = {}
        for c in changes:
            if c.address in by_addr:
                raise ValueError("duplicate address in changes")
            by_addr[c.address] = c
        removals = [a for a, c in by_addr.items() if c.voting_power == 0]
        updates = {a: c for a, c in by_addr.items() if c.voting_power > 0}
        for c in by_addr.values():
            if c.voting_power < 0:
                raise ValueError("negative voting power in update")
        for a in removals:
            if not self.has_address(a):
                raise ValueError("removing unknown validator")

        cur = {v.address: v for v in self.validators}
        # new validators' priorities use the total after the updates but
        # before the removals (validator_set.go:470-501)
        projected = sum(
            (updates[a].voting_power if a in updates else v.voting_power)
            for a, v in cur.items())
        projected += sum(c.voting_power for a, c in updates.items()
                         if a not in cur)
        if projected > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power would exceed cap")

        for a, c in updates.items():
            if a in cur:
                cur[a].voting_power = c.voting_power
            else:
                nv = c.copy()
                # new validators start at -1.125 * the projected total
                nv.proposer_priority = -(projected + (projected >> 3))
                cur[a] = nv
        for a in removals:
            del cur[a]
        if not cur:
            raise ValueError("validator set would be empty")

        self.validators = sorted(cur.values(), key=lambda v: v.address)
        self._total = None
        for k in _DERIVED:                    # membership or powers changed
            self.__dict__.pop(k, None)
        self.total_voting_power()
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        if self.proposer is not None:
            idx, v = self.get_by_address(self.proposer.address)
            self.proposer = v if idx >= 0 else None

    def validate_basic(self) -> str | None:
        if not self.validators:
            return "validator set is empty"
        if self.proposer is None:
            return "proposer is not set"
        return None
