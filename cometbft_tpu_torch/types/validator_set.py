"""Validator and ValidatorSet (reference: ``types/validator.go``,
``types/validator_set.go``).

Counterpart of ``cometbft_tpu/types/validator_set.py`` for what commit
and light-header verification read: the address-sorted validator list,
lookups by index and by address, the total voting power, the dense
columnar view of an all-Ed25519 set, the BLS cohort and the set's merkle
hash.  Validators hold Ed25519 or BLS12-381 keys.  Proposer rotation and
set updates belong to later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from ..crypto import merkle
from . import wire

__all__ = ["MAX_TOTAL_VOTING_POWER", "Validator", "ValidatorSet"]

MAX_TOTAL_VOTING_POWER = (2**63 - 1) // 8


def _pubkey_proto(pk) -> bytes:
    """cometbft.crypto.v1.PublicKey oneof: 1=ed25519, 3=bls12_381 (2 is
    secp256k1, which the port does not carry)."""
    fld = {"ed25519": 1, "bls12_381": 3}[pk.type()]
    return wire.field_bytes(fld, pk.bytes(), force=True)


@dataclass
class Validator:
    pub_key: object                  # Ed25519PubKey or Bls12381PubKey
    voting_power: int
    _address: bytes = field(default=b"", repr=False)

    @property
    def address(self) -> bytes:
        if not self._address:
            self._address = self.pub_key.address()
        return self._address

    def copy(self) -> "Validator":
        return replace(self)

    def simple_encode(self) -> bytes:
        """SimpleValidator proto for set hashing (types/validator.go)."""
        return (wire.field_message(1, _pubkey_proto(self.pub_key), force=True)
                + wire.field_varint(2, self.voting_power))


class ValidatorSet:
    """Validators sorted by address (the reference's order)."""

    def __init__(self, validators: list[Validator]):
        vals = sorted((v.copy() for v in validators),
                      key=lambda v: v.address)
        if len({v.address for v in vals}) != len(vals):
            raise ValueError("duplicate validator address")
        if any(v.voting_power < 0 for v in vals):
            raise ValueError("negative voting power")
        self.validators: list[Validator] = vals
        self._total: int | None = None

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
