"""State carried from the JAX package into the port, from numpy arrays.

With these, both packages verify the same commit against the same
validator set, and a node's cached per-valset tables move across:

- :func:`tables_from_jax` takes ``cometbft_tpu.ops.ed25519.
  prepare_pubkey_tables`` output (four ``(16, 20, N)`` int32 arrays of
  13-bit limbs, limb-major, plus the ``(N,)`` ok mask) and returns the
  port's ``(N, 16, 4, 10)`` table in canonical limbs;
- :func:`validator_set_from_arrays` mirrors ``ValidatorSet.dense()``,
  or takes public keys of mixed types (``key_types``: 32-byte Ed25519
  and 48-byte BLS12-381 keys), and optionally the proposer priorities
  and the proposer, so that the stored bytes match;
- :func:`commit_from_arrays` mirrors ``Commit.dense_columns()`` plus the
  header fields, the validator addresses and, for an aggregate commit,
  its aggregate signature and signer bitmap;
- :func:`header_from_fields` builds a ``Header`` from a header's field
  values, and :func:`light_block_from_arrays` a ``LightBlock`` from
  those, a validator set's arrays and a commit's arrays, so a chain made
  by the JAX package is verified by both packages.

Nothing here imports the JAX package: the inputs are plain arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.bls12381 import Bls12381PubKey
from .crypto.keys import Ed25519PubKey
from .light.types import LightBlock
from .ops import fe
from .types.block_id import BlockID, PartSetHeader
from .types.commit import Commit, CommitSig
from .types.header import Header
from .types.validator_set import Validator, ValidatorSet

__all__ = ["tables_from_jax", "validator_set_from_arrays",
           "commit_from_arrays", "header_from_fields",
           "light_block_from_arrays"]

_JAX_RADIX = 13


def tables_from_jax(ypx, ymx, z2, t2d, ok, device="cpu"):
    """JAX cached tables -> (tab (N, 16, 4, 10) int32 canonical limbs,
    ok (N,) bool) on ``device``.  Each element's value is taken mod p,
    so any limb form the JAX side holds converts exactly."""
    comps = np.stack([np.asarray(c, np.int64) for c in (ypx, ymx, z2, t2d)])
    # (4, 16, 20, N) -> (N, 16, 4, 20) limbs of 13 bits
    limbs = comps.transpose(3, 1, 0, 2).astype(object)
    shifts = np.array([1 << (_JAX_RADIX * i) for i in range(limbs.shape[-1])],
                      dtype=object)
    vals = (limbs * shifts).sum(axis=-1) % fe.P_INT          # (N, 16, 4)
    out = np.zeros(vals.shape + (10,), np.int64)
    for i, (o, w) in enumerate(zip(fe.OFFSETS, fe.WIDTHS)):
        out[..., i] = ((vals >> o) & ((1 << w) - 1)).astype(np.int64)
    tab = torch.from_numpy(out.astype(np.int32)).to(device)
    return tab, torch.from_numpy(np.asarray(ok, bool).copy()).to(device)


_KEY_CLASSES = {"ed25519": Ed25519PubKey, "bls12_381": Bls12381PubKey}


def validator_set_from_arrays(pubs, powers, key_types=None,
                              priorities=None,
                              proposer_address=None) -> ValidatorSet:
    """pubs (N, 32) uint8 (or N byte strings) and powers (N,) int64 -> a
    ValidatorSet (sorted by address, so rows given in the JAX set's order
    keep their index).  ``key_types``, N strings ("ed25519" or
    "bls12_381"), gives each key's type; without it every key is
    Ed25519.  A new set's proposer priorities are those of one increment;
    ``priorities`` (N,) instead sets each row's priority and
    ``proposer_address`` the proposer (b"": none), as a set that has
    rotated or been updated holds them."""
    raw = [bytes(p) if isinstance(p, (bytes, bytearray))
           else np.asarray(p, np.uint8).tobytes() for p in pubs]
    kinds = key_types if key_types is not None else ["ed25519"] * len(raw)
    if len(kinds) != len(raw) or len(powers) != len(raw):
        raise ValueError("pubs, powers and key_types differ in length")
    vs = ValidatorSet([Validator(_KEY_CLASSES[kt](r), int(pw))
                       for r, kt, pw in zip(raw, kinds, powers)])
    if priorities is not None:
        if len(priorities) != len(raw):
            raise ValueError("pubs and priorities differ in length")
        by_key = {r: int(pr) for r, pr in zip(raw, priorities)}
        for v in vs.validators:
            v.proposer_priority = by_key[v.pub_key.bytes()]
    if proposer_address is not None:
        _, vs.proposer = vs.get_by_address(bytes(proposer_address))
    return vs


def commit_from_arrays(height: int, round_: int, block_hash: bytes,
                       part_set_total: int, part_set_hash: bytes, flags,
                       timestamps_ns, addresses, sigs, sig_lens=None,
                       agg_signature: bytes = b"",
                       agg_signers: bytes = b"") -> Commit:
    """Header fields plus per-lane columns -> a Commit.  ``flags`` (N,)
    uint8, ``timestamps_ns`` (N,) int64, ``addresses`` N 20-byte strings
    (b"" for absent lanes), ``sigs`` (N, W) uint8 with W >= every
    signature's length (64 for Ed25519, 96 for BLS); ``sig_lens`` (N,)
    optional signature lengths (default 64 on non-absent lanes, 0 on
    absent ones).  An aggregate commit also gives its 96-byte
    ``agg_signature`` and ``agg_signers`` bitmap; its AGGREGATE-flag lanes
    have length 0."""
    n = len(flags)
    lanes = []
    for i in range(n):
        fl = int(flags[i])
        ln = (int(sig_lens[i]) if sig_lens is not None
              else (0 if fl == 1 else 64))
        lanes.append(CommitSig(fl, bytes(addresses[i]), int(timestamps_ns[i]),
                               np.asarray(sigs[i], np.uint8).tobytes()[:ln]))
    bid = BlockID(bytes(block_hash),
                  PartSetHeader(int(part_set_total), bytes(part_set_hash)))
    return Commit(int(height), int(round_), bid, lanes, bytes(agg_signature),
                  bytes(agg_signers))


def header_from_fields(last_block_id, **fields) -> Header:
    """A ``Header`` from the values of a header's fields, named as the
    dataclass fields (chain_id, height, time_ns, the eleven hashes and
    addresses, version_block, version_app); ``last_block_id`` is
    ``(hash, part_set_total, part_set_hash)``."""
    bhash, total, psh = last_block_id
    return Header(last_block_id=BlockID(bytes(bhash), PartSetHeader(
        int(total), bytes(psh))), **fields)


def light_block_from_arrays(header: dict, pubs, powers, commit: dict,
                            key_types=None, priorities=None,
                            proposer_address=None) -> LightBlock:
    """A ``LightBlock`` from ``header`` (keyword arguments of
    :func:`header_from_fields`), the validator set's ``pubs``, ``powers``,
    ``key_types``, ``priorities`` and ``proposer_address``
    (:func:`validator_set_from_arrays`) and ``commit`` (keyword arguments
    of :func:`commit_from_arrays`)."""
    return LightBlock(header=header_from_fields(**header),
                      commit=commit_from_arrays(**commit),
                      validators=validator_set_from_arrays(
                          pubs, powers, key_types, priorities,
                          proposer_address))
