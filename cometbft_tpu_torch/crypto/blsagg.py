"""BLS aggregate-commit verification: between ``types/validation.py``, the
G1 fold on the device and the pairings on the host.

Counterpart of ``cometbft_tpu/crypto/blsagg.py``.  A commit's BLS
for-block cohort arrives as one aggregate G2 signature plus a signer
bitmap (``types/commit.py``); verifying it costs a fold of the signers'
G1 public keys and two pairings, instead of one verification per
validator.

- :func:`valset_table`: every cohort public key is decompressed and
  subgroup-checked once (``bls12381.pk_to_affine``) and cached on the
  validator set with the numpy columns the commit checks read.
- The fold is the kernel (``ops/blsg1.g1_masked_sum``): the cohort's
  affine keys are packed once per table into the kernel's word layout
  and kept on the device, keyed by the table's identity, so a changed
  set can never fold stale keys; a call uploads only the row mask.  On
  ``device="cpu"`` the same call runs the kernel's plain version;
  ``device=None`` folds on the first of the plan's devices: under a
  device set the fold is not sharded, as the JAX package does not shard
  it.  There
  is no host fold behind it: the JAX package's complement fold (the
  full-cohort sum minus the absentees) is not a route of the port.
- :func:`verify_commit_aggregate` returns ``False``, never raises, for a
  bad table, a signer outside the cohort, an infinity sum or a bad
  signature, as the JAX package does.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import blsg1
from . import batch as _batch
from . import bls12381 as _bls
from . import plan as _plan

__all__ = ["AggTable", "valset_table", "verify_commit_aggregate"]


class AggTable(NamedTuple):
    """Per-valset aggregation table, built once and cached on the set:
    ``affine`` maps cohort valset index -> 96-byte affine public key;
    ``cohort`` (K,) int64 the cohort's valset indices in index order (the
    rows of the device table); ``cohort_mask`` bool (N,); ``addr_mat``
    uint8 (N, 20) with the cohort rows filled; ``powers`` int64 (N,)."""

    affine: dict
    cohort: np.ndarray
    cohort_mask: np.ndarray
    addr_mat: np.ndarray
    powers: np.ndarray


def valset_table(vals) -> AggTable:
    """The per-valset :class:`AggTable`, built once and cached on the set.
    Raises ValueError if a cohort public key fails decompression or the
    subgroup check."""
    tbl = vals.__dict__.get("_bls_agg_tbl")
    if tbl is None:
        idx, pks = vals.bls_cohort()
        affine = {i: _bls.pk_to_affine(pk) for i, pk in zip(idx, pks)}
        n = vals.size()
        cohort_mask = np.zeros((n,), np.bool_)
        addr_mat = np.zeros((n, 20), np.uint8)
        powers = np.zeros((n,), np.int64)
        for i, val in enumerate(vals.validators):
            powers[i] = val.voting_power
            if i in affine:
                cohort_mask[i] = True
                addr_mat[i] = np.frombuffer(val.address, np.uint8)
        tbl = AggTable(affine, np.asarray(idx, np.int64), cohort_mask,
                       addr_mat, powers)
        vals.__dict__["_bls_agg_tbl"] = tbl
    return tbl


def _device_table(vals, tbl: AggTable, device) -> torch.Tensor:
    """The cohort's (K, 2, 12) int32 word table on ``device`` (row r is
    cohort member ``tbl.cohort[r]``), packed once and cached on the set
    under the identity of ``tbl``."""
    cached = vals.__dict__.get("_bls_dev_tbl")
    if cached is None or cached[0] is not tbl or cached[1] != device:
        k = len(tbl.cohort)
        limbs = np.zeros((k, 2, blsg1.NLIMB), np.int32)
        for r, i in enumerate(tbl.cohort.tolist()):
            limbs[r] = blsg1.limbs_from_xy(tbl.affine[i])
        words = blsg1.words_from_limbs(torch.from_numpy(limbs)).to(device)
        cached = (tbl, device, words)
        vals.__dict__["_bls_dev_tbl"] = cached
    return cached[2]


def verify_commit_aggregate(vals, signer_indices, msg: bytes,
                            agg_sig: bytes, device=None) -> bool:
    """Verify one commit's aggregate lane block: ``signer_indices`` are
    valset indices (the decoded bitmap), an iterable of ints or a numpy
    bool mask of shape (valset size,); ``msg`` is the shared
    zero-timestamp sign bytes, ``agg_sig`` the 96-byte aggregate.  The
    signers' keys are folded on ``device`` (None: the plan's first) and the two
    pairings run on the host.  Returns False, never raises, on any
    failure, a signer outside the valset's BLS cohort included."""
    dev = _plan.resolve_devices(device)[0]
    try:
        tbl = valset_table(vals)
    except ValueError:
        return False
    if isinstance(signer_indices, np.ndarray):
        mask = signer_indices
        if (not mask.any() or mask.shape != tbl.cohort_mask.shape
                or bool((mask & ~tbl.cohort_mask).any())):
            return False
    else:
        signers = list(signer_indices)
        if not signers or any(i not in tbl.affine for i in signers):
            return False
        mask = np.zeros(tbl.cohort_mask.shape, np.bool_)
        mask[signers] = True
    rows = torch.from_numpy(mask[tbl.cohort].astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    out = blsg1.g1_masked_sum(_device_table(vals, tbl, dev), rows).cpu()
    _batch._note_dispatch("bls_agg", rows.shape[0],
                          time.perf_counter() - t0)
    agg_pk = blsg1.xy_from_projective(out.numpy())
    if agg_pk is None:             # the signers' keys sum to infinity
        return False
    return _bls.verify_aggregate_affine(agg_pk, msg, agg_sig)
