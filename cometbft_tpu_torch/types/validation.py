"""Commit verification on the device (reference: ``types/validation.go``).

Counterpart of ``cometbft_tpu/types/validation.py:179-290``, with the
same lane selection, tally, early-exit rules and error classes:

- ``VerifyCommit``: every non-absent signature (commit and nil votes)
  is verified; only for-block power counts; more than 2/3 is needed.
- ``VerifyCommitLight``: commit-flag signatures only, stopping after the
  lane whose power pushes the tally past 2/3; later lanes are not
  verified.
- ``VerifyCommitLightTrusting``: signers looked up by address in a
  (possibly different) trusted set, threshold = trust level of its
  total; a duplicate address is an invalid commit.
- ``*AllSignatures``: the evidence variants, with no early exit;
- ``verify_commits_light_batched``: ``VerifyCommitLight`` over many
  commits sharing one validator set, in one dense device call (the
  light client's sequential sync and blocksync's cross-block seam).

Signatures are verified first, then the tally is checked, so a bad
signature raises ``ErrInvalidSignature`` with the first bad lane (in
commit order) before any power error.  Lanes whose signature is not 64
bytes count as bad lanes.  On an all-Ed25519 set, the selected lanes'
sign bytes are built in one C call (``native.build_vote_sign_bytes``,
over ``Commit.sign_bytes_templates`` and the commit's columns; a library
that does not build raises, with no per-lane fallback) and every
selected lane goes to one dense device call
(``crypto/batch.verify_dense``) through the per-valset table cache.

A commit carrying a BLS aggregate (``types/commit.py``) has its whole
folded cohort verified up front (``_verify_aggregate``: the G1 fold on
the device, two pairings on the host); ``VerifyCommitLight`` returns as
soon as that proven power clears 2/3.  Such commits, and every set with a
BLS member, then go through the lane loop of the JAX package: aggregate
lanes are tallied, not verified again; Ed25519 lanes go to one device
batch (``crypto/batch.BatchVerifier``); individual BLS lanes (NIL votes,
cohorts below 2) are verified one by one by the host library.

Not in this slice: the verified-signature cache of ``crypto/scheduler``
and blocksync's patient device wait.  ``device`` is a device, ``"cpu"``,
or ``None`` for the plan's devices (``crypto/plan.py:resolve_devices``:
the device set, over which the dense verify shards its lanes, else
CUDA, raising without a card).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from .. import native as _native
from ..crypto import batch as cryptobatch
from ..crypto import blsagg as _blsagg
from ..crypto import plan as _plan
from .commit import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, Commit
from .validator_set import ValidatorSet

__all__ = ["CommitVerificationError", "ErrInvalidCommit",
           "ErrNotEnoughVotingPower", "ErrInvalidSignature",
           "ErrBatchItemInvalid", "VerifyCommit", "VerifyCommitLight",
           "VerifyCommitLightAllSignatures", "VerifyCommitLightTrusting",
           "VerifyCommitLightTrustingAllSignatures",
           "verify_commits_light_batched"]


def _devices(device):
    """``device`` as the dispatch layer takes it: ``None`` stays ``None``
    (the plan's devices, resolved in ``crypto/batch.py``, so a device set
    takes effect); checked here first, so a call without a card raises
    before any work."""
    _plan.resolve_devices(device)
    return device


class CommitVerificationError(Exception):
    pass


class ErrInvalidCommit(CommitVerificationError):
    pass


class ErrNotEnoughVotingPower(CommitVerificationError):
    pass


class ErrInvalidSignature(CommitVerificationError):
    def __init__(self, idx: int, msg: str = ""):
        self.idx = idx
        super().__init__(msg or f"wrong signature (#{idx})")


def _check_commit_basics(vals: ValidatorSet, commit: Commit, height: int,
                         block_id) -> None:
    if vals.size() != commit.size():
        raise ErrInvalidCommit(
            f"invalid commit: {commit.size()} sigs for {vals.size()} vals")
    if height != commit.height:
        raise ErrInvalidCommit(
            f"invalid commit height {commit.height}, want {height}")
    if block_id != commit.block_id:
        raise ErrInvalidCommit("invalid commit: wrong block ID")


def _verify_aggregate(chain_id: str, vals: ValidatorSet, commit: Commit, *,
                      lookup_by_address: bool, device) -> tuple:
    """Verify the commit's BLS aggregate lane block up front
    (``cometbft_tpu/types/validation.py:79``).  Returns ``(proven
    aggregate lane indices, pre-tallied power)``: empty and 0 without an
    aggregate, or on the trusting path when a signer does not resolve to
    a BLS validator of the trusted set (the aggregate then contributes
    nothing).  The power is the proven lanes' power on the index path and
    0 on the trusting path, whose loop tallies by address.

    Index path: any malformation raises ErrInvalidCommit, a failing
    aggregate raises ErrInvalidSignature on the first aggregate lane; the
    lane checks run over numpy columns cached per commit and per set."""
    if not commit.has_aggregate():
        return frozenset(), 0
    err = commit._validate_aggregate()
    if err:
        raise ErrInvalidCommit(f"invalid commit: {err}")
    lanes = commit.aggregate_lanes()
    power = 0
    if not lookup_by_address:
        try:
            tbl = _blsagg.valset_table(vals)
        except ValueError:
            raise ErrInvalidSignature(
                lanes[0], "invalid BLS cohort pubkey in valset") from None
        n = len(commit.signatures)
        if tbl.cohort_mask.shape[0] != n:
            raise ErrInvalidCommit(
                f"invalid commit: {n} sigs for {vals.size()} vals")
        cached = commit.__dict__.get("_agg_np")
        if cached is None:
            mask = np.zeros((n,), np.bool_)
            lane_addrs = np.zeros((len(lanes), 20), np.uint8)
            for r, idx in enumerate(lanes):
                mask[idx] = True
                addr = commit.signatures[idx].validator_address
                if len(addr) == 20:
                    lane_addrs[r] = np.frombuffer(addr, np.uint8)
            cached = (mask, lane_addrs)
            commit.__dict__["_agg_np"] = cached
        mask, lane_addrs = cached
        stray = mask & ~tbl.cohort_mask
        if bool(stray.any()):
            raise ErrInvalidCommit(
                f"aggregate lane {int(np.nonzero(stray)[0][0])} "
                "is not a BLS validator")
        addr_bad = (tbl.addr_mat[mask] != lane_addrs).any(axis=1)
        if bool(addr_bad.any()):
            raise ErrInvalidCommit(
                f"aggregate lane {lanes[int(np.nonzero(addr_bad)[0][0])]} "
                "address does not match valset")
        power = int(tbl.powers[mask].sum())
        signers = mask
    else:
        signers = []
        for idx in lanes:
            vi, val = vals.get_by_address(
                commit.signatures[idx].validator_address)
            if vi < 0 or val.pub_key.type() != "bls12_381":
                return frozenset(), 0       # unattributable: contributes 0
            signers.append(vi)
    if not _blsagg.verify_commit_aggregate(
            vals, signers, commit.aggregate_sign_bytes(chain_id),
            commit.agg_signature, device=device):
        raise ErrInvalidSignature(
            lanes[0], f"wrong aggregate signature (lanes {lanes})")
    return frozenset(lanes), power


def _verify_loop(chain_id, vals, commit, needed, agg_proven, agg_power, *,
                 count_all, verify_nil_sigs, lookup_by_address,
                 device) -> None:
    """The JAX package's lane loop (``types/validation.py:_verify``), for
    commits with an aggregate and sets with a BLS member: aggregate lanes
    proven up front are tallied only, every other selected lane goes to
    one ``BatchVerifier`` (Ed25519 lanes in one device call, BLS lanes on
    the host)."""
    bv = cryptobatch.create_batch_verifier(device)
    lanes: list[int] = []
    tally = agg_power
    seen: set[bytes] = set()
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        if not cs.is_commit() and not verify_nil_sigs:
            # ignored before the lookup and duplicate bookkeeping
            # (validation.go:243-266)
            continue
        if cs.is_aggregate():
            if not lookup_by_address:
                # index path: pre-tallied in agg_power
                if not count_all and tally > needed:
                    break
                continue
            if idx not in agg_proven:
                continue          # trusting path, unresolved cohort
        if lookup_by_address:
            vi, val = vals.get_by_address(cs.validator_address)
            if vi < 0:
                continue
            if cs.validator_address in seen:
                raise ErrInvalidCommit(
                    f"duplicate validator {cs.validator_address.hex()} in "
                    "commit")
            seen.add(cs.validator_address)
        else:
            val = vals.get_by_index(idx)
        if cs.is_aggregate():
            tally += val.voting_power       # proven up front
            if not count_all and tally > needed:
                break
            continue
        bv.add(val.pub_key, commit.vote_sign_bytes_for(
            chain_id, idx, val.pub_key.type()), cs.signature)
        lanes.append(idx)
        if cs.is_commit():
            tally += val.voting_power
        if not count_all and tally > needed:
            break
    if len(bv) > 0:
        ok, oks = bv.verify()
        if not ok:
            raise ErrInvalidSignature(lanes[oks.index(False)])
    if tally <= needed:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally} <= needed {needed}")


def _verify(chain_id, vals, commit, needed, *, count_all, verify_nil_sigs,
            lookup_by_address, device) -> None:
    """The aggregate up front, then the dense path on an all-Ed25519 set
    without aggregate lanes, else the lane loop."""
    agg_proven, agg_power = _verify_aggregate(
        chain_id, vals, commit, lookup_by_address=lookup_by_address,
        device=device)
    if agg_power > needed and not count_all and not verify_nil_sigs:
        return        # VerifyCommitLight: the proven aggregate clears 2/3
    if vals.dense() is None or commit.has_aggregate():
        _verify_loop(chain_id, vals, commit, needed, agg_proven, agg_power,
                     count_all=count_all, verify_nil_sigs=verify_nil_sigs,
                     lookup_by_address=lookup_by_address, device=device)
    elif lookup_by_address:
        _verify_by_address(chain_id, vals, commit, needed,
                           count_all=count_all, device=device)
    else:
        _verify_by_index(chain_id, vals, commit, needed, count_all=count_all,
                         verify_nil_sigs=verify_nil_sigs, device=device)


def _columns(commit: Commit):
    cols = commit.dense_columns()
    if cols is None:
        raise ErrInvalidCommit("invalid commit: flag or timestamp range")
    return cols


def _light_scope(powers, flags, needed):
    """Commit-flag lanes up to and including the one whose power pushes
    the tally past ``needed``.  Returns (scope indices, tally)."""
    scope = np.nonzero(flags == BLOCK_ID_FLAG_COMMIT)[0]
    cum = np.cumsum(powers[scope]) if scope.size else np.zeros(0, np.int64)
    over = np.nonzero(cum > needed)[0]
    if over.size:
        return scope[:int(over[0]) + 1], int(cum[int(over[0])])
    return scope, int(cum[-1]) if cum.size else 0


def _dense_build_rows(chain_id, commit, ts, flags, scope):
    """Sign bytes of commit lanes ``scope`` as zero-padded rows, built in
    one C call (``native.build_vote_sign_bytes``) from the commit's
    templates and its ``ts`` and ``flags`` columns: (msgs (k, stride)
    uint8, lens (k,) int64)."""
    pre_c, pre_n, post = commit.sign_bytes_templates(chain_id)
    return _native.build_vote_sign_bytes(pre_c, pre_n, post, ts[scope],
                                         flags[scope])


def _lane_verdicts(valset_pubs, rows, sigs, sig_ok, msgs, lens, device):
    """(k,) verdicts of lanes signed by valset rows ``rows``: one dense
    device call over the lanes whose signature is 64 bytes; the others
    are bad lanes."""
    oks = np.zeros((rows.size,), bool)
    live = np.nonzero(sig_ok)[0]
    if live.size:
        _, out = cryptobatch.verify_dense(
            np.ascontiguousarray(valset_pubs[rows[live]]),
            np.ascontiguousarray(sigs[live]),
            np.ascontiguousarray(msgs[live]), lens[live], device=device,
            valset_pubs=valset_pubs, scope=rows[live])
        oks[live] = out
    return oks


def _verify_lanes(chain_id, commit, valset_pubs, scope, rows, cols,
                  device) -> None:
    """Verify commit lanes ``scope`` (signed by valset rows ``rows``;
    ``cols`` the commit's ``_columns``) and raise ErrInvalidSignature
    naming the first bad lane in commit order."""
    if not scope.size:
        return
    flags, ts, sigmat, sig_ok = cols
    msgs, lens = _dense_build_rows(chain_id, commit, ts, flags, scope)
    oks = _lane_verdicts(valset_pubs, rows, sigmat[scope], sig_ok[scope],
                         msgs, lens, device)
    if not oks.all():
        raise ErrInvalidSignature(int(scope[np.nonzero(~oks)[0][0]]))


def _verify_by_index(chain_id, vals, commit, needed, *, count_all,
                     verify_nil_sigs, device) -> None:
    pubs, powers = vals.dense()
    cols = _columns(commit)
    flags = cols[0]
    commit_mask = flags == BLOCK_ID_FLAG_COMMIT
    if count_all:
        scope = np.nonzero((flags != BLOCK_ID_FLAG_ABSENT) if verify_nil_sigs
                           else commit_mask)[0]
        tally = int(powers[commit_mask].sum())
    else:
        scope, tally = _light_scope(powers, flags, needed)
    _verify_lanes(chain_id, commit, pubs, scope, scope, cols, device)
    if tally <= needed:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally} <= needed {needed}")


def _verify_by_address(chain_id, vals, commit, needed, *, count_all,
                       device) -> None:
    pubs, powers = vals.dense()
    cols = _columns(commit)
    flags = cols[0]
    aidx = vals.address_index()
    seen: set[bytes] = set()
    scope, rows = [], []
    tally = 0
    for i, cs in enumerate(commit.signatures):
        # non-commit sigs are ignored before the lookup and the duplicate
        # check (validation.go:243-266)
        if int(flags[i]) != BLOCK_ID_FLAG_COMMIT:
            continue
        row = aidx.get(cs.validator_address)
        if row is None:
            continue
        if cs.validator_address in seen:
            raise ErrInvalidCommit(
                f"duplicate validator {cs.validator_address.hex()} in "
                "commit")
        seen.add(cs.validator_address)
        scope.append(i)
        rows.append(row)
        tally += int(powers[row])
        if not count_all and tally > needed:
            break
    _verify_lanes(chain_id, commit, pubs, np.asarray(scope, np.int64),
                  np.asarray(rows, np.int64), cols, device)
    if tally <= needed:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally} <= needed {needed}")


def VerifyCommit(chain_id: str, vals: ValidatorSet, block_id, height: int,
                 commit: Commit, device=None) -> None:
    """All signatures verified; more than 2/3 of the total power must be
    for ``block_id`` (types/validation.go:28)."""
    dev = _devices(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(chain_id, vals, commit, needed, count_all=True,
            verify_nil_sigs=True, lookup_by_address=False, device=dev)


def VerifyCommitLight(chain_id: str, vals: ValidatorSet, block_id,
                      height: int, commit: Commit, device=None) -> None:
    """Commit-flag signatures only, early exit past 2/3
    (types/validation.go:63)."""
    dev = _devices(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(chain_id, vals, commit, needed, count_all=False,
            verify_nil_sigs=False, lookup_by_address=False, device=dev)


def VerifyCommitLightAllSignatures(chain_id: str, vals: ValidatorSet,
                                   block_id, height: int, commit: Commit,
                                   device=None) -> None:
    """types/validation.go:96 (evidence path: no early exit)."""
    dev = _devices(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(chain_id, vals, commit, needed, count_all=True,
            verify_nil_sigs=False, lookup_by_address=False, device=dev)


def VerifyCommitLightTrusting(chain_id: str, vals: ValidatorSet,
                              commit: Commit,
                              trust_level: Fraction = Fraction(1, 3),
                              device=None, count_all: bool = False) -> None:
    """Trust-level verification against a possibly different validator
    set, looked up by address (types/validation.go:127)."""
    if trust_level <= 0 or trust_level > 1:
        raise ValueError("trust level must be in (0, 1]")
    dev = _devices(device)
    needed = (vals.total_voting_power() * trust_level.numerator
              // trust_level.denominator)
    _verify(chain_id, vals, commit, needed, count_all=count_all,
            verify_nil_sigs=False, lookup_by_address=True, device=dev)


def VerifyCommitLightTrustingAllSignatures(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        trust_level: Fraction = Fraction(1, 3), device=None) -> None:
    """types/validation.go:182 (evidence path: no early exit)."""
    VerifyCommitLightTrusting(chain_id, vals, commit, trust_level,
                              device=device, count_all=True)


class ErrBatchItemInvalid(CommitVerificationError):
    """A commit inside a multi-commit batch failed; ``item`` indexes the
    offending entry and ``height`` is its height."""

    def __init__(self, item: int, height: int, cause: Exception):
        self.item = item
        self.height = height
        self.cause = cause
        super().__init__(f"commit #{item} (height {height}): {cause}")


def verify_commits_light_batched(chain_id: str, vals: ValidatorSet,
                                 items: list, device=None) -> int:
    """``VerifyCommitLight`` over many commits sharing one validator set
    in one dense device call (``cometbft_tpu/types/validation.py:581``,
    its dense core at :673).  ``items`` is a list of ``(block_id, height,
    commit)``.  Returns the number of signatures verified.

    Basics and tally are checked per item in item order; then every
    selected lane of every commit goes to one ``verify_dense`` call
    through the per-valset table cache.  Raises ``ErrBatchItemInvalid``
    naming the first offending item.  When its ``cause`` is
    ``ErrInvalidSignature``, every item before ``err.item`` had all its
    selected lanes proven valid (lanes are in item order and every
    verdict is computed before the first bad lane raises); any other
    cause is a basics or tally failure found before the dispatch, and
    earlier items were not signature-checked.

    On a set with a BLS member, or when an item carries an aggregate, the
    items go through the JAX package's loop (:func:`_batched_loop`)
    instead, with the same raise order and demux."""
    dev = _devices(device)
    needed = vals.total_voting_power() * 2 // 3
    if vals.dense() is None or any(c.has_aggregate() for _, _, c in items):
        return _batched_loop(chain_id, vals, items, needed, dev)
    pubs, powers = vals.dense()
    rows, sigs, sig_ok, msgs, lens, lanes = [], [], [], [], [], []
    for k, (block_id, height, commit) in enumerate(items):
        try:
            _check_commit_basics(vals, commit, height, block_id)
            flags, ts, sigmat, ok = _columns(commit)
        except CommitVerificationError as e:
            raise ErrBatchItemInvalid(k, height, e) from e
        scope, tally = _light_scope(powers, flags, needed)
        if tally <= needed:
            raise ErrBatchItemInvalid(
                k, height,
                ErrNotEnoughVotingPower(f"tallied {tally} <= {needed}"))
        m, ln = _dense_build_rows(chain_id, commit, ts, flags, scope)
        rows.append(scope)
        sigs.append(sigmat[scope])
        sig_ok.append(ok[scope])
        msgs.append(m)
        lens.append(ln)
        lanes.extend((k, int(i)) for i in scope)
    if not lanes:
        return 0
    stride = max(m.shape[1] for m in msgs)
    msgs = [np.pad(m, ((0, 0), (0, stride - m.shape[1]))) for m in msgs]
    oks = _lane_verdicts(pubs, np.concatenate(rows), np.concatenate(sigs),
                         np.concatenate(sig_ok), np.concatenate(msgs),
                         np.concatenate(lens), dev)
    if not oks.all():
        k, idx = lanes[int(np.nonzero(~oks)[0][0])]
        raise ErrBatchItemInvalid(k, items[k][1], ErrInvalidSignature(idx))
    return len(lanes)


def _batched_loop(chain_id, vals, items, needed, device) -> int:
    """``verify_commits_light_batched`` as the JAX package's loop
    (``cometbft_tpu/types/validation.py:630``): per item, the basics and
    the aggregate (whose power is pre-tallied), then the light scope of
    the other commit lanes; one ``BatchVerifier`` over every item's
    lanes."""
    bv = cryptobatch.create_batch_verifier(device)
    lanes: list[tuple[int, int]] = []
    for k, (block_id, height, commit) in enumerate(items):
        try:
            _check_commit_basics(vals, commit, height, block_id)
            _, tally = _verify_aggregate(chain_id, vals, commit,
                                         lookup_by_address=False,
                                         device=device)
        except CommitVerificationError as e:
            raise ErrBatchItemInvalid(k, height, e) from e
        if tally > needed:
            continue              # the aggregate alone clears the threshold
        for idx, cs in enumerate(commit.signatures):
            if not cs.is_commit() or cs.is_aggregate():
                continue
            val = vals.get_by_index(idx)
            bv.add(val.pub_key, commit.vote_sign_bytes_for(
                chain_id, idx, val.pub_key.type()), cs.signature)
            lanes.append((k, idx))
            tally += val.voting_power
            if tally > needed:
                break
        if tally <= needed:
            raise ErrBatchItemInvalid(
                k, height,
                ErrNotEnoughVotingPower(f"tallied {tally} <= {needed}"))
    if len(bv) > 0:
        ok, oks = bv.verify()
        if not ok:
            k, idx = lanes[oks.index(False)]
            raise ErrBatchItemInvalid(k, items[k][1], ErrInvalidSignature(idx))
    return len(lanes)
