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
bytes count as bad lanes.  Sign bytes are built in Python per lane and
every selected lane goes to one dense device call
(``crypto/batch.verify_dense``) through the per-valset table cache.

Not in this slice: BLS aggregate lanes (a commit carrying them raises
``ErrInvalidCommit``), the verified-signature cache of
``crypto/scheduler`` and blocksync's patient device wait.  ``device`` is
``None`` (CUDA) or ``"cpu"``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..crypto import batch as cryptobatch
from ..device import resolve_device
from .commit import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, Commit
from .validator_set import ValidatorSet

__all__ = ["CommitVerificationError", "ErrInvalidCommit",
           "ErrNotEnoughVotingPower", "ErrInvalidSignature",
           "ErrBatchItemInvalid", "VerifyCommit", "VerifyCommitLight",
           "VerifyCommitLightAllSignatures", "VerifyCommitLightTrusting",
           "VerifyCommitLightTrustingAllSignatures",
           "verify_commits_light_batched"]


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


def _columns(commit: Commit):
    if commit.has_aggregate():
        raise ErrInvalidCommit(
            "invalid commit: BLS aggregate lanes are not supported")
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


def _sign_rows(chain_id, commit, scope):
    """Sign bytes of commit lanes ``scope`` as zero-padded rows:
    (msgs (k, L) uint8, lens (k,) int64)."""
    msgs_b = [commit.vote_sign_bytes(chain_id, int(i)) for i in scope]
    maxlen = max((len(m) for m in msgs_b), default=0)
    msgs = np.zeros((len(msgs_b), maxlen), np.uint8)
    lens = np.zeros((len(msgs_b),), np.int64)
    for j, m in enumerate(msgs_b):
        msgs[j, :len(m)] = np.frombuffer(m, np.uint8)
        lens[j] = len(m)
    return msgs, lens


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


def _verify_lanes(chain_id, commit, valset_pubs, scope, rows, sigmat,
                  sig_ok, device) -> None:
    """Verify commit lanes ``scope`` (signed by valset rows ``rows``) and
    raise ErrInvalidSignature naming the first bad lane in commit order."""
    if not scope.size:
        return
    msgs, lens = _sign_rows(chain_id, commit, scope)
    oks = _lane_verdicts(valset_pubs, rows, sigmat[scope], sig_ok[scope],
                         msgs, lens, device)
    if not oks.all():
        raise ErrInvalidSignature(int(scope[np.nonzero(~oks)[0][0]]))


def _verify_by_index(chain_id, vals, commit, needed, *, count_all,
                     verify_nil_sigs, device) -> None:
    pubs, powers = vals.dense()
    flags, _, sigmat, sig_ok = _columns(commit)
    commit_mask = flags == BLOCK_ID_FLAG_COMMIT
    if count_all:
        scope = np.nonzero((flags != BLOCK_ID_FLAG_ABSENT) if verify_nil_sigs
                           else commit_mask)[0]
        tally = int(powers[commit_mask].sum())
    else:
        scope, tally = _light_scope(powers, flags, needed)
    _verify_lanes(chain_id, commit, pubs, scope, scope, sigmat, sig_ok,
                  device)
    if tally <= needed:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally} <= needed {needed}")


def _verify_by_address(chain_id, vals, commit, needed, *, count_all,
                       device) -> None:
    pubs, powers = vals.dense()
    flags, _, sigmat, sig_ok = _columns(commit)
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
                  np.asarray(rows, np.int64), sigmat, sig_ok, device)
    if tally <= needed:
        raise ErrNotEnoughVotingPower(
            f"tallied {tally} <= needed {needed}")


def VerifyCommit(chain_id: str, vals: ValidatorSet, block_id, height: int,
                 commit: Commit, device=None) -> None:
    """All signatures verified; more than 2/3 of the total power must be
    for ``block_id`` (types/validation.go:28)."""
    dev = resolve_device(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_by_index(chain_id, vals, commit, needed, count_all=True,
                     verify_nil_sigs=True, device=dev)


def VerifyCommitLight(chain_id: str, vals: ValidatorSet, block_id,
                      height: int, commit: Commit, device=None) -> None:
    """Commit-flag signatures only, early exit past 2/3
    (types/validation.go:63)."""
    dev = resolve_device(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_by_index(chain_id, vals, commit, needed, count_all=False,
                     verify_nil_sigs=False, device=dev)


def VerifyCommitLightAllSignatures(chain_id: str, vals: ValidatorSet,
                                   block_id, height: int, commit: Commit,
                                   device=None) -> None:
    """types/validation.go:96 (evidence path: no early exit)."""
    dev = resolve_device(device)
    _check_commit_basics(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_by_index(chain_id, vals, commit, needed, count_all=True,
                     verify_nil_sigs=False, device=dev)


def VerifyCommitLightTrusting(chain_id: str, vals: ValidatorSet,
                              commit: Commit,
                              trust_level: Fraction = Fraction(1, 3),
                              device=None, count_all: bool = False) -> None:
    """Trust-level verification against a possibly different validator
    set, looked up by address (types/validation.go:127)."""
    if trust_level <= 0 or trust_level > 1:
        raise ValueError("trust level must be in (0, 1]")
    dev = resolve_device(device)
    needed = (vals.total_voting_power() * trust_level.numerator
              // trust_level.denominator)
    _verify_by_address(chain_id, vals, commit, needed, count_all=count_all,
                       device=dev)


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
    earlier items were not signature-checked."""
    dev = resolve_device(device)
    pubs, powers = vals.dense()
    needed = vals.total_voting_power() * 2 // 3
    rows, sigs, sig_ok, msgs, lens, lanes = [], [], [], [], [], []
    for k, (block_id, height, commit) in enumerate(items):
        try:
            _check_commit_basics(vals, commit, height, block_id)
            flags, _, sigmat, ok = _columns(commit)
        except CommitVerificationError as e:
            raise ErrBatchItemInvalid(k, height, e) from e
        scope, tally = _light_scope(powers, flags, needed)
        if tally <= needed:
            raise ErrBatchItemInvalid(
                k, height,
                ErrNotEnoughVotingPower(f"tallied {tally} <= {needed}"))
        m, ln = _sign_rows(chain_id, commit, scope)
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
