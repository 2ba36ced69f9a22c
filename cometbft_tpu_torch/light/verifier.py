"""Light-client header verification (reference: ``light/verifier.go``).

Counterpart of ``cometbft_tpu/light/verifier.py:31-162``, with the same
checks, order and error classes; ``backend=`` is ``device=`` (None:
CUDA, ``"cpu"``: the plain versions).

- ``verify_adjacent`` (:91): consecutive heights; the new header's
  validator hash must equal the trusted header's next_validators_hash,
  then its own validator set must have signed with > 2/3.
- ``verify_non_adjacent`` (:30): any height gap; the trusted set must
  have signed with >= trust level (default 1/3), else
  ErrNewValSetCantBeTrusted, and the new set with > 2/3.
- ``verify`` (:133): dispatcher.
- ``verify_sequential_batched``: sequential sync with the commit
  signatures of each same-validator-set run of headers proven in one
  device call (``types/validation.verify_commits_light_batched``).
"""

from __future__ import annotations

from fractions import Fraction

from ..types.validation import (ErrNotEnoughVotingPower, VerifyCommitLight,
                                VerifyCommitLightTrusting,
                                verify_commits_light_batched)
from .types import (ErrInvalidHeader, ErrNewValSetCantBeTrusted, LightBlock,
                    LightClientError)

__all__ = ["DEFAULT_TRUST_LEVEL", "MAX_CLOCK_DRIFT_NS", "verify",
           "verify_adjacent", "verify_non_adjacent",
           "verify_sequential_batched"]

DEFAULT_TRUST_LEVEL = Fraction(1, 3)
MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000


def _verify_new_header_and_vals(chain_id: str, trusted: LightBlock,
                                untrusted: LightBlock, now_ns: int,
                                max_clock_drift_ns: int, device) -> None:
    """light/verifier.go:177 verifyNewHeaderAndVals."""
    err = untrusted.validate_basic(chain_id, device)
    if err:
        raise ErrInvalidHeader(err)
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"expected height > {trusted.height}, got {untrusted.height}")
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise ErrInvalidHeader("header time not after trusted header")
    if untrusted.header.time_ns >= now_ns + max_clock_drift_ns:
        raise ErrInvalidHeader("header time from the future")


def _check_trusted_period(trusted: LightBlock, trusting_period_ns: int,
                          now_ns: int) -> None:
    if trusted.header.time_ns + trusting_period_ns <= now_ns:
        raise LightClientError(
            f"trusted header {trusted.height} expired "
            "(outside trusting period)")


def verify_adjacent(chain_id: str, trusted: LightBlock,
                    untrusted: LightBlock, trusting_period_ns: int,
                    now_ns: int,
                    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
                    device=None) -> None:
    """light/verifier.go:91 VerifyAdjacent."""
    if untrusted.height != trusted.height + 1:
        raise ErrInvalidHeader("headers must be adjacent in height")
    _check_trusted_period(trusted, trusting_period_ns, now_ns)
    _verify_new_header_and_vals(chain_id, trusted, untrusted, now_ns,
                                max_clock_drift_ns, device)
    if untrusted.header.validators_hash != \
            trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            "header validators_hash != trusted next_validators_hash")
    VerifyCommitLight(chain_id, untrusted.validators,
                      untrusted.commit.block_id, untrusted.height,
                      untrusted.commit, device=device)


def verify_non_adjacent(chain_id: str, trusted: LightBlock,
                        untrusted: LightBlock, trusting_period_ns: int,
                        now_ns: int,
                        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                        max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
                        device=None) -> None:
    """light/verifier.go:30 VerifyNonAdjacent."""
    if untrusted.height == trusted.height + 1:
        return verify_adjacent(chain_id, trusted, untrusted,
                               trusting_period_ns, now_ns,
                               max_clock_drift_ns, device)
    _check_trusted_period(trusted, trusting_period_ns, now_ns)
    _verify_new_header_and_vals(chain_id, trusted, untrusted, now_ns,
                                max_clock_drift_ns, device)
    # the old (trusted) set must still vouch with >= trust level (:56)
    try:
        VerifyCommitLightTrusting(chain_id, trusted.validators,
                                  untrusted.commit, trust_level,
                                  device=device)
    except ErrNotEnoughVotingPower as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    # and the new set must have signed its own header with > 2/3 (:71)
    VerifyCommitLight(chain_id, untrusted.validators,
                      untrusted.commit.block_id, untrusted.height,
                      untrusted.commit, device=device)


def verify(chain_id: str, trusted: LightBlock, untrusted: LightBlock,
           trusting_period_ns: int, now_ns: int,
           trust_level: Fraction = DEFAULT_TRUST_LEVEL,
           max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
           device=None) -> None:
    """light/verifier.go:133 Verify dispatcher."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(chain_id, trusted, untrusted,
                            trusting_period_ns, now_ns, trust_level,
                            max_clock_drift_ns, device)
    else:
        verify_adjacent(chain_id, trusted, untrusted, trusting_period_ns,
                        now_ns, max_clock_drift_ns, device)


def verify_sequential_batched(chain_id: str, trusted: LightBlock,
                              chain: list[LightBlock],
                              trusting_period_ns: int, now_ns: int,
                              max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
                              device=None, max_batch: int = 256) -> None:
    """Verify a contiguous header chain as ``verify_adjacent`` per header
    would (the reference's verifySequential, light/client.go:609): the
    structural checks run per header in order, and the commit signatures
    of each run of up to ``max_batch`` headers with one validator set are
    proven in one device call."""
    _check_trusted_period(trusted, trusting_period_ns, now_ns)
    prev = trusted
    i = 0
    while i < len(chain):
        run = []
        vals_hash = chain[i].header.validators_hash
        j = i
        while j < len(chain) and len(run) < max_batch and \
                chain[j].header.validators_hash == vals_hash:
            lb = chain[j]
            if lb.height != prev.height + 1:
                raise ErrInvalidHeader(
                    f"chain gap at height {lb.height} "
                    f"(prev {prev.height})")
            _verify_new_header_and_vals(chain_id, prev, lb, now_ns,
                                        max_clock_drift_ns, device)
            if lb.header.validators_hash != \
                    prev.header.next_validators_hash:
                raise ErrInvalidHeader(
                    f"header {lb.height} validators_hash != "
                    "prev next_validators_hash")
            run.append(lb)
            prev = lb
            j += 1
        verify_commits_light_batched(
            chain_id, run[0].validators,
            [(lb.commit.block_id, lb.height, lb.commit) for lb in run],
            device=device)
        i = j
