"""Attack detection: compare the primary's newly verified header with
every witness (reference: ``light/detector.go:28`` detectDivergence,
``:121`` handleConflictingHeaders, ``:285``
examineConflictingHeaderAgainstTrace).

Counterpart of ``cometbft_tpu/light/detector.py``.  All witnesses are
asked at once (one asyncio gather).  A witness that serves a different,
validly signed header at the same height means that the primary or the
witness is attacking: the detector walks the primary's verification
trace against the witness to find the last common height, builds
``LightClientAttackEvidence`` against both sides, gives each to the
other side (the witness gets the case against the primary and the
primary the case against the witness) and raises ``DivergenceError``.

A witness block is checked with the port's ``VerifyCommitLight`` on the
client's device.  Replies that fail the basic checks or the signature
check mark the witness bad and drop it; a witness that answers
``ErrLightBlockNotFound`` (lagging) is dropped after
``MAX_WITNESS_LAG_STRIKES`` misses in a row.
"""

from __future__ import annotations

import asyncio

from ..types.evidence import LightClientAttackEvidence
from ..types.validation import CommitVerificationError, VerifyCommitLight
from .provider import ErrLightBlockNotFound
from .types import LightBlock, LightClientError

__all__ = ["MAX_WITNESS_LAG_STRIKES", "DivergenceError",
           "detect_divergence"]

# consecutive not-found replies before a lagging witness is dropped
MAX_WITNESS_LAG_STRIKES = 3


class DivergenceError(LightClientError):
    def __init__(self, witness_id: str, primary_block: LightBlock,
                 witness_block: LightBlock, evidence,
                 evidence_against_witness=None, common_height: int = 0):
        self.witness_id = witness_id
        self.primary_block = primary_block
        self.witness_block = witness_block
        # evidence incriminating the primary (named ``evidence`` for the
        # original one-sided API); its twin incriminates the witness
        self.evidence = evidence
        self.evidence_against_primary = evidence
        self.evidence_against_witness = evidence_against_witness
        self.common_height = common_height
        super().__init__(
            f"witness {witness_id} diverges at height "
            f"{primary_block.height} (common height {common_height}): "
            f"primary {primary_block.header.hash().hex()[:12]} vs witness "
            f"{witness_block.header.hash().hex()[:12]}")


def _verify_witness_block(client, wlb: LightBlock) -> str | None:
    """Basic checks and signature verification of a block a witness
    served: the detector never builds evidence from an unsigned
    fabrication (detector.go compareNewHeaderWithWitness).  An error
    string, or None."""
    err = wlb.validate_basic(client.chain_id, client.device)
    if err is not None:
        return err
    try:
        VerifyCommitLight(client.chain_id, wlb.validators,
                          wlb.commit.block_id, wlb.height, wlb.commit,
                          device=client.device)
    except CommitVerificationError as e:
        return str(e)
    return None


async def _examine_against_trace(client, witness, trace: list[LightBlock]):
    """Walk the primary's verification trace against the witness to
    locate the fork (detector.go:285 examineConflictingHeaderAgainstTrace):
    returns ``(common, primary_divergent, witness_divergent)`` where
    ``common`` is the LAST trace block the witness agrees with and the
    divergent pair sit at the first trace height where hashes split.
    The witness's divergent block must itself verify — otherwise the
    witness is lying rather than forked, and LightClientError names it."""
    w0 = await witness.light_block(trace[0].height)
    if w0.header.hash() != trace[0].header.hash():
        raise LightClientError(
            f"witness {witness.id()} disagrees with the trace root at "
            f"height {trace[0].height}: no common header exists")
    common = trace[0]
    for tb in trace[1:]:
        wb = await witness.light_block(tb.height)
        if wb.header.hash() != tb.header.hash():
            err = _verify_witness_block(client, wb)
            if err is not None:
                raise LightClientError(
                    f"witness {witness.id()} served an invalid divergent "
                    f"block at height {tb.height}: {err}")
            return common, tb, wb
        common = tb
    raise LightClientError(
        f"witness {witness.id()} agrees with the whole trace; "
        f"no divergence to examine")


def _attack_evidence(block: LightBlock, common: LightBlock
                     ) -> LightClientAttackEvidence:
    return LightClientAttackEvidence(
        conflicting_header_hash=block.header.hash(),
        conflicting_height=block.height,
        common_height=common.height,
        total_voting_power=block.validators.total_voting_power(),
        timestamp_ns=block.header.time_ns,
        conflicting_block=block)


def _lag_strikes(client) -> dict:
    if not hasattr(client, "_witness_lag_strikes"):
        client._witness_lag_strikes = {}
    return client._witness_lag_strikes


async def detect_divergence(client, lb: LightBlock, now_ns: int,
                            trace: list[LightBlock] | None = None) -> None:
    """detector.go:28 detectDivergence: every witness must agree on the
    header hash at lb.height; on a validly-signed conflict, examine the
    trace, build two-sided evidence, dispatch it, and raise."""
    if not client.witnesses:
        return
    if not trace:
        latest = client.store.latest()
        trace = [latest, lb] if latest is not None and \
            latest.height < lb.height else [lb]
    witnesses = list(client.witnesses)
    replies = await asyncio.gather(
        *(w.light_block(lb.height) for w in witnesses),
        return_exceptions=True)

    strikes = _lag_strikes(client)
    bad_witnesses = []
    conflicts = []                    # (witness, wlb), verified-signed
    for witness, res in zip(witnesses, replies):
        if isinstance(res, asyncio.CancelledError):
            # gather(return_exceptions=True) swallows cancellation into
            # the result list: a cancelled cross-check is the CALLER
            # shutting down, not a broken witness — re-raise so the
            # cancellation propagates instead of striking the witness
            raise res
        if isinstance(res, ErrLightBlockNotFound):
            # lagging witness: tolerated a few times, then dropped — a
            # witness that can never serve the height gives no attack
            # coverage and would otherwise be retried forever
            n = strikes.get(witness.id(), 0) + 1
            strikes[witness.id()] = n
            if n >= MAX_WITNESS_LAG_STRIKES:
                bad_witnesses.append(witness)
            continue
        if isinstance(res, BaseException):
            bad_witnesses.append(witness)
            continue
        strikes.pop(witness.id(), None)
        if res.header.hash() == lb.header.hash():
            continue
        if _verify_witness_block(client, res) is not None:
            # not a real signed fork, just a broken/lying witness
            bad_witnesses.append(witness)
            continue
        conflicts.append((witness, res))

    try:
        if not conflicts:
            return
        # a real fork on at least one side: walk the trace against EVERY
        # conflicting witness until one yields a verified two-sided
        # divergence (detector.go:121 examines each conflict).  A trace
        # walk that fails — the witness served an invalid or missing
        # intermediate block — marks THAT witness bad and moves on: one
        # broken witness must not mask a real attack another conflicting
        # witness can still prove.
        last_err: Exception | None = None
        witness = wlb = None
        common = primary_div = witness_div = None
        for cand, cand_wlb in conflicts:
            try:
                common, primary_div, witness_div = \
                    await _examine_against_trace(client, cand, trace)
            except (LightClientError, ErrLightBlockNotFound) as e:
                bad_witnesses.append(cand)
                last_err = e
                continue
            witness, wlb = cand, cand_wlb
            break
        if witness is None:
            # every conflicting witness failed the walk: surface the
            # last failure (callers treat it as witness misbehavior)
            raise last_err if isinstance(last_err, LightClientError) \
                else LightClientError(
                    f"all conflicting witnesses failed the trace walk: "
                    f"{last_err}")
        ev_against_primary = _attack_evidence(primary_div, common)
        ev_against_witness = _attack_evidence(witness_div, common)
        # evidence goes to whichever side is honest: the witness
        # receives the case against the primary and vice versa
        # (detector.go handleConflictingHeaders evidence dispatch)
        for target, ev in ((witness, ev_against_primary),
                           (client.primary, ev_against_witness)):
            try:
                await target.report_evidence(ev)
            except Exception:
                pass                  # best-effort, like the reference
        raise DivergenceError(witness.id(), primary_div, witness_div,
                              ev_against_primary, ev_against_witness,
                              common.height)
    finally:
        for w in bad_witnesses:
            if w in client.witnesses:
                client.witnesses.remove(w)
            strikes.pop(w.id(), None)
