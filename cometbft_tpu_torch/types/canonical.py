"""Canonical sign-bytes encoders.

The exact bytes validators sign (reference: ``types/canonical.go:57,71``,
``types/vote.go:150``, ``proto/cometbft/types/v1/canonical.proto``): a
length-prefixed proto3 encoding of CanonicalVote / CanonicalProposal /
CanonicalVoteExtension.  Any disagreement here is a consensus failure, so
the layout is hand-rolled through ``wire`` and pinned by tests against an
independently protoc-compiled schema.

Timestamps are integer nanoseconds since the Unix epoch throughout the
framework; the canonical encoding splits them into Timestamp{seconds,nanos}.

The port's own copy of ``cometbft_tpu/types/canonical.py``: the
sign bytes are byte-identical to the JAX package's.
"""

from __future__ import annotations

from . import wire
from .block_id import BlockID

# SignedMsgType (proto/cometbft/types/v1/types.proto)
SIGNED_MSG_TYPE_PREVOTE = 1
SIGNED_MSG_TYPE_PRECOMMIT = 2
SIGNED_MSG_TYPE_PROPOSAL = 32


def encode_timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp {int64 seconds=1; int32 nanos=2}."""
    seconds, nanos = divmod(ns, 1_000_000_000)
    return wire.field_varint(1, seconds) + wire.field_varint(2, nanos)


def canonical_vote_sign_bytes(chain_id: str, msg_type: int, height: int,
                              round_: int, block_id: BlockID,
                              timestamp_ns: int) -> bytes:
    """CanonicalVote, length-prefixed (types/vote.go:150 VoteSignBytes).

    Fields: type=1 varint, height=2 sfixed64, round=3 sfixed64,
    block_id=4 (omitted when nil), timestamp=5 (always emitted),
    chain_id=6.
    """
    body = (wire.field_varint(1, msg_type)
            + wire.field_sfixed64(2, height)
            + wire.field_sfixed64(3, round_)
            + wire.field_message(4, block_id.encode_canonical())
            + wire.field_message(5, encode_timestamp(timestamp_ns),
                                 force=True)
            + wire.field_string(6, chain_id))
    return wire.length_prefixed(body)


class CanonicalVoteEncoder:
    """Template encoder for one (chain_id, type, height, round, block_id):
    every field except the timestamp is precomputed, so encoding the N
    sign-bytes of a commit costs N cheap concatenations instead of N full
    proto builds (~25 us -> ~1 us each; at 10k validators this is the
    difference between 250 ms and 10 ms of host work on the VerifyCommit
    latency path)."""

    __slots__ = ("_prefix", "_suffix")

    def __init__(self, chain_id: str, msg_type: int, height: int,
                 round_: int, block_id: BlockID):
        self._prefix = (wire.field_varint(1, msg_type)
                        + wire.field_sfixed64(2, height)
                        + wire.field_sfixed64(3, round_)
                        + wire.field_message(
                            4, block_id.encode_canonical()))
        self._suffix = wire.field_string(6, chain_id)

    def sign_bytes(self, timestamp_ns: int) -> bytes:
        body = (self._prefix
                + wire.field_message(5, encode_timestamp(timestamp_ns),
                                     force=True)
                + self._suffix)
        return wire.length_prefixed(body)


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


def decode_timestamp_from_vote(sign_bytes: bytes) -> int:
    """Extract the timestamp (ns) from canonical vote sign bytes — used by
    FilePV to decide whether a re-sign request differs only by timestamp
    (privval/file.go checkVotesOnlyDifferByTimestamp does the same via
    proto decode)."""
    ln, off = _read_varint(sign_bytes, 0)
    end = off + ln
    while off < end:
        tag, off = _read_varint(sign_bytes, off)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, off = _read_varint(sign_bytes, off)
        elif wt == 1:
            val = int.from_bytes(sign_bytes[off:off + 8], "little")
            off += 8
        elif wt == 2:
            ln2, off = _read_varint(sign_bytes, off)
            val = sign_bytes[off:off + ln2]
            off += ln2
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if field == 5:                       # timestamp submessage
            seconds = nanos = 0
            o2 = 0
            while o2 < len(val):
                t2, o2 = _read_varint(val, o2)
                v2, o2 = _read_varint(val, o2)
                if t2 >> 3 == 1:
                    seconds = v2
                elif t2 >> 3 == 2:
                    nanos = v2
            return seconds * 1_000_000_000 + nanos
    raise ValueError("no timestamp field in sign bytes")


def canonical_proposal_sign_bytes(chain_id: str, height: int, round_: int,
                                  pol_round: int, block_id: BlockID,
                                  timestamp_ns: int) -> bytes:
    """CanonicalProposal (types/canonical.go:36, proposal sign bytes)."""
    body = (wire.field_varint(1, SIGNED_MSG_TYPE_PROPOSAL)
            + wire.field_sfixed64(2, height)
            + wire.field_sfixed64(3, round_)
            + wire.field_varint(4, pol_round)
            + wire.field_message(5, block_id.encode_canonical())
            + wire.field_message(6, encode_timestamp(timestamp_ns),
                                 force=True)
            + wire.field_string(7, chain_id))
    return wire.length_prefixed(body)


def canonical_vote_extension_sign_bytes(chain_id: str, height: int,
                                        round_: int,
                                        extension: bytes) -> bytes:
    """CanonicalVoteExtension (types/vote.go VoteExtensionSignBytes)."""
    body = (wire.field_bytes(1, extension)
            + wire.field_sfixed64(2, height)
            + wire.field_sfixed64(3, round_)
            + wire.field_string(4, chain_id))
    return wire.length_prefixed(body)
