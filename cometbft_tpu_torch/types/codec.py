"""Serialization codec for storage (counterpart of
``cometbft_tpu/types/codec.py``).

Hash and sign bytes use the canonical proto encodings (``types/wire.py``);
stored and transported objects use a tagged-dict codec over MessagePack:
each object becomes a dict whose ``"!"`` key names its type.  The tags
and field keys are the JAX package's, so :func:`pack` gives the same
bytes as its ``codec.pack`` for the same object.  The MessagePack
subset is the port's own (``types/_msgpack.py``), byte for byte
``msgpack.packb(obj, use_bin_type=True)``.

Tagged types: ``PartSetHeader``, ``BlockID``, ``CommitSig``, ``Commit``
(``agg``/``asg`` only when the commit carries an aggregate), ``Header``,
``Data``, ``Validator`` (Ed25519 or BLS12-381 keys), ``ValidatorSet``,
``Vote``, ``Proposal``, ``DuplicateVoteEvidence``,
``LightClientAttackEvidence``, ``LightBlock``, ``Block``,
``ExtendedCommit`` and ``ExtendedCommitSig``.  An unknown tag raises
TypeError.
"""

from __future__ import annotations

from . import _msgpack
from .block_id import BlockID, PartSetHeader
from .commit import Commit, CommitSig, ExtendedCommit, ExtendedCommitSig
from .evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from .header import Block, Data, Header
from .validator_set import Validator, ValidatorSet
from .vote import Proposal, Vote

__all__ = ["pack", "unpack", "to_dict", "from_dict"]


def pack(obj) -> bytes:
    return _msgpack.packb(to_dict(obj))


def unpack(raw: bytes):
    return from_dict(_msgpack.unpackb(raw))


# --------------------------------------------------------------- dict codecs

def _commit_dict(t: str, obj, sigs: list) -> dict:
    """A ``Commit`` or ``ExtendedCommit`` (``sigs`` its lanes)."""
    d = {"!": t, "h": obj.height, "r": obj.round,
         "bid": to_dict(obj.block_id), "sigs": [to_dict(s) for s in sigs]}
    if obj.agg_signature or obj.agg_signers:
        # only when present: an Ed25519 commit's dict has no such keys
        d["agg"] = obj.agg_signature
        d["asg"] = obj.agg_signers
    return d


def to_dict(obj):
    if obj is None or isinstance(obj, (int, str, bytes, bool)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [to_dict(o) for o in obj]
    if isinstance(obj, dict):                 # plain containers recurse
        return {k: to_dict(v) for k, v in obj.items()}
    t = type(obj).__name__
    if isinstance(obj, PartSetHeader):
        return {"!": t, "total": obj.total, "hash": obj.hash}
    if isinstance(obj, BlockID):
        return {"!": t, "hash": obj.hash,
                "psh": to_dict(obj.part_set_header)}
    if isinstance(obj, CommitSig):
        return {"!": t, "flag": obj.block_id_flag,
                "addr": obj.validator_address, "ts": obj.timestamp_ns,
                "sig": obj.signature}
    if isinstance(obj, Commit):
        return _commit_dict(t, obj, obj.signatures)
    if isinstance(obj, ExtendedCommitSig):
        return {"!": t, "cs": to_dict(obj.commit_sig), "ext": obj.extension,
                "extsig": obj.extension_signature}
    if isinstance(obj, ExtendedCommit):
        return _commit_dict(t, obj, obj.extended_signatures)
    if isinstance(obj, Vote):
        return {"!": t, "t": obj.type, "h": obj.height, "r": obj.round,
                "bid": to_dict(obj.block_id), "ts": obj.timestamp_ns,
                "addr": obj.validator_address, "idx": obj.validator_index,
                "sig": obj.signature, "ext": obj.extension,
                "extsig": obj.extension_signature}
    if isinstance(obj, Proposal):
        return {"!": t, "h": obj.height, "r": obj.round,
                "pol": obj.pol_round, "bid": to_dict(obj.block_id),
                "ts": obj.timestamp_ns, "sig": obj.signature}
    if isinstance(obj, Header):
        return {"!": t, "chain": obj.chain_id, "h": obj.height,
                "ts": obj.time_ns, "lbi": to_dict(obj.last_block_id),
                "lch": obj.last_commit_hash, "dh": obj.data_hash,
                "vh": obj.validators_hash, "nvh": obj.next_validators_hash,
                "ch": obj.consensus_hash, "ah": obj.app_hash,
                "lrh": obj.last_results_hash, "eh": obj.evidence_hash,
                "prop": obj.proposer_address, "vb": obj.version_block,
                "va": obj.version_app}
    if isinstance(obj, Data):
        return {"!": t, "txs": list(obj.txs)}
    if isinstance(obj, Block):
        return {"!": t, "hdr": to_dict(obj.header), "data": to_dict(obj.data),
                "ev": [to_dict(e) for e in obj.evidence],
                "lc": to_dict(obj.last_commit)}
    if isinstance(obj, Validator):
        return {"!": t, "pk_type": obj.pub_key.type(),
                "pk": obj.pub_key.bytes(), "power": obj.voting_power,
                "prio": obj.proposer_priority}
    if isinstance(obj, ValidatorSet):
        return {"!": t, "vals": [to_dict(v) for v in obj.validators],
                "prop": obj.proposer.address if obj.proposer else b""}
    if isinstance(obj, DuplicateVoteEvidence):
        return {"!": t, "a": to_dict(obj.vote_a), "b": to_dict(obj.vote_b),
                "tvp": obj.total_voting_power, "vp": obj.validator_power,
                "ts": obj.timestamp_ns}
    if isinstance(obj, LightClientAttackEvidence):
        return {"!": t, "chh": obj.conflicting_header_hash,
                "chht": obj.conflicting_height, "comh": obj.common_height,
                "byz": [to_dict(v) for v in obj.byzantine_validators],
                "tvp": obj.total_voting_power, "ts": obj.timestamp_ns,
                "cb": to_dict(obj.conflicting_block)}
    from ..light.types import LightBlock  # lazy: light imports types

    if isinstance(obj, LightBlock):
        return {"!": "LightBlock", "h": to_dict(obj.header),
                "c": to_dict(obj.commit), "v": to_dict(obj.validators)}
    raise TypeError(f"codec: unsupported type {t}")


def _validator_set(d) -> ValidatorSet:
    """A decoded set as stored: validators with their priorities and the
    stored proposer, no increment; the dense view, the address index and
    the device tables are built anew on first use."""
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = [from_dict(v) for v in d["vals"]]
    vs._total = None
    vs.proposer = None
    if d["prop"]:
        _, vs.proposer = vs.get_by_address(d["prop"])
    return vs


def from_dict(d):
    if d is None or isinstance(d, (int, str, bytes, bool)):
        return d
    if isinstance(d, list):
        return [from_dict(x) for x in d]
    t = d.get("!")
    if t is None:                             # plain containers recurse
        return {k: from_dict(v) for k, v in d.items()}
    if t == "PartSetHeader":
        return PartSetHeader(d["total"], d["hash"])
    if t == "BlockID":
        return BlockID(d["hash"], from_dict(d["psh"]))
    if t == "CommitSig":
        return CommitSig(d["flag"], d["addr"], d["ts"], d["sig"])
    if t == "Commit":
        return Commit(d["h"], d["r"], from_dict(d["bid"]),
                      [from_dict(s) for s in d["sigs"]],
                      d.get("agg", b""), d.get("asg", b""))
    if t == "ExtendedCommitSig":
        return ExtendedCommitSig(from_dict(d["cs"]), d["ext"], d["extsig"])
    if t == "ExtendedCommit":
        return ExtendedCommit(d["h"], d["r"], from_dict(d["bid"]),
                              [from_dict(s) for s in d["sigs"]],
                              d.get("agg", b""), d.get("asg", b""))
    if t == "Vote":
        return Vote(type=d["t"], height=d["h"], round=d["r"],
                    block_id=from_dict(d["bid"]), timestamp_ns=d["ts"],
                    validator_address=d["addr"], validator_index=d["idx"],
                    signature=d["sig"], extension=d["ext"],
                    extension_signature=d["extsig"])
    if t == "Proposal":
        return Proposal(height=d["h"], round=d["r"], pol_round=d["pol"],
                        block_id=from_dict(d["bid"]), timestamp_ns=d["ts"],
                        signature=d["sig"])
    if t == "Header":
        return Header(chain_id=d["chain"], height=d["h"], time_ns=d["ts"],
                      last_block_id=from_dict(d["lbi"]),
                      last_commit_hash=d["lch"], data_hash=d["dh"],
                      validators_hash=d["vh"], next_validators_hash=d["nvh"],
                      consensus_hash=d["ch"], app_hash=d["ah"],
                      last_results_hash=d["lrh"], evidence_hash=d["eh"],
                      proposer_address=d["prop"], version_block=d["vb"],
                      version_app=d["va"])
    if t == "Data":
        return Data(txs=list(d["txs"]))
    if t == "Block":
        return Block(header=from_dict(d["hdr"]), data=from_dict(d["data"]),
                     evidence=[from_dict(e) for e in d["ev"]],
                     last_commit=from_dict(d["lc"]))
    if t == "Validator":
        from ..crypto.keys import pub_key_from_type_bytes

        return Validator(pub_key_from_type_bytes(d["pk_type"], d["pk"]),
                         d["power"], d["prio"])
    if t == "ValidatorSet":
        return _validator_set(d)
    if t == "DuplicateVoteEvidence":
        return DuplicateVoteEvidence(from_dict(d["a"]), from_dict(d["b"]),
                                     d["tvp"], d["vp"], d["ts"])
    if t == "LightClientAttackEvidence":
        return LightClientAttackEvidence(
            d["chh"], d["chht"], d["comh"],
            byzantine_validators=[from_dict(v) for v in d.get("byz", [])],
            total_voting_power=d["tvp"], timestamp_ns=d["ts"],
            conflicting_block=from_dict(d.get("cb")))
    if t == "LightBlock":
        from ..light.types import LightBlock

        return LightBlock(header=from_dict(d["h"]), commit=from_dict(d["c"]),
                          validators=from_dict(d["v"]))
    raise TypeError(f"codec: unknown tag {t!r}")
