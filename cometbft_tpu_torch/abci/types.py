"""ABCI request and response types (reference: ``abci/types/types.pb.go``,
slimmed to the fields consensus, the mempool and the syncs use).

Counterpart of ``cometbft_tpu/abci/types.py``: the same dataclasses with
the same fields in the same order, since ``abci/client.py:_encode_value``
stores a FinalizeBlock response field by field."""

from __future__ import annotations

from dataclasses import dataclass, field

CODE_TYPE_OK = 0

PROCESS_PROPOSAL_ACCEPT = 1
PROCESS_PROPOSAL_REJECT = 2
VERIFY_VOTE_EXT_ACCEPT = 1
VERIFY_VOTE_EXT_REJECT = 2
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_REJECT = 2
OFFER_SNAPSHOT_REJECT_FORMAT = 3
OFFER_SNAPSHOT_REJECT_SENDER = 4
APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3


@dataclass
class ApplySnapshotChunkResponse:
    """Full reference shape (abci ApplySnapshotChunkResponse:
    result + refetch_chunks + reject_senders).  Apps may return a bare
    status int instead; the statesync syncer normalizes."""

    result: int = APPLY_CHUNK_ACCEPT
    refetch_chunks: list = field(default_factory=list)   # indexes
    reject_senders: list = field(default_factory=list)   # peer ids


@dataclass
class EventAttribute:
    key: str
    value: str
    index: bool = True


@dataclass
class Event:
    type: str
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        """Deterministic encoding for last_results_hash."""
        from ..types import wire

        return (wire.field_varint(1, self.code)
                + wire.field_bytes(2, self.data)
                + wire.field_varint(5, self.gas_wanted)
                + wire.field_varint(6, self.gas_used))


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int
    # proof of possession — REQUIRED when admitting a new bls12_381 key
    # (the rogue-key defense the aggregate-commit fast path rests on);
    # ignored for other key types, removals, and power changes of
    # already-admitted keys.  sm/execution.py rejects the update when
    # the proof is missing or fails bls12381.pop_verify.
    pop: bytes = b""


@dataclass
class Misbehavior:
    type: str                 # "DUPLICATE_VOTE" | "LIGHT_CLIENT_ATTACK"
    validator_address: bytes
    validator_power: int
    height: int
    time_ns: int
    total_voting_power: int


@dataclass
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


@dataclass
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class QueryResponse:
    code: int = CODE_TYPE_OK
    log: str = ""
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    # merkle proof op chain as wire dicts {"type","key","data"}
    # (abci ProofOps; verified against the header app_hash at height+1)
    proof_ops: list = field(default_factory=list)


@dataclass
class CheckTxResponse:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class InitChainRequest:
    chain_id: str
    initial_height: int
    time_ns: int
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    consensus_params: object = None


@dataclass
class InitChainResponse:
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""
    consensus_params: object = None


@dataclass
class PrepareProposalRequest:
    max_tx_bytes: int
    txs: list[bytes]
    height: int
    time_ns: int
    proposer_address: bytes = b""
    local_last_commit: object = None
    misbehavior: list[Misbehavior] = field(default_factory=list)


@dataclass
class PrepareProposalResponse:
    txs: list[bytes] = field(default_factory=list)


@dataclass
class ProcessProposalRequest:
    txs: list[bytes]
    height: int
    time_ns: int
    hash: bytes = b""
    proposer_address: bytes = b""
    misbehavior: list[Misbehavior] = field(default_factory=list)


@dataclass
class FinalizeBlockRequest:
    txs: list[bytes]
    height: int
    time_ns: int
    hash: bytes = b""
    proposer_address: bytes = b""
    decided_last_commit: object = None
    misbehavior: list[Misbehavior] = field(default_factory=list)
    syncing_to_height: int = 0


@dataclass
class FinalizeBlockResponse:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object = None
    app_hash: bytes = b""

    def results_hash(self, device=None) -> bytes:
        """Merkle root of the tx results' encodings; at
        ``merkle.MERKLE_KERNEL_MIN_LEAVES`` results or more it is hashed
        by the kernels on ``device`` (None: CUDA)."""
        from ..crypto import merkle

        return merkle.hash_from_byte_slices_fast(
            [r.encode() for r in self.tx_results], device=device)


@dataclass
class ExtendVoteResponse:
    vote_extension: bytes = b""


@dataclass
class VerifyVoteExtensionResponse:
    status: int = VERIFY_VOTE_EXT_ACCEPT

    @property
    def accepted(self) -> bool:
        return self.status == VERIFY_VOTE_EXT_ACCEPT


@dataclass
class CommitResponse:
    retain_height: int = 0
