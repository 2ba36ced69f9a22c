"""Example kvstore application (counterpart of
``cometbft_tpu/abci/kvstore.py``; reference:
``abci/example/kvstore/kvstore.go``).

Transactions are ``key=value`` bytes; state is a dict with a
deterministic app hash (a merkle root over ``kv_leaf`` leaves, so queries
are provable); InitChain installs genesis validators;
``val:<pubkey_b64>!<power>`` transactions update the validator set; vote
extensions carry a height-tagged payload; snapshots serialize the full
state in fixed-size chunks with the port's MessagePack subset
(``types/_msgpack.py``), byte for byte the JAX package's.  ``device`` is
where an app hash of ``crypto/merkle.MERKLE_KERNEL_MIN_LEAVES`` keys or
more is hashed (below that it is hashlib on any device)."""

from __future__ import annotations

import base64
import hashlib
import json
import struct

from ..types import _msgpack
from . import types as t
from .application import Application

__all__ = ["KVStoreApplication", "SNAPSHOT_CHUNK_SIZE", "VALSET_PREFIX"]

SNAPSHOT_CHUNK_SIZE = 64 * 1024
VALSET_PREFIX = b"val:"


class KVStoreApplication(Application):
    def __init__(self, device=None):
        self.device = device
        self.state: dict[bytes, bytes] = {}
        self._leaves: dict[bytes, bytes] = {}   # key -> kv_leaf, lazily
        self.height = 0
        self.app_hash = self._compute_app_hash()
        self.validators: dict[bytes, int] = {}     # pubkey bytes -> power
        self.pending_updates: list[t.ValidatorUpdate] = []
        self.misbehavior_seen: list[t.Misbehavior] = []   # punished offenders
        self.snapshots: dict[int, object] = {}     # height -> state copy | serialized bytes (lazy)
        self._restore_chunks: dict[int, bytes] = {}
        self._restoring: t.Snapshot | None = None

    # ----------------------------------------------------------------- info

    async def info(self) -> t.InfoResponse:
        return t.InfoResponse(data="kvstore", version="0.1.0",
                              app_version=1,
                              last_block_height=self.height,
                              last_block_app_hash=self.app_hash)

    async def query(self, path: str, data: bytes, height: int,
                    prove: bool) -> t.QueryResponse:
        value = self.state.get(data, b"")
        resp = t.QueryResponse(key=data, value=value, height=self.height,
                               log="exists" if value else "does not exist")
        if prove and value:
            from ..crypto.merkle import ValueOp

            index, proofs = self._ensure_proof_cache()
            op = ValueOp(data, proofs[index[data]]).proof_op()
            resp.proof_ops = [{"type": op.type, "key": op.key,
                               "data": op.data}]
        return resp

    # -------------------------------------------------------------- mempool

    async def check_tx(self, tx: bytes, recheck: bool = False
                       ) -> t.CheckTxResponse:
        if self._parse_tx(tx) is None:
            return t.CheckTxResponse(code=1, log="malformed tx")
        return t.CheckTxResponse(gas_wanted=1)

    @staticmethod
    def _parse_tx(tx: bytes):
        if tx.startswith(VALSET_PREFIX):
            body = tx[len(VALSET_PREFIX):]
            if b"!" not in body:
                return None
            pk_b64, power = body.split(b"!", 1)
            try:
                pk = base64.b64decode(pk_b64, validate=True)
                return ("val", pk, int(power))
            except Exception:
                return None
        if b"=" not in tx:
            return None
        k, v = tx.split(b"=", 1)
        return ("set", k, v)

    # ------------------------------------------------------------ consensus

    async def init_chain(self, req: t.InitChainRequest) -> t.InitChainResponse:
        for vu in req.validators:
            self.validators[vu.pub_key_bytes] = vu.power
        if req.app_state_bytes and req.app_state_bytes != b"{}":
            # genesis app_state is JSON (types/genesis.go AppState semantics)
            d = json.loads(req.app_state_bytes)
            self.state = {str(k).encode(): str(v).encode()
                          for k, v in d.items()}
            self._leaves.clear()
        self.app_hash = self._compute_app_hash()
        return t.InitChainResponse(app_hash=self.app_hash)

    async def process_proposal(self, req: t.ProcessProposalRequest) -> int:
        for tx in req.txs:
            if self._parse_tx(tx) is None:
                return t.PROCESS_PROPOSAL_REJECT
        return t.PROCESS_PROPOSAL_ACCEPT

    async def finalize_block(self, req: t.FinalizeBlockRequest
                             ) -> t.FinalizeBlockResponse:
        self.misbehavior_seen.extend(req.misbehavior)
        results, updates = [], []
        for tx in req.txs:
            parsed = self._parse_tx(tx)
            if parsed is None:
                results.append(t.ExecTxResult(code=1, log="malformed tx"))
                continue
            if parsed[0] == "val":
                _, pk, power = parsed
                if power > 0:
                    self.validators[pk] = power
                else:
                    self.validators.pop(pk, None)
                updates.append(t.ValidatorUpdate("ed25519", pk, power))
                results.append(t.ExecTxResult(
                    events=[t.Event("valset", [
                        t.EventAttribute("pubkey",
                                         base64.b64encode(pk).decode()),
                        t.EventAttribute("power", str(power))])]))
            else:
                _, k, v = parsed
                self.state[k] = v
                self._leaves.pop(k, None)   # leaf recomputed at hash time
                results.append(t.ExecTxResult(
                    gas_used=1,
                    events=[t.Event("app", [
                        t.EventAttribute("key", k.decode("utf-8", "replace")),
                    ])]))
        self.height = req.height
        self.app_hash = self._compute_app_hash()
        return t.FinalizeBlockResponse(tx_results=results,
                                       validator_updates=updates,
                                       app_hash=self.app_hash)

    async def extend_vote(self, height: int, round_: int,
                          block_hash: bytes) -> t.ExtendVoteResponse:
        return t.ExtendVoteResponse(
            vote_extension=b"ext" + struct.pack(">q", height))

    async def verify_vote_extension(self, height, round_, validator_address,
                                    block_hash, extension
                                    ) -> t.VerifyVoteExtensionResponse:
        want = b"ext" + struct.pack(">q", height)
        ok = extension == want
        return t.VerifyVoteExtensionResponse(
            status=t.VERIFY_VOTE_EXT_ACCEPT if ok
            else t.VERIFY_VOTE_EXT_REJECT)

    async def commit(self) -> t.CommitResponse:
        # a CHEAP dict copy per height; msgpack+hash happen lazily in
        # _snapshot_raw when a statesync peer actually lists/fetches —
        # serializing the whole store every block was a top-3 cost in
        # the e2e throughput profile (the reference kvstore has no
        # snapshot support at all; this keeps it without the per-block
        # tax)
        self.snapshots[self.height] = (dict(self.state),
                                       dict(self.validators), self.height)
        # retention must outlive a statesyncer's offer->fetch window even
        # on fast test chains
        for h in sorted(self.snapshots)[:-16]:
            del self.snapshots[h]
        return t.CommitResponse(retain_height=0)

    # ------------------------------------------------------------ snapshots

    def _snapshot_raw(self, height: int) -> bytes:
        """Serialized snapshot bytes for a height, computed on first use
        from the stored state copy and cached."""
        v = self.snapshots.get(height)
        if v is None:
            return b""
        if isinstance(v, bytes):
            return v
        state, vals, h = v
        raw = _msgpack.packb({"state": sorted(state.items()),
                              "vals": sorted(vals.items()),
                              "height": h})
        self.snapshots[height] = raw
        return raw

    def _compute_app_hash(self) -> bytes:
        """Merkle root over key-bound leaves: queries are PROVABLE against
        the app hash in the next block header (crypto/merkle ValueOp).

        Root only (``hash_from_byte_slices_fast`` on ``device``): the
        per-key proofs that only ``query(prove=True)`` needs are built
        lazily in :meth:`_ensure_proof_cache` and invalidated on
        mutation.

        Leaf bytes are cached per key (``_leaves``; writers invalidate
        the touched key): each block re-hashes the tree but not the
        untouched leaves' value digests."""
        from ..crypto.merkle import hash_from_byte_slices_fast, kv_leaf

        self._proof_cache = None           # state changed: proofs stale
        leaves = self._leaves
        return hash_from_byte_slices_fast(
            [leaves.get(k) or
             leaves.setdefault(k, kv_leaf(k, self.state[k]))
             for k in sorted(self.state)], device=self.device)

    def _ensure_proof_cache(self):
        """Build (lazily) the per-key inclusion proofs for proven
        queries; valid until the next state mutation."""
        if self._proof_cache is None:
            from ..crypto.merkle import kv_leaf, proofs_from_byte_slices

            keys = sorted(self.state)
            leaves = self._leaves
            _, proofs = proofs_from_byte_slices(
                [leaves.get(k) or
                 leaves.setdefault(k, kv_leaf(k, self.state[k]))
                 for k in keys], device=self.device)
            self._proof_cache = ({k: i for i, k in enumerate(keys)},
                                 proofs)
        return self._proof_cache

    async def list_snapshots(self) -> list[t.Snapshot]:
        out = []
        for h in sorted(self.snapshots):
            raw = self._snapshot_raw(h)
            nchunks = (len(raw) + SNAPSHOT_CHUNK_SIZE - 1) \
                // SNAPSHOT_CHUNK_SIZE or 1
            out.append(t.Snapshot(height=h, format=1, chunks=nchunks,
                                  hash=hashlib.sha256(raw).digest()))
        return out

    async def offer_snapshot(self, snapshot: t.Snapshot,
                             app_hash: bytes) -> int:
        if snapshot.format != 1:
            return t.OFFER_SNAPSHOT_REJECT_FORMAT
        self._restoring = snapshot
        self._restore_chunks = {}
        return t.OFFER_SNAPSHOT_ACCEPT

    async def load_snapshot_chunk(self, height: int, format_: int,
                                  chunk: int) -> bytes:
        raw = self._snapshot_raw(height)
        off = chunk * SNAPSHOT_CHUNK_SIZE
        return raw[off:off + SNAPSHOT_CHUNK_SIZE]

    async def apply_snapshot_chunk(self, index: int, chunk: bytes,
                                   sender: str) -> int:
        """Chunks are keyed by index: duplicates/re-sends and out-of-order
        delivery (statesync retries) are harmless."""
        if self._restoring is None:
            return t.APPLY_CHUNK_ABORT
        self._restore_chunks[index] = chunk
        if len(self._restore_chunks) == self._restoring.chunks and \
                all(i in self._restore_chunks
                    for i in range(self._restoring.chunks)):
            raw = b"".join(self._restore_chunks[i]
                           for i in range(self._restoring.chunks))
            if hashlib.sha256(raw).digest() != self._restoring.hash:
                # keep _restoring: the syncer refetches and re-applies —
                # dropping it here would turn the retry into an abort
                self._restore_chunks = {}
                return t.APPLY_CHUNK_RETRY
            d = _msgpack.unpackb(raw)
            self.state = dict(d["state"])
            self._leaves.clear()
            self.validators = dict(d["vals"])
            self.height = d["height"]
            self.app_hash = self._compute_app_hash()
            self._restoring = None
        return t.APPLY_CHUNK_ACCEPT
