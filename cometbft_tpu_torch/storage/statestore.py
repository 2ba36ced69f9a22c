"""State and StateStore (reference: ``state/state.go``,
``state/store.go``).

Counterpart of ``cometbft_tpu/storage/statestore.py``: ``State`` is the
snapshot consensus carries from height to height (validator sets,
params, last results); ``StateStore`` keeps it with the validator sets
and params by height and the FinalizeBlock responses, and prunes below
a retain height (``state/store.go:112-152``).  The keys and record bytes
are the JAX store's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..types import _msgpack, codec
from ..types.block_id import BlockID
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams, default_consensus_params
from ..types.validator_set import ValidatorSet
from .db import KVStore
from .db import height_key as _hkey

__all__ = ["K_STATE", "K_VALS", "K_PARAMS", "K_ABCI", "K_RETAIN",
           "K_PRUNED_TO", "K_OFFLINE_SS", "State", "StateStore",
           "state_to_dict", "state_from_dict", "rollback_state"]

K_STATE = b"S/state"
K_VALS = b"S/v/"
K_PARAMS = b"S/p/"
K_ABCI = b"S/r/"
K_RETAIN = b"S/retain"
K_PRUNED_TO = b"S/prunedto"
K_OFFLINE_SS = b"S/offliness"


@dataclass
class State:
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time_ns: int
    validators: ValidatorSet
    next_validators: ValidatorSet
    last_validators: ValidatorSet | None
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_height_params_changed: int
    last_results_hash: bytes
    app_hash: bytes

    @classmethod
    def from_genesis(cls, doc: GenesisDoc) -> "State":
        vals = doc.validator_set()
        return cls(
            chain_id=doc.chain_id,
            initial_height=doc.initial_height,
            last_block_height=0,
            last_block_id=BlockID(),
            last_block_time_ns=doc.genesis_time_ns,
            validators=vals,
            next_validators=vals.copy_increment_proposer_priority(1),
            last_validators=None,
            last_height_validators_changed=doc.initial_height,
            consensus_params=doc.consensus_params,
            last_height_params_changed=doc.initial_height,
            last_results_hash=b"",
            app_hash=doc.app_hash,
        )

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy(),
            next_validators=self.next_validators.copy(),
            last_validators=(self.last_validators.copy()
                             if self.last_validators else None),
        )

    def is_empty(self) -> bool:
        return self.last_block_height == 0 and not self.chain_id


def state_to_dict(state: State) -> dict:
    """The stored record of a state (the map under ``K_STATE``)."""
    return {
        "chain": state.chain_id,
        "ih": state.initial_height,
        "h": state.last_block_height,
        "bid": codec.to_dict(state.last_block_id),
        "ts": state.last_block_time_ns,
        "vals": codec.to_dict(state.validators),
        "nvals": codec.to_dict(state.next_validators),
        "lvals": codec.to_dict(state.last_validators),
        "lhvc": state.last_height_validators_changed,
        "params": _params_to_dict(state.consensus_params),
        "lhpc": state.last_height_params_changed,
        "lrh": state.last_results_hash,
        "ah": state.app_hash,
    }


def state_from_dict(d: dict) -> State:
    return State(
        chain_id=d["chain"], initial_height=d["ih"],
        last_block_height=d["h"],
        last_block_id=codec.from_dict(d["bid"]),
        last_block_time_ns=d["ts"],
        validators=codec.from_dict(d["vals"]),
        next_validators=codec.from_dict(d["nvals"]),
        last_validators=codec.from_dict(d["lvals"]),
        last_height_validators_changed=d["lhvc"],
        consensus_params=_params_from_dict(d["params"]),
        last_height_params_changed=d["lhpc"],
        last_results_hash=d["lrh"], app_hash=d["ah"])


class StateStore:
    def __init__(self, db: KVStore):
        self.db = db

    # ----------------------------------------------------------- state

    def save(self, state: State) -> None:
        self.db.set(K_STATE, _msgpack.packb(state_to_dict(state)))
        # validator sets by height, for light clients and evidence
        self.save_validators(state.last_block_height + 1, state.validators)
        self.save_validators(state.last_block_height + 2,
                             state.next_validators)
        self.db.set(_hkey(K_PARAMS, state.last_block_height + 1),
                    _msgpack.packb(_params_to_dict(state.consensus_params)))

    def load(self) -> State | None:
        raw = self.db.get(K_STATE)
        return state_from_dict(_msgpack.unpackb(raw)) if raw else None

    def bootstrap(self, state: State) -> None:
        """Install a state directly (statesync; state/store.go
        Bootstrap)."""
        self.save(state)
        if state.last_validators is not None:
            self.save_validators(state.last_block_height,
                                 state.last_validators)

    def clear_state(self) -> None:
        """Drop the latest state (the storage doctor's last resort: the
        node starts again from genesis).  Records by height stay and are
        overwritten as heights are applied again."""
        self.db.delete(K_STATE)

    # ----------------------------------------- validators/params by height

    def save_validators(self, height: int, vals: ValidatorSet) -> None:
        self.db.set(_hkey(K_VALS, height), codec.pack(vals))

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(_hkey(K_VALS, height))
        return codec.unpack(raw) if raw else None

    def load_params(self, height: int) -> ConsensusParams | None:
        raw = self.db.get(_hkey(K_PARAMS, height))
        return _params_from_dict(_msgpack.unpackb(raw)) if raw else None

    # ------------------------------------------------- abci responses

    def save_finalize_block_response(self, height: int, resp_raw: bytes):
        self.db.set(_hkey(K_ABCI, height), resp_raw)

    def load_finalize_block_response(self, height: int) -> bytes | None:
        return self.db.get(_hkey(K_ABCI, height))

    # ------------------------------------------------------- pruning

    def set_retain_heights(self, app: int, companion: int = 0) -> None:
        self.db.set(K_RETAIN, _msgpack.packb({"app": app, "dc": companion}))

    def get_retain_height(self) -> int:
        raw = self.db.get(K_RETAIN)
        if not raw:
            return 0
        d = _msgpack.unpackb(raw)
        vals = [v for v in (d["app"], d["dc"]) if v > 0]
        return min(vals) if vals else 0

    def prune_states(self, retain_height: int) -> int:
        """Delete the records by height below ``retain_height``, from a
        stored low-water mark on (state/store.go PruneStates), so no
        height is skipped however far the retain height jumps."""
        raw = self.db.get(K_PRUNED_TO)
        start = _msgpack.unpackb(raw) if raw else 1
        pruned = 0
        for h in range(start, retain_height):
            for prefix in (K_VALS, K_PARAMS, K_ABCI):
                if self.db.has(_hkey(prefix, h)):
                    self.db.delete(_hkey(prefix, h))
                    pruned += 1
        if retain_height > start:
            self.db.set(K_PRUNED_TO, _msgpack.packb(retain_height))
        return pruned

    def set_offline_state_sync_height(self, height: int) -> None:
        self.db.set(K_OFFLINE_SS, _msgpack.packb(height))

    def get_offline_state_sync_height(self) -> int:
        raw = self.db.get(K_OFFLINE_SS)
        return _msgpack.unpackb(raw) if raw else 0


def _params_to_dict(p: ConsensusParams) -> dict:
    return {
        "block": [p.block.max_bytes, p.block.max_gas],
        "evidence": [p.evidence.max_age_num_blocks,
                     p.evidence.max_age_duration_ns, p.evidence.max_bytes],
        "validator": p.validator.pub_key_types,
        "version": p.version.app,
        "feature": [p.feature.vote_extensions_enable_height,
                    p.feature.pbts_enable_height],
        "synchrony": [p.synchrony.precision_ns,
                      p.synchrony.message_delay_ns],
    }


def _params_from_dict(d: dict) -> ConsensusParams:
    p = default_consensus_params()
    p.block.max_bytes, p.block.max_gas = d["block"]
    (p.evidence.max_age_num_blocks, p.evidence.max_age_duration_ns,
     p.evidence.max_bytes) = d["evidence"]
    p.validator.pub_key_types = list(d["validator"])
    p.version.app = d["version"]
    (p.feature.vote_extensions_enable_height,
     p.feature.pbts_enable_height) = d["feature"]
    p.synchrony.precision_ns, p.synchrony.message_delay_ns = d["synchrony"]
    return p


def rollback_state(state_store: StateStore, block_store,
                   remove_block: bool = False) -> State:
    """Undo the latest state transition (reference:
    ``state/rollback.go``): the state after h - 1 is rebuilt from the
    stores (block h carries app_hash and last_results_hash as of h - 1,
    the records by height the rotated sets) and saved.  The application
    is rolled back to the same height separately, as in the reference."""
    state = state_store.load()
    if state is None:
        raise ValueError("no state to roll back")
    h = state.last_block_height
    if h <= 0:
        raise ValueError("state is at genesis; nothing to roll back")
    if block_store.height() != h:
        raise ValueError(
            f"block store height {block_store.height()} != state height {h}"
            " (cannot roll back)")

    block = block_store.load_block(h)
    prev_meta = block_store.load_block_meta(h - 1)
    vals_h = state_store.load_validators(h)
    vals_h1 = state_store.load_validators(h + 1)
    vals_prev = state_store.load_validators(h - 1)
    params = state_store.load_params(h)
    if block is None or vals_h is None or vals_h1 is None:
        raise ValueError(f"missing records to roll back height {h}")

    prev_block = block_store.load_block(h - 1)
    rolled = replace(
        state,
        last_block_height=h - 1,
        last_block_id=prev_meta.block_id if prev_meta is not None
        else type(state.last_block_id)(),
        last_block_time_ns=prev_block.header.time_ns
        if prev_block is not None else state.last_block_time_ns,
        validators=vals_h,
        next_validators=vals_h1,
        last_validators=vals_prev,
        # h + 1, not h: the rolled-back state still holds the
        # next_validators that take effect at h + 1 (state/rollback.go)
        last_height_validators_changed=min(
            state.last_height_validators_changed, h + 1),
        consensus_params=params if params is not None
        else state.consensus_params,
        last_height_params_changed=min(state.last_height_params_changed,
                                       h + 1),
        app_hash=block.header.app_hash,
        last_results_hash=block.header.last_results_hash,
    )
    state_store.save(rolled)
    if remove_block:
        block_store.remove_tip()
    return rolled
