"""BlockStore (reference: ``store/store.go:46``): blocks, block metas,
commits, the seen commit and extended commits, keyed by height with a
height-ordered key layout.

Counterpart of ``cometbft_tpu/storage/blockstore.py``: the same keys and
the same record bytes (the codec's tagged dicts and plain MessagePack
maps through the port's ``types/_msgpack.py``).  Part sets are not
stored: they are a function of the block's bytes and are built again
when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import _msgpack, codec
from ..types.block_id import BlockID
from ..types.commit import Commit, ExtendedCommit
from ..types.header import Block
from ..types.part_set import PartSet
from .db import KVStore
from .db import height_key as _hkey

__all__ = ["K_BLOCK", "K_COMMIT", "K_SEEN_COMMIT", "K_EXT_COMMIT", "K_META",
           "K_STATE", "BlockMeta", "BlockStore"]

K_BLOCK = b"B/"
K_COMMIT = b"C/"          # the canonical commit of a height (from H + 1)
K_SEEN_COMMIT = b"SC"     # the latest seen commit (one record)
K_EXT_COMMIT = b"EC/"
K_META = b"M/"
K_STATE = b"BSJ"          # base and height


@dataclass
class BlockMeta:
    block_id: BlockID
    block_size: int
    num_txs: int
    header_height: int


class BlockStore:
    def __init__(self, db: KVStore):
        self.db = db
        raw = db.get(K_STATE)
        if raw:
            d = _msgpack.unpackb(raw)
            self._base, self._height = d["base"], d["height"]
        else:
            self._base = self._height = 0

    def base(self) -> int:
        return self._base

    def height(self) -> int:
        return self._height

    def size(self) -> int:
        return self._height - self._base + 1 if self._height else 0

    def _bookkeeping(self) -> bytes:
        return _msgpack.packb({"base": self._base, "height": self._height})

    def save_block(self, block: Block, parts: PartSet,
                   seen_commit: Commit) -> None:
        h = block.header.height
        if h != self._height + 1 and self._height != 0:
            raise ValueError(
                f"non-contiguous block save: {h} after {self._height}")
        bid = BlockID(block.hash(), parts.header())
        if self._base == 0:
            self._base = h
        self._height = h
        batch: dict[bytes, bytes] = {
            _hkey(K_BLOCK, h): codec.pack(block),
            _hkey(K_META, h): _msgpack.packb({
                "bid": codec.to_dict(bid), "size": parts.byte_size,
                "ntxs": len(block.data.txs), "h": h}),
            K_SEEN_COMMIT: codec.pack(seen_commit),
            K_STATE: self._bookkeeping(),
        }
        if block.last_commit is not None:
            batch[_hkey(K_COMMIT, h - 1)] = codec.pack(block.last_commit)
        self.db.set_batch(batch)     # one grouped write

    def save_block_with_extended_commit(self, block: Block, parts: PartSet,
                                        seen_ext: ExtendedCommit) -> None:
        self.save_block(block, parts, seen_ext.to_commit())
        self.db.set(_hkey(K_EXT_COMMIT, block.header.height),
                    codec.pack(seen_ext))

    def load_block(self, height: int) -> Block | None:
        raw = self.db.get(_hkey(K_BLOCK, height))
        return codec.unpack(raw) if raw else None

    def load_block_parts(self, height: int, device=None) -> PartSet | None:
        """The block's part set, built again from its bytes."""
        block = self.load_block(height)
        if block is None:
            return None
        return PartSet.from_data(codec.pack(block), device=device)

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self.db.get(_hkey(K_META, height))
        if not raw:
            return None
        d = _msgpack.unpackb(raw)
        return BlockMeta(codec.from_dict(d["bid"]), d["size"], d["ntxs"],
                         d["h"])

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit of ``height`` (from block h + 1's
        last commit)."""
        raw = self.db.get(_hkey(K_COMMIT, height))
        return codec.unpack(raw) if raw else None

    def load_seen_commit(self) -> Commit | None:
        raw = self.db.get(K_SEEN_COMMIT)
        return codec.unpack(raw) if raw else None

    def load_block_extended_commit(self, height: int
                                   ) -> ExtendedCommit | None:
        raw = self.db.get(_hkey(K_EXT_COMMIT, height))
        return codec.unpack(raw) if raw else None

    def _delete_height(self, h: int) -> None:
        for prefix in (K_BLOCK, K_META, K_COMMIT, K_EXT_COMMIT):
            self.db.delete(_hkey(prefix, h))

    def prune_blocks(self, retain_height: int) -> int:
        """Remove the blocks below ``retain_height`` (store/store.go
        PruneBlocks); returns how many.  A height past the store's tip
        raises, as in the reference."""
        if retain_height <= self._base:
            return 0
        if retain_height > self._height + 1:
            raise ValueError(
                f"retain height {retain_height} beyond store height "
                f"{self._height}")
        pruned = 0
        for h in range(self._base, retain_height):
            self._delete_height(h)
            pruned += 1
        self._base = retain_height
        self.db.set(K_STATE, self._bookkeeping())
        return pruned

    def truncate_above(self, height: int) -> int:
        """Remove every block above ``height`` (the storage doctor's
        repair: blocksync fetches the tip again); missing records are
        tolerated.  Returns the number of heights removed."""
        if height < 0 or (self._height and height > self._height):
            raise ValueError(
                f"cannot truncate to {height}: store at {self._height}")
        removed = 0
        while self._height > height:
            self._delete_height(self._height)
            self._height -= 1
            removed += 1
        if self._height == 0:
            self._base = 0
        elif self._base > self._height:
            self._base = self._height
        if removed:
            self.db.set(K_STATE, self._bookkeeping())
        return removed

    def is_dirty(self) -> bool:
        """True while the backing store was salvaged after corruption and
        not yet verified: a dirty store serves no blocks."""
        fn = getattr(self.db, "is_dirty", None)
        return bool(fn is not None and fn())

    def clear_dirty(self) -> None:
        fn = getattr(self.db, "clear_dirty", None)
        if fn is not None:
            fn()

    def remove_tip(self) -> None:
        """Delete the highest block (rollback --hard; the reference pairs
        state/rollback.go with store.DeleteLatestBlock)."""
        if self._height == 0:
            raise ValueError("empty block store")
        self._delete_height(self._height)
        self._height -= 1
        if self._height < self._base:
            self._base = self._height
        self.db.set(K_STATE, self._bookkeeping())

    def bootstrap_statesync(self, height: int, seen_commit: Commit) -> None:
        """Statesync's bookkeeping: no blocks below ``height``, but the
        trusted commit for it, so consensus proposes at height + 1 and
        blocksync serves nothing older."""
        if self._height != 0:
            raise ValueError("cannot bootstrap a non-empty block store")
        self._base = height
        self._height = height
        self.db.set_batch({K_SEEN_COMMIT: codec.pack(seen_commit),
                           K_STATE: self._bookkeeping()})
