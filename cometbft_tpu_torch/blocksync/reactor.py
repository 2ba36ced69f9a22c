"""Blocksync reactor: fast-sync a lagging node from its peers' block
stores (reference: ``internal/blocksync/reactor.go:55,319,495,548``;
counterpart of ``cometbft_tpu/blocksync/reactor.py``).

Channel 0x40, five messages: StatusRequest/StatusResponse,
BlockRequest/BlockResponse/NoBlockResponse (``proto/cometbft/blocksync``),
MessagePack maps whose ``"@"`` key names the message, byte for byte the
JAX package's.

Where the reference verifies one commit per block
(``reactor.go:495``, VerifyCommitLight per PeekTwoBlocks pair), this
reactor takes a *window* of fetched blocks and proves all their commits
in one dense device call (``types/validation.py:
verify_commits_light_batched``), then applies the blocks with the
signatures not checked again.  The window is double-buffered: while
window K verifies (its dispatch queued on the device-owner thread,
``patient=True``), window K + 1 is packed (part sets, sign-bytes rows)
on a worker thread.  Verdicts come back per item, so one bad block costs
the refetch of its height and of its voucher, the proven prefix still
applies, and the peer that served it is reported (``bad_block``)
through ``Switch.report_peer``.  ``device`` is where the windows verify
and where large hashes run (None: CUDA; ``"cpu"``: the plain versions).
"""

from __future__ import annotations

import asyncio

from ..crypto import plan as deviceplan
from ..libs import aio, clock
from ..p2p.reactor import ChannelDescriptor, Reactor
from ..sm.validation import BlockValidationError, validate_block
from ..types import _msgpack, codec
from ..types.block_id import BlockID
from ..types.part_set import PartSet
from ..types.validation import (CommitVerificationError, ErrBatchItemInvalid,
                                ErrInvalidSignature,
                                verify_commits_light_batched)
from .pool import BlockPool

__all__ = ["BLOCKSYNC_CHANNEL", "STATUS_UPDATE_INTERVAL",
           "SWITCH_CHECK_INTERVAL", "BATCH_WINDOW", "BlocksyncReactor"]

BLOCKSYNC_CHANNEL = 0x40
STATUS_UPDATE_INTERVAL = 3.0     # reference statusUpdateIntervalSeconds (10)
SWITCH_CHECK_INTERVAL = 0.2      # reference switchToConsensusIntervalSeconds
# blocks a device call by default (+1 for the vouching tail); the
# verify_window argument overrides it
BATCH_WINDOW = 32


def _pack(tag: str, **fields) -> bytes:
    fields["@"] = tag
    return _msgpack.packb(fields)


class BlocksyncReactor(Reactor):
    def __init__(self, block_exec, block_store, state, *,
                 fast_sync: bool = False, switch_to_consensus=None,
                 device=None,
                 no_peers_grace: float = 5.0,
                 verify_window: int | None = None, name: str = "bs"):
        super().__init__()
        self.block_exec = block_exec
        self.block_store = block_store
        self.state = state
        self.fast_sync = fast_sync
        self.switch_to_consensus = switch_to_consensus
        self.device = device
        self.no_peers_grace = no_peers_grace
        # blocks whose commits fill one device call
        self.verify_window = max(2, int(verify_window or BATCH_WINDOW))
        self.name = name
        self.pool: BlockPool | None = None
        self._tasks: list[asyncio.Task] = []
        self.synced = asyncio.Event()
        self.hold = False        # statesync runs first; node releases us
        if not fast_sync:
            self.synced.set()

    def get_channels(self):
        return [ChannelDescriptor(BLOCKSYNC_CHANNEL, priority=5,
                                  send_queue_capacity=1000,
                                  name="blocksync")]

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if not self.fast_sync or self.hold:
            return
        await self.start_sync()

    async def start_sync(self) -> None:
        """Start the pool and the apply loop; a node whose statesync runs
        first calls this when it is done (``hold``; the reference starts
        statesync, then blocksync)."""
        self.pool = BlockPool(
            self.block_store.height() + 1
            if self.block_store.height() else self.state.initial_height,
            self._send_block_request, self._on_pool_peer_error)
        self.pool.start()
        self._tasks = [
            asyncio.create_task(self._apply_routine()),
            asyncio.create_task(self._status_routine()),
        ]
        if self.switch is not None:
            # peers that connected while statesync held us sent their
            # ranges to a pool that did not exist yet: ask again, as the
            # reference's pool routine does when it starts
            # (BroadcastStatusRequest); the JAX package's reactor does
            # not, and its restored node learns no peer height
            self.switch.broadcast(BLOCKSYNC_CHANNEL, _pack("sreq"))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        if self.pool is not None:
            await self.pool.stop()

    # ---------------------------------------------------------------- p2p

    def add_peer(self, peer) -> None:
        peer.send(BLOCKSYNC_CHANNEL, _pack(
            "sres", h=self.block_store.height(), b=self.block_store.base()))
        if self.pool is not None:
            peer.send(BLOCKSYNC_CHANNEL, _pack("sreq"))

    def remove_peer(self, peer, reason=None) -> None:
        if self.pool is not None:
            self.pool.remove_peer(peer.id, str(reason or ""))

    def receive(self, channel_id: int, peer, msg: bytes) -> None:
        d = _msgpack.unpackb(msg)
        tag = d.get("@")
        if tag == "sreq":
            peer.send(BLOCKSYNC_CHANNEL, _pack(
                "sres", h=self.block_store.height(),
                b=self.block_store.base()))
        elif tag == "sres":
            if self.pool is not None:
                self.pool.set_peer_range(peer.id, d["b"], d["h"])
        elif tag == "breq":
            self._serve_block(peer, d["h"])
        elif tag == "bres":
            if self.pool is not None:
                block = codec.unpack(d["blk"])
                ext = codec.unpack(d["ext"]) if d.get("ext") else None
                self.pool.add_block(peer.id, block, ext)
        elif tag == "nores":
            pass    # requester timeout will redo with another peer

    def _serve_block(self, peer, height: int) -> None:
        """reactor.go respondToPeer."""
        if getattr(self.block_store, "is_dirty", None) is not None and \
                self.block_store.is_dirty():
            # salvaged-but-unverified store: salvage can resurrect stale
            # records, so nothing here may be served until the doctor's
            # deep verification clears the dirty marker
            peer.send(BLOCKSYNC_CHANNEL, _pack("nores", h=height))
            return
        block = self.block_store.load_block(height)
        if block is None:
            peer.send(BLOCKSYNC_CHANNEL, _pack("nores", h=height))
            return
        ext = None
        if self.state.consensus_params.feature.vote_extensions_enabled(
                height):
            ext = self.block_store.load_block_extended_commit(height)
        peer.send(BLOCKSYNC_CHANNEL, _pack(
            "bres", h=height, blk=codec.pack(block),
            ext=codec.pack(ext) if ext is not None else None))

    def _send_block_request(self, peer_id: str, height: int) -> None:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is not None:
            peer.send(BLOCKSYNC_CHANNEL, _pack("breq", h=height))

    def _on_pool_peer_error(self, peer_id: str, reason: str,
                            event: str = "block_timeout") -> None:
        if self.switch is None:
            return
        if hasattr(self.switch, "report_peer"):
            # score the event (bad_block bans on repetition) and drop the
            # peer: the pool already decided it must go
            self.switch.report_peer(peer_id, event, detail=reason,
                                    disconnect=True)
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            aio.spawn(self.switch.stop_peer_for_error(peer, reason))

    # ------------------------------------------------------- status gossip

    async def _status_routine(self) -> None:
        while True:
            await clock.sleep(STATUS_UPDATE_INTERVAL)
            if self.switch is not None:
                self.switch.broadcast(BLOCKSYNC_CHANNEL, _pack(
                    "sres", h=self.block_store.height(),
                    b=self.block_store.base()))

    # ---------------------------------------------------------- apply loop

    async def _apply_routine(self) -> None:
        """reactor.go:319 poolRoutine as a double-buffered pipeline: one
        window verifies while the next is peeked, packed and queued
        behind it, so the host's packing overlaps the device's work."""
        pool = self.pool
        started = clock.monotonic()
        staged: _StagedWindow | None = None
        while True:
            if self._should_switch(started):
                self._discard_staged(staged)
                await self._do_switch()
                return
            if staged is None:
                try:
                    staged = self._stage_window(0)
                except _RedoBlock as e:
                    pool.redo_request(e.height)
                    pool.redo_request(e.height + 1)
                    continue
            if staged is None:
                await clock.sleep(SWITCH_CHECK_INTERVAL)
                continue
            # stage the window behind the one in flight: its packing runs
            # while the first verifies.  A set boundary or an empty pool
            # tail gives None (a partial window goes as it is, it never
            # waits to fill); skip > 0 never raises
            nxt = self._stage_window(staged.n_blocks)
            try:
                applied = await self._apply_staged(staged)
            except _RedoBlock as e:
                # the block and the next one (whose last_commit vouched
                # for it) are both suspect: the reference redoes both
                # (reactor.go:505-512).  redo_request reports the peer
                # that served it (bad_block, through the pool's error
                # hook) and fetches again; the window staged behind
                # verified heights now fetched again, so it goes.
                pool.redo_request(e.height)
                pool.redo_request(e.height + 1)
                self._discard_staged(nxt)
                staged = None
                continue
            staged = nxt
            if applied == 0 and staged is None:
                await clock.sleep(SWITCH_CHECK_INTERVAL)

    def _should_switch(self, started: float) -> bool:
        pool = self.pool
        if pool.is_caught_up():
            return True
        if not pool.peers and \
                clock.monotonic() - started > self.no_peers_grace:
            return True          # nobody to sync from: just run consensus
        return False

    async def _do_switch(self) -> None:
        """reactor.go:421-431 SwitchToConsensus."""
        await self.pool.stop()
        self.synced.set()
        if self.switch_to_consensus is not None:
            await self.switch_to_consensus(self.state)

    # ------------------------------------------------- window accumulator

    def _stage_window(self, skip: int) -> "_StagedWindow | None":
        """Take the longest run of fetched blocks under one validator set,
        from ``skip`` blocks past the pool's head (skip > 0: the second
        buffer), and hand it to a worker thread: packing (part sets,
        sign-bytes rows) and the device call run off the event loop
        while this loop applies.

        Returns None when there is nothing to stage.  Raises _RedoBlock
        only for skip = 0 with a set mismatch at the very next block to
        apply (the header lies, or the chain changed validators); at
        skip > 0 the same mismatch is the boundary that the next turn
        of the loop handles with the new state."""
        state = self.state
        blocks = deviceplan.window_blocks(
            self.verify_window, len(state.validators.validators))
        window = self.pool.peek_window(skip + blocks + 1)[skip:]
        if len(window) < 2:
            return None
        vals_hash = state.validators.hash(self.device)
        raw = []                 # (block, vouching commit, ext)
        for i in range(len(window) - 1):
            first, ext = window[i]
            second, _ = window[i + 1]
            if first.header.validators_hash != vals_hash or \
                    second.last_commit is None:
                break
            raw.append((first, second.last_commit, ext))
        if not raw:
            if skip == 0:
                raise _RedoBlock(self.pool.height)
            return None
        task = asyncio.create_task(asyncio.to_thread(
            self._pack_verify_window, state, raw))
        # a discarded buffer (redo, switch-over) must not surface
        # "exception never retrieved": read the exception when done
        task.add_done_callback(lambda t: t.cancelled() or t.exception())
        return _StagedWindow(task=task, n_blocks=len(raw),
                             first_height=raw[0][0].header.height)

    def _pack_verify_window(self, state, raw):
        """Worker thread: pack the part sets and block IDs, then prove
        every commit of the window in one device call (``patient``: it
        queues behind the window ahead on the device-owner thread).
        Returns ``(prefix, err)``: the prefix entries are ready to apply,
        and ``err`` (an ErrBatchItemInvalid, ``item`` relative to the
        window) marks the first unproven item; entries before
        ``err.item`` are proven, so the caller applies them before the
        bad height is fetched again."""
        prefix = []              # (block, parts, block_id, commit, ext)
        items = []
        for first, commit, ext in raw:
            parts = PartSet.from_data(codec.pack(first), device=self.device)
            fid = BlockID(first.hash(), parts.header())
            items.append((fid, first.header.height, commit))
            prefix.append((first, parts, fid, commit, ext))
        err = None
        try:
            verify_commits_light_batched(
                state.chain_id, state.validators, items,
                device=self.device, patient=True)
        except ErrBatchItemInvalid as e:
            err = e
            if e.item > 0 and not isinstance(e.cause, ErrInvalidSignature):
                # a basics or tally failure before the dispatch: no lane
                # was verified.  Prove the prefix apart, so that its good
                # blocks still apply.  (A signature failure needs no
                # second pass: the dispatch computed every verdict, so
                # the items before the offender are proven.)
                try:
                    verify_commits_light_batched(
                        state.chain_id, state.validators, items[:e.item],
                        device=self.device, patient=True)
                except ErrBatchItemInvalid as e2:
                    err = e2
        return prefix, err

    async def _apply_staged(self, staged: "_StagedWindow") -> int:
        """Await the window's verdicts and apply the proven prefix
        (reactor.go:495-548).  A bad commit raises _RedoBlock for its
        height after the proven blocks before it applied: one lying peer
        costs one refetch, not the window."""
        prefix, err = await staged.task
        good = prefix if err is None else prefix[:err.item]
        applied = 0
        state = self.state
        for first, parts, fid, commit, ext in good:
            h = first.header.height
            try:
                # structural checks only: sigs proven in the batch above
                validate_block(state, first, device=self.device,
                               verify_last_commit_sigs=False)
                self.block_exec.evidence_pool.check_evidence(first.evidence)
            except (BlockValidationError, CommitVerificationError) as e:
                raise _RedoBlock(h) from e
            ext_enabled = state.consensus_params.feature \
                .vote_extensions_enabled(h)
            if ext_enabled:
                if ext is None or ext.height != h or \
                        not ext.ensure_extensions(True):
                    raise _RedoBlock(h)
                self.block_store.save_block_with_extended_commit(
                    first, parts, ext)
            else:
                self.block_store.save_block(first, parts, commit)
            state = await self.block_exec.apply_block(
                state, fid, first, verified=True)
            self.state = state
            self.pool.pop_request()
            applied += 1
        if err is not None:
            raise _RedoBlock(err.height) from err
        return applied

    @staticmethod
    def _discard_staged(staged: "_StagedWindow | None") -> None:
        """Drop a speculative buffer whose heights are being refetched
        (or whose reactor is switching over).  The to_thread body cannot
        be interrupted mid-dispatch; the done callback attached at stage
        time consumes its result/exception."""
        if staged is not None:
            staged.task.cancel()


class _StagedWindow:
    """One buffer of the double-buffered verify pipeline: a window of
    contiguous fetched blocks whose packing + batched commit
    verification run on the dispatch worker."""

    __slots__ = ("task", "n_blocks", "first_height")

    def __init__(self, task, n_blocks: int, first_height: int):
        self.task = task
        self.n_blocks = n_blocks
        self.first_height = first_height


class _RedoBlock(Exception):
    def __init__(self, height: int):
        self.height = height
        super().__init__(f"redo block {height}")
