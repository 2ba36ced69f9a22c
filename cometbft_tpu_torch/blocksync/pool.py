"""BlockPool: block fetching by height for fast sync (reference:
``internal/blocksync/pool.go:72,116,218,296,438``; counterpart of
``cometbft_tpu/blocksync/pool.py``).

One requester per height in flight, bounded by a total and a per-peer
cap, each an asyncio task on the node's event loop (one writer, so the
pool takes no locks).  Fetched blocks wait in the pool until the
reactor's apply loop takes them in height order, a *window* at a time
(:meth:`BlockPool.peek_window`) rather than the reference's
PeekTwoBlocks pairs: the window is what fills one device call."""

from __future__ import annotations

import asyncio
from typing import Callable

from ..libs import clock

__all__ = ["REQUEST_TIMEOUT", "MAX_TOTAL_REQUESTERS",
           "MAX_PENDING_PER_PEER", "BlockPool"]

REQUEST_TIMEOUT = 15.0          # pool.go requestRetrySeconds
MAX_TOTAL_REQUESTERS = 64       # pool.go maxTotalRequesters (600) scaled down
MAX_PENDING_PER_PEER = 20       # pool.go maxPendingRequestsPerPeer


class _BsPeer:
    def __init__(self, peer_id: str, base: int, height: int):
        self.id = peer_id
        self.base = base
        self.height = height
        self.pending = 0            # outstanding block requests


class _Requester:
    """Owns fetching one height (pool.go bpRequester)."""

    def __init__(self, pool: "BlockPool", height: int):
        self.pool = pool
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.ext_commit = None
        self.got_block = asyncio.Event()
        self.redo = asyncio.Event()
        self.task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            # pick a peer that has our height and spare pending capacity
            peer = None
            while peer is None:
                peer = self.pool._pick_peer(self.height)
                if peer is None:
                    await clock.sleep(0.05)
                    if self.pool._stopped:
                        return
            self.peer_id = peer.id
            peer.pending += 1
            self.pool.send_request(peer.id, self.height)
            try:
                await clock.wait_for(self._wait_block_or_redo(),
                                      REQUEST_TIMEOUT)
            except asyncio.TimeoutError:
                # peer too slow: drop it (pool.go:153 timeout -> RemovePeer)
                self.pool.remove_peer(peer.id, reason="block request timeout",
                                      event="block_timeout")
            finally:
                peer.pending = max(0, peer.pending - 1)
            if self.block is not None and not self.redo.is_set():
                return                          # done; pool consumes us
            # redo: try again with a different peer
            self.redo.clear()
            self.block = None
            self.ext_commit = None
            self.got_block.clear()

    async def _wait_block_or_redo(self) -> None:
        waits = [asyncio.create_task(self.got_block.wait()),
                 asyncio.create_task(self.redo.wait())]
        try:
            await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
        finally:
            # also on cancellation (request timeout): asyncio.wait does not
            # cancel its waiters for us
            for t in waits:
                t.cancel()

    def give_block(self, peer_id: str, block, ext_commit) -> bool:
        if self.peer_id != peer_id or self.block is not None:
            return False
        self.block = block
        self.ext_commit = ext_commit
        self.got_block.set()
        return True

    def refetch(self) -> None:
        """Discard any held block and fetch again from another peer (the
        redo path of pool.go bpRequester.redo)."""
        self.block = None
        self.ext_commit = None
        self.peer_id = None
        if self.task.done():
            self.got_block = asyncio.Event()
            self.redo = asyncio.Event()
            self.task = asyncio.create_task(self._run())
        else:
            self.redo.set()
            self.got_block.set()

    def stop(self) -> None:
        self.task.cancel()


class BlockPool:
    def __init__(self, start_height: int,
                 send_request: Callable[[str, int], None],
                 on_peer_error: Callable[[str, str, str], None] =
                 lambda p, r, e: None):
        self.height = start_height          # next height to consume
        self.send_request = send_request
        self.on_peer_error = on_peer_error
        self.peers: dict[str, _BsPeer] = {}
        self.requesters: dict[int, _Requester] = {}
        self.max_peer_height = 0
        self._stopped = False
        self._spawn_task: asyncio.Task | None = None

    def start(self) -> None:
        self._spawn_task = asyncio.create_task(self._make_requesters())

    async def stop(self) -> None:
        self._stopped = True
        if self._spawn_task is not None:
            self._spawn_task.cancel()
        for r in self.requesters.values():
            r.stop()
        self.requesters.clear()

    # ------------------------------------------------------------- peers

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """StatusResponse from a peer (pool.go SetPeerRange)."""
        p = self.peers.get(peer_id)
        if p is None:
            p = self.peers[peer_id] = _BsPeer(peer_id, base, height)
        else:
            p.base, p.height = base, height
        self.max_peer_height = max(self.max_peer_height, height)

    def remove_peer(self, peer_id: str, reason: str = "",
                    event: str | None = None) -> None:
        """Drop a peer from the pool.  ``event`` names the misbehavior
        to report upstream (``block_timeout`` / ``bad_block``); None
        means the peer simply went away (switch-initiated removal) and
        must NOT be scored."""
        p = self.peers.pop(peer_id, None)
        if p is None:
            return
        for r in self.requesters.values():
            if r.peer_id == peer_id:
                r.refetch()     # pending AND already-delivered are suspect
        # a gone (or lying) tall peer must not pin the catch-up target
        # (pool.go removePeer -> updateMaxPeerHeight)
        self.max_peer_height = max(
            (q.height for q in self.peers.values()), default=0)
        if event is not None:
            self.on_peer_error(peer_id, reason, event)

    def _pick_peer(self, height: int) -> _BsPeer | None:
        best = None
        for p in self.peers.values():
            if p.base <= height <= p.height and \
                    p.pending < MAX_PENDING_PER_PEER and \
                    (best is None or p.pending < best.pending):
                best = p
        return best

    # --------------------------------------------------------- requesters

    async def _make_requesters(self) -> None:
        """pool.go:116 makeRequestersRoutine."""
        while not self._stopped:
            next_h = self.height + len(self.requesters)
            if len(self.requesters) < MAX_TOTAL_REQUESTERS and \
                    next_h <= self.max_peer_height:
                # skip heights already consumed below self.height
                if next_h not in self.requesters and next_h >= self.height:
                    self.requesters[next_h] = _Requester(self, next_h)
                    continue
            await clock.sleep(0.02)

    def add_block(self, peer_id: str, block, ext_commit=None) -> bool:
        """BlockResponse arrived (pool.go:296 AddBlock)."""
        r = self.requesters.get(block.header.height)
        if r is None:
            return False
        return r.give_block(peer_id, block, ext_commit)

    # ------------------------------------------------------------ consume

    def peek_window(self, max_blocks: int) -> list[tuple[object, object]]:
        """Longest contiguous run of fetched blocks from ``height``
        (generalizes pool.go PeekTwoBlocks to a device-batch window).
        Returns [(block, ext_commit)]."""
        out = []
        h = self.height
        while len(out) < max_blocks:
            r = self.requesters.get(h)
            if r is None or r.block is None:
                break
            out.append((r.block, r.ext_commit))
            h += 1
        return out

    def pop_request(self) -> None:
        """Block at ``height`` applied; advance (pool.go PopRequest)."""
        r = self.requesters.pop(self.height, None)
        if r is not None:
            r.stop()
        self.height += 1

    def redo_request(self, height: int) -> str | None:
        """Verification downstream failed: penalize the peer that served
        this height and refetch every block it delivered (pool.go
        RedoRequest).  ``bad_block`` is the heaviest misbehavior event:
        the peer-quality scorer bans on repetition."""
        r = self.requesters.get(height)
        bad_peer = r.peer_id if r is not None else None
        if bad_peer is not None:
            self.remove_peer(bad_peer, reason=f"bad block at {height}",
                             event="bad_block")
        elif r is not None:
            r.refetch()
        return bad_peer

    # ------------------------------------------------------------- status

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: we have peers and consumed to within one
        block of the best peer height."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height
